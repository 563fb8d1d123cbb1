"""Idle share of the device in the neighbour engine's calls: 1 - busy /
wall over the ``wvt_build`` and ``wvt_refresh`` spans, the sweep
programs' captures below them (``wvt_capture``) cut out of both, busy the
union of device ops in the trace, in %.  Moves ``wvt_updates_per_s``."""

from benchlib.spans import idle_pct


def read(run):
    return idle_pct(run, "wvt_done", ("wvt_build", "wvt_refresh"),
                    ("wvt_capture",))
