"""Idle share of the device in the WVT loop's steady iterations: 1 -
busy / wall over the ``wvt_iteration`` spans, with the builds, list
refreshes and program captures below them (``wvt_build``,
``wvt_refresh``, ``wvt_capture``) cut out of both, in %: the idle time
that speculative dispatch and replayed programs should hide.  Moves
``wvt_updates_per_s``."""

from benchlib.spans import idle_pct


def read(run):
    return idle_pct(run, "wvt_done", ("wvt_iteration",),
                    ("wvt_build", "wvt_refresh", "wvt_capture"))
