"""Idle share of the device over the WVT loops: 1 - busy / wall over every
``wvt_loop`` span (the program's ``record_function``), busy the union of
device ops in the trace, in %.  Moves ``wvt_updates_per_s``."""

from benchlib.devtrace import WVT_SPAN


def read(run):
    if run.trace is None:
        return None
    share = run.trace.idle_share(WVT_SPAN)
    return None if share is None else 100.0 * share
