"""Idle share of the device over the window's ICs: 1 - busy / wall over the
harness's span around each IC, in %.  Moves ``ic_s``."""

from benchlib.devtrace import IC_SPAN


def read(run):
    if run.trace is None:
        return None
    share = run.trace.idle_share(IC_SPAN)
    return None if share is None else 100.0 * share
