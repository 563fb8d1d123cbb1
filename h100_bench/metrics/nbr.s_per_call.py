"""Seconds a neighbour-engine call: the summed ``seconds`` of the
``wvt_build`` and ``wvt_refresh`` records over their count.  Moves
``wvt_updates_per_s``."""


def read(run):
    calls = run.records("wvt_build") + run.records("wvt_refresh")
    if not calls:
        return None
    return sum(f["seconds"] for _, f in calls) / len(calls)
