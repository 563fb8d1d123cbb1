"""Share of the WVT loops' time in the neighbour engine: the summed
``seconds`` of the ``wvt_build`` and ``wvt_refresh`` records over the
summed ``wvt_done`` seconds, in %.  Moves ``wvt_updates_per_s``."""


def read(run):
    calls = run.records("wvt_build") + run.records("wvt_refresh")
    loop = sum(f["seconds"] for _, f in run.records("wvt_done"))
    if not calls or loop <= 0:
        return None
    return 100.0 * sum(f["seconds"] for _, f in calls) / loop
