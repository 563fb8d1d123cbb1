"""Seconds an IC spent making the WVT loop's programs (the ``seconds`` of
every ``wvt_graph`` record: iteration and sweep programs captured).
Moves ``wvt_updates_per_s``."""


def read(run):
    recs = run.records("wvt_graph")
    if not recs:
        return None
    return sum(f["seconds"] for _, f in recs) / len(run.ics)
