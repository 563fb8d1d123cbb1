"""WVT iterations an IC (``wvt_done.iterations``).  Moves ``ic_s``."""


def read(run):
    recs = run.records("wvt_done")
    if not recs:
        return None
    return sum(f["iterations"] for _, f in recs) / len(run.ics)
