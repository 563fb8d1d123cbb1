"""WVT relaxation rate: gas particles x WVT iterations, summed over the
window's ICs, over the summed ``wvt_done`` seconds of their loops (the
stage log's span of each loop, host clock after a device synchronise)."""


def read(run):
    done = [(ic.n_gas, f) for ic in run.ics for _, f in ic.stage("wvt_done")]
    seconds = sum(f["seconds"] for _, f in done)
    if not done or seconds <= 0:
        return None
    return sum(n * f["iterations"] for n, f in done) / seconds
