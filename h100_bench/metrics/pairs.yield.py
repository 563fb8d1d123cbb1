"""Share of the pairs that the WVT loop's pair kernels walked that the
inputs need, in %: gas x iterations x DESNNGB (``pairs_roofline``'s
work), summed over the window's ICs, over the summed ``pairs_walked`` of
their ``wvt_done`` records (the program's counter: every kernel call's
walked 128-lane source blocks, over all its sweeps, times 128 x 128).
Beside ``pairs_roofline`` it tells pairs walked in excess from time
spent on a walked pair.  Moves ``wvt_updates_per_s``."""


def read(run):
    done = [(ic.n_gas, f) for ic in run.ics for _, f in ic.stage("wvt_done")
            if f.get("pairs_walked")]
    if not done:
        return None
    need = sum(n * f["iterations"] for n, f in done) * run.facts["desnngb"]
    return 100.0 * need / sum(f["pairs_walked"] for _, f in done)
