"""Peak device memory: the largest ``torch.cuda.max_memory_allocated()``
read after each IC of the window (``make_ics`` resets the peak as it
starts), in GiB."""


def read(run):
    peak = max(ic.peak_bytes for ic in run.ics)
    return peak / 2**30 if peak > 0 else None
