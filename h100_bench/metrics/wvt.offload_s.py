"""Seconds an IC of the WVT loop's large-run offload: the summed seconds
of the program's ``wvt_offload`` span (the particle set parked: ``pid``
and ``halo`` copied to pinned host memory, the rest freed) and
``wvt_restore`` span (both permuted on the host, copied back, the set
rebuilt), carried on the ``wvt_done`` record, over the window's ICs.
Both lie inside ``wvt_done``'s seconds: moves ``wvt_updates_per_s``.
None where no loop parked its set (below the offload threshold, or a
program without the spans)."""

from benchlib.spans import named, span_lists

NAMES = ("wvt_offload", "wvt_restore")


def read(run):
    seconds = [s[i]["seconds"] for s in span_lists(run, "wvt_done")
               for name in NAMES for i in named(s, name)]
    return sum(seconds) / len(run.ics) if seconds else None
