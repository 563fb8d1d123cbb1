"""Share of the WVT loops' time in the neighbour engine's own work: the
seconds of the ``wvt_build`` and ``wvt_refresh`` spans with the sweep
programs' captures below them (``wvt_capture`` spans) cut out, over the
seconds of the ``wvt_loop`` spans, in %.  ``nbr.share`` counts those
captures too; the spans ride on the ``wvt_done`` record.  Moves
``wvt_updates_per_s``."""

from benchlib.spans import named, self_seconds, span_lists

CALLS = ("wvt_build", "wvt_refresh")


def read(run):
    own = loop = 0.0
    for spans in span_lists(run, "wvt_done"):
        loop += sum(spans[i]["seconds"] for i in named(spans, "wvt_loop"))
        own += sum(self_seconds(spans, i, ("wvt_capture",))
                   for i, s in enumerate(spans) if s["name"] in CALLS)
    return 100.0 * own / loop if loop > 0 else None
