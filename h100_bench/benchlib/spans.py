"""The program's spans, as the stage log carries them: the list field
``spans`` of a record (``wvt_done`` for the WVT loop, ``velocities`` for
the velocity tables), each span a dict of ``name``, ``parent`` (an index
into the same list, -1 for a root), ``t0`` (the host clock,
``time.perf_counter``, at its start), ``seconds`` and a few fields.

A span's interval maps to the device trace's clock through the
harness's own offset (``devtrace.Trace.ns``).  "Cut out": the intervals
of the spans named below a span are taken away from both its wall time
and its busy time.  A run of a program whose records carry no spans
finds none here, and the metrics that read them are left out.
"""

from __future__ import annotations

from bisect import bisect_left, bisect_right
from itertools import accumulate


class Busy:
    """The union of a trace's device ops as sorted disjoint intervals,
    with running lengths, so that the busy time of a window costs two
    bisections: ``devtrace.Trace.busy_s`` scans every op at each call,
    and a traced window holds ~1e5 ops against ~1e3 spans.  The same
    union, so the same seconds."""

    def __init__(self, trace):
        merged = []
        for s, e in sorted((s, e) for _, s, e in trace.ops):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            elif e > s:
                merged.append([s, e])
        self.starts = [s for s, _ in merged]
        self.ends = [e for _, e in merged]
        self.before = [0.0] + list(accumulate(e - s for s, e in merged))

    def busy_s(self, lo, hi):
        """Seconds in [lo, hi] (ns) in which some device op ran."""
        i = bisect_right(self.ends, lo)     # the first ending after lo
        j = bisect_left(self.starts, hi)    # those before j start before hi
        if j <= i:
            return 0.0
        ns = (self.before[j] - self.before[i] - max(0.0, lo - self.starts[i])
              - max(0.0, self.ends[j - 1] - hi))
        return ns * 1e-9


def span_lists(run, stage):
    """The ``spans`` list of every record of ``stage`` over the window's
    ICs (records without one are skipped)."""
    return [f["spans"] for ic in run.ics for _, f in ic.stage(stage)
            if f.get("spans")]


def named(spans, name):
    """The indices of the spans called ``name``."""
    return [i for i, s in enumerate(spans) if s["name"] == name]


def below(spans, i, names):
    """The indices of the spans called one of ``names`` that lie below
    span ``i``, the topmost of them only (none of their ancestors up to
    ``i`` is called one of ``names``)."""
    out = []
    for j in range(i + 1, len(spans)):
        if spans[j]["name"] not in names:
            continue
        k = spans[j]["parent"]
        while k > i and spans[k]["name"] not in names:
            k = spans[k]["parent"]
        if k == i:
            out.append(j)
    return out


def self_seconds(spans, i, cut):
    """The seconds of span ``i`` with the spans ``cut`` below it cut
    out."""
    return spans[i]["seconds"] - sum(spans[j]["seconds"]
                                     for j in below(spans, i, cut))


def interval(trace, span):
    """(start, end) of ``span`` on the device trace's clock (ns)."""
    lo = trace.ns(span["t0"])
    return lo, lo + span["seconds"] * 1e9


def wall_busy(trace, busy, spans, i, cut=()):
    """(wall, busy) seconds of span ``i`` with the spans ``cut`` below
    it cut out; ``busy``: the trace's ``Busy``."""
    lo, hi = interval(trace, spans[i])
    wall, on = (hi - lo) * 1e-9, busy.busy_s(lo, hi)
    for j in below(spans, i, cut):
        a, b = interval(trace, spans[j])
        wall -= (b - a) * 1e-9
        on -= busy.busy_s(a, b)
    return wall, on


def idle_pct(run, stage, names, cut):
    """1 - busy / wall over every span called one of ``names`` in the
    records of ``stage``, each with the spans ``cut`` below it cut out,
    in %; None without a trace or without such a span."""
    lists = span_lists(run, stage)
    if run.trace is None or not lists:
        return None
    index = Busy(run.trace)
    wall = busy = 0.0
    for spans in lists:
        for i, s in enumerate(spans):
            if s["name"] in names:
                w, b = wall_busy(run.trace, index, spans, i, cut)
                wall += w
                busy += b
    if wall <= 0:
        return None
    return 100.0 * (1.0 - busy / wall)
