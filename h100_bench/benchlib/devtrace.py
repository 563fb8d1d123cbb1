"""The device trace of a traced run, read from ``torch.profiler``'s raw
events in memory (no Chrome trace is written).

The union of device intervals is a frozen copy of the arithmetic of the
program's ``toycluster_tpu_torch/trace.py`` (``busy_s``), so that a change
to the program cannot move it.  Times are the profiler's nanoseconds; a
host-clock stamp ``t`` (``time.perf_counter``) maps to ``t * 1e9 +
offset``, the offset read from the harness's own span around each IC.
"""

from __future__ import annotations

from collections import defaultdict
from dataclasses import dataclass

IC_SPAN = "h100_bench_ic"      # the harness's record_function around an IC
WVT_SPAN = "wvt_loop"          # the program's span around the WVT loop


def union_ns(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def clip(intervals, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if min(e, hi) > max(s, lo)]


def events(prof, span_names=(IC_SPAN, WVT_SPAN)):
    """(ops, spans) of a finished profiler run: ops (name, start ns, end
    ns) of every device op, spans {name: [(start, end)]} of the host
    ranges named ``span_names``.  A record_function also shows on the
    device timeline as a user annotation, which is no op."""
    import torch
    ops, spans = [], defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        note = getattr(e, "is_user_annotation", lambda: False)()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not note and e.name() not in span_names:
                ops.append((e.name(), start, end))
        elif e.name() in span_names:
            spans[e.name()].append((start, end))
    return ops, dict(spans)


@dataclass
class Trace:
    ops: list           # (name, start ns, end ns)
    spans: dict         # name -> [(start ns, end ns)], in time order
    offset: float       # profiler ns - host perf_counter ns

    def ns(self, t):
        """The profiler time of host-clock stamp ``t`` (s)."""
        return t * 1e9 + self.offset

    def busy_s(self, lo, hi):
        """Seconds in [lo, hi] in which some device op ran."""
        return union_ns(clip([(s, e) for _, s, e in self.ops], lo, hi)) * 1e-9

    def idle_share(self, span_name):
        """1 - busy / wall over every span ``span_name``; None without
        one."""
        spans = self.spans.get(span_name) or []
        wall = sum(e - s for s, e in spans) * 1e-9
        if wall <= 0:
            return None
        busy = sum(self.busy_s(s, e) for s, e in spans)
        return 1.0 - busy / wall

    def op_seconds(self, match, span_name=None):
        """Device seconds of the ops whose name contains one of the
        strings ``match``, within the spans ``span_name`` (all ops
        without), and their count."""
        windows = self.spans.get(span_name, []) if span_name else None
        total, count = 0.0, 0
        for name, s, e in self.ops:
            if not any(m in name for m in match):
                continue
            if windows is not None:
                e2 = sum(max(0, min(e, hi) - max(s, lo)) for lo, hi in windows)
                if e2 <= 0:
                    continue
                total += e2
            else:
                total += e - s
            count += 1
        return total * 1e-9, count


def _gap_label(stage):
    return {"wvt": "wvt iteration", "wvt_build": "wvt build",
            "wvt_refresh": "wvt refresh", "wvt_graph": "wvt capture",
            "wvt_retry": "wvt retry", "wvt_done": "wvt end"}.get(stage, stage)


def breakdown(trace, ics, top=10):
    """The device ops that took most time, and the idle time of the
    device by what the host was doing, each as seconds an IC over the
    traced ICs.  A gap of the device is put down to the stage whose
    record came first after the gap began (the stage the host was
    busy with); after an IC's last record, to "between ICs"."""
    n = max(len(ics), 1)
    per_op = defaultdict(float)
    for name, s, e in trace.ops:
        per_op[name] += (e - s) * 1e-9
    idle = defaultdict(float)
    intervals = sorted((s, e) for _, s, e in trace.ops)
    for ic, (lo, hi) in zip(ics, trace.spans.get(IC_SPAN, [])):
        stamps = [(trace.ns(t), stage) for t, stage, _ in ic.records]
        cursor = lo
        for s, e in clip(intervals, lo, hi) + [(hi, hi)]:
            if s > cursor:
                label = next((st for t, st in stamps if t >= cursor),
                             "between ICs")
                idle[_gap_label(label)] += (s - cursor) * 1e-9
            cursor = max(cursor, e)

    def ranked(d):
        return [[k[:160], v / n] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:top]]

    return {"device_ops": ranked(per_op), "idle_gaps": ranked(idle)}
