"""Device trace of the main path on one CUDA card::

    python -m toycluster_tpu_torch.trace <parfile> [field=value ...]
        [engine=stream|classed]

Runs ``make_ics`` on ``cuda`` twice in one process, writing no snapshot:
once to build the kernels and warm the allocator, then under
``torch.profiler`` with CUDA activity (``trace_make_ics``), its stage log
kept by a ``utils.logging.Records`` of its own.  Prints, for the traced
run:

* its host wall time and the device's busy time, the union of the
  intervals of every device op (kernels, copies, memsets), and the idle
  share 1 - busy / wall;
* the same over the WVT loop's span alone (the host range that
  ``make_ics`` marks with ``record_function(WVT_SPAN)``);
* the device time and call count of each device op name, largest first;
* each span that the stage log's records carry (the WVT loop's and the
  velocity tables', ``utils.logging.Spans``; each also a range of the
  trace, ``profiler_ranges``), by name: the count, the
  wall seconds, the device's busy and idle seconds within them, and the
  idle seconds that fall in no span below them (their own); the spans
  are mapped to the profiler's clock by the start of its WVT range and
  the start of the loop's root span;
* the wall time of each WVT iteration (from the stage log), the
  saturated lanes of each retry, the iterations the loop queued ahead,
  adopted and dropped and the pairs its pair kernels walked;
* the peak device memory and the launch counts of the pair kernels.

Fails when the profiler recorded no device op.
"""

from __future__ import annotations

import sys
import time
from bisect import bisect_left, bisect_right
from collections import defaultdict
from itertools import accumulate

import torch

from .cli import _coerce
from .config import parse_par_file
from .ops import blocks, class_pair, stream_pair
from .pipeline import make_ics
from .utils import logging as tlog
from .utils.profiling import profiler

# the record_function name of the WVT loop's span in make_ics
WVT_SPAN = "wvt_loop"
KERNELS = (stream_pair.stream_wvt, stream_pair.stream_curl,
           class_pair.solve_density, class_pair.wvt_displacement,
           class_pair.fused_wvt, blocks.super_sweep)


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def busy_s(intervals, lo=float("-inf"), hi=float("inf")):
    """Seconds covered by the (start, end) nanosecond ``intervals`` of
    device ops, within [lo, hi] (nanoseconds)."""
    return _busy_us([(max(s, lo), min(e, hi)) for s, e in intervals
                     if min(e, hi) > max(s, lo)]) * 1e-9


def device_ops(prof):
    """(name, start ns, end ns) of every device op of a finished
    ``torch.profiler`` run, and the (start, end) of each WVT_SPAN on the
    host, read from the profiler's raw events (parsing them into
    FunctionEvents takes tens of seconds for a 1e7 run).  The device
    timeline also carries each record_function's span, from its first to
    its last device op: a user annotation, not an op."""
    ops, spans = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        note = getattr(e, "is_user_annotation", lambda: False)()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            if not note and e.name() != WVT_SPAN:
                ops.append((e.name(), start, end))
        elif e.name() == WVT_SPAN:
            spans.append((start, end))
    return ops, spans


def busy_index(intervals):
    """``busy_s`` of many windows over one set of ``intervals``: a
    function of (lo, hi) that bisects their union (sorted disjoint
    intervals with running lengths) instead of sorting them again."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        elif e > s:
            merged.append([s, e])
    starts = [s for s, _ in merged]
    ends = [e for _, e in merged]
    before = [0.0] + list(accumulate(e - s for s, e in merged))

    def busy(lo, hi):
        i, j = bisect_right(ends, lo), bisect_left(starts, hi)
        if j <= i:
            return 0.0
        return (before[j] - before[i] - max(0.0, lo - starts[i])
                - max(0.0, ends[j - 1] - hi)) * 1e-9
    return busy


def span_table(spans, busy, offset):
    """{name: [count, wall s, busy s, idle s, own idle s]} of ``spans``
    (``utils.logging.Spans`` dicts of one list: parents are indices into
    it), each mapped to the profiler's clock as t0 * 1e9 + ``offset`` and
    read with ``busy`` (``busy_index`` of the device ops).  Own idle: the
    idle seconds of a span less those of the spans directly below it."""
    idle = []
    for s in spans:
        lo = s["t0"] * 1e9 + offset
        idle.append(s["seconds"] - busy(lo, lo + s["seconds"] * 1e9))
    own = list(idle)
    for s, i in zip(spans, idle):
        if s["parent"] >= 0:
            own[s["parent"]] -= i
    out = defaultdict(lambda: [0, 0.0, 0.0, 0.0, 0.0])
    for s, i, o in zip(spans, idle, own):
        row = out[s["name"]]
        row[0] += 1
        row[1] += s["seconds"]
        row[2] += s["seconds"] - i
        row[3] += i
        row[4] += o
    return dict(out)


def trace_make_ics(cfg, engine="stream"):
    """One ``make_ics`` run of ``cfg`` on cuda (no snapshot, the stage
    log kept by a ``Records`` of its own, the launch counters from 0)
    under the profiler.  Returns a dict: ``wall``, ``busy`` (s) and
    ``idle`` (share) of the run; ``wvt_wall``, ``wvt_busy``, ``wvt_idle``
    of the WVT loop's span; ``ops`` {device op name: [calls, ms]};
    ``peak`` (bytes); ``launches`` {kernel: count}; ``records`` (the
    stage log's, as dicts); ``spans`` (``span_table`` of every record's
    spans, or None without the WVT span)."""
    records = tlog.Records()
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profiler(torch.device("cuda")) as prof, tlog.profiler_ranges():
        t0 = time.perf_counter()
        make_ics(cfg, device="cuda", engine=engine, write=False,
                 log=records)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops, spans = device_ops(prof)
    if not ops:
        raise RuntimeError("the profiler recorded no device op")
    intervals = [(s, e) for _, s, e in ops]
    res = dict(wall=wall, busy=busy_s(intervals),
               peak=torch.cuda.max_memory_allocated(),
               launches={k.__name__: k.launches for k in KERNELS},
               wvt_wall=None, wvt_busy=None, wvt_idle=None,
               records=records, spans=None)
    res["idle"] = 1.0 - res["busy"] / wall
    if spans:
        lo, hi = spans[0]
        res["wvt_wall"] = (hi - lo) * 1e-9
        res["wvt_busy"] = busy_s(intervals, lo, hi)
        res["wvt_idle"] = 1.0 - res["wvt_busy"] / res["wvt_wall"]
        roots = [s for r in records for s in r.get("spans", ())
                 if s["name"] == WVT_SPAN]
        if roots:
            offset = lo - roots[0]["t0"] * 1e9
            busy = busy_index(intervals)
            table = defaultdict(lambda: [0, 0.0, 0.0, 0.0, 0.0])
            for r in records:
                for name, row in span_table(r.get("spans", ()), busy,
                                            offset).items():
                    table[name] = [a + b for a, b in zip(table[name], row)]
            res["spans"] = dict(table)
    per = defaultdict(lambda: [0, 0.0])
    for name, s, e in ops:
        per[name][0] += 1
        per[name][1] += (e - s) * 1e-6
    res["ops"] = dict(per)
    return res


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python -m toycluster_tpu_torch.trace <parameterfile> "
              "[field=value...] [engine=stream|classed]", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        raise RuntimeError("the trace needs a CUDA device")
    overrides = dict(tok.partition("=")[::2] for tok in argv[1:])
    engine = overrides.pop("engine", "stream")
    cfg = parse_par_file(argv[0], **{k: _coerce(v)
                                     for k, v in overrides.items()})
    make_ics(cfg, device="cuda", engine=engine, write=False,
             log=tlog.silent_log)

    r = trace_make_ics(cfg, engine)
    print(f"traced run: wall {r['wall']:.6f} s, device busy "
          f"{r['busy']:.6f} s, idle share {r['idle']:.6f}")
    if r["wvt_wall"] is not None:
        print(f"wvt loop span: wall {r['wvt_wall']:.6f} s, device busy "
              f"{r['wvt_busy']:.6f} s, idle share {r['wvt_idle']:.6f}")
    print(f"{'device op':<60} {'calls':>6} {'ms':>12} {'share':>8}")
    for name, (n, ms) in sorted(r["ops"].items(),
                                key=lambda kv: -kv[1][1])[:15]:
        print(f"{name[:60]:<60} {n:>6} {ms:>12.3f} "
              f"{ms * 1e-3 / r['busy']:>8.4f}")
    if r["spans"]:
        print(f"{'span':<16} {'count':>6} {'wall s':>10} {'busy s':>10} "
              f"{'idle s':>10} {'own idle s':>10}")
        for name, (n, wall, busy, idle, own) in r["spans"].items():
            print(f"{name:<16} {n:>6} {wall:>10.6f} {busy:>10.6f} "
                  f"{idle:>10.6f} {own:>10.6f}")
    prev = None
    iters = []
    for rec in r["records"]:
        if rec["stage"] == "wvt":
            iters.append(round(rec["t"] - prev, 3))
        if rec["stage"] == "wvt_retry":
            print(f"wvt retry at it={rec['it']}: {rec['n_sat']} saturated "
                  f"lanes, rebuild={rec['rebuild']}")
        if rec["stage"] == "wvt_done":
            print(f"wvt iterations queued ahead {rec['speculated']}, "
                  f"adopted {rec['adopted']}, dropped {rec['dropped']}; "
                  f"pairs walked {rec['pairs_walked']}")
        prev = rec["t"]
    print(f"wvt iteration wall s: {iters}")
    print(f"peak device memory {r['peak'] / 2**30:.4f} GiB; launches "
          + " ".join(f"{k}={n}" for k, n in r["launches"].items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
