"""Device trace of the main path on one CUDA card::

    python -m toycluster_tpu_torch.trace <parfile> [field=value ...]
        [engine=stream|classed]

Runs ``make_ics`` on ``cuda`` twice in one process, writing no snapshot:
once to build the kernels and warm the allocator, then under
``torch.profiler`` with CUDA activity (``trace_make_ics``).  Prints, for
the traced run:

* its host wall time and the device's busy time, the union of the
  intervals of every device op (kernels, copies, memsets), and the idle
  share 1 - busy / wall;
* the same over the WVT loop's span alone (the host range that
  ``make_ics`` marks with ``record_function(WVT_SPAN)``);
* the device time and call count of each device op name, largest first;
* the wall time of each WVT iteration (from the stage log), the
  saturated lanes of each retry, the iterations the loop queued ahead,
  adopted and dropped, and its iteration programs made and replayed
  (the kernels of a replayed CUDA graph are device ops of their own in
  the trace, so they count in the busy time);
* the peak device memory and the launch counts of the pair kernels.

Fails when the profiler recorded no device op.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch

from .cli import _coerce
from .config import parse_par_file
from .ops import class_pair, stream_pair
from .pipeline import make_ics
from .utils import logging as tlog
from .utils.profiling import profiler

# the record_function name of the WVT loop's span in make_ics
WVT_SPAN = "wvt_loop"
KERNELS = (stream_pair.stream_wvt, stream_pair.stream_curl,
           class_pair.solve_density, class_pair.wvt_displacement,
           class_pair.fused_wvt)


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


def trace_make_ics(cfg, engine="stream"):
    """One ``make_ics`` run of ``cfg`` on cuda (no snapshot, the stage
    log's records in ``tlog.METRICS``, the launch counters from 0) under
    the profiler.  Returns a dict: ``wall``, ``busy`` (s) and ``idle``
    (share) of the run; ``wvt_wall``, ``wvt_busy``, ``wvt_idle`` of the
    WVT loop's span; ``ops`` {device op name: [calls, ms]}; ``peak``
    (bytes); ``launches`` {kernel: count}."""
    tlog.METRICS.clear()
    for k in KERNELS:
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with profiler(torch.device("cuda")) as prof:
        t0 = time.perf_counter()
        make_ics(cfg, device="cuda", engine=engine, write=False,
                 log=tlog.stage_log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ops, spans = device_ops(prof)
    if not ops:
        raise RuntimeError("the profiler recorded no device op")
    intervals = [(s, e) for _, s, e in ops]
    res = dict(wall=wall, busy=busy_s(intervals),
               peak=torch.cuda.max_memory_allocated(),
               launches={k.__name__: k.launches for k in KERNELS},
               wvt_wall=None, wvt_busy=None, wvt_idle=None)
    res["idle"] = 1.0 - res["busy"] / wall
    if spans:
        lo, hi = spans[0]
        res["wvt_wall"] = (hi - lo) * 1e-9
        res["wvt_busy"] = busy_s(intervals, lo, hi)
        res["wvt_idle"] = 1.0 - res["wvt_busy"] / res["wvt_wall"]
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
    prev = None
    iters = []
    for rec in tlog.METRICS:
        if rec["stage"] == "wvt":
            iters.append(round(rec["t"] - prev, 3))
        if rec["stage"] == "wvt_retry":
            print(f"wvt retry at it={rec['it']}: {rec['n_sat']} saturated "
                  f"lanes, rebuild={rec['rebuild']}")
        if rec["stage"] == "wvt_done":
            print(f"wvt iterations queued ahead {rec['speculated']}, "
                  f"adopted {rec['adopted']}, dropped {rec['dropped']}; "
                  f"iteration programs made {rec['captured']}, replayed "
                  f"{rec['replayed']}, eager iterations {rec['eager']}")
        prev = rec["t"]
    print(f"wvt iteration wall s: {iters}")
    print(f"peak device memory {r['peak'] / 2**30:.4f} GiB; launches "
          + " ".join(f"{k}={n}" for k, n in r["launches"].items()))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
