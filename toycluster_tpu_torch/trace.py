"""Device trace of the main path on one CUDA card::

    python -m toycluster_tpu_torch.trace <parfile> [field=value ...]

Runs ``make_ics`` on ``cuda`` twice in one process, writing no snapshot:
once to build the kernels and warm the allocator, then under
``torch.profiler`` with CUDA activity.  Prints, for the traced run:

* its host wall time and the device's busy time, the union of the
  intervals of every device op (kernels, copies, memsets), and the idle
  share 1 - busy / wall;
* the device time and call count of each device op name, largest first;
* the wall time of each WVT iteration (from the stage log) and the
  saturated lanes of each retry;
* the peak device memory and the launch counts of the stream kernels.

Fails when the profiler recorded no device op.
"""

from __future__ import annotations

import sys
import time
from collections import defaultdict

import torch

from .cli import _coerce
from .config import parse_par_file
from .ops import stream_pair
from .pipeline import make_ics
from .utils import logging as tlog


def _busy_us(intervals):
    """Length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if e <= end:
            continue
        busy += e - max(s, end)
        end = e
    return busy


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python -m toycluster_tpu_torch.trace <parameterfile> "
              "[field=value...]", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        raise RuntimeError("the trace needs a CUDA device")
    overrides = dict(tok.partition("=")[::2] for tok in argv[1:])
    cfg = parse_par_file(argv[0], **{k: _coerce(v)
                                     for k, v in overrides.items()})
    log = tlog.silent_log
    make_ics(cfg, device="cuda", write=False, log=log)

    tlog.METRICS.clear()
    stream_pair.stream_wvt.launches = stream_pair.stream_curl.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        make_ics(cfg, device="cuda", write=False, log=tlog.stage_log)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("the profiler recorded no device op")
    busy = _busy_us([(e.time_range.start, e.time_range.end)
                     for e in dev]) * 1e-6
    per = defaultdict(lambda: [0, 0.0])
    for e in dev:
        per[e.name][0] += 1
        per[e.name][1] += (e.time_range.end - e.time_range.start) * 1e-3
    print(f"traced run: wall {wall:.6f} s, device busy {busy:.6f} s, "
          f"idle share {1.0 - busy / wall:.6f}")
    print(f"{'device op':<60} {'calls':>6} {'ms':>12} {'share':>8}")
    for name, (n, ms) in sorted(per.items(), key=lambda kv: -kv[1][1])[:15]:
        print(f"{name[:60]:<60} {n:>6} {ms:>12.3f} "
              f"{ms * 1e-3 / busy:>8.4f}")
    prev = None
    iters = []
    for rec in tlog.METRICS:
        if rec["stage"] == "wvt":
            iters.append(round(rec["t"] - prev, 3))
        if rec["stage"] == "wvt_retry":
            print(f"wvt retry at it={rec['it']}: {rec['n_sat']} saturated "
                  f"lanes, rebuild={rec['rebuild']}")
        prev = rec["t"]
    print(f"wvt iteration wall s: {iters}")
    print(f"peak device memory {peak / 2**30:.4f} GiB; launches "
          f"stream_wvt={stream_pair.stream_wvt.launches} "
          f"stream_curl={stream_pair.stream_curl.launches}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
