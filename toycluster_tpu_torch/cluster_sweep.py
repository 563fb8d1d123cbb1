"""Time the count-class two-pass kernels at every cluster size::

    python -m toycluster_tpu_torch.cluster_sweep <parfile> [field=value ...]

Runs ``make_ics`` on ``cuda`` with ``engine=classed`` and, at every
``solve_density`` and ``wvt_displacement`` call of the WVT loop, times the
same call with its rows on 1, 2, 4 and 8 CTAs (CUDA events, 2 launches
each).  Prints one JSON line per call (rows, list width, list mode, the
size ``class_pair._cluster_size`` chooses, ms per size) and, per kernel,
the sums over all calls at each fixed size, under the rule, and at the
best size of each call: the measurement the rule's constants rest on.
"""

from __future__ import annotations

import json
import subprocess
import sys

import torch

from .cli import _coerce
from .config import parse_par_file
from .models import wvt
from .ops import class_pair as cp
from .pipeline import make_ics
from .utils import logging as tlog

SIZES = (1, 2, 4, 8)


def _event_ms(fn, reps=2):
    start, stop = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def _timed(fn, cand_arg, rows):
    def call(*args, **kw):
        S, M = args[cand_arg].shape
        sb = bool(kw.get("sb_mode"))
        fn(*args, **kw)                      # warm
        ms = {c: _event_ms(lambda: fn(*args, **kw, cluster=c))
              for c in SIZES}
        rows.append(dict(kernel=fn.__name__, rows=S, width=M, sb_mode=sb,
                         rule=cp._cluster_size(S, M * (8 if sb else 1), None),
                         ms=ms))
        return fn(*args, **kw)
    return call


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print("Usage: python -m toycluster_tpu_torch.cluster_sweep "
              "<parameterfile> [field=value...]", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        raise RuntimeError("the sweep needs a CUDA device")
    cfg = parse_par_file(argv[0], **{
        k: _coerce(v) for k, v in (t.partition("=")[::2] for t in argv[1:])})
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip())
    rows = []
    saved = wvt.solve_density, wvt.wvt_displacement
    wvt.solve_density = _timed(cp.solve_density, 2, rows)
    wvt.wvt_displacement = _timed(cp.wvt_displacement, 3, rows)
    try:
        make_ics(cfg, device="cuda", engine="classed", write=False,
                 log=tlog.silent_log)
    finally:
        wvt.solve_density, wvt.wvt_displacement = saved
    for r in rows:
        print(json.dumps(r))
    for name in ("solve_density", "wvt_displacement"):
        mine = [r for r in rows if r["kernel"] == name]
        sums = {c: sum(r["ms"][c] for r in mine) for c in SIZES}
        print(f"{name}: {len(mine)} calls; sum ms at "
              + ", ".join(f"{c} CTAs a row {sums[c]:.3f}" for c in SIZES)
              + f"; under the rule {sum(r['ms'][r['rule']] for r in mine):.3f}"
              f"; at each call's best size "
              f"{sum(min(r['ms'].values()) for r in mine):.3f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
