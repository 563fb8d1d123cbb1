#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Checks that CUDA is available and prints the card's name and power
   limit.
2. Builds both hand-written kernels (toycluster_tpu_torch/csrc/*.cu) with
   nvcc for sm_90a and prints the build times and nvcc's register report.
3. Holds each kernel against its plain PyTorch version on the card on a
   1e5-gas synthetic cusp (toycluster_tpu_torch/ops/cusp.py; stream_wvt:
   wc6 and m4, with and without the displacement; stream_curl: wc6 and
   m4), with the tolerances of the CPU tests.
4. Drives the CLI main path, ``toycluster_tpu_torch.cli.main``, on the
   repository's cluster.par (Ntotal 1e6, WC6, B field on) with
   device=cuda, with every launch counter set to 0 just before; then
   checks that every kernel was launched, the neighbour contract
   fraction >= 0.999, that err_mean fell, and reads the snapshot back
   (1e6 particles, finite, rho/u/bfld nonzero on the gas).  Prints the
   per-stage wall times and the WVT particle updates per second.
5. Holds each kernel against its plain version again on the inputs of
   its first main-path call, and times both there with CUDA events.

Prints the kernel record and the card line before the last line, and as
the last line {"ok": true, "device": {...}}.  Any failure exits nonzero
without that line.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "toycluster_tpu_torch"
# (name, source, the TPU kernel it replaces)
KERNELS = (
    ("stream_wvt", f"{PKG}/csrc/stream_wvt.cu",
     "toycluster_tpu/ops/pallas_pair.py:1261"),
    ("stream_curl", f"{PKG}/csrc/stream_curl.cu",
     "toycluster_tpu/ops/pallas_pair.py:1953"),
)


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


# ------------------------------------------------------------ comparisons

def compare_wvt(torch, got, ref, valid, desnngb, do_disp):
    """The CPU tests' tolerances: h/rho rtol 2e-3 on >= 98% of done
    lanes, |wkNgb - DESNNGB| < 0.05 + 1e-3 on done lanes (or no more
    than the plain version's own deviation: a speculatively accepted
    lane is extrapolated, not re-measured), delta rtol 2e-4 / atol 1e-6
    max|delta|.  Returns max |wkNgb_kernel - wkNgb_plain| over the lanes
    done in both."""
    g_rho, g_h, _, g_wk, g_done, g_d = got
    r_rho, r_h, _, r_wk, r_done, r_d = ref
    v = valid.reshape(g_h.shape)
    both = v & g_done & r_done
    if int(both.sum()) < 0.97 * int((v & r_done).sum()):
        fail(f"stream_wvt: kernel done on {int((v & g_done).sum())} lanes,"
             f" plain on {int((v & r_done).sum())}")
    ok = (torch.isclose(g_h[both], r_h[both], rtol=2e-3, atol=0)
          & torch.isclose(g_rho[both], r_rho[both], rtol=2e-3, atol=0))
    if float(ok.float().mean()) <= 0.98:
        fail(f"stream_wvt: h/rho differ on {int((~ok).sum())} lanes")
    dev = float((g_wk[both] - desnngb).abs().max())
    dev_plain = float((r_wk[both] - desnngb).abs().max())
    say(f"  done lanes {int(both.sum())}/{int(v.sum())}; max |wkNgb - "
        f"DESNNGB| kernel {dev:.4g}, plain {dev_plain:.4g}")
    if dev >= max(0.05, dev_plain) + 1e-3:
        fail(f"stream_wvt: |wkNgb - DESNNGB| = {dev} on a done lane "
             f"(plain version: {dev_plain})")
    if do_disp:
        a, b = r_d[v], g_d[v]
        scale = float(a.abs().max())
        bad = (b - a).abs() > 1e-6 * scale + 2e-4 * a.abs()
        if bool(bad.any()):
            fail(f"stream_wvt: delta differs on {int(bad.sum())} values, "
                 f"max abs {float((b - a).abs().max())} (scale {scale})")
    return float((g_wk[both] - r_wk[both]).abs().max())


def compare_curl(torch, got, ref, valid):
    """rtol 5e-4, atol 2e-5 max|B| (the CPU test's tolerance).  Returns
    max |B_kernel - B_plain| / max|B_plain|."""
    v = valid.reshape(got.shape[:2])
    a, b = ref[v], got[v]
    scale = float(a.abs().max())
    if scale == 0:
        fail("stream_curl: the plain curl is zero")
    bad = (b - a).abs() > 2e-5 * scale + 5e-4 * a.abs()
    if bool(bad.any()):
        fail(f"stream_curl: {int(bad.sum())} values out of tolerance, max "
             f"abs {float((b - a).abs().max())} (scale {scale})")
    return float((b - a).abs().max()) / scale


def event_ms(torch, fn, reps):
    """Mean time of fn() on the card over reps runs, by CUDA events."""
    start, stop = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def check_kernels_on_cusp(torch, sp, device):
    from toycluster_tpu_torch.ops import cusp
    n = 100_000
    for kernel in ("wc6", "m4"):
        for do_disp in (True, False):
            args, kw, valid = cusp.wvt_inputs(kernel, do_disp, n,
                                              device=device)
            got = sp.stream_wvt(*args, **kw)
            torch.cuda.synchronize()
            ref = sp._stream_wvt_reference(*args, n_sweeps=sp.N_SWEEPS, **kw)
            err = compare_wvt(torch, got, ref, valid, kw["desnngb"], do_disp)
            k_ms = event_ms(torch, lambda: sp.stream_wvt(*args, **kw), 5)
            p_ms = event_ms(torch, lambda: sp._stream_wvt_reference(
                *args, n_sweeps=sp.N_SWEEPS, **kw), 1)
            say(f"cusp 1e5 stream_wvt kernel={kernel} do_disp={do_disp}: "
                f"rows={args[0].shape[0]} width={args[1].shape[1]} "
                f"max|dwk|={err:.3g} kernel_ms={k_ms:.3f} "
                f"plain_ms={p_ms:.3f}")
        args, kw, valid = cusp.curl_inputs(kernel, n, device=device)
        got = sp.stream_curl(*args, **kw)
        torch.cuda.synchronize()
        ref = sp._stream_curl_reference(*args, **kw)
        err = compare_curl(torch, got, ref, valid)
        k_ms = event_ms(torch, lambda: sp.stream_curl(*args, **kw), 5)
        p_ms = event_ms(torch, lambda: sp._stream_curl_reference(*args, **kw),
                        1)
        say(f"cusp 1e5 stream_curl kernel={kernel}: max|dB|/max|B|="
            f"{err:.3g} kernel_ms={k_ms:.3f} plain_ms={p_ms:.3f}")


# --------------------------------------------------------------- main path

def run_main_path(torch, sp, tmp):
    """The CLI main path on cuda, with the first stream_wvt and
    stream_curl call's inputs recorded for step 5."""
    from toycluster_tpu_torch import cli
    from toycluster_tpu_torch.models import bfield, sph, wvt
    from toycluster_tpu_torch.utils import logging as tlog

    recorded = {}

    def recorder(name, fn):
        def call(*args, **kw):
            out = fn(*args, **kw)
            if name not in recorded and kw.get("do_disp", True):
                recorded[name] = (args, kw)
            return out
        return call

    wvt.stream_wvt = recorder("stream_wvt", sp.stream_wvt)
    bfield.stream_curl = recorder("stream_curl", sp.stream_curl)
    par = ROOT / PKG / "data" / "cluster.par"
    out = Path(tmp) / "IC"
    tlog.METRICS.clear()
    sp.stream_wvt.launches = 0
    sp.stream_curl.launches = 0
    t0 = time.perf_counter()
    rc = cli.main([str(par), f"output_file={out}", "device=cuda"])
    wall = time.perf_counter() - t0
    launches = {"stream_wvt": sp.stream_wvt.launches,
                "stream_curl": sp.stream_curl.launches}
    wvt.stream_wvt = sp.stream_wvt
    bfield.stream_curl = sp.stream_curl
    if rc != 0:
        fail(f"cli.main returned {rc}")
    for name, n in launches.items():
        if n <= 0:
            fail(f"the main path launched {name} no time")
    say(f"main path: wall {wall:.3f} s, launches {launches}")

    prev = 0.0
    for rec in tlog.METRICS:
        if rec["stage"].startswith("wvt") and rec["stage"] != "wvt_done":
            continue
        say(f"stage {rec['stage']:<16} ends at {rec['t']:9.3f} s "
            f"(+{rec['t'] - prev:.3f} s)")
        prev = rec["t"]
    errs = [r["err_mean"] for r in tlog.METRICS if r["stage"] == "wvt"]
    done = [r for r in tlog.METRICS if r["stage"] == "wvt_done"]
    say(f"wvt err_mean trajectory ({len(errs)} iterations): {errs}")
    if len(errs) < 2 or not errs[-1] < 0.6 * errs[0]:
        fail(f"err_mean did not fall: {errs}")
    say(f"wvt: {done[0]['iterations']} iterations in "
        f"{done[0]['seconds']:.3f} s = "
        f"{done[0]['particle_updates_per_s']:.6g} particle updates/s")
    frac = sph.last_contract_frac
    say(f"neighbour contract fraction {frac}")
    if not frac >= 0.999:
        fail(f"contract fraction {frac} < 0.999")

    from toycluster_tpu_torch.io.gadget import read_snapshot
    import numpy as np
    snap = read_snapshot(str(out))
    n_gas = snap["header"].npart[0]
    if snap["pos"].shape[0] != 1_000_000:
        fail(f"snapshot holds {snap['pos'].shape[0]} particles")
    for k in ("pos", "vel", "ids", "u", "rho", "hsml", "bfld", "rho_model"):
        if not np.isfinite(snap[k]).all():
            fail(f"snapshot block {k} is not finite")
    for k in ("rho", "u", "hsml"):
        if not (snap[k][:n_gas] > 0).all():
            fail(f"snapshot block {k} has non-positive gas values")
    if not (np.abs(snap["bfld"]).sum(axis=1) > 0).mean() > 0.99:
        fail("bfld is zero on more than 1% of the gas")
    say(f"snapshot: {snap['pos'].shape[0]} particles, {n_gas} gas, finite")
    return launches, recorded


def time_on_main_path_inputs(torch, sp, recorded):
    """Kernel vs plain on the inputs of each kernel's first main-path
    call: agreement and CUDA-event times.  These launches come after the
    counted run."""
    res = {}
    args, kw = recorded["stream_wvt"]
    got = sp.stream_wvt(*args, **kw)
    torch.cuda.synchronize()
    ref = sp._stream_wvt_reference(*args, n_sweeps=sp.N_SWEEPS, **kw)
    nb = args[0].shape[0]
    valid = args[0][:, 3, :] > 0
    err = compare_wvt(torch, got, ref, valid.reshape(nb, 128),
                      kw["desnngb"], kw.get("do_disp", True))
    k_ms = event_ms(torch, lambda: sp.stream_wvt(*args, **kw), 5)
    p_ms = event_ms(torch, lambda: sp._stream_wvt_reference(
        *args, n_sweeps=sp.N_SWEEPS, **kw), 1)
    say(f"main-path stream_wvt: rows={nb} width={args[1].shape[1]} "
        f"max|dwk|={err:.6g} kernel_ms={k_ms:.6g} plain_ms={p_ms:.6g}")
    res["stream_wvt"] = (err, k_ms, p_ms)

    args, kw = recorded["stream_curl"]
    got = sp.stream_curl(*args, **kw)
    torch.cuda.synchronize()
    ref = sp._stream_curl_reference(*args, **kw)
    valid = args[0][:, 3, :] > 0
    err = compare_curl(torch, got, ref, valid)
    k_ms = event_ms(torch, lambda: sp.stream_curl(*args, **kw), 5)
    p_ms = event_ms(torch, lambda: sp._stream_curl_reference(*args, **kw), 1)
    say(f"main-path stream_curl: rows={args[0].shape[0]} "
        f"width={args[1].shape[1]} max|dB|/max|B|={err:.6g} "
        f"kernel_ms={k_ms:.6g} plain_ms={p_ms:.6g}")
    res["stream_curl"] = (err, k_ms, p_ms)
    return res


def main():
    import torch
    if not torch.cuda.is_available():
        fail("CUDA is not available")
    if not (ROOT / PKG / "csrc").is_dir():
        fail(f"{PKG} is not beside this script")
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    say(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"device {torch.cuda.get_device_name(0)}")

    from toycluster_tpu_torch.ops import cuda_build
    from toycluster_tpu_torch.ops import stream_pair as sp
    for name, _, _ in KERNELS:
        t0 = time.perf_counter()
        cuda_build.load(name)
        say(f"build {name}: {time.perf_counter() - t0:.3f} s")
        for line in cuda_build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                say(f"  nvcc: {line.strip()}")

    check_kernels_on_cusp(torch, sp, torch.device("cuda"))

    with tempfile.TemporaryDirectory() as tmp:
        launches, recorded = run_main_path(torch, sp, tmp)
    res = time_on_main_path_inputs(torch, sp, recorded)
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": launches[name], "max_abs_err": res[name][0],
         "ms": res[name][1], "plain_ms": res[name][2]}
        for name, src, rep in KERNELS]}
    for k in record["kernels"]:
        for key in ("max_abs_err", "ms", "plain_ms"):
            if not math.isfinite(k[key]):
                fail(f"{k['name']} {key} is not finite")
    say(card)
    say(json.dumps(record))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
