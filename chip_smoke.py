#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

1. Checks that CUDA is available and prints the card's name and power
   limit.
2. Builds the five hand-written kernels (toycluster_tpu_torch/csrc/*.cu)
   with nvcc for sm_90a, one nvcc process each, all started together,
   and prints the build time and nvcc's register report.
3. Holds each kernel against its plain PyTorch version on the card on a
   1e5-gas synthetic cusp (toycluster_tpu_torch/ops/cusp.py), with the
   tolerances of the CPU tests: stream_wvt (wc6 and m4, with and without
   the displacement), stream_curl (wc6 and m4, superblock and block
   lists), solve_density, wvt_displacement and fused_wvt (wc6 and m4,
   block and superblock lists; fused_wvt with and without its distance
   bounds, which must give bit-identical results).  For stream_wvt it
   also checks that its member pruning and its hoisted wrap change no
   bit (the kernel against itself with prune=False, hoist=False), prints
   the listed, kept and swept members and the sweeps per row (median,
   p99, max, from the kernel's stats) and times the kernel as it runs,
   without the hoisted wrap, and without pruning and hoisting.
4. Drives the CLI main path, ``toycluster_tpu_torch.cli.main``, on the
   repository's cluster.par (Ntotal 1e6, WC6, B field on) with
   device=cuda twice, with every launch counter set to 0 just before
   each run: once on the stream engine (the default) and once with
   engine=classed.  After each run it checks that the engine's kernels
   were launched (stream: stream_wvt and stream_curl; classed:
   solve_density, wvt_displacement, fused_wvt and block-list
   stream_curl, and no stream_wvt), that the neighbour contract fraction
   is >= 0.999 and err_mean fell, and reads the snapshot back (1e6
   particles, finite, rho/u/bfld nonzero on the gas).  Prints the
   per-stage wall times and the WVT particle updates per second of each
   run.
5. Holds each kernel against its plain version again on the inputs of
   its first main-path call (for stream_wvt with the checks of step 3),
   times both there with CUDA events, and computes each kernel's bound:
   the larger of its fp32 operations over the card's fp32 peak and its
   bytes (inputs read once, outputs written once) over the HBM peak,
   with the operations counted from this run's data (the members the
   chunk test keeps for the stream kernels, the listed blocks for the
   count-class kernels, the sweeps the kernel or the plain version took,
   and the periodic wrap only on the rows whose reach leaves the box).

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
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PKG = "toycluster_tpu_torch"
PALLAS = "toycluster_tpu/ops/pallas_pair.py"
# (record name, kernel library, TPU kernel it replaces)
KERNELS = (
    ("stream_wvt", "stream_wvt", f"{PALLAS}:1261"),
    ("stream_curl", "stream_curl", f"{PALLAS}:1953"),
    ("stream_curl_blocks", "stream_curl", f"{PALLAS}:1953"),
    ("solve_density", "solve_density", f"{PALLAS}:104"),
    ("wvt_displacement", "wvt_displacement", f"{PALLAS}:637"),
    ("fused_wvt", "fused_wvt", f"{PALLAS}:230"),
)
LIBS = ("stream_wvt", "stream_curl", "solve_density", "wvt_displacement",
        "fused_wvt")
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): fp32 outside the tensor cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_HBM = 3.35e12
PAIRS = 128 * 128       # pairs of one receiver block and one source block
# fp32 operations of one evaluated pair on the path of a pair out of
# range, counted from the kernels' sources (an FMA counts 2): the
# separation (3 subtractions; r2, a mul and 2 FMAs), the per-pair wrap
# (per axis a mul, a rint and an FMA), and per kernel what precedes its
# range test.  The few percent of pairs within range cost more and are
# not counted: the bound is a lower bound.
OPS_DIST, OPS_WRAP = 8, 12
OPS_DENS = {"wc6": 1, "m4": 2}  # r2 / h^2; M4: sqrt and r / h
OPS_UNION = 7                   # rsqrt, max, r, r / h, hbar (2), hbar^2
OPS_DISP = 6                    # to box units (3), hbar (2), hbar^2


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


# ------------------------------------------------------------ comparisons

def unpack(out, do_disp):
    """A plain count-class output (S, 128, 5 or 8) as (rho, h, vf, wk,
    done, delta)."""
    return (out[..., 0], out[..., 1], out[..., 2], out[..., 3],
            out[..., 4] > 0.5, out[..., 5:8] if do_disp else None)


def compare_wvt(torch, got, ref, valid, desnngb, do_disp, name="stream_wvt"):
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
        fail(f"{name}: kernel done on {int((v & g_done).sum())} lanes,"
             f" plain on {int((v & r_done).sum())}")
    ok = (torch.isclose(g_h[both], r_h[both], rtol=2e-3, atol=0)
          & torch.isclose(g_rho[both], r_rho[both], rtol=2e-3, atol=0))
    if float(ok.float().mean()) <= 0.98:
        fail(f"{name}: h/rho differ on {int((~ok).sum())} lanes")
    dev = float((g_wk[both] - desnngb).abs().max())
    dev_plain = float((r_wk[both] - desnngb).abs().max())
    say(f"  done lanes {int(both.sum())}/{int(v.sum())}; max |wkNgb - "
        f"DESNNGB| kernel {dev:.4g}, plain {dev_plain:.4g}")
    if dev >= max(0.05, dev_plain) + 1e-3:
        fail(f"{name}: |wkNgb - DESNNGB| = {dev} on a done lane "
             f"(plain version: {dev_plain})")
    if do_disp:
        compare_disp(torch, g_d, r_d, v, name)
    return float((g_wk[both] - r_wk[both]).abs().max())


def compare_disp(torch, got, ref, valid, name):
    """rtol 2e-4, atol 1e-6 max|delta|.  Returns max |delta_kernel -
    delta_plain|."""
    a, b = ref[valid], got[valid]
    scale = float(a.abs().max())
    bad = (b - a).abs() > 1e-6 * scale + 2e-4 * a.abs()
    if bool(bad.any()):
        fail(f"{name}: delta differs on {int(bad.sum())} values, "
             f"max abs {float((b - a).abs().max())} (scale {scale})")
    return float((b - a).abs().max())


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


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors
               if hasattr(t, "element_size"))


def bound(ops, n_bytes):
    """(bound_ms, bound_by): the larger of ops / fp32 peak and bytes /
    HBM peak."""
    t_ops, t_bytes = ops / PEAK_FP32, n_bytes / PEAK_HBM
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                        else "bytes")


def quantiles(torch, x):
    """median, p99 and max of a per-row count."""
    x = x.double()
    return (float(torch.quantile(x, 0.5)), float(torch.quantile(x, 0.99)),
            float(x.max()))


def dist_ops(sp, xi, r_pair, box):
    """(S,) fp32 operations of one pair's separation per receiver row of
    positions xi (S, 3, 128) and largest pair range r_pair (S,): the wrap
    counts only where the row's reach leaves the box (sp.interior_rows;
    elsewhere no pair in range needs it)."""
    return OPS_DIST + OPS_WRAP * (~sp.interior_rows(xi, r_pair, box)).double()


def wvt_bound(torch, sp, args, kw, st):
    """stream_wvt's bound from its stats: the union pass over the members
    kept for either consumer, the later sweeps over the members kept for
    the density, without the wrap on the rows that skip it."""
    src, cand, cnt, xi, h0, cap, hm_i, _, box = args
    do_disp = kw.get("do_disp", True)
    _, _, flag = sp.prune_tables(src, xi, cap, hm_i, box, do_disp=do_disp)
    dist = OPS_DIST + OPS_WRAP * (1 - flag.double())
    dens = OPS_DENS[kw.get("kernel", "wc6")]
    sweeps, n_u, n_d = (st[:, k].double() for k in range(3))
    ops = PAIRS * float((n_u * (dist + (OPS_UNION if do_disp else dens))
                         + n_d * (sweeps - 1) * (dist + dens)).sum())
    return bound(ops, nbytes(src, cand, cnt, xi, h0, cap, hm_i)
                 + cand.shape[0] * 128 * 8 * 4) + (ops,)


def listed_blocks(torch, sp, cand, cnt, nb, sb_mode):
    """Per row, the valid source blocks of the first min(cnt, M) list
    entries (all entries without cnt)."""
    if cnt is not None:
        slot = torch.arange(cand.shape[1], device=cand.device)
        cand = torch.where(slot[None] < cnt[:, None], cand,
                           torch.full_like(cand, -1))
    return sp.list_entries(cand, nb, sb_mode)[1]


# -------------------------------------------------- kernel vs plain checks

def check_wvt(torch, sp, args, kw, valid, tag):
    """stream_wvt against its plain version; pruned against unpruned and
    hoisted against wrapped, bit for bit; the per-row statistics; kernel
    times with and without pruning and hoisting, and the plain time."""
    S = args[1].shape[0]
    st = torch.zeros((S, 4), dtype=torch.int32, device=args[0].device)
    got = sp.stream_wvt(*args, **kw, stats=st)
    full = sp.stream_wvt(*args, **kw, prune=False, hoist=False)
    torch.cuda.synchronize()
    for a, b in zip(got, full):
        if not (a is None and b is None or torch.equal(a, b)):
            fail(f"{tag} stream_wvt: pruning or the hoisted wrap changed "
                 f"the result")
    ref = sp._stream_wvt_reference(*args, n_sweeps=sp.N_SWEEPS, **kw)
    err = compare_wvt(torch, got, ref, valid, kw["desnngb"],
                      kw.get("do_disp", True))
    n_u, n_d, listed = st[:, 1], st[:, 2], st[:, 3]
    if not int(n_u.sum()) < int(listed.sum()):
        fail(f"{tag} stream_wvt: the member test kept every listed member")
    swept = n_u + n_d * (st[:, 0] - 1)
    _, _, flag = sp.prune_tables(args[0], args[3], args[5], args[6],
                                 args[8], do_disp=kw.get("do_disp", True))
    say(f"{tag} stream_wvt members per row (median, p99, max): listed "
        f"{quantiles(torch, listed)}, kept {quantiles(torch, n_u)}, kept "
        f"for the density {quantiles(torch, n_d)}, swept "
        f"{quantiles(torch, swept)}; sweeps {quantiles(torch, st[:, 0])}; "
        f"kept/listed {int(n_u.sum()) / int(listed.sum()):.4f}; rows "
        f"without the wrap {int(flag.sum())}/{S}; pruned and unpruned "
        f"bit-identical")
    res = dict(err=err, stats=st)
    res["ms"] = event_ms(torch, lambda: sp.stream_wvt(*args, **kw), 5)
    res["ms_unpruned"] = event_ms(torch, lambda: sp.stream_wvt(
        *args, **kw, prune=False, hoist=False), 3)
    res["ms_unhoisted"] = event_ms(torch, lambda: sp.stream_wvt(
        *args, **kw, hoist=False), 5)
    res["plain_ms"] = event_ms(torch, lambda: sp._stream_wvt_reference(
        *args, n_sweeps=sp.N_SWEEPS, **kw), 1)
    res["bound_ms"], res["bound_by"], ops = wvt_bound(torch, sp, args, kw,
                                                      st)
    say(f"{tag} stream_wvt: kernel_ms={res['ms']:.6g} unhoisted_ms={res['ms_unhoisted']:.6g} unpruned_unhoisted_ms="
        f"{res['ms_unpruned']:.6g} plain_ms={res['plain_ms']:.6g} "
        f"bound_ms={res['bound_ms']:.6g} ({res['bound_by']}, "
        f"{ops:.6g} fp32 operations)")
    return res


def check_curl(torch, sp, args, kw, valid):
    """stream_curl against its plain version; its bound counts the pairs
    of the member blocks that stream_wvt's chunk test keeps at the curl's
    range (r < hsml_i), as the TPU curl prunes them."""
    got = sp.stream_curl(*args, **kw)
    torch.cuda.synchronize()
    ref = sp._stream_curl_reference(*args, **kw)
    src, cand, cnt, xi, hsml = args[:5]
    box = args[8]
    rtab = sp._recv_tab(sp.build_chunk_tab(xi, hsml, box), hsml, None)
    kept, _, listed = sp._keep_rows(
        rtab, sp.build_chunk_tab(src[:, :3], src[:, 3], box), cand, cnt, box,
        False, sb_mode=kw.get("sb_mode", False))
    kept = kept.sum(dim=1)
    ops = PAIRS * float((kept * dist_ops(sp, xi, hsml.amax(dim=1),
                                         box)).sum())
    say(f"  stream_curl sb_mode={kw.get('sb_mode', False)}: the chunk test "
        f"keeps {int(kept.sum())} of {int(listed.sum())} listed blocks")
    b_ms, b_by = bound(ops, nbytes(*args) + cand.shape[0] * 128 * 3 * 4)
    return dict(err=compare_curl(torch, got, ref, valid),
                ms=event_ms(torch, lambda: sp.stream_curl(*args, **kw), 5),
                plain_ms=event_ms(torch, lambda: sp._stream_curl_reference(
                    *args, **kw), 1), bound_ms=b_ms, bound_by=b_by)


def check_solve(torch, sp, cp, args, kw, valid):
    kw = dict(kw)
    n_sweeps = kw.pop("n_sweeps", cp.SOLVE_SWEEPS)
    got = cp.solve_density(*args, n_sweeps=n_sweeps, **kw)
    torch.cuda.synchronize()
    pos, _, cand = args[:3]
    sweeps = torch.zeros(cand.shape[0], dtype=torch.int32,
                         device=cand.device)
    ref = cp._solve_density_reference(*args, n_sweeps=n_sweeps, **kw,
                                      sweeps=sweeps)
    err = compare_wvt(torch, got, unpack(ref, False), valid, kw["desnngb"],
                      False, "solve_density")
    xi, cap, box = args[3], args[5], args[7]
    blocks = listed_blocks(torch, sp, cand, None, pos.shape[0],
                           kw.get("sb_mode", False)).sum(dim=1)
    ops = PAIRS * float((blocks * sweeps * (dist_ops(
        sp, xi, cap.amax(dim=1), box) + OPS_DENS[kw["kernel"]])).sum())
    b_ms, b_by = bound(ops, nbytes(*args) + cand.shape[0] * 128 * 5 * 4)
    return dict(err=err, ms=event_ms(torch, lambda: cp.solve_density(
        *args, n_sweeps=n_sweeps, **kw), 5), plain_ms=event_ms(
        torch, lambda: cp._solve_density_reference(
            *args, n_sweeps=n_sweeps, **kw), 1), bound_ms=b_ms, bound_by=b_by)


def check_disp(torch, sp, cp, args, kw, valid):
    got = cp.wvt_displacement(*args, **kw)
    torch.cuda.synchronize()
    ref = cp._wvt_displacement_reference(*args, **kw)
    pos, h_blocks, cand, xi, h_i, box = (args[k] for k in (0, 2, 3, 4, 5, 7))
    blocks = listed_blocks(torch, sp, cand, None, pos.shape[0],
                           kw.get("sb_mode", False)).sum(dim=1)
    r_pair = 0.5 * (h_i.amax(dim=1) + h_blocks.max()) * box
    ops = PAIRS * float((blocks * (dist_ops(sp, xi, r_pair, box)
                                   + OPS_DISP)).sum())
    b_ms, b_by = bound(ops, nbytes(*args) + cand.shape[0] * 128 * 3 * 4)
    return dict(
        err=compare_disp(torch, got, ref, valid, "wvt_displacement"),
        ms=event_ms(torch, lambda: cp.wvt_displacement(*args, **kw), 5),
        plain_ms=event_ms(torch, lambda: cp._wvt_displacement_reference(
            *args, **kw), 1), bound_ms=b_ms, bound_by=b_by)


def check_fused(torch, sp, cp, args, kw, valid):
    """Kernel vs plain with the caller's bounds, and bit-identical
    kernel outputs with and without them."""
    kw = dict(kw)
    n_sweeps = kw.pop("n_sweeps", cp.FUSED_SWEEPS)
    full = dict(kw, n_sweeps=n_sweeps, do_disp=kw.get("do_disp", True),
                sb_mode=kw.get("sb_mode", False), gdist=kw.get("gdist"),
                dkeep=kw.get("dkeep"))
    got = cp.fused_wvt(*args, **full)
    unbounded = cp.fused_wvt(*args, **dict(full, gdist=None, dkeep=None))
    torch.cuda.synchronize()
    for a, b in zip(got, unbounded):
        if not torch.equal(a, b):
            fail("fused_wvt: the distance bounds changed the result")
    pos, hm_blocks, cand, cnt, xi, _, cap, hm_i, _, box = args
    sweeps = torch.zeros(cand.shape[0], dtype=torch.int32,
                         device=cand.device)
    ref = cp._fused_wvt_reference(*args, **full, sweeps=sweeps)
    err = compare_wvt(torch, got, unpack(ref, full["do_disp"]), valid,
                      kw["desnngb"], full["do_disp"], "fused_wvt")
    ok = listed_blocks(torch, sp, cand, cnt, pos.shape[0], full["sb_mode"])
    dens, disp = ok, ok if full["do_disp"] else torch.zeros_like(ok)
    if full["gdist"] is not None:
        dens = ok & (full["gdist"] <= cap.amax(dim=1)[:, None])
    if full["dkeep"] is not None:
        disp = disp & full["dkeep"]
    r_disp = 0.5 * (hm_i.amax(dim=1) + hm_blocks.max()) * box
    ops = PAIRS * float(
        (dens.sum(dim=1) * sweeps * (dist_ops(sp, xi, cap.amax(dim=1), box)
                                     + OPS_DENS[kw["kernel"]])).sum()
        + (disp.sum(dim=1) * (dist_ops(sp, xi, r_disp, box)
                              + OPS_DISP)).sum())
    b_ms, b_by = bound(ops, nbytes(*args, full["gdist"], full["dkeep"])
                       + cand.shape[0] * 128 * 8 * 4)
    return dict(err=err, ms=event_ms(torch, lambda: cp.fused_wvt(
        *args, **full), 5), plain_ms=event_ms(
        torch, lambda: cp._fused_wvt_reference(*args, **full), 1),
        bound_ms=b_ms, bound_by=b_by)


def check_kernels_on_cusp(torch, sp, cp, device):
    from toycluster_tpu_torch.ops import cusp
    n = 100_000
    for kernel in ("wc6", "m4"):
        for do_disp in (True, False):
            args, kw, valid = cusp.wvt_inputs(kernel, do_disp, n,
                                              device=device)
            check_wvt(torch, sp, args, kw, valid,
                      f"cusp 1e5 kernel={kernel} do_disp={do_disp} rows="
                      f"{args[0].shape[0]} width={args[1].shape[1]}:")
        for sb_mode in (True, False):
            args, kw, valid = cusp.curl_inputs(kernel, n, device=device,
                                               sb_mode=sb_mode)
            r = check_curl(torch, sp, args, kw, valid)
            say(f"cusp 1e5 stream_curl kernel={kernel} sb_mode={sb_mode}: "
                f"width={args[1].shape[1]} max|dB|/max|B|={r['err']:.3g} "
                f"kernel_ms={r['ms']:.3f} plain_ms={r['plain_ms']:.3f}")
        for sb_mode in (False, True):
            c = cusp.class_inputs(kernel, n, sb_mode, device=device)
            v = c["valid"]
            kw = dict(kernel=kernel, desnngb=c["desnngb"], sb_mode=sb_mode)
            tag = (f"kernel={kernel} sb_mode={sb_mode} rows="
                   f"{c['cand'].shape[0]} width={c['cand'].shape[1]}")
            r = check_solve(torch, sp, cp, (
                c["pos_t"], c["valid_t"], c["cand"], c["pos_t"], c["h0"],
                c["cap"], 1.0, cusp.BOX), kw, v)
            say(f"cusp 1e5 solve_density {tag}: max|dwk|={r['err']:.3g} "
                f"kernel_ms={r['ms']:.3f} plain_ms={r['plain_ms']:.3f}")
            r = check_disp(torch, sp, cp, (
                c["pos_t"], c["valid_t"], c["h_b3"], c["cand"], c["pos_t"],
                c["hm"], 1.0, cusp.BOX), dict(kernel=kernel,
                                              sb_mode=sb_mode), v)
            say(f"cusp 1e5 wvt_displacement {tag}: max|ddelta|="
                f"{r['err']:.3g} kernel_ms={r['ms']:.3f} "
                f"plain_ms={r['plain_ms']:.3f}")
            r = check_fused(torch, sp, cp, (
                c["pos_t"], c["hm_blocks"], c["cand"], c["cnt"], c["pos_t"],
                c["h0"], c["cap"], c["hm"], 1.0, cusp.BOX),
                dict(kw, gdist=c["gdist"], dkeep=c["dkeep"]), v)
            say(f"cusp 1e5 fused_wvt {tag}: bounds bit-identical, "
                f"max|dwk|={r['err']:.3g} kernel_ms={r['ms']:.3f} "
                f"plain_ms={r['plain_ms']:.3f}")


# --------------------------------------------------------------- main path

def check_snapshot(out):
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
    if not (np.abs(snap["bfld"][:n_gas]).sum(axis=1) > 0).mean() > 0.99:
        fail("bfld is zero on more than 1% of the gas")
    say(f"snapshot: {snap['pos'].shape[0]} particles, {n_gas} gas, finite")


def run_main_path(torch, sp, cp, tmp, engine):
    """The CLI main path on cuda with ``engine``: every launch counter
    set to 0 just before, the first call's inputs of each kernel
    recorded for step 5 (the stream engine's stand-alone density solve,
    do_disp=False, is not recorded), and block-list stream_curl launches
    counted apart.  Returns (launches, recorded)."""
    from toycluster_tpu_torch import cli
    from toycluster_tpu_torch.models import bfield, sph, wvt
    from toycluster_tpu_torch.utils import logging as tlog

    recorded, by_name = {}, Counter()

    def recorder(fn, name_of):
        def call(*args, **kw):
            n0 = fn.launches
            out = fn(*args, **kw)
            name = name_of(kw)
            if name is not None:
                by_name[name] += fn.launches - n0
                recorded.setdefault(name, (args, kw))
            return out
        return call

    def curl_name(kw):
        return "stream_curl" if kw.get("sb_mode") else "stream_curl_blocks"

    patches = [
        (wvt, "stream_wvt", recorder(
            sp.stream_wvt, lambda kw: "stream_wvt"
            if kw.get("do_disp", True) else None)),
        (bfield, "stream_curl", recorder(sp.stream_curl, curl_name)),
        (wvt, "solve_density", recorder(cp.solve_density,
                                        lambda kw: "solve_density")),
        (sph, "solve_density", recorder(cp.solve_density,
                                        lambda kw: "solve_density")),
        (wvt, "wvt_displacement", recorder(cp.wvt_displacement,
                                           lambda kw: "wvt_displacement")),
        (wvt, "fused_wvt", recorder(cp.fused_wvt, lambda kw: "fused_wvt")),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    par = ROOT / PKG / "data" / "cluster.par"
    out = Path(tmp) / f"IC_{engine}"
    tlog.METRICS.clear()
    kernels = (sp.stream_wvt, sp.stream_curl, cp.solve_density,
               cp.wvt_displacement, cp.fused_wvt)
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        rc = cli.main([str(par), f"output_file={out}", "device=cuda",
                       f"engine={engine}"])
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    wall = time.perf_counter() - t0
    launches = {k.__name__: k.launches for k in kernels}
    launches["stream_curl_blocks"] = by_name["stream_curl_blocks"]
    if rc != 0:
        fail(f"cli.main returned {rc} (engine={engine})")
    need = (("stream_wvt", "stream_curl") if engine == "stream" else
            ("solve_density", "wvt_displacement", "fused_wvt",
             "stream_curl_blocks"))
    for name in need:
        if launches[name] <= 0:
            fail(f"the {engine} main path launched {name} no time")
    if engine == "classed" and launches["stream_wvt"] != 0:
        fail("the classed main path launched stream_wvt")
    say(f"main path engine={engine}: wall {wall:.3f} s, launches "
        f"{launches}")

    prev = t0 - tlog._T0
    for rec in tlog.METRICS:
        if rec["stage"].startswith("wvt") and rec["stage"] != "wvt_done":
            continue
        say(f"[{engine}] stage {rec['stage']:<16} ends at {rec['t']:9.3f} s "
            f"(+{rec['t'] - prev:.3f} s)")
        prev = rec["t"]
    errs = [r["err_mean"] for r in tlog.METRICS if r["stage"] == "wvt"]
    done = [r for r in tlog.METRICS if r["stage"] == "wvt_done"]
    builds = [r for r in tlog.METRICS if r["stage"] == "wvt_build"]
    retries = [r for r in tlog.METRICS if r["stage"] == "wvt_retry"]
    say(f"[{engine}] wvt err_mean trajectory ({len(errs)} iterations): "
        f"{errs}")
    say(f"[{engine}] wvt builds {len(builds)}, far-tail rows per build "
        f"{[r.get('tail_rows', 0) for r in builds]}, list widths "
        f"{[r['max_cand'] for r in builds]}; retries "
        f"{[(r['it'], r['n_sat']) for r in retries]}")
    if len(errs) < 2 or not errs[-1] < 0.6 * errs[0]:
        fail(f"err_mean did not fall: {errs}")
    say(f"[{engine}] wvt: {done[0]['iterations']} iterations in "
        f"{done[0]['seconds']:.3f} s = "
        f"{done[0]['particle_updates_per_s']:.6g} particle updates/s")
    frac = sph.last_contract_frac
    say(f"[{engine}] neighbour contract fraction {frac}")
    if not frac >= 0.999:
        fail(f"contract fraction {frac} < 0.999")
    check_snapshot(out)
    return launches, recorded


def time_on_main_path_inputs(torch, sp, cp, recorded):
    """Kernel vs plain on the inputs of each kernel's first main-path
    call: agreement, CUDA-event times and bounds.  These launches come
    after the counted runs."""
    res = {}
    args, kw = recorded["stream_wvt"]
    res["stream_wvt"] = check_wvt(
        torch, sp, args, kw, (args[0][:, 3, :] > 0),
        f"main-path rows={args[1].shape[0]} width={args[1].shape[1]}:")
    # receiver lanes with a nonzero wfac are the curl's valid ones; the
    # count-class operators are held on every receiver lane
    for name, check, cand_arg, valid_of in (
            ("stream_wvt", None, 1, None),
            ("stream_curl", check_curl, 1, lambda a: a[5] != 0),
            ("stream_curl_blocks", check_curl, 1, lambda a: a[5] != 0),
            ("solve_density", check_solve, 2,
             lambda a: torch.ones_like(a[4], dtype=torch.bool)),
            ("wvt_displacement", check_disp, 3,
             lambda a: torch.ones_like(a[5], dtype=torch.bool)),
            ("fused_wvt", check_fused, 2,
             lambda a: torch.ones_like(a[5], dtype=torch.bool))):
        args, kw = recorded[name]
        if check is check_curl:
            res[name] = check(torch, sp, args, kw, valid_of(args))
        elif check is not None:
            res[name] = check(torch, sp, cp, args, kw, valid_of(args))
        cand = args[cand_arg]
        r = res[name]
        say(f"main-path {name}: rows={cand.shape[0]} width={cand.shape[1]} "
            f"sb_mode={kw.get('sb_mode', name == 'stream_wvt')} "
            f"max_err={r['err']:.6g} kernel_ms={r['ms']:.6g} "
            f"plain_ms={r['plain_ms']:.6g} bound_ms={r['bound_ms']:.6g} "
            f"({r['bound_by']})")
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

    from toycluster_tpu_torch.ops import class_pair as cp
    from toycluster_tpu_torch.ops import cuda_build
    from toycluster_tpu_torch.ops import stream_pair as sp
    t0 = time.perf_counter()
    cuda_build.build(LIBS)
    say(f"build of {len(LIBS)} kernels (parallel nvcc): "
        f"{time.perf_counter() - t0:.3f} s")
    for name in LIBS:
        cuda_build.load(name)
        for line in cuda_build.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                say(f"  nvcc {name}: {line.strip()}")

    check_kernels_on_cusp(torch, sp, cp, torch.device("cuda"))

    launches, recorded = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine, names in (("stream", ("stream_wvt", "stream_curl")),
                              ("classed", ("solve_density",
                                           "wvt_displacement", "fused_wvt",
                                           "stream_curl_blocks"))):
            run_launches, run_recorded = run_main_path(torch, sp, cp, tmp,
                                                       engine)
            for name in names:
                launches[name] = run_launches[name]
                if name not in run_recorded:
                    fail(f"no {name} call was recorded")
                recorded[name] = run_recorded[name]
    res = time_on_main_path_inputs(torch, sp, cp, recorded)
    # no single PyTorch call computes a per-lane h solve or an SPH pair
    # sum over candidate lists: library_ms is null for every kernel
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{lib}.cu",
         "replaces": rep, "launches": launches[name],
         "max_abs_err": res[name]["err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"],
         "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "library_ms": None}
        for name, lib, rep in KERNELS]}
    # stream_wvt without hoisting, and without pruning and hoisting
    for key in ("ms_unhoisted", "ms_unpruned"):
        record["kernels"][0][key] = res["stream_wvt"][key]
    for k in record["kernels"]:
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms"):
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
