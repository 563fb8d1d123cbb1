#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py
With ``--parent-csrc DIR`` (the csrc directory of another tree whose
fused_wvt and stream_curl kernels have the one-CTA-of-128-threads C
interface) step 7 also builds those two kernels and times them on the same
recorded inputs, in turns with this tree's (parent, change, change,
parent).

1. Checks that CUDA is available and prints the card's name and power
   limit.
2. Builds the eight hand-written kernels (toycluster_tpu_torch/csrc/*.cu:
   the five pair kernels, the velocity stage's Eddington kernel, the
   neighbour engine's superblock sweep and the WVT loop's model density)
   with
   nvcc for sm_90a, one nvcc process each, all started together, and
   prints the build time and nvcc's register report.
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
   without the hoisted wrap, and without pruning and hoisting.  Then
   padded rows, as the count-class engine makes them: the odd receiver
   rows of the cusp as one count class (solve_density, wvt_displacement,
   fused_wvt on block lists) and as far-tail rows (solve_density on
   superblock lists), their ids padded with -1 to the quantized size
   (``sph.quantize_size``; rows all -1, counts 0), through
   ``sph.run_classed``: the real rows against the plain versions on the
   exact rows with the same tolerances, the padded rows' outputs finite
   and dropped (row 0, whose receivers they gather, stays zero).
4. Drives the CLI main path, ``toycluster_tpu_torch.cli.main``, on the
   repository's cluster.par (Ntotal 1e6, WC6, B field on) with
   device=cuda twice, with every launch counter set to 0 just before
   each run: once on the stream engine (the default) and once with
   engine=classed.  After each run it checks that the engine's kernels
   were launched (stream: stream_wvt and stream_curl; classed:
   solve_density and wvt_displacement over block lists and over the
   far-tail rows' superblock lists, fused_wvt and block-list
   stream_curl, and no stream_wvt) and the Eddington kernel once (every
   run of the script that counts launches checks that), that the
   neighbour contract fraction is >= 0.999 and err_mean fell, and reads
   the snapshot back (1e6 particles, finite, rho/u/bfld nonzero on the
   gas).  Prints the
   per-stage wall times and the WVT particle updates per second of each
   run.
5. Drives the config-4 scene (configs/run_configs.py:29-30 as overrides
   of the repository's par: a 1:3 merger with Giocoli substructure)
   through ``make_ics(device="cuda", check=True)`` twice, counted as in
   step 4: at Ntotal 1e7 on the stream engine, and at 1e6 on
   engine=classed with SLOW_SUBSTRUCTURE.  After each run it checks that
   the scene has subhalos and the particle budgets hold, that the
   engine's kernels were launched, the contract fraction and err_mean as
   in step 4, that the pipeline's density audit and a second one on 512
   lanes of subhalo gas (direct summation, ops/brute.py) are within
   5e-3, that the gas of the subhalos past index 1 keeps |B| <= BMAX_SUB
   and that the snapshot reads back; it prints the halo count, the stage
   times, the WVT record, per-row statistics of the first stream_wvt and
   far-tail solve_density calls and the peak device memory.  A second
   run of each scene, without the audit and the snapshot, synchronises
   and times every call of the per-halo functions and prints their share
   of each of its stages (the first run's times carry no such
   instrumentation).
6. Two large runs of the config-4 preset (``run_configs.PRESETS[4]``),
   counted without recording any kernel's inputs, each printing its
   stage times with the allocator's mem_gib / peak_gib, each WVT build's
   and list refresh's time and width, the widths its candidate search
   started and ended at, the sweeps it ran, the wall between WVT
   iterations and its phase's wall time.  A: at config 5's size,
   Ntotal 1e8 (5e7 gas), on the stream engine through
   ``make_ics(check=True, wvt_checkpoint=...)``, with the checks of step
   5, and the checkpoint must hold the last iteration of the form 16 k -
   1 the run moved past; prints each kernel call's device time (CUDA
   events around the wrapper), the checkpoint saves' times and the peak
   device memory per gas particle and the WVT loop's seconds; no build or
   list refresh may grow its search from below a width an earlier one
   reached (the sticky search width), and at 5e7 gas the loop must park
   the particle set (``wvt_offload``, ``wvt_restore``); A keeps the
   inputs of its first superblock sweep for step 11.  Then A's offload
   gate: the particle set make_ics hands the loop on A's scene, relaxed
   twice from a host copy to wvt_max_iter 1, with the offload off and
   on, must give the same pos, rho, hsml, pid and halo to the bit, and
   the device memory at the first build must be at least 2 GiB lower
   with the offload.  A2: A's scene on engine=classed without the
   checkpoint, with A's checks; prints the builds with their far-tail
   rows, widths and memory, each kernel record's device times, and the
   peak allocated and reserved a gas particle.  B: at Ntotal 1e7 on
   engine=classed,
   a run stopped at wvt_max_iter 16 must leave it = 15 in a fresh
   checkpoint; a second run (default wvt_max_iter, the audit,
   ``profile_dir``) must resume at it = 16 with the saved step, pass step
   5's checks but the fall of err_mean, end at an err_mean no higher than
   the file's err_last, and leave a torch.profiler trace that parses and
   names fused_wvt or solve_density.
7. Holds each kernel against its plain version again on the inputs of
   its first main-path call (solve_density and wvt_displacement: of the
   first block-list call, the 512-wide count class, and of the first
   far-tail call, as records of their own; with the checks of step 3),
   times both there with CUDA events, and computes each kernel's bound:
   the larger of its fp32 operations over the card's fp32 peak and its
   bytes (inputs read once, outputs written once) over the HBM peak,
   with the operations counted from this run's data (the members the
   chunk test keeps for stream_wvt and for wvt_displacement, the blocks
   the sweeps of solve_density walked (of the blocks its test keeps,
   those within each sweep's own ranges), the warp tiles (32 receiver
   lanes x 32 sources, 16 a block) that stream_curl and the sweeps of
   fused_wvt walked and one displacement pass over fused_wvt's
   displacement tiles, the sweeps the kernel took, and the periodic wrap
   only on the rows whose reach leaves the box).  fused_wvt is also timed
   without its frozen-lane skip and without its warp tiles.  The
   Eddington kernel is held against its plain version on the inputs of
   its call in step 5's first run (config 4 at Ntotal 1e7, every halo's
   knots and energies stacked): each energy within 1e-12 of its terms
   summed in magnitude, the same knots summed, a rerun bit-identical;
   both are timed with CUDA events, and its bound is the larger of its
   fp64 operations (OPS_EDDINGTON a term below its energy) over the
   card's fp64 peak and its bytes over the HBM peak.  The superblock
   sweep kernel (``blk.super_sweep``) is held against the plain PyTorch
   sweep (``blk._super_sweep``, the top-k) on the inputs of the first
   superblock sweep of step 5's first run (config 4 at Ntotal 1e7) and of
   phase A's (1e8): the same lists, counts and widest count to the bit, a
   rerun bit-identical; both are timed with CUDA events, and its bound is
   the larger of OPS_SWEEP fp32 operations a box test (rows x
   superblocks) over the card's fp32 peak and its bytes over the HBM
   peak.  The model-density kernel (``ops.density_model``) is held
   against its plain version (the per-halo PyTorch loop) on config 4's
   scene at 5e6 gas lanes (51 halos) and config 5's at 5e7 (72 halos),
   lanes about the halo centres out past rcut (``cusp.model_points``),
   each halo's own beta and no cool core, as the benchmark's
   configurations run it: to the bit, a rerun bit-identical; both timed
   with CUDA events (20 launches of the kernel), and its bound is the
   larger of OPS_MODEL fp32 operations a lane-halo over the card's fp32
   peak and its bytes over the HBM peak.  Every counted run zeroes and
   reads its launches, and every WVT relaxation's ``wvt_done`` record must
   count at least one model-density launch an iteration.

8. The sharded path (``toycluster_tpu_torch/parallel/``), through
   ``make_ics(mesh=..., check=True)`` with the ranks started by
   ``parallel.mesh.spawn`` after the kernels were built here.  Under gloo,
   two ranks sharing the one card: B, config 4 at Ntotal 1e7 on the
   stream engine (ring halo); C, the repository's par (1e6) with the ring
   halo and again with the gather halo; D, the par on the xla engine
   (make_ics engine=classed).  E: ``sharded_density`` and
   ``sharded_curl`` on C-ring's relaxed gas.  Then under NCCL, one rank:
   A, B's scene, and E again.  Each run sums its ranks' launch counters,
   set to 0 just before it: the sharded loop must have launched
   stream_wvt (A, B, C) or solve_density and wvt_displacement and no
   stream_wvt at all (D), E solve_density and block-list stream_curl;
   each run's contract fraction >= 0.999 on the sharded loop's last
   solve and on every rank's final solve, no list or ring overflow, its
   density audit <= 5e-3, and its snapshot must read back.  B's first
   sharded step is held against A's (rho, hsml rtol 2e-4; positions rtol
   1e-4, atol 1e-2; the same start) and B's final err_mean within 1% of
   A's; A's first and final err_mean within 1% of step 5's single-card
   run of the same scene; C's ring and gather relaxations must be
   bit-equal; D's (xla engine) err_mean trajectory must have C's length
   and each value within 1e-3 relative of C's, its relaxed rho and hsml
   within rtol 2e-3 of C's and its positions within 1e-2 hsml of C's
   (periodic), each on >= 98% of the gas (the kernels' tolerance against
   their plain versions, compare_wvt); E at world size 2 against 1 at
   rtol 2e-4 (density) and 3e-4 / atol 1e-8 (curl).  Rank 0 records the
   first call of the sharded loop of B (stream_wvt on the ring-filled
   [local | buffer | dump] sources) and of D (solve_density and
   wvt_displacement on the xla engine's block lists over the gathered
   sources); after the runs each is launched here on its full inputs
   and held against its plain version on SHARDED_CHECK_ROWS of its rows
   (most of them rows whose lists name remote sources), with the
   tolerances of step 3.  Prints
   per run the iterations, the err_mean trajectory, the updates/s, rank
   0's collectives per iteration (host clock and CUDA events), the ring
   buffer's fill against its slots and the peak device memory per rank.
   Two ranks on one card measure no multi-card speed.
9. The variant slice, counted as in step 4, through ``make_ics`` or the
   CLI on cuda.  Presets 1 (65,536 particles, no B field; on both
   engines) and 3 (1e7, an equal-mass merger on a zero-energy comet
   orbit; stream engine) of ``run_configs`` with the density audit, the
   contract and err_mean checks of step 4, their first and final
   err_mean within 2% and 10% (preset 1) and 1% and 5% (preset 3) of the
   JAX package's records of the same presets (FLAGSHIP_r07_config1.json,
   FLAGSHIP_r07_config3.json), and the snapshot; then the 1e6 par with
   sph_kernel=m4 on both engines with step 4's checks, each kernel
   record's first M4 main-path call held against its plain version with
   step 3's tolerances, timed and bounded as in step 7 (every kernel
   must be launched by one of the two runs); then flag variants of the
   par at 1e6 with step 4's checks: cool cores (mass ratio 0.5, Cuspy 3,
   engine=classed), the parabola and direct orbits (mass ratio 0.5),
   no_rcut_in_t=false, the Buote07 concentration, bfld_norm=0 and
   baryon_fraction=0.  Every run must launch its engine's displacement
   kernel, stream_curl exactly when it has a B field, the far-tail
   records when a WVT build had far-tail rows, no stream_wvt on the
   classed engine and, without gas, no pair kernel; the DM-only
   snapshot holds no gas and finite, nonzero DM speeds.
10. Speculative dispatch of the WVT loop: the 1e6 par on both engines and
   config 4 at Ntotal 5e6 (stream engine), each with TOYCLUSTER_SPECULATE
   at 1 and at 0, through ``make_ics(device="cuda", check=True)`` with the
   gates of step 4 (the 1e6 par) or step 5 (config 4) and the snapshot,
   then again under the profiler (``toycluster_tpu_torch.trace``).  From
   the build on, every speculating WVT run of the script runs the window
   between queuing iteration it+1 and reading iteration it's scalars
   under ``torch.cuda.set_sync_debug_mode("error")`` (``wvt.SYNC_CHECK``):
   a host sync there fails the run.  Prints per run the iterations, the
   iterations queued ahead, adopted and dropped, the loop's seconds and
   updates/s, and the device's idle share of the traced WVT loop and of
   the traced run; the speculating 1e6 stream and config-4 runs must
   adopt a queued iteration, no run at 0 may queue one.  Then preset 1
   (stream engine) at both settings, with step 9's gate against the JAX
   package's record and its first and final err_mean printed beside it.
11. The superblock sweep: on the inputs of phase A's first superblock
   sweep (its first build's, 5e7 gas, kept in the run), at the recorded
   width and at the width cap ``sph.SB_WIDTH_CAP``, the sweep as the
   loop runs it (``blk._find_candidates_super_k``: on the card the sweep
   kernel, "top-k" in the output) and its oracle (the stable sort over
   every superblock, ``blk._find_candidates_super_k_sorted``) must give
   the same lists, counts and overflow to the bit; prints both times
   (CUDA events, in turns), their peak memory and, at the recorded
   width, the time of the plain PyTorch sweep with no selection.

Prints the wall time of each phase, the kernel record (with each record's
M4 numbers of step 9 as ``m4_*`` keys) and the card line before the last
line, and as the last line {"ok": true, "device": {...}}.  Any failure
exits nonzero without that line.
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
    ("solve_density_sb", "solve_density", f"{PALLAS}:104"),
    ("wvt_displacement", "wvt_displacement", f"{PALLAS}:637"),
    ("wvt_displacement_sb", "wvt_displacement", f"{PALLAS}:637"),
    ("fused_wvt", "fused_wvt", f"{PALLAS}:230"),
)
LIBS = ("stream_wvt", "stream_curl", "solve_density", "wvt_displacement",
        "fused_wvt")
# the velocity stage's kernel: every halo's f(E) integral in float64 (record
# name, kernel library, the JAX package's host function it takes over; it
# replaces no TPU kernel)
EDDINGTON = ("eddington_integral", "eddington",
             "toycluster_tpu/models/eddington.py:61")
# the neighbour engine's superblock sweep (record name, kernel library, the
# JAX package's XLA function it takes over; it replaces no TPU kernel)
SUPER_SWEEP = ("super_sweep", "super_sweep",
               "toycluster_tpu/ops/blocks.py:273")
# the WVT loop's model density (record name, kernel library, the JAX
# package's XLA function it takes over; it replaces no TPU kernel)
DENSITY_MODEL = ("density_model", "density_model",
                 "toycluster_tpu/models/sph.py:94")
# Published peaks of one H100 SXM at its 700 W limit (NVIDIA's data
# sheet): fp32 and fp64 outside the tensor cores, and HBM3.
PEAK_FP32 = 67e12
PEAK_FP64 = 34e12
PEAK_HBM = 3.35e12
PAIRS = 128 * 128       # pairs of one receiver block and one source block
TILE_PAIRS = 32 * 32    # pairs of one warp tile, 16 a block
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
# fp64 operations of one Eddington term below its E (csrc/eddington.cu):
# E - x_k, sqrt (as one), s * sqrt(s), the product with d_k, the sum
OPS_EDDINGTON = 5
# fp32 operations of one box test of the superblock sweep
# (csrc/super_sweep.cu): per axis the difference, its scale, rint, the
# wrap's product and difference, the half-widths' sum, |d| - w, the clamp
# and the square (9); the two adds of the sum; the range (an add, a
# half, a max, a square) and the compare
OPS_SWEEP = 34
# fp32 operations of one lane-halo of the model density
# (csrc/density_model.cu), each power, division and square root as one:
# the difference (3), the squares and their sums (5), the root, r / rcut,
# its power and the taper's add, r / rcore, its square and add, the
# model's power, rho0 times it, the division by the taper and the max
OPS_MODEL = 19
# what a check may measure besides the contract's keys: stream_wvt
# without hoisting, the parent's kernel, a kernel without pruning and
# hoisting, on one CTA a row, fused_wvt without the frozen-lane skip and
# without the warp tiles; the blocks kept of those listed, the blocks
# walked of listed x sweeps, the tiles walked of 16 x the blocks walked;
# the Eddington kernel's error over each energy's terms in magnitude
EXTRA_KEYS = ("ms_unhoisted", "parent_ms", "ms_unpruned", "ms_cluster1",
              "cluster", "kept_over_listed", "walked_over_listed",
              "tiles_over_walked", "ms_no_skip", "ms_no_tiles",
              "err_over_magnitude", "ms_1e8", "plain_ms_1e8",
              "bound_ms_1e8")
# the config-4 scenes of step 5: (engine, ntotal, SLOW_SUBSTRUCTURE); the
# first, at the benchmark's size, gives step 7 the Eddington kernel's inputs
SUBSTRUCTURE_RUNS = (("stream", 10_000_000, False),
                     ("classed", 1_000_000, True))
# step 6: the config-4 preset at config 5's size (stream engine), and the
# checkpoint -> resume pair (engine=classed)
LARGE_NTOTAL = 100_000_000
RESUME_NTOTAL = 10_000_000
# the per-halo work of a substructure scene, by module and function:
# Python loops over the halos (some 8 small device ops a halo), host
# tables built one a halo and the velocity tables of every halo (host
# splines a halo, one integral call); a second run of each config-4
# scene times every call
HALO_LOOPS = (("positions", "halo_containing_gas"),
              ("positions", "halo_containing_dm"),
              ("sph", "global_density_model"),
              ("bfield", "set_vector_potential"),
              ("temperature", "build_energy_tables_stacked"),
              ("velocities", "velocity_tables"),
              ("velocities", "gas_bulk_velocities"))
# the kernel records of the classed main path
CLASSED_NAMES = ("solve_density", "solve_density_sb", "wvt_displacement",
                 "wvt_displacement_sb", "fused_wvt", "stream_curl_blocks")


def fail(msg):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg):
    print(msg, flush=True)


def phase(name, t0):
    """Print the wall time of the phase that began at t0; returns now."""
    t = time.perf_counter()
    say(f"phase {name}: {t - t0:.3f} s")
    return t


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


def check_curl(torch, sp, args, kw, valid, parent=None):
    """stream_curl against its plain version, with the checks of
    ``list_walk_checks`` and one CTA a row against the cluster the wrapper
    chooses; the warp tiles the kernel walked must be the plain oracle's,
    row by row; its bound counts the pairs of the tiles that its chunk
    test keeps at the curl's range (r < hsml_i)."""
    plain_kw = {k: v for k, v in kw.items() if k not in ("packed",
                                                         "cluster")}
    sb_mode = kw.get("sb_mode", False)
    src, cand, cnt, xi, hsml = args[:5]
    box = args[8]
    S = cand.shape[0]
    kw = dict(kw)
    if kw.get("cluster") is None:   # the wrapper's rule
        kw["cluster"] = sp._cluster_size(
            S, cand.shape[1] * (8 if sb_mode else 1), None)
    cluster = kw["cluster"]
    st = torch.zeros((S, 5), dtype=torch.int32, device=cand.device)

    def run(**options):
        return sp.stream_curl(*args, **{**kw, **options})

    got = run(stats=st)
    keep, ok = sp.curl_keep(src, cand, cnt, xi, hsml, box, sb_mode=sb_mode,
                            tiles=True)
    kept = list_walk_checks(torch, f"stream_curl sb_mode={sb_mode}", run,
                            torch.equal, st, keep.any(dim=2), ok)
    tiles = keep.sum(dim=(1, 2))
    if not torch.equal(st[:, 4].long(), tiles):
        fail(f"stream_curl: the kernel walked {int(st[:, 4].sum())} warp "
             f"tiles, the plain test keeps {int(tiles.sum())}")
    ref = sp._stream_curl_reference(*args, **plain_kw)
    res = dict(err=compare_curl(torch, got, ref, valid), cluster=cluster,
               kept_over_listed=int(kept.sum()) / max(int(ok.sum()), 1),
               tiles_over_walked=int(tiles.sum()) / max(
                   16 * int(kept.sum()), 1))
    if cluster > 1:
        compare_curl(torch, run(cluster=1), ref, valid)
        res["ms_cluster1"] = event_ms(torch, lambda: run(cluster=1), 2)
    ops = TILE_PAIRS * float((tiles * dist_ops(sp, xi, hsml.amax(dim=1),
                                               box)).sum())
    res["bound_ms"], res["bound_by"] = bound(
        ops, nbytes(*args) + S * 128 * 3 * 4)
    if parent is not None:
        compare_curl(torch, parent.stream_curl(torch, args, plain_kw), ref,
                     valid)
        res["parent_ms"], res["ms"] = ab_ms(
            torch, lambda: parent.stream_curl(torch, args, plain_kw), run, 3)
    else:
        res["ms"] = event_ms(torch, run, 5)
    res["ms_unpruned"] = event_ms(torch, lambda: run(prune=False,
                                                     hoist=False), 2)
    res["plain_ms"] = event_ms(torch, lambda: sp._stream_curl_reference(
        *args, **plain_kw), 1)
    return res


class ParentKernels:
    """fused_wvt and stream_curl of another tree's csrc directory (the C
    interface of the one-CTA-of-128-threads kernels), built beside this
    tree's to time both on the same inputs."""

    def __init__(self, sp, csrc):
        from toycluster_tpu_torch.ops import cuda_build
        self.sp, names = sp, ("fused_wvt", "stream_curl")
        self.call = cuda_build._call
        cuda_build.build(names, Path(csrc))
        self.fn = {n: getattr(cuda_build.load(n, Path(csrc)), f"{n}_launch")
                   for n in names}

    def bounds(self, torch, args, full):
        """The (gdist, dkeep) that tree's main path gave its fused_wvt
        (class_pair.fused_bounds): block-box distances against the widest
        displacement range, from the recorded positions."""
        from toycluster_tpu_torch.ops.blocks import _interval_dist2
        pos, hm_blocks, cand, cnt, xi, _, _, hm_i, _, box = args
        e, ok = self.sp._listed_members(cand, cnt, pos.shape[0],
                                        full["sb_mode"])
        lo_s, hi_s = self.sp._wrapped_bounds(pos, box)
        lo_r, hi_r = self.sp._wrapped_bounds(xi, box)
        d2 = _interval_dist2(lo_r[:, None], hi_r[:, None], lo_s[e], hi_s[e],
                             box)
        gd = torch.where(ok, torch.sqrt(d2),
                         torch.full_like(d2, float("inf")))
        dk = gd <= 0.5 * (hm_i.amax(dim=1)[:, None]
                          + hm_blocks[:, 0].amax(dim=1)[e]) * box
        return gd.to(torch.float32).contiguous(), dk.to(torch.uint8)

    def fused_wvt(self, torch, args, full, gdist, dkeep):
        pos, hm_blocks, cand, cnt, xi, h0, cap, hm_i, mpart, box = args
        out = torch.empty((cand.shape[0], 128, 8), dtype=torch.float32,
                          device=cand.device)
        self.call(self.fn["fused_wvt"], "parent fused_wvt", [
            pos, hm_blocks, cand, cnt, xi, h0, cap, hm_i, gdist, dkeep, out,
            cand.shape[0], cand.shape[1], pos.shape[0],
            self.sp._KIND[full["kernel"]], bool(full["sb_mode"]),
            bool(full["do_disp"]), full["n_sweeps"], float(mpart),
            float(box), float(full["desnngb"]), float(self.sp._rho_corr(
                full["desnngb"], mpart, full["kernel"]))])
        return out

    def stream_curl(self, torch, args, kw):
        src, cand, cnt, xi, hsml, wfac, apot, _, box = args
        sb_mode = bool(kw.get("sb_mode"))
        out = torch.empty((cand.shape[0], 128, 3), dtype=torch.float32,
                          device=cand.device)
        self.call(self.fn["stream_curl"], "parent stream_curl", [
            self.sp._pad_superblocks(src) if sb_mode else src, cand, cnt, xi,
            hsml, wfac, apot, out, cand.shape[0], cand.shape[1],
            src.shape[0], self.sp._KIND[kw["kernel"]], sb_mode, float(box)])
        return out


def ab_ms(torch, parent_fn, fn, reps):
    """(parent_ms, ms), each the mean of two timings taken in turns:
    parent, change, change, parent."""
    a0 = event_ms(torch, parent_fn, reps)
    b0 = event_ms(torch, fn, reps)
    b1 = event_ms(torch, fn, reps)
    a1 = event_ms(torch, parent_fn, reps)
    return 0.5 * (a0 + a1), 0.5 * (b0 + b1)


def list_walk_checks(torch, name, run, same, st, keep, ok):
    """What the four list-walk kernels share: ``run(**options)``
    launches the kernel; pruned against unpruned and unwrapped against
    wrapped runs must agree to the bit, a second run must repeat the bits,
    and the blocks the kernel kept (``st``, its stats) must be the plain
    oracle's (``keep``, ``ok``).  Returns the kept blocks per row."""
    got = run()
    for off in (dict(prune=False, hoist=False), dict()):
        if not same(got, run(**off)):
            fail(f"{name}: pruning, the dropped wrap or a second run "
                 f"changed the result")
    torch.cuda.synchronize()
    kept, listed = keep.sum(dim=1), ok.sum(dim=1)
    if not (torch.equal(st[:, 1].long(), kept)
            and torch.equal(st[:, 2].long(), listed)):
        fail(f"{name}: the kernel kept {int(st[:, 1].sum())} of "
             f"{int(st[:, 2].sum())} blocks, the plain test "
             f"{int(kept.sum())} of {int(listed.sum())}")
    say(f"  {name}: blocks per row (median, p99, max) listed "
        f"{quantiles(torch, listed)}, kept {quantiles(torch, kept)}; "
        f"kept/listed {int(kept.sum()) / max(int(listed.sum()), 1):.4f}; "
        f"pruned and unpruned bit-identical")
    return kept


def check_solve(torch, sp, cp, args, kw, valid):
    """solve_density against its plain version, with the checks of
    ``list_walk_checks``; its bound counts the pairs of the blocks its
    sweeps walked (of the kept blocks, those within each sweep's own
    ranges: the kernel's count, at most kept x sweeps)."""
    kw = dict(kw)
    n_sweeps = kw.pop("n_sweeps", cp.SOLVE_SWEEPS)
    plain_kw = {k: kw[k] for k in ("kernel", "desnngb", "sb_mode")
                if k in kw}
    pos, valid_t, cand, xi, _, cap, _, box = args
    S = cand.shape[0]
    sb_mode = kw.get("sb_mode", False)
    if kw.get("cluster") is None:   # the wrapper's rule
        kw["cluster"] = cp._cluster_size(
            S, cand.shape[1] * (8 if sb_mode else 1), None)
    cluster = kw["cluster"]
    st = torch.zeros((S, 4), dtype=torch.int32, device=cand.device)

    def run(**options):
        return cp.solve_density(*args, n_sweeps=n_sweeps,
                                **{**kw, **options})

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    got = run(stats=st)
    keep, ok = cp.density_keep(pos, valid_t, cand, xi, cap, box,
                               sb_mode=sb_mode)
    kept = list_walk_checks(torch, "solve_density", run, same, st, keep, ok)
    sweeps = torch.zeros(S, dtype=torch.int32, device=cand.device)
    ref = unpack(cp._solve_density_reference(
        *args, n_sweeps=n_sweeps, **plain_kw, sweeps=sweeps), False)
    err = compare_wvt(torch, got, ref, valid, kw["desnngb"], False,
                      "solve_density")
    res = dict(err=err, cluster=cluster,
               kept_over_listed=int(kept.sum()) / max(int(ok.sum()), 1),
               walked_over_listed=int(st[:, 3].sum()) / max(
                   int((ok.sum(dim=1) * st[:, 0]).sum()), 1))
    if cluster > 1:
        compare_wvt(torch, run(cluster=1), ref, valid, kw["desnngb"], False,
                    "solve_density cluster=1")
        res["ms_cluster1"] = event_ms(torch, lambda: run(cluster=1), 2)
    walked, most = st[:, 3].long(), kept * st[:, 0]
    if bool((walked > most).any()) or int(walked.sum()) <= 0:
        fail(f"solve_density: {int(walked.sum())} blocks walked, "
             f"{int(most.sum())} kept x sweeps")
    say(f"  solve_density: sweeps per row (median, p99, max) kernel "
        f"{quantiles(torch, st[:, 0])}, plain {quantiles(torch, sweeps)}; "
        f"blocks walked over all sweeps {quantiles(torch, walked)}, "
        f"walked / (kept x sweeps) {int(walked.sum()) / int(most.sum()):.4f}"
        f"; {cluster} CTAs a row")
    ops = PAIRS * float((walked * (dist_ops(
        sp, xi, cap.amax(dim=1), box) + OPS_DENS[kw["kernel"]])).sum())
    res["bound_ms"], res["bound_by"] = bound(
        ops, nbytes(*args) + S * 128 * 5 * 4)
    res["ms"] = event_ms(torch, run, 5)
    res["ms_unpruned"] = event_ms(torch, lambda: run(prune=False,
                                                     hoist=False), 2)
    res["plain_ms"] = event_ms(torch, lambda: cp._solve_density_reference(
        *args, n_sweeps=n_sweeps, **plain_kw), 1)
    return res


def check_disp(torch, sp, cp, args, kw, valid):
    """wvt_displacement against its plain version, as ``check_solve``."""
    plain_kw = {k: kw[k] for k in ("kernel", "sb_mode") if k in kw}
    pos, valid_t, h_blocks, cand, xi, h_i, _, box = args
    S = cand.shape[0]
    sb_mode = kw.get("sb_mode", False)
    kw = dict(kw)
    if kw.get("cluster") is None:   # the wrapper's rule
        kw["cluster"] = cp._cluster_size(
            S, cand.shape[1] * (8 if sb_mode else 1), None)
    cluster = kw["cluster"]
    st = torch.zeros((S, 4), dtype=torch.int32, device=cand.device)

    def run(**options):
        return cp.wvt_displacement(*args, **{**kw, **options})

    got = run(stats=st)
    keep, ok = cp.displacement_keep(pos, valid_t, h_blocks, cand, xi, h_i,
                                    box, sb_mode=sb_mode)
    kept = list_walk_checks(torch, "wvt_displacement", run, torch.equal, st,
                            keep, ok)
    ref = cp._wvt_displacement_reference(*args, **plain_kw)
    res = dict(err=compare_disp(torch, got, ref, valid, "wvt_displacement"),
               cluster=cluster,
               kept_over_listed=int(kept.sum()) / max(int(ok.sum()), 1))
    if cluster > 1:
        compare_disp(torch, run(cluster=1), ref, valid,
                     "wvt_displacement cluster=1")
        res["ms_cluster1"] = event_ms(torch, lambda: run(cluster=1), 2)
    h_src = torch.where(valid_t > 0.5, h_blocks, torch.zeros_like(h_blocks))
    r_pair = 0.5 * (h_i.amax(dim=1) + h_src.max()) * box
    ops = PAIRS * float((kept * (dist_ops(sp, xi, r_pair, box)
                                 + OPS_DISP)).sum())
    res["bound_ms"], res["bound_by"] = bound(
        ops, nbytes(*args) + S * 128 * 3 * 4)
    res["ms"] = event_ms(torch, run, 5)
    res["ms_unpruned"] = event_ms(torch, lambda: run(prune=False,
                                                     hoist=False), 2)
    res["plain_ms"] = event_ms(
        torch, lambda: cp._wvt_displacement_reference(*args, **plain_kw), 1)
    return res


def check_fused(torch, sp, cp, args, kw, valid, parent=None):
    """fused_wvt against its plain version, with the checks of
    ``list_walk_checks``; bit-identical outputs with and without the
    caller's bounds, with and without the frozen-lane skip, and with and
    without the warp tiles.  Its bound counts the pairs of the density
    tiles its sweeps walked (the kernel's count) and the displacement's
    operations on the tiles kept for it (the separations of a tile in
    both are counted once)."""
    kw = dict(kw)
    n_sweeps = kw.pop("n_sweeps", cp.FUSED_SWEEPS)
    packed = kw.pop("packed", None)
    full = dict(kw, n_sweeps=n_sweeps, do_disp=kw.get("do_disp", True),
                sb_mode=kw.get("sb_mode", False), gdist=kw.get("gdist"),
                dkeep=kw.get("dkeep"))
    pos, hm_blocks, cand, cnt, xi, _, cap, hm_i, _, box = args
    S = cand.shape[0]
    st = torch.zeros((S, 5), dtype=torch.int32, device=cand.device)

    def run(**options):
        return cp.fused_wvt(*args, **{**full, "packed": packed, **options})

    def raw(debug=0):
        # the C entry point's debug bits: 1, no frozen-lane skip; 2, every
        # warp runs every kept block
        out = cp._fused_wvt_cuda(*args, **full, prune=True, hoist=True,
                                 stats=None, packed=packed, debug=debug)
        return out if full["do_disp"] else out[..., :5]

    def same(a, b):
        return all(torch.equal(x, y) for x, y in zip(a, b))

    got = run(stats=st)
    if full["gdist"] is not None or full["dkeep"] is not None:
        if not same(got, run(gdist=None, dkeep=None)):
            fail("fused_wvt: the distance bounds changed the result")
    dens_t, disp_t, ok = cp.fused_keep(
        pos, hm_blocks, cand, cnt, xi, cap, hm_i, box, tiles=True,
        **{k: full[k] for k in ("sb_mode", "do_disp", "gdist", "dkeep")})
    dens, disp = dens_t.any(dim=2), disp_t.any(dim=2)
    kept = list_walk_checks(torch, "fused_wvt", run, same, st, dens | disp,
                            ok)
    base = raw()
    if not torch.equal(base[..., :5], torch.stack(
            got[:4] + (got[4].float(),), dim=-1)):
        fail("fused_wvt: the wrapper and the C entry point disagree")
    for what, debug in (("the frozen-lane skip", 1), ("the warp tiles", 2),
                        ("both", 3)):
        if not torch.equal(base, raw(debug)):
            fail(f"fused_wvt: switching off {what} changed the result")
    torch.cuda.synchronize()
    sweeps = torch.zeros(S, dtype=torch.int32, device=cand.device)
    ref = cp._fused_wvt_reference(*args, **full, sweeps=sweeps)
    err = compare_wvt(torch, got, unpack(ref, full["do_disp"]), valid,
                      kw["desnngb"], full["do_disp"], "fused_wvt")
    walked, most = st[:, 3].long(), dens.sum(dim=1) * st[:, 0]
    tiles, most_t = st[:, 4].long(), dens_t.sum(dim=(1, 2)) * st[:, 0]
    if bool((walked > most).any()) or int(walked.sum()) <= 0:
        fail(f"fused_wvt: {int(walked.sum())} density blocks walked, "
             f"{int(most.sum())} kept x sweeps")
    if bool((tiles > most_t).any()) or bool((tiles < walked).any()):
        fail(f"fused_wvt: {int(tiles.sum())} density tiles walked, "
             f"{int(most_t.sum())} kept x sweeps, in {int(walked.sum())} "
             f"blocks")
    say(f"  fused_wvt: sweeps per row (median, p99, max) kernel "
        f"{quantiles(torch, st[:, 0])}, plain {quantiles(torch, sweeps)}; "
        f"kept for the density {int(dens.sum()) / max(int(ok.sum()), 1):.4f}"
        f" of listed, for the displacement "
        f"{int(disp.sum()) / max(int(ok.sum()), 1):.4f}; density blocks "
        f"walked over all sweeps {quantiles(torch, walked)}, walked / (kept "
        f"x sweeps) {int(walked.sum()) / max(int(most.sum()), 1):.4f}; "
        f"density tiles walked / (16 x blocks walked) "
        f"{int(tiles.sum()) / max(16 * int(walked.sum()), 1):.4f}, "
        f"displacement tiles kept / (16 x blocks kept) "
        f"{int(disp_t.sum()) / max(16 * int(disp.sum()), 1):.4f}; runs "
        f"without the frozen-lane skip and the warp tiles bit-identical")
    hm_rows = hm_i if full["do_disp"] else None
    r_pair = sp.pair_range(cap, hm_rows, hm_blocks.max(), box)
    ops = TILE_PAIRS * float(
        (tiles * (dist_ops(sp, xi, r_pair, box) + OPS_DENS[kw["kernel"]])
         + disp_t.sum(dim=(1, 2)) * OPS_DISP).sum())
    res = dict(err=err,
               kept_over_listed=int(kept.sum()) / max(int(ok.sum()), 1),
               walked_over_listed=int(walked.sum()) / max(
                   int((ok.sum(dim=1) * st[:, 0]).sum()), 1),
               tiles_over_walked=int(tiles.sum()) / max(
                   16 * int(walked.sum()), 1))
    res["bound_ms"], res["bound_by"] = bound(
        ops, nbytes(*args, full["gdist"], full["dkeep"]) + S * 128 * 8 * 4)
    if parent is not None:
        gd, dk = parent.bounds(torch, args, full)
        compare_wvt(torch, unpack(parent.fused_wvt(
            torch, args, full, gd, dk), full["do_disp"]),
            unpack(ref, full["do_disp"]), valid, kw["desnngb"],
            full["do_disp"], "parent fused_wvt")
        res["parent_ms"], res["ms"] = ab_ms(
            torch, lambda: parent.fused_wvt(torch, args, full, gd, dk), run,
            3)
    else:
        res["ms"] = event_ms(torch, run, 5)
    res["ms_unpruned"] = event_ms(torch, lambda: run(prune=False,
                                                     hoist=False), 2)
    res["ms_no_skip"], res["ms_no_tiles"] = ab_ms(
        torch, lambda: raw(1), lambda: raw(2), 3)
    res["plain_ms"] = event_ms(
        torch, lambda: cp._fused_wvt_reference(*args, **full), 1)
    return res


def check_padded(torch, sp, cp, c, kernel, sb_mode):
    """Padded rows as the count-class engine makes them: the odd receiver
    rows of the cusp ``c`` (``cusp.class_inputs``) as one count class
    (block lists: solve_density, wvt_displacement, fused_wvt) or as
    far-tail rows (superblock lists: solve_density), their ids padded
    with -1 to ``sph.quantize_size`` (rows all -1, counts 0) and run
    through ``sph.run_classed``.  The real rows must agree with the plain
    versions on the exact rows (step 3's tolerances), the padded rows'
    outputs must be finite, and they must be dropped: row 0, whose
    receivers they gather and which is no real id, stays zero.  Returns
    the padded and the real row counts and the kernels held.  The
    two-pass kernels run at ``stream_pair.padded_cluster``'s split, as
    the count-class engine runs them."""
    from toycluster_tpu_torch.models import sph
    from toycluster_tpu_torch.ops import blocks as blk
    from toycluster_tpu_torch.ops.cusp import BOX
    cand, cnt, nb = c["cand"], c["cnt"], c["cand"].shape[0]
    real = torch.arange(1, nb, 2, dtype=torch.int32, device=cand.device)
    ids = sph._pad_ids(real, sph.quantize_size(real.numel(), nb,
                                               -1 if sb_mode else 0))
    pad = ids < 0
    if not bool(pad.any()):
        fail(f"padded rows: {real.numel()} rows of {nb} need no padding")
    idc = torch.clamp(ids, min=0).long()
    rl = real.long()
    desnngb = c["desnngb"]
    pos_t, valid_t, h0, cap, hm = (c[k] for k in ("pos_t", "valid_t", "h0",
                                                  "cap", "hm"))
    dev_kw = dict(kernel=kernel, desnngb=desnngb)
    calls = [
        ("solve_density", lambda i, rows, n: cp.solve_density(
            pos_t, valid_t, rows, pos_t[i], h0[i], cap[i], 1.0, BOX,
            sb_mode=sb_mode, cluster=sp.padded_cluster(rows, sb_mode),
            **dev_kw)[:5],
         lambda: cp._solve_density_reference(
            pos_t, valid_t, cand[rl], pos_t[rl], h0[rl], cap[rl], 1.0,
            BOX, n_sweeps=cp.SOLVE_SWEEPS, sb_mode=sb_mode,
            **dev_kw))]
    if not sb_mode:
        calls += [
            ("wvt_displacement", lambda i, rows, n: (cp.wvt_displacement(
                pos_t, valid_t, c["h_b3"], rows, pos_t[i], hm[i], 1.0,
                BOX, kernel=kernel,
                cluster=sp.padded_cluster(rows, False)),),
             lambda: cp._wvt_displacement_reference(
                pos_t, valid_t, c["h_b3"], cand[rl], pos_t[rl], hm[rl], 1.0,
                BOX, kernel=kernel, sb_mode=False)),
            ("fused_wvt", lambda i, rows, n: cp.fused_wvt(
                pos_t, c["hm_blocks"], rows, n, pos_t[i], h0[i], cap[i],
                hm[i], 1.0, BOX, **dev_kw),
             lambda: cp._fused_wvt_reference(
                pos_t, c["hm_blocks"], cand[rl], cnt[rl], pos_t[rl], h0[rl],
                cap[rl], hm[rl], 1.0, BOX, n_sweeps=cp.FUSED_SWEEPS,
                sb_mode=False, do_disp=True, gdist=None, dkeep=None,
                **dev_kw))]
    tail_rows = torch.where(pad[:, None], -1, cand[idc])
    tail_cnt = torch.where(pad, 0, cnt[idc])
    state = sph.NeighbourState(
        index=blk.BlockIndex(*(torch.zeros((nb, 0), device=cand.device),)
                             * 7),
        cand=blk.CandidateList(idx=cand, count=cnt, overflow=0),
        h_cap=cap.reshape(-1),
        tail=(ids, tail_rows, tail_cnt) if sb_mode else None)
    for name, run, plain in calls:
        raw = []

        def fn(ids_, rows, n, _run=run):
            raw.append(_run(torch.clamp(ids_, min=0).long(), rows, n))
            return raw[-1]
        if sb_mode:
            got = sph.run_classed(state, None, lambda i, r, n: fn(i, r, n),
                                  sels=[])
        else:
            got = sph.run_classed(state, lambda i, r, n, m: fn(i, r, n),
                                  sels=[(cand.shape[1], ids)])
        torch.cuda.synchronize()
        for x in raw[0]:
            if x.is_floating_point() and not bool(
                    torch.isfinite(x[pad]).all()):
                fail(f"{name}: a padded row's output is not finite")
        others = torch.ones(nb, dtype=torch.bool, device=cand.device)
        others[rl] = False
        if not bool(others[0]) or any(bool((x[others] != 0).any())
                                      for x in got):
            fail(f"{name}: a padded row's output was not dropped")
        ref = plain()
        v = c["valid"][rl]
        if name == "wvt_displacement":
            compare_disp(torch, got[0][rl], ref, v, f"padded {name}")
        else:
            do_disp = name == "fused_wvt"
            compare_wvt(torch, tuple(x[rl] for x in got[:5]) + (
                got[5][rl] if do_disp else None,), unpack(ref, do_disp), v,
                desnngb, do_disp, f"padded {name}")
    return ids.numel(), real.numel(), [name for name, _, _ in calls]


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
                f"kernel_ms={r['ms']:.3f} plain_ms={r['plain_ms']:.3f} "
                f"bound_ms={r['bound_ms']:.3f}")
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
                f"plain_ms={r['plain_ms']:.3f} "
                f"bound_ms={r['bound_ms']:.3f}")
            n_pad, n_real, names = check_padded(torch, sp, cp, c, kernel,
                                                sb_mode)
            say(f"cusp 1e5 padded {'far-tail rows' if sb_mode else 'class'}"
                f" kernel={kernel}: {n_real} rows padded to {n_pad}; "
                f"{', '.join(names)} agree with the plain versions, the "
                f"padded rows finite and dropped")


# --------------------------------------------------------------- main path

def check_snapshot(out, n_total, bfld=True):
    """Read the snapshot back: n_total particles, every block finite,
    rho/u/hsml positive on the gas and bfld nonzero on 99% of it (with
    ``bfld=False``: zero on all of it).  Returns the snapshot."""
    from toycluster_tpu_torch.io.gadget import read_snapshot
    import numpy as np
    snap = read_snapshot(str(out))
    n_gas = snap["header"].npart[0]
    if snap["pos"].shape[0] != n_total:
        fail(f"snapshot holds {snap['pos'].shape[0]} particles, not "
             f"{n_total}")
    for k in ("pos", "vel", "ids", "u", "rho", "hsml", "bfld", "rho_model"):
        if not np.isfinite(snap[k]).all():
            fail(f"snapshot block {k} is not finite")
    for k in ("rho", "u", "hsml"):
        if not (snap[k][:n_gas] > 0).all():
            fail(f"snapshot block {k} has non-positive gas values")
    b_set = np.abs(snap["bfld"][:n_gas]).sum(axis=1) > 0
    if bfld and not b_set.mean() > 0.99:
        fail("bfld is zero on more than 1% of the gas")
    if not bfld and b_set.any():
        fail(f"bfld is set on {int(b_set.sum())} gas particles of a run "
             f"without a B field")
    say(f"snapshot: {snap['pos'].shape[0]} particles, {n_gas} gas, finite")
    return snap


def row_name(lib, kw):
    """The kernel record that a call of kernel library ``lib`` with
    keywords ``kw`` counts for: block-list stream_curl and the
    superblock-list calls of the count-class kernels have their own."""
    if lib == "stream_curl":
        return "stream_curl" if kw.get("sb_mode") else "stream_curl_blocks"
    if lib in ("solve_density", "wvt_displacement") and kw.get("sb_mode"):
        return lib + "_sb"
    return lib


_RUN_LOG = None


def run_log():
    """The stage log of the script's runs: one
    ``utils.logging.Records`` (each record a dict of t, stage and fields,
    printed as ``stage_log`` prints it), cleared by ``counted``; every
    run whose records are read logs to it."""
    global _RUN_LOG
    if _RUN_LOG is None:
        from toycluster_tpu_torch.utils.logging import Records
        _RUN_LOG = Records(echo=True)
    return _RUN_LOG


def counted(torch, sp, cp, drive, record=True):
    """``drive()`` with every launch counter (``_kernel_fns``) and the
    stage log's records set to 0 just before; the kernel wrappers (the
    velocity stage's Eddington kernel's too) are patched by name to
    record each kernel's first call's inputs for step 7 (the stream
    engine's stand-alone density solve, do_disp=False, is not recorded;
    with ``record=False``, which keeps a large run's inputs from
    outliving it, CUDA events time each such call on the device instead)
    and to count block-list stream_curl launches and each list mode of
    solve_density and wvt_displacement apart (by the calls' ``sb_mode``:
    the far-tail calls under their ``_sb`` records).  Returns (drive's
    result, launches by record name, launches by kernel, recorded inputs
    (or, by record name, the device ms and list shape of each call), wall
    s, start time)."""
    from toycluster_tpu_torch.models import bfield, sph, velocities, wvt
    from toycluster_tpu_torch.ops import eddington as ed

    recorded, by_name = {}, Counter()

    def recorder(fn, name_of):
        def call(*args, **kw):
            n0 = fn.launches
            name = name_of(kw)
            if name is not None and not record:
                ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
                ev[0].record()
            out = fn(*args, **kw)
            if name is not None:
                by_name[name] += fn.launches - n0
                if record:
                    # the loop's own stats= output is no input
                    recorded.setdefault(name, (args, {
                        k: v for k, v in kw.items() if k != "stats"}))
                else:
                    # the call's (rows, width): its first int32 matrix
                    # (the Eddington kernel's: its knots, (halos, knots))
                    shape = next((tuple(a.shape) for a in args
                                  if torch.is_tensor(a) and a.ndim == 2
                                  and a.dtype == torch.int32),
                                 tuple(args[0].shape))
                    ev[1].record()
                    recorded.setdefault(name, []).append((ev, shape))
            return out
        return call

    patches = [
        (wvt, "stream_wvt", recorder(
            sp.stream_wvt, lambda kw: "stream_wvt"
            if kw.get("do_disp", True) else None)),
        (bfield, "stream_curl", recorder(
            sp.stream_curl, lambda kw: row_name("stream_curl", kw))),
        (wvt, "solve_density", recorder(
            cp.solve_density, lambda kw: row_name("solve_density", kw))),
        (sph, "solve_density", recorder(
            cp.solve_density, lambda kw: row_name("solve_density", kw))),
        (wvt, "wvt_displacement", recorder(
            cp.wvt_displacement, lambda kw: row_name("wvt_displacement",
                                                     kw))),
        (wvt, "fused_wvt", recorder(cp.fused_wvt, lambda kw: "fused_wvt")),
        (velocities, "eddington_integral", recorder(
            ed.eddington_integral, lambda kw: EDDINGTON[0])),
    ]
    saved = [(mod, attr, getattr(mod, attr)) for mod, attr, _ in patches]
    for mod, attr, fn in patches:
        setattr(mod, attr, fn)
    run_log().clear()
    kernels = _kernel_fns()
    for k in kernels:
        k.launches = 0
    t0 = time.perf_counter()
    try:
        result = drive()
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    wall = time.perf_counter() - t0
    if not record:
        torch.cuda.synchronize()
        recorded = {name: [(s.elapsed_time(e), shape)
                           for (s, e), shape in evs]
                    for name, evs in recorded.items()}
    totals = {k.__name__: k.launches for k in kernels}
    launches = dict(totals)
    # the count-class kernels' launches per list mode
    for k in (cp.solve_density, cp.wvt_displacement):
        name = k.__name__
        if by_name[name] + by_name[name + "_sb"] != k.launches:
            fail(f"{name}: {k.launches} launches, {by_name[name]} + "
                 f"{by_name[name + '_sb']} recorded")
        launches[name] = by_name[name]
        launches[name + "_sb"] = by_name[name + "_sb"]
    launches["stream_curl_blocks"] = by_name["stream_curl_blocks"]
    return result, launches, totals, recorded, wall, t0


def report_run(tag, t0, fell=True):
    """Print the stage times (and device memory where the record has it),
    the WVT record and the neighbour contract of the run whose stage-log
    records ``run_log()`` holds; fail unless the contract fraction is
    >= 0.999 and, with ``fell``, err_mean fell to below 0.6 of its first
    value.  Returns the records."""
    from toycluster_tpu_torch.models import sph
    report_stages(tag, t0)
    errs = [r["err_mean"] for r in run_log() if r["stage"] == "wvt"]
    done = [r for r in run_log() if r["stage"] == "wvt_done"]
    builds = [r for r in run_log() if r["stage"] == "wvt_build"]
    retries = [r for r in run_log() if r["stage"] == "wvt_retry"]
    refreshes = [r for r in run_log() if r["stage"] == "wvt_refresh"]
    stamps = [r["t"] for r in run_log() if r["stage"] == "wvt"]
    say(f"[{tag}] wvt err_mean trajectory ({len(errs)} iterations): "
        f"{errs}; wall between iterations, s "
        f"{[round(b - a, 3) for a, b in zip(stamps, stamps[1:])]}")
    say(f"[{tag}] wvt builds {len(builds)}, far-tail rows per build "
        f"{[r.get('tail_rows', 0) for r in builds]}, list widths "
        f"{[r['max_cand'] for r in builds]}, (class, far-tail) shapes "
        f"{[(r.get('classes'), r.get('tail')) for r in builds]}, seconds "
        f"{[round(r['seconds'], 4) for r in builds]}; list refreshes (it, "
        f"width, s) {[(r['it'], r['max_cand'], round(r['seconds'], 4))
                      for r in refreshes]}; retries "
        f"{[(r['it'], r['n_sat']) for r in retries]}")
    if fell and (len(errs) < 2 or not errs[-1] < 0.6 * errs[0]):
        fail(f"err_mean did not fall: {errs}")
    say(f"[{tag}] wvt: {done[0]['iterations']} iterations in "
        f"{done[0]['seconds']:.3f} s = "
        f"{done[0]['particle_updates_per_s']:.6g} particle updates/s; "
        f"iterations queued ahead {done[0]['speculated']}, adopted "
        f"{done[0]['adopted']}, dropped {done[0]['dropped']}; model "
        f"density launches {done[0].get('model_launches')} over "
        f"{done[0].get('model_halos')} halos")
    if ("model_launches" in done[0]
            and not done[0]["model_launches"] >= done[0]["iterations"]):
        fail(f"{tag}: {done[0]['model_launches']} model-density launches "
             f"in {done[0]['iterations']} iterations")
    frac = sph.last_contract_frac
    say(f"[{tag}] neighbour contract fraction {frac}")
    if not frac >= 0.999:
        fail(f"contract fraction {frac} < 0.999")
    return list(run_log())


def report_stages(tag, t0):
    """Print the stage times (and device memory where the record has it)
    of the run that began at t0."""
    for stage, t, dt, rec in stage_spans(run_log(), t0):
        mem = (f"; mem_gib {rec['mem_gib']:.4f} peak_gib "
               f"{rec['peak_gib']:.4f}" if "mem_gib" in rec else "")
        say(f"[{tag}] stage {stage:<16} ends at {t:9.3f} s (+{dt:.3f} s)"
            f"{mem}")


def stage_spans(records, t0):
    """(stage, end, seconds, record) for each stage-log record of a run
    that began at t0; the WVT loop's own records fold into its
    wvt_done."""
    from toycluster_tpu_torch.utils import logging as tlog
    prev = t0 - tlog._T0
    for rec in records:
        if rec["stage"].startswith("wvt") and rec["stage"] != "wvt_done":
            continue
        yield rec["stage"], rec["t"], rec["t"] - prev, rec
        prev = rec["t"]


def timed_halo_loops(torch):
    """Patch the HALO_LOOPS functions to time each call, synchronised
    before and after, and book it to the stage the log records next.
    Returns (book {(record index, name): [calls, s]}, restore)."""
    import importlib
    book, saved = {}, []
    for mod_name, attr in HALO_LOOPS:
        mod = importlib.import_module(f"{PKG}.models.{mod_name}")
        fn = getattr(mod, attr)

        def timed(*args, _fn=fn, _name=attr, **kw):
            torch.cuda.synchronize()
            t = time.perf_counter()
            out = _fn(*args, **kw)
            torch.cuda.synchronize()
            rec = book.setdefault((len(run_log()), _name), [0, 0.0])
            rec[0] += 1
            rec[1] += time.perf_counter() - t
            return out
        saved.append((mod, attr, fn))
        setattr(mod, attr, timed)

    def restore():
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)
    return book, restore


def report_halo_loops(tag, book, records, t0):
    """Print, for each stage, the time of each per-halo function in it
    and its share of the stage."""
    times = Counter()
    for stage, _, dt, _ in stage_spans(records, t0):
        times[stage] += dt
    per_stage = {}
    for (i, name), (calls, sec) in book.items():
        stage = records[i]["stage"] if i < len(records) else "end"
        stage = "wvt_done" if stage.startswith("wvt") else stage
        c = per_stage.setdefault(stage, {}).setdefault(name, [0, 0.0])
        c[0] += calls
        c[1] += sec
    for stage, fns in per_stage.items():
        total = times.get(stage, float("nan"))
        say(f"[{tag}] per-halo work in stage {stage} ({total:.3f} s): " +
            "; ".join(f"{n} {c} calls {sec:.3f} s ({sec / total:.3f} of "
                      f"the stage)" for n, (c, sec) in fns.items()))


def first_call_stats(torch, sp, cp, tag, recorded):
    """Per-row statistics of a run's first stream_wvt call and first
    far-tail solve_density call, from the kernels' stats outputs (these
    launches come after the counted run): sweeps, members or blocks
    listed, kept and walked, and the far-tail call's CTAs a row."""
    if "stream_wvt" in recorded:
        args, kw = recorded["stream_wvt"]
        cand = args[1]
        st = torch.zeros((cand.shape[0], 4), dtype=torch.int32,
                         device=cand.device)
        sp.stream_wvt(*args, **kw, stats=st)
        say(f"[{tag}] first stream_wvt call: rows {cand.shape[0]} width "
            f"{cand.shape[1]}; per row (median, p99, max) sweeps "
            f"{quantiles(torch, st[:, 0])}, members listed "
            f"{quantiles(torch, st[:, 3])}, kept {quantiles(torch, st[:, 1])}"
            f"; kept/listed {int(st[:, 1].sum()) / int(st[:, 3].sum()):.4f}")
    if "solve_density_sb" in recorded:
        args, kw = recorded["solve_density_sb"]
        cand = args[2]
        st = torch.zeros((cand.shape[0], 4), dtype=torch.int32,
                         device=cand.device)
        cp.solve_density(*args, **kw, stats=st)
        say(f"[{tag}] first far-tail solve_density call: rows "
            f"{cand.shape[0]} width {cand.shape[1]}, "
            f"{cp._cluster_size(cand.shape[0], cand.shape[1] * 8, None)} "
            f"CTAs a row; per row (median, p99, max) sweeps "
            f"{quantiles(torch, st[:, 0])}, blocks listed "
            f"{quantiles(torch, st[:, 2])}, kept {quantiles(torch, st[:, 1])}"
            f", walked over all sweeps {quantiles(torch, st[:, 3])}")


def eddington_once(what, launches):
    """Fail unless ``what`` (one make_ics) launched the Eddington kernel
    once: the velocity stage's one integral call for all halos."""
    n = launches[EDDINGTON[0]]
    if n != 1:
        fail(f"{what} launched {EDDINGTON[0]} {n} times, not once")


def check_eddington(torch, call):
    """Step 7's check of the Eddington kernel on the inputs of its call
    in the first config-4 run of step 5 (every halo's knots, m2 and
    energies, stacked): against its plain version on the card on the
    same tensors, each energy within 1e-12 of its terms summed in
    magnitude and the same knots summed, a rerun bit-identical; both
    timed with CUDA events, and the bound: the larger of the fp64
    operations of the terms below their energies over the card's fp64
    peak and the bytes read and written once over the HBM peak."""
    from toycluster_tpu_torch.ops import eddington as ed
    (x, m2, E), _ = call
    got, terms = ed.eddington_integral(x, m2, E)
    again, again_terms = ed.eddington_integral(x, m2, E)
    if not (torch.equal(got, again) and torch.equal(terms, again_terms)):
        fail("eddington_integral: a rerun differs")
    ref, ref_terms = ed._eddington_integral_reference(x, m2, E)
    if not torch.equal(terms, ref_terms):
        fail("eddington_integral: the knots summed differ from the plain "
             "version's")
    # each energy's terms summed in magnitude: 2 |m2_0| sqrt((E - x_0)_+)
    # + 4/3 sum_k |d_k| ((E - x_k)_+)^(3/2)
    mag = []
    for xh, mh, eh in zip(x, m2, E):
        c1 = torch.diff(mh) / torch.diff(xh)
        d = torch.cat([c1[:1], torch.diff(c1)])
        s = torch.clamp(eh[:, None] - xh[None, :-1], min=0.0)
        mag.append(2.0 * mh[0].abs() * torch.sqrt(
            torch.clamp(eh - xh[0], min=0.0))
            + (4.0 / 3.0) * ((s * torch.sqrt(s)) @ d.abs()))
    diff = (got - ref).abs()
    rel = float((diff / torch.stack(mag).clamp(min=1e-300)).max())
    if not rel <= 1e-12:
        fail(f"eddington_integral: {rel:.6g} of the terms summed in "
             f"magnitude from the plain version, above 1e-12")
    ms = event_ms(torch, lambda: ed.eddington_integral(x, m2, E), 20)
    plain_ms = event_ms(
        torch, lambda: ed._eddington_integral_reference(x, m2, E), 5)
    n_terms = int(terms.sum(dtype=torch.int64))
    t_ops = n_terms * OPS_EDDINGTON / PEAK_FP64
    t_bytes = nbytes(x, m2, E, got, terms) / PEAK_HBM
    bound_ms = 1e3 * max(t_ops, t_bytes)
    say(f"eddington_integral: halos={x.shape[0]} knots={x.shape[1]} "
        f"energies={E.shape[1]} terms={n_terms} max_abs_err="
        f"{float(diff.max()):.6g} err_over_magnitude={rel:.6g} "
        f"kernel_ms={ms:.6g} plain_ms={plain_ms:.6g} bound_ms="
        f"{bound_ms:.6g} ({'operations' if t_ops >= t_bytes else 'bytes'})")
    if bound_ms > ms:
        fail(f"eddington_integral: bound {bound_ms} ms above the kernel's "
             f"{ms} ms")
    return dict(err=float(diff.max()), err_over_magnitude=rel, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by="operations" if t_ops >= t_bytes else "bytes")


def check_super_sweep(torch, calls):
    """Step 7's check of the superblock sweep kernel on the inputs of
    ``calls`` ((tag, ``first_sweep``'s args): step 5's first run's first
    sweep and phase A's): its lists, counts and widest count against the
    plain PyTorch sweep's (``blk._super_sweep`` with the top-k) on the
    same tensors to the bit, a rerun bit-identical; both timed with CUDA
    events, and the bound: the larger of OPS_SWEEP fp32 operations a box
    test (rows x superblocks) over the fp32 peak and the bytes read and
    written once over the HBM peak.  Returns the first call's row, the
    second's times as ``*_1e8``."""
    from toycluster_tpu_torch.ops import blocks as blk
    rows = []
    for tag, call in calls:
        if call is None:
            fail(f"super_sweep: {tag} recorded no superblock sweep")
        bi, rec_ids, radius, radius_sym, boxsize, width = call
        args = blk._super_args(bi, rec_ids, radius, radius_sym)

        def kernel():
            return blk.super_sweep(*args, boxsize=boxsize, max_cand=width)

        def plain():
            return blk._super_sweep(*args, boxsize=boxsize, max_cand=width)
        got, again, ref = kernel(), kernel(), plain()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            fail(f"super_sweep: a rerun differs ({tag})")
        if not (torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
                and int(got[2][0]) == int(ref[2])):
            bad = int((got[0] != ref[0]).any(dim=1).sum())
            fail(f"super_sweep: {bad} rows, counts equal "
                 f"{torch.equal(got[1], ref[1])}, differ from the plain "
                 f"sweep's ({tag}, width {width})")
        del again, ref
        t, ns = rec_ids.shape[0], bi.sb_lo.shape[0]
        big = t * ns > 1e9
        ms = event_ms(torch, kernel, 5 if big else 20)
        plain_ms = event_ms(torch, plain, 1 if big else 3)
        bound_ms, by = bound(t * ns * OPS_SWEEP, nbytes(
            bi.bb_lo, bi.bb_hi, bi.sb_lo, bi.sb_hi, rec_ids, radius,
            radius_sym, *got))
        say(f"super_sweep ({tag}): rows={t} superblocks={ns} width={width} "
            f"widest={int(got[2][0])} spilled={int(got[2][1])} "
            f"kernel_ms={ms:.6g} plain_ms={plain_ms:.6g} bound_ms="
            f"{bound_ms:.6g} ({by})")
        if bound_ms > ms:
            fail(f"super_sweep: bound {bound_ms} ms above the kernel's {ms} "
                 f"ms ({tag})")
        rows.append(dict(err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by))
    res = rows[0]
    for key in ("ms", "plain_ms", "bound_ms"):
        res[f"{key}_1e8"] = rows[1][key]
    return res


def check_density_model(torch):
    """Step 7's check of the model-density kernel: config 4's scene at
    5e6 gas lanes and config 5's at 5e7 (``cusp.model_points``), each
    halo's own beta, no cool core, every gas halo: against the plain
    version (the per-halo PyTorch loop) on the card to the bit, a rerun
    bit-identical; both timed with CUDA events, and the bound: the larger
    of OPS_MODEL fp32 operations a lane-halo over the fp32 peak and the
    bytes read and written once over the HBM peak.  Returns config 4's
    row, config 5's times as ``*_1e8``."""
    from toycluster_tpu_torch.models.substructure import setup_substructure
    from toycluster_tpu_torch.ops import cusp
    from toycluster_tpu_torch.ops import density_model as dm
    from toycluster_tpu_torch.particles import halo_arrays_from_scene
    from toycluster_tpu_torch.run_configs import PARS, PRESETS
    from toycluster_tpu_torch.scene import build_scene
    rows = []
    for preset, n in ((4, 5_000_000), (5, 50_000_000)):
        cfg = par_config(**{**PRESETS[preset], "output_file": "unused"},
                         par=PARS.get(preset))
        scene = setup_substructure(build_scene(cfg), seed=cfg.seed + 7)
        ha = halo_arrays_from_scene(scene, "cuda")
        box = scene.boxsize
        halos = dm.gas_halos(ha)
        table = dm.model_table(ha, box, halos)
        pos = cusp.model_points(ha, box, n)

        def kernel():
            return dm.density_model(pos, ha, box, halos=halos, table=table)

        def plain():
            return dm._density_model_reference(pos, ha, box, None, None,
                                               halos)
        got, again, ref = kernel(), kernel(), plain()
        if not torch.equal(got, again):
            fail(f"density_model: a rerun differs (config {preset})")
        if not torch.equal(got, ref):
            ulp = (got.view(torch.int32).long()
                   - ref.view(torch.int32).long()).abs()
            fail(f"density_model: {int((got != ref).sum())} lanes differ "
                 f"from the plain version's, up to {int(ulp.max())} ulp "
                 f"(config {preset}, {n} lanes)")
        del again, ref
        ms = event_ms(torch, kernel, 20)
        plain_ms = event_ms(torch, plain, 3)
        bound_ms, by = bound(n * len(halos) * OPS_MODEL,
                             nbytes(pos, table.tab, got))
        say(f"density_model (config {preset}): lanes={n} halos="
            f"{len(halos)} kernel_ms={ms:.6g} plain_ms={plain_ms:.6g} "
            f"bound_ms={bound_ms:.6g} ({by})")
        if bound_ms > ms:
            fail(f"density_model: bound {bound_ms} ms above the kernel's "
                 f"{ms} ms (config {preset})")
        rows.append(dict(err=0.0, ms=ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, bound_by=by))
        del pos, got
    res = rows[0]
    for key in ("ms", "plain_ms", "bound_ms"):
        res[f"{key}_1e8"] = rows[1][key]
    return res


def run_main_path(torch, sp, cp, tmp, engine):
    """The CLI main path on cuda with ``engine``, counted (``counted``).
    Returns (launches, recorded)."""
    from toycluster_tpu_torch import cli
    par = ROOT / PKG / "data" / "cluster.par"
    out = Path(tmp) / f"IC_{engine}"
    rc, launches, _, recorded, wall, t0 = counted(
        torch, sp, cp, lambda: cli.main([str(par), f"output_file={out}",
                                         "device=cuda", f"engine={engine}"],
                                        log=run_log()))
    if rc != 0:
        fail(f"cli.main returned {rc} (engine={engine})")
    need = (("stream_wvt", "stream_curl", SUPER_SWEEP[0])
            if engine == "stream" else CLASSED_NAMES)
    for name in need:
        if launches[name] <= 0:
            fail(f"the {engine} main path launched {name} no time")
    if engine == "classed" and launches["stream_wvt"] != 0:
        fail("the classed main path launched stream_wvt")
    eddington_once(f"the {engine} main path", launches)
    say(f"main path engine={engine}: wall {wall:.3f} s, launches "
        f"{launches}")
    report_run(engine, t0)
    check_snapshot(out, 1_000_000)
    return launches, recorded


def config4(ntotal, out, **over):
    """The config-4 preset (``run_configs.PRESETS[4]``, the JAX package's
    configs/run_configs.py:29-30, as overrides of the repository's par:
    mass ratio 1/3, Giocoli substructure) at ``ntotal``."""
    from toycluster_tpu_torch.run_configs import PRESETS
    return par_config(**{**PRESETS[4], "ntotal": ntotal,
                         "output_file": str(out), **over})


def check_config4(torch, tag, cfg, engine, scene, parts, totals, t0,
                  fell=True):
    """The checks of a config-4 run: subhalos, particle budgets, the
    engine's kernels launched (``totals``), ``report_run`` (contract
    fraction, err_mean), the pipeline's density audit and a second one on
    512 lanes of subhalo gas <= 5e-3, |B| <= BMAX_SUB on the gas of the
    subhalos past index 1.  Returns the stage-log records."""
    from toycluster_tpu_torch.models.bfield import BMAX_SUB
    from toycluster_tpu_torch.ops.brute import density_at
    from toycluster_tpu_torch.scene import build_scene
    nsub = scene.nhalos - scene.sub_first
    say(f"[{tag}] {scene.nhalos} halos ({nsub} subhalos from index "
        f"{scene.sub_first}), {scene.npart_gas} gas, {scene.npart_dm} DM, "
        f"subhalo gas {sum(h.npart_gas for h in scene.halos[scene.sub_first:])}")
    if not nsub > 0:
        fail(f"{tag}: no subhalos")
    base = build_scene(cfg)
    n_gas = parts.n_gas
    per_halo = torch.bincount(parts.halo[n_gas:].long(),
                              minlength=scene.nhalos).tolist()
    if not (sum(h.npart_gas for h in scene.halos) == base.npart_gas == n_gas
            and sum(h.npart_dm for h in scene.halos) == base.npart_dm
            and per_halo == [h.npart_dm for h in scene.halos]):
        fail(f"{tag}: particle budgets not conserved")
    libs = (("stream_wvt", "stream_curl") if engine == "stream" else
            ("solve_density", "wvt_displacement", "fused_wvt",
             "stream_curl"))
    for name in libs:
        if totals[name] <= 0:
            fail(f"the {tag} run launched {name} no time")
    if engine == "classed" and totals["stream_wvt"] != 0:
        fail(f"the {tag} run launched stream_wvt")
    eddington_once(f"the {tag} run", totals)
    recs = report_run(tag, t0, fell)
    audit = [r for r in recs if r["stage"] == "check_density"]
    if not audit or not audit[0].get("worst_rel_err", 1.0) <= 5e-3:
        fail(f"{tag}: check_density {audit}")
    sub = torch.nonzero(parts.halo[:n_gas] >= scene.sub_first).flatten()
    idx = sub[torch.linspace(0, sub.numel() - 1, min(512, sub.numel()),
                             device=sub.device).long()]
    rho = density_at(parts.pos[idx], parts.hsml[idx], parts.pos[:n_gas],
                     scene.mpart_gas, scene.boxsize, kernel=cfg.sph_kernel,
                     desnngb=cfg.desnngb)
    worst = float(((rho - parts.rho[idx]).abs() / parts.rho[idx]).max())
    say(f"[{tag}] density audits: check_density worst rel err "
        f"{audit[0]['worst_rel_err']} on {audit[0]['n']} gas lanes; "
        f"subhalo gas worst rel err {worst:.6g} on {idx.numel()} lanes")
    if not worst <= 5e-3:
        fail(f"{tag}: subhalo-gas density audit {worst}")
    b = torch.linalg.vector_norm(parts.bfld[parts.halo[:n_gas] > 1], dim=-1)
    if b.numel() and float(b.max()) > BMAX_SUB * (1 + 1e-5):
        fail(f"{tag}: |B| {float(b.max())} > BMAX_SUB on subhalo gas")
    say(f"[{tag}] max |B| on the gas of halos > 1: "
        f"{float(b.max()) if b.numel() else 0.0:.6g} G "
        f"(BMAX_SUB {BMAX_SUB:g}) over {b.numel()} particles")
    return recs


def run_substructure(torch, sp, cp, tmp, engine, ntotal, slow):
    """The config-4 scene at ``ntotal`` through ``make_ics(device="cuda",
    engine=engine, check=True)``, counted (``counted``), with
    SLOW_SUBSTRUCTURE when ``slow``, held to ``check_config4``; the
    snapshot must read back.  A second run of the same scene, without
    the audit and the snapshot, times every call of the per-halo
    functions (``timed_halo_loops``) for their share of each stage.
    Returns the first run's err_mean trajectory, its Eddington call's
    inputs and those of its first superblock sweep (``first_sweep``)."""
    from toycluster_tpu_torch.ops import blocks as blk
    from toycluster_tpu_torch.pipeline import make_ics
    tag = f"config-4 {ntotal:.0e} {engine}"
    out = Path(tmp) / f"IC_sub_{engine}"
    cfg = config4(ntotal, out, report_subhalos=True,
                  slow_substructure=slow)
    torch.cuda.synchronize()
    mem0 = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    sweep, first = blk._find_candidates_super_k, {}
    blk._find_candidates_super_k = first_sweep(torch, sweep, first)
    try:
        (scene, parts), launches, totals, recorded, wall, t0 = counted(
            torch, sp, cp, lambda: make_ics(cfg, device="cuda",
                                            engine=engine, check=True,
                                            log=run_log()))
    finally:
        blk._find_candidates_super_k = sweep
    peak = torch.cuda.max_memory_allocated()
    say(f"[{tag}] slow_substructure={slow}; wall {wall:.3f} s; launches "
        f"{launches}")
    recs = check_config4(torch, tag, cfg, engine, scene, parts, totals, t0)
    first_call_stats(torch, sp, cp, tag, recorded)
    eddington_call = recorded[EDDINGTON[0]]
    del recorded
    say(f"[{tag}] peak device memory {peak / 2**30:.4f} GiB "
        f"({mem0 / 2**30:.4f} GiB held before the run)")
    del parts
    check_snapshot(out, ntotal)
    # the per-halo loops' share of each stage, from a second run whose
    # per-halo calls are each synchronised (its times are not the run's)
    book, restore = timed_halo_loops(torch)
    try:
        _, _, _, recorded, wall, t0 = counted(
            torch, sp, cp, lambda: make_ics(cfg, device="cuda",
                                            engine=engine, write=False,
                                            log=run_log()))
    finally:
        restore()
    del recorded
    say(f"[{tag}] instrumented run (every per-halo call synchronised): "
        f"wall {wall:.3f} s")
    report_halo_loops(f"{tag} instrumented", book, list(run_log()), t0)
    return ([r["err_mean"] for r in recs if r["stage"] == "wvt"],
            eddington_call, first.get("args"))


def read_checkpoint(path):
    """(it, step, err_last) of a WVT checkpoint; fails if it is absent."""
    import numpy as np
    if not Path(path).is_file():
        fail(f"no WVT checkpoint at {path}")
    with np.load(path) as ck:
        return int(ck["it"]), float(ck["step"]), float(ck["err_last"])


def saved_it(recs):
    """The iteration whose end the last checkpoint of a run should hold:
    the last one past which the run moved the gas with (it + 1) a
    multiple of 16 (a stop leaves its iteration unmoved)."""
    its = [r["it"] for r in recs if r["stage"] == "wvt"]
    if any(r.get("reused") for r in recs if r["stage"] == "sph_quantities"):
        its = its[:-1]
    return max((i for i in its if (i + 1) % 16 == 0), default=None)


def kernel_ms_summary(tag, dev_ms):
    """Print each kernel record's device ms a call (CUDA events around
    the wrapper), by list shape (rows, width): the calls' count, mean,
    least, most and sum."""
    for name, calls in dev_ms.items():
        for shape in sorted({sh for _, sh in calls}):
            ms = [m for m, sh in calls if sh == shape]
            say(f"[{tag}] {name} {shape}: {len(ms)} calls, device ms a "
                f"call (CUDA events around the wrapper) mean "
                f"{sum(ms) / len(ms):.3f}, least {min(ms):.3f}, most "
                f"{max(ms):.3f}, sum {sum(ms):.3f}")


def run_large(torch, sp, cp, tmp, engine):
    """Phase A (``engine="stream"``) and A2 (``"classed"``): the config-4
    preset at config 5's size (Ntotal 1e8, 5e7 gas; config 5's own preset
    needs par tags the repository lacks) through ``make_ics(device=
    "cuda", engine=engine, check=True)`` (A also with ``wvt_checkpoint``),
    counted without recording any kernel's inputs (CUDA events time each
    kernel call instead), held to ``check_config4``; the snapshot reads
    back, and A's checkpoint holds the iteration ``saved_it`` names.  At
    5e7 gas the loop parks the particle set (``wvt_offload``): the run
    must log it and its rebuild.  Prints each stage's time and device
    memory, each build's and list refresh's time, widths, shapes,
    searched widths, sweeps and memory, each kernel record's device
    times, the checkpoint saves' times, and the peak device memory
    allocated and reserved, also a gas particle.  On the
    stream engine no build or refresh may grow its search from below a
    width an earlier one of the relaxation reached (the sticky search
    width).  Returns the run's stage-log records and the inputs of its
    first superblock sweep (``first_sweep``: the first build's)."""
    import shutil
    from toycluster_tpu_torch.models import wvt
    from toycluster_tpu_torch.ops import blocks as blk
    from toycluster_tpu_torch.pipeline import make_ics
    ntotal = LARGE_NTOTAL
    tag = f"config-4 {ntotal:.0e} {engine}"
    out = Path(tmp) / "IC_large"
    ck = Path(tmp) / "wvt_large.npz" if engine == "stream" else None
    cfg = config4(ntotal, out)
    say(f"[{tag}] free space for the snapshot in {tmp}: "
        f"{shutil.disk_usage(tmp).free / 2**30:.3f} GiB")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    mem0 = torch.cuda.memory_allocated()
    reserved0 = torch.cuda.memory_reserved()
    sweep = blk._find_candidates_super_k
    first = {}
    blk._find_candidates_super_k = first_sweep(torch, sweep, first)
    try:
        (scene, parts), launches, totals, dev_ms, wall, t0 = counted(
            torch, sp, cp, lambda: make_ics(
                cfg, device="cuda", engine=engine, check=True,
                wvt_checkpoint=None if ck is None else str(ck),
                log=run_log()), record=False)
    finally:
        blk._find_candidates_super_k = sweep
    peak = torch.cuda.max_memory_allocated()
    peak_reserved = torch.cuda.max_memory_reserved()
    say(f"[{tag}] wall {wall:.3f} s; launches {launches}")
    kernel_ms_summary(tag, dev_ms)
    recs = check_config4(torch, tag, cfg, engine, scene, parts, totals, t0)
    n_gas = scene.npart_gas
    offload = [r for r in recs if r["stage"] == "wvt_offload"]
    restore = [r for r in recs if r["stage"] == "wvt_restore"]
    say(f"[{tag}] offload {offload}; restore {restore}")
    if not (wvt.offload_enabled(n_gas) and len(offload) == len(restore)
            == 1):
        fail(f"{tag}: {n_gas} gas, offload records {offload}, restore "
             f"records {restore}")
    builds = [r for r in recs if r["stage"] in ("wvt_build", "wvt_refresh")]
    rows = [(r["stage"], r["it"], round(r["seconds"], 4), r["max_cand"],
             r["searched"], r["sweeps"], r.get("tail_rows"),
             round(r["mem_gib"], 4), round(r["peak_gib"], 4))
            for r in builds]
    say(f"[{tag}] builds and list refreshes (stage, it, s, width, searched "
        f"(first, last), sweeps, far-tail rows, mem_gib, peak_gib): "
        f"{rows}")
    check_search_widths(tag, engine, builds)
    done = [r for r in recs if r["stage"] == "wvt_done"][0]
    say(f"[{tag}] WVT loop {done['seconds']:.6f} s, "
        f"{done['particle_updates_per_s']:.6g} updates/s; builds "
        f"{len([r for r in builds if r['stage'] == 'wvt_build'])} in "
        f"{sum(r['seconds'] for r in builds if r['stage'] == 'wvt_build'):.3f}"
        f" s, list refreshes "
        f"{len([r for r in builds if r['stage'] == 'wvt_refresh'])} in "
        f"{sum(r['seconds'] for r in builds if r['stage'] == 'wvt_refresh'):.3f}"
        f" s")
    if ck is not None:
        saves = [r for r in recs if r["stage"] == "wvt_checkpoint"]
        say(f"[{tag}] checkpoint saves (it, s): "
            f"{[(r['it'], round(r['seconds'], 4)) for r in saves]}")
        it, step, _ = read_checkpoint(ck)
        if saved_it(recs) is None or it != saved_it(recs):
            fail(f"{tag}: checkpoint holds it = {it}, expected "
                 f"{saved_it(recs)}")
        say(f"[{tag}] checkpoint holds it = {it}, step = {step}")
        ck.unlink()
    say(f"[{tag}] peak device memory {peak / 2**30:.4f} GiB allocated "
        f"({mem0 / 2**30:.4f} GiB held before the run), "
        f"{peak / n_gas:.1f} B a gas particle; {peak_reserved / 2**30:.4f} "
        f"GiB reserved ({reserved0 / 2**30:.4f} GiB before), "
        f"{peak_reserved / n_gas:.1f} B a gas particle")
    del parts
    check_snapshot(out, ntotal)
    out.unlink()
    return recs, first.get("args")


def first_sweep(torch, sweep, first):
    """``blk._find_candidates_super_k`` that keeps the inputs of its first
    call in ``first["args"]`` (the box fields of its block index, the
    rows, radii, box size and list width), copied, then calls
    ``sweep``."""
    from toycluster_tpu_torch.ops import blocks as blk

    def call(bi, rec_ids, radius, radius_sym, boxsize, max_cand, *rest):
        if "args" not in first:
            none = bi.bb_lo.new_empty((0,))
            first["args"] = (
                blk.BlockIndex(order=none, pos=none, valid=none,
                               bb_lo=bi.bb_lo.clone(),
                               bb_hi=bi.bb_hi.clone(),
                               sb_lo=bi.sb_lo.clone(),
                               sb_hi=bi.sb_hi.clone()),
                rec_ids.clone(), radius.clone(), radius_sym.clone(),
                boxsize, max_cand)
        return sweep(bi, rec_ids, radius, radius_sym, boxsize, max_cand,
                     *rest)
    return call


def check_search_widths(tag, engine, builds):
    """The sticky search width of a stream relaxation: no build or list
    refresh (``wvt_build`` / ``wvt_refresh`` records, in order) grows its
    search from a first width below the last width an earlier one
    reached, so none sweeps twice at a width the relaxation reached
    before.  Prints the calls that grew."""
    if engine != "stream":
        return
    reached, grew = 0, []
    for r in builds:
        first, last = r["searched"]
        if first < last:
            grew.append((r["stage"], r["it"], r["searched"], r["sweeps"]))
            if first < reached:
                fail(f"{tag}: {r['stage']} at it = {r['it']} searched "
                     f"{r['searched']} after an earlier call reached "
                     f"{reached}")
        reached = max(reached, last)
    say(f"[{tag}] searches that grew (stage, it, searched, sweeps): {grew}; "
        f"none grew from below a width reached before")


class _Handed(Exception):
    """Raised where the offload gate takes the particle set that
    ``make_ics`` hands its WVT loop."""


# the offload gate's depth: its two loops stop after iteration 1 (a
# build, then a list refresh)
OFFLOAD_GATE_ITER = 1
# the fields the offload gate holds to the bit, and the most device
# memory at the first build that the offload must save at 5e7 gas, GiB
OFFLOAD_GATE_FIELDS = ("pos", "rho", "hsml", "pid", "halo")
OFFLOAD_GATE_GIB = 2.0


def run_offload_gate(torch):
    """Phase A's offload gate: the particle set that ``make_ics`` hands
    its WVT loop on phase A's scene (config 4 at Ntotal 1e8, 5e7 gas,
    stream engine) is kept in host memory, then relaxed twice from it
    through the holder, to wvt_max_iter OFFLOAD_GATE_ITER: with
    TOYCLUSTER_WVT_OFFLOAD_N above 5e7 (offload off), then at its
    default (on).  The two must give the same bits for
    OFFLOAD_GATE_FIELDS, and the device memory at the first build
    (``wvt_build``'s ``mem_gib``) must be at least OFFLOAD_GATE_GIB lower
    with the offload.  Returns {offload: first build's mem_gib}."""
    import os
    from toycluster_tpu_torch.models import wvt
    from toycluster_tpu_torch.particles import Particles
    from toycluster_tpu_torch.pipeline import make_ics
    tag = f"offload gate, config-4 {LARGE_NTOTAL:.0e} stream"
    cfg = config4(LARGE_NTOTAL, "unused", wvt_max_iter=OFFLOAD_GATE_ITER)
    handed, regularise = {}, wvt.regularise_sph_particles

    def hand(scene, ha, holder, **kw):
        parts = holder.pop()
        handed.update(scene=scene, ha=ha, host={
            f: getattr(parts, f).cpu() for f in parts.__dataclass_fields__})
        raise _Handed

    wvt.regularise_sph_particles = hand
    try:
        make_ics(cfg, device="cuda", write=False)
    except _Handed:
        pass
    finally:
        wvt.regularise_sph_particles = regularise
    if "host" not in handed:
        fail(f"{tag}: make_ics did not hand its particle set over")
    mem, got = {}, {}
    try:
        for on in (False, True):
            if on:
                os.environ.pop("TOYCLUSTER_WVT_OFFLOAD_N", None)
            else:
                os.environ["TOYCLUSTER_WVT_OFFLOAD_N"] = str(
                    2 * handed["scene"].npart_gas)
            holder = [Particles(**{f: x.to("cuda")
                                   for f, x in handed["host"].items()})]
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            mem0 = torch.cuda.memory_allocated()
            run_log().clear()
            t = time.perf_counter()
            parts, _ = wvt.regularise_sph_particles(
                handed["scene"], handed["ha"], holder, engine="stream",
                log=run_log())
            wall = time.perf_counter() - t
            recs = list(run_log())
            build = [r for r in recs if r["stage"] == "wvt_build"][0]
            offload = [r for r in recs if r["stage"] == "wvt_offload"]
            restore = [r for r in recs if r["stage"] == "wvt_restore"]
            if bool(offload) != on or bool(restore) != on:
                fail(f"{tag}: offload {on}, yet records {offload} "
                     f"{restore}")
            mem[on] = build["mem_gib"]
            say(f"[{tag}] offload {'on' if on else 'off'}: relaxation "
                f"{wall:.3f} s; {mem0 / 2**30:.4f} GiB allocated before, "
                f"first build mem_gib {build['mem_gib']:.4f} peak_gib "
                f"{build['peak_gib']:.4f}; offload {offload}; restore "
                f"{restore}")
            got[on] = {f: getattr(parts, f).cpu()
                       for f in OFFLOAD_GATE_FIELDS}
            del parts
    finally:
        os.environ.pop("TOYCLUSTER_WVT_OFFLOAD_N", None)
    for f in OFFLOAD_GATE_FIELDS:
        if not torch.equal(got[True][f], got[False][f]):
            fail(f"{tag}: {f} differs with the offload on and off")
    saved = mem[False] - mem[True]
    say(f"[{tag}] {', '.join(OFFLOAD_GATE_FIELDS)} the same to the bit; "
        f"the offload saved {saved:.4f} GiB at the first build "
        f"({saved * 2**30 / handed['scene'].npart_gas:.1f} B a gas "
        f"particle)")
    if not saved >= OFFLOAD_GATE_GIB:
        fail(f"{tag}: the offload saved {saved:.4f} GiB at the first build, "
             f"less than {OFFLOAD_GATE_GIB}")
    return mem


def run_resume(torch, sp, cp, tmp):
    """Phase B: WVT checkpoint -> resume on engine=classed, config 4 at
    Ntotal 1e7.  Run 1 stops at wvt_max_iter 16 and must leave it = 15
    in a fresh checkpoint; run 2, the default wvt_max_iter with the same
    checkpoint, the density audit and ``profile_dir``, must resume at
    it = 16 with the saved step, pass ``check_config4`` but for the fall
    of err_mean, end with err_mean <= the file's err_last, and write a
    trace that parses and names a count-class kernel."""
    from toycluster_tpu_torch.pipeline import make_ics
    ntotal = RESUME_NTOTAL
    tag = f"config-4 {ntotal:.0e} classed"
    ck = Path(tmp) / "wvt_resume.npz"
    prof = Path(tmp) / "profile"
    cfg = config4(ntotal, Path(tmp) / "IC_resume", wvt_max_iter=16)
    _, launches, _, _, wall, t0 = counted(
        torch, sp, cp, lambda: make_ics(cfg, device="cuda", engine="classed",
                                        write=False, wvt_checkpoint=str(ck),
                                        log=run_log()),
        record=False)
    say(f"[{tag} run 1, wvt_max_iter=16] wall {wall:.3f} s; launches "
        f"{launches}")
    report_run(f"{tag} run 1", t0)
    it, step, err_last = read_checkpoint(ck)
    if it != 15:
        fail(f"{tag}: run 1 left it = {it} in its checkpoint, not 15")
    say(f"[{tag} run 1] checkpoint it = {it}, step = {step}, err_last = "
        f"{err_last}")
    cfg = config4(ntotal, Path(tmp) / "IC_resume")
    (scene, parts), launches, totals, _, wall, t0 = counted(
        torch, sp, cp, lambda: make_ics(
            cfg, device="cuda", engine="classed", check=True, write=False,
            wvt_checkpoint=str(ck), profile_dir=str(prof),
            log=run_log()), record=False)
    resumed = [r for r in run_log() if r["stage"] == "wvt_resume"]
    say(f"[{tag} run 2, resumed] wall {wall:.3f} s; launches {launches}; "
        f"{resumed}")
    if not (len(resumed) == 1 and resumed[0]["it"] == 16
            and resumed[0]["step"] == step):
        fail(f"{tag}: run 2 logged {resumed}, not it = 16, step = {step}")
    recs = check_config4(torch, f"{tag} run 2", cfg, "classed", scene, parts,
                         totals, t0, fell=False)
    # the stage log rounds err_mean to 5 digits
    errs = [r["err_mean"] for r in recs if r["stage"] == "wvt"]
    if not errs[-1] <= round(err_last, 5):
        fail(f"{tag}: run 2 ended at err_mean {errs[-1]} > the "
             f"checkpoint's err_last {err_last}")
    trace = prof / "wvt_trace.json"
    size = trace.stat().st_size
    with open(trace) as fh:
        names = {e.get("name", "") for e in json.load(fh)["traceEvents"]}
    kernels = sorted(n for n in names
                     if "fused_wvt" in n or "solve_density" in n)
    if not kernels:
        fail(f"{tag}: the trace of run 2 names no count-class kernel")
    say(f"[{tag} run 2] trace {size / 2**20:.1f} MiB, {len(names)} names, "
        f"count-class kernels {kernels}")
    trace.unlink()
    ck.unlink()


def time_on_main_path_inputs(torch, sp, cp, recorded, parent=None,
                             tag="main-path"):
    """Kernel vs plain on the inputs of each kernel's first main-path
    call (of each record in ``recorded``): agreement, CUDA-event times
    and bounds.  These launches come after the counted runs.  With
    ``parent`` (ParentKernels) the fused_wvt and stream_curl records also
    time its kernels."""
    res = {}
    if "stream_wvt" in recorded:
        args, kw = recorded["stream_wvt"]
        res["stream_wvt"] = check_wvt(
            torch, sp, args, kw, (args[0][:, 3, :] > 0),
            f"{tag} rows={args[1].shape[0]} width={args[1].shape[1]}:")
    # receiver lanes with a nonzero wfac are the curl's valid ones; the
    # count-class operators are held on every receiver lane
    for name, check, cand_arg, valid_of in (
            ("stream_wvt", None, 1, None),
            ("stream_curl", check_curl, 1, lambda a: a[5] != 0),
            ("stream_curl_blocks", check_curl, 1, lambda a: a[5] != 0),
            ("solve_density", check_solve, 2,
             lambda a: torch.ones_like(a[4], dtype=torch.bool)),
            ("solve_density_sb", check_solve, 2,
             lambda a: torch.ones_like(a[4], dtype=torch.bool)),
            ("wvt_displacement", check_disp, 3,
             lambda a: torch.ones_like(a[5], dtype=torch.bool)),
            ("wvt_displacement_sb", check_disp, 3,
             lambda a: torch.ones_like(a[5], dtype=torch.bool)),
            ("fused_wvt", check_fused, 2,
             lambda a: torch.ones_like(a[5], dtype=torch.bool))):
        if name not in recorded:
            continue
        args, kw = recorded[name]
        if check is check_curl:
            res[name] = check(torch, sp, args, kw, valid_of(args), parent)
        elif check is check_fused:
            res[name] = check(torch, sp, cp, args, kw, valid_of(args),
                              parent)
        elif check is not None:
            res[name] = check(torch, sp, cp, args, kw, valid_of(args))
        cand = args[cand_arg]
        r = res[name]
        extra = "".join(f" {k}={r[k]:.6g}" for k in EXTRA_KEYS[1:]
                        if k in r)
        say(f"{tag} {name}: rows={cand.shape[0]} width={cand.shape[1]} "
            f"sb_mode={kw.get('sb_mode', name == 'stream_wvt')} "
            f"max_err={r['err']:.6g} kernel_ms={r['ms']:.6g} "
            f"plain_ms={r['plain_ms']:.6g} bound_ms={r['bound_ms']:.6g} "
            f"({r['bound_by']}){extra}")
        if r["bound_ms"] > r["ms"]:
            fail(f"{name}: bound {r['bound_ms']} ms above the kernel's "
                 f"{r['ms']} ms")
    return res


# ------------------------------------------------ step 8: the sharded path

# (tag, Config overrides of the par, make_ics engine, halo, first step)
# of the two-rank gloo runs on one card (B, C, D) and of the one-rank
# NCCL run (A); the config-4 runs at step 5's full size
SHARDED_NTOTAL = 10_000_000
SHARDED_GLOO = (("B", "config4", "stream", None, True),
                ("C-ring", "par", "stream", None, False),
                ("C-gather", "par", "stream", "gather", False),
                ("D", "par", "classed", None, False))
SHARDED_NCCL = (("A", "config4", "stream", None, True),)
SHARD_TIMEOUT = 600
# the runs whose first sharded-loop call of each kernel rank 0 records
# (B: ring-filled sources; D: the xla engine's block lists), and the rows
# of such a call held against the plain version: 3 in 4 of them rows whose
# lists name remote sources, the rest rows with local sources alone
RECORDED_RUNS = ("B", "D")
SHARDED_CHECK_ROWS = 1024
# E's list width: the stand-alone stages raise on list overflow, and rows
# of the 1e6 par list more than the JAX default's 256 blocks (the card,
# PR 8); 4096 exceeds its 3,907 blocks, so no row can overflow
E_MAX_CAND = 4096


def _kernel_fns():
    from toycluster_tpu_torch.ops import blocks as blk
    from toycluster_tpu_torch.ops import class_pair as cp
    from toycluster_tpu_torch.ops import density_model as dm
    from toycluster_tpu_torch.ops import eddington as ed
    from toycluster_tpu_torch.ops import stream_pair as sp
    return (sp.stream_wvt, sp.stream_curl, cp.solve_density,
            cp.wvt_displacement, cp.fused_wvt, ed.eddington_integral,
            blk.super_sweep, dm.density_model)


def _launch_counts():
    return {k.__name__: k.launches for k in _kernel_fns()}


def _row_counting(torch, mod, attrs, rows, calls=None):
    """Patch the kernel wrappers ``attrs`` that module ``mod`` calls so
    that each call adds its launches to ``rows`` under its kernel record
    (``row_name``) and, with ``calls``, keeps a copy of the first call of
    each record's inputs there.  Returns the function that restores
    them."""
    from toycluster_tpu_torch.ops import class_pair as cp
    from toycluster_tpu_torch.ops import stream_pair as sp
    saved = []
    for attr in attrs:
        fn = getattr(sp if attr.startswith("stream") else cp, attr)

        def call(*args, _fn=fn, _lib=attr, **kw):
            n0 = _fn.launches
            out = _fn(*args, **kw)
            name = row_name(_lib, kw)
            rows[name] += _fn.launches - n0
            if calls is not None and name not in calls:
                calls[name] = ([a.clone() if torch.is_tensor(a) else a
                                for a in args], dict(kw))
            return out
        saved.append((attr, getattr(mod, attr)))
        setattr(mod, attr, call)

    def restore():
        for attr, fn in saved:
            setattr(mod, attr, fn)
    return restore


def _sharded_run(mesh, tmp, tag, scene_name, engine, halo, first_step):
    """One ``make_ics(mesh=mesh, check=True)`` on this rank, with the
    collectives timed and every launch counter set to 0 just before.
    ``wvt_shard.regularise_sharded`` is wrapped to count the launches of
    the sharded loop alone, by kernel record, to force ``halo``, to save
    the loop's output (``<tag>_wvt.npz``) and, with ``first_step``, the
    first sharded step (a fresh ``sharded_wvt_iteration`` call on the
    loop's input, ``<tag>_first.npz``), on rank 0; in RECORDED_RUNS rank
    0 also saves the first loop call of each kernel record
    (``<tag>_<record>_call.pt``)."""
    import numpy as np
    import torch
    from toycluster_tpu_torch.models import sph
    from toycluster_tpu_torch.parallel import wvt_shard
    from toycluster_tpu_torch.pipeline import make_ics
    from toycluster_tpu_torch.utils import logging as tlog
    out = Path(tmp) / f"IC_{tag}"
    cfg = (config4(SHARDED_NTOTAL, out) if scene_name == "config4" else
           config_par(out))
    loop = Counter()
    orig = wvt_shard.regularise_sharded

    def save(name, **arrays):
        if mesh.rank == 0:
            np.savez(Path(tmp) / f"{tag}_{name}.npz",
                     **{k: v.cpu().numpy() if torch.is_tensor(v) else v
                        for k, v in arrays.items()})

    def relax(mesh_, ha, pos_gas, **kw):
        if halo is not None:
            kw["halo"] = halo
        if first_step:
            pos, n_real = wvt_shard.pad_for_mesh(pos_gas, mesh_.size)
            eng = wvt_shard.sharded_wvt_iteration(
                mesh_, ha, n_real=n_real, boxsize=kw["boxsize"],
                mpart=kw["mpart"], desnngb=kw["desnngb"],
                kernel=kw["kernel"], cool_core=kw["cool_core"],
                engine=kw["engine"], halo=kw.get("halo", "auto"))
            st = eng(pos, torch.zeros_like(pos[:, 0]), kw["step"])
            save("first", pos0=pos_gas, pos=st.pos[:n_real],
                 rho=st.rho[:n_real], hsml=st.hsml[:n_real],
                 err_mean=float(st.err_mean))
            del st, eng
        mesh_.collective_stats()
        calls = {} if tag in RECORDED_RUNS and mesh_.rank == 0 else None
        restore = _row_counting(torch, wvt_shard, (
            "stream_wvt", "solve_density", "wvt_displacement"), loop, calls)
        try:
            res = orig(mesh_, ha, pos_gas, **kw)
        finally:
            restore()
        torch.cuda.synchronize()
        save("wvt", pos=res[0], rho=res[1], hsml=res[2])
        for name, call in (calls or {}).items():
            torch.save(call, Path(tmp) / f"{tag}_{name}_call.pt")
        return res

    logs = []

    def log(stage, **kw):
        logs.append({"t": time.perf_counter(), "stage": stage,
                     **{k: v for k, v in kw.items() if tlog._jsonable(v)}})

    for k in _kernel_fns():
        k.launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wvt_shard.regularise_sharded = relax
    t0 = time.perf_counter()
    try:
        scene, parts = make_ics(cfg, device=mesh.device, engine=engine,
                                check=True, mesh=mesh, log=log)
    finally:
        wvt_shard.regularise_sharded = orig
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if tag == "C-ring":
        # the stages' inputs (E): the relaxed gas and its solved fields
        n_gas = parts.n_gas
        save("stages_in", pos=parts.pos[:n_gas], hsml=parts.hsml[:n_gas],
             rho=parts.rho[:n_gas], vf=parts.var_hsml_fac[:n_gas],
             apot=parts.apot[:n_gas], boxsize=scene.boxsize,
             mpart=scene.mpart_gas, desnngb=cfg.desnngb,
             kernel=cfg.sph_kernel,
             **halo_arrays_of(scene, mesh.device))
    return dict(tag=tag, rank=mesh.rank, wall=wall, logs=logs,
                launches=_launch_counts(), loop_launches=dict(loop),
                contract=sph.last_contract_frac, n_total=scene.ntotal,
                n_gas=parts.n_gas, out=str(out),
                peak_gib=torch.cuda.max_memory_allocated(mesh.device) / 2**30)


def halo_arrays_of(scene, device):
    """The scene's HaloArrays fields, as ``ha_<field>`` tensors."""
    import dataclasses
    from toycluster_tpu_torch.particles import halo_arrays_from_scene
    ha = halo_arrays_from_scene(scene, device)
    return {f"ha_{f.name}": getattr(ha, f.name)
            for f in dataclasses.fields(ha)}


def config_par(out):
    """The repository's par as it is (Ntotal 1e6, WC6, B field on)."""
    return par_config(output_file=str(out))


def _sharded_stages(mesh, tmp):
    """E on this rank: ``sharded_density`` (warm-started from the solved
    hsml) and ``sharded_curl`` on the relaxed gas of C-ring, counted by
    kernel record; rank 0 saves the results as ``E_ws<size>.npz``."""
    import numpy as np
    import torch
    from toycluster_tpu_torch.from_reference import halo_arrays_from_numpy
    from toycluster_tpu_torch.parallel import stages
    with np.load(Path(tmp) / "C-ring_stages_in.npz") as f:
        d = {k: f[k] for k in f.files}
    dev = mesh.device
    ha = halo_arrays_from_numpy({k[3:]: v for k, v in d.items()
                                 if k.startswith("ha_")}, dev)
    t = {k: torch.as_tensor(d[k], device=dev)
         for k in ("pos", "hsml", "rho", "vf", "apot")}
    kw = dict(boxsize=float(d["boxsize"]), mpart=float(d["mpart"]),
              kernel=str(d["kernel"]), max_cand=E_MAX_CAND)
    for k in _kernel_fns():
        k.launches = 0
    rows = Counter()
    restore = _row_counting(torch, stages, ("solve_density", "stream_curl"),
                            rows)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        rho, hsml, vf, wk = stages.sharded_density(
            mesh, ha, t["pos"], t["hsml"], desnngb=int(d["desnngb"]), **kw)
        b, bmax = stages.sharded_curl(mesh, t["pos"], t["hsml"], t["rho"],
                                      t["vf"], t["apot"], **kw)
        torch.cuda.synchronize()
    finally:
        restore()
    wall = time.perf_counter() - t0
    if mesh.rank == 0:
        np.savez(Path(tmp) / f"E_ws{mesh.size}.npz",
                 **{k: v.cpu().numpy() for k, v in dict(
                     rho=rho, hsml=hsml, vf=vf, wk=wk, b=b, bmax=bmax).items()})
    return dict(tag="E", rank=mesh.rank, wall=wall,
                launches=_launch_counts(), stage_launches=dict(rows))


def rank_step8(mesh, tmp, runs, stages_too):
    """The runs of step 8 on one rank, then (``stages_too``) E."""
    mesh.timing = True
    out = [_sharded_run(mesh, tmp, *run) for run in runs]
    if stages_too:
        mesh.timing = False
        out.append(_sharded_stages(mesh, tmp))
    return out


def _close(name, a, b, rtol, atol=0.0):
    import numpy as np
    err = np.abs(a - b) - (atol + rtol * np.abs(b))
    if not (err <= 0).all():
        fail(f"{name}: {(err > 0).sum()} of {err.size} values beyond rtol "
             f"{rtol} atol {atol}")
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(b), 1e-30)))


def _mostly_close(name, diff, limit, share=0.98):
    """Fail unless diff <= limit on at least ``share`` of the values;
    returns diff's (median, p99, max) over the values."""
    import numpy as np
    q = tuple(float(x) for x in np.quantile(diff, (0.5, 0.99, 1.0)))
    if not np.mean(diff <= limit) >= share:
        fail(f"{name}: within {limit} on {np.mean(diff <= limit):.6f} of "
             f"{diff.size} values, under {share} (median, p99, max {q})")
    return q


def report_sharded(tag, ranks):
    """Print a sharded run's numbers and check it: the loop's kernels
    (launch counters of the ranks summed, by kernel record), the contract
    fraction >= 0.999 on the loop's last solve and on every rank's final
    solve, no candidate-list or ring overflow, the density audit <= 5e-3,
    the snapshot.  Returns (loop launches by record, run launches by
    kernel, the wvt_shard records)."""
    first = ranks[0]
    logs = first["logs"]
    loop = Counter()
    total = Counter()
    for r in ranks:
        loop.update(r["loop_launches"])
        total.update(r["launches"])
    shard = [r for r in logs if r["stage"] == "wvt_shard"]
    done = [r for r in logs if r["stage"] == "wvt_shard_done"][0]
    ring = [r for r in logs if r["stage"] == "wvt_shard_ring"]
    comm = [r for r in logs if r["stage"] == "wvt_shard_comm"]
    builds = [r for r in logs if r["stage"] == "wvt_shard_build"]
    audit = [r for r in logs if r["stage"] == "check_density"]
    say(f"[{tag}] world size {len(ranks)}: wall {first['wall']:.3f} s; "
        f"launches (ranks summed) in the sharded loop by record "
        f"{dict(loop)}, in the whole run by kernel {dict(total)}")
    say(f"[{tag}] wvt_shard: {done['iterations']} iterations in "
        f"{done['seconds']:.3f} s = {done['particle_updates_per_s']:.6g} "
        f"particle updates/s; err_mean {[r['err_mean'] for r in shard]}; "
        f"overflow {[r['overflow'] for r in shard]}; builds at "
        f"{[(r['it'], r['overflow']) for r in builds]}; contract fraction "
        f"of the last iteration {done['contract_frac']:.6f}")
    if ring:
        say(f"[{tag}] ring buffer fill (it, largest fill over the ranks, "
            f"slots R): {[(r['it'], r['fill'], r['slots']) for r in ring]}")
    if comm:
        host = [r["host_s"] for r in comm]
        ms = [r["device_ms"] or 0.0 for r in comm]
        say(f"[{tag}] rank 0 collectives per iteration: "
            f"{comm[0]['collectives']} calls; host s {host}; device ms "
            f"(CUDA events) {ms}; mean host {sum(host) / len(host):.6f} s, "
            f"device {sum(ms) / len(ms):.6f} ms")
    say(f"[{tag}] peak device memory per rank GiB "
        f"{[round(r['peak_gib'], 4) for r in ranks]}; final contract "
        f"fraction per rank {[r['contract'] for r in ranks]}; audit "
        f"{audit}")
    if not done["contract_frac"] >= 0.999:
        fail(f"{tag}: the sharded loop's contract {done['contract_frac']} "
             f"< 0.999")
    for r in ranks:
        if not r["contract"] >= 0.999:
            fail(f"{tag} rank {r['rank']}: contract {r['contract']} < 0.999")
    over = [r["overflow"] for r in shard + builds if r["overflow"] > 0]
    if over:
        fail(f"{tag}: list or ring overflow {over}")
    if not audit or not audit[0].get("worst_rel_err", 1.0) <= 5e-3:
        fail(f"{tag}: check_density {audit}")
    check_snapshot(first["out"], first["n_total"])
    Path(first["out"]).unlink()
    return loop, total, shard


def _check_rows(torch, cand, n_local):
    """SHARDED_CHECK_ROWS rows of a sharded call, spread evenly: 3 in 4
    of them among the rows whose lists name a source slot >= n_local
    (ring buffer or another rank's blocks), the rest among the others."""
    remote = (cand >= n_local).any(dim=1)
    picked = []
    for mask, k in ((remote, 3 * SHARDED_CHECK_ROWS // 4),
                    (~remote, SHARDED_CHECK_ROWS // 4)):
        ids = torch.nonzero(mask).flatten()
        if ids.numel():
            sel = torch.linspace(0, ids.numel() - 1, min(k, ids.numel()),
                                 device=ids.device).long()
            picked.append(ids[sel])
    rows = torch.unique(torch.cat(picked))
    return rows, int(remote.sum())


def check_sharded_calls(torch, sp, cp, tmp):
    """The recorded first sharded-loop calls of B and D, launched here on
    their full inputs and held against the plain version on the rows of
    ``_check_rows`` with step 3's tolerances.  Returns {record: (max
    error against the plain version, kernel ms on the full call)}."""
    res = {}
    for tag, name, cand_arg in (("B", "stream_wvt", 1),
                                ("D", "solve_density", 2),
                                ("D", "wvt_displacement", 3)):
        path = Path(tmp) / f"{tag}_{name}_call.pt"
        if not path.exists():
            fail(f"{tag}: no sharded {name} call was recorded")
        args, kw = torch.load(path, map_location="cuda")
        path.unlink()
        cand = args[cand_arg]
        nbl = cand.shape[0]
        if name == "stream_wvt":
            # superblock slots: the local ones, then the ring's buffer
            # and its dump slot
            n_local = nbl // 8
            row_args = range(1, 7)
            valid_all = args[0][:nbl, 3, :] > 0
        else:
            n_local = nbl
            row_args = range(2, 6) if name == "solve_density" else \
                range(3, 6)
            valid_all = args[1][:nbl, 0, :] > 0.5
        rows, n_remote = _check_rows(torch, cand, n_local)
        sub = list(args)
        for i in row_args:
            sub[i] = args[i][rows].contiguous()
        valid = valid_all[rows]
        t0 = time.perf_counter()
        if name == "stream_wvt":
            full = sp.stream_wvt(*args, **kw)
            got = tuple(None if x is None else x[rows] for x in full)
            ref = sp._stream_wvt_reference(*sub, n_sweeps=sp.N_SWEEPS, **kw)
            err = compare_wvt(torch, got, ref, valid, kw["desnngb"],
                              kw.get("do_disp", True), f"{tag} {name}")
            ms = event_ms(torch, lambda: sp.stream_wvt(*args, **kw), 3)
        elif name == "solve_density":
            full = cp.solve_density(*args, **kw)
            got = tuple(x[rows] for x in full)
            plain_kw = dict(kernel=kw["kernel"], desnngb=kw["desnngb"],
                            sb_mode=kw.get("sb_mode", False))
            ref = unpack(cp._solve_density_reference(
                *sub, n_sweeps=kw.get("n_sweeps", cp.SOLVE_SWEEPS),
                **plain_kw), False)
            err = compare_wvt(torch, got, ref, valid, kw["desnngb"], False,
                              f"{tag} {name}")
            ms = event_ms(torch, lambda: cp.solve_density(*args, **kw), 3)
        else:
            got = cp.wvt_displacement(*args, **kw)[rows]
            ref = cp._wvt_displacement_reference(
                *sub, kernel=kw["kernel"], sb_mode=kw.get("sb_mode", False))
            err = compare_disp(torch, got, ref, valid, f"{tag} {name}")
            ms = event_ms(torch, lambda: cp.wvt_displacement(*args, **kw), 3)
        say(f"[{tag} sharded {name}] first loop call on rank 0: "
            f"{args[0].shape[0]} source blocks for {nbl} receiver blocks, "
            f"list width {cand.shape[1]}, {n_remote} rows naming remote "
            f"sources; kernel {ms:.6g} ms on the full call; against the "
            f"plain version on {rows.numel()} rows: max_err {err:.6g} "
            f"({time.perf_counter() - t0:.3f} s)")
        res[name] = (err, ms)
    return res


def run_sharded(torch, sp, cp, tmp, single_card_errs):
    """Step 8: the sharded path (``parallel/``) on the card: B, C, D and
    E's two-rank half under gloo, two ranks sharing cuda:0; then A and
    E's one-rank half under NCCL.  ``single_card_errs`` is step 5's
    err_mean trajectory of A's scene.  Returns (the sharded loops'
    launches by kernel record, E's launches by kernel record, both summed
    over runs and ranks; ``check_sharded_calls``'s results)."""
    import numpy as np
    from toycluster_tpu_torch.parallel.mesh import spawn
    # the ranks share the card with this process: hand back its cache
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    gloo = spawn(rank_step8, 2, backend="gloo", device="cuda",
                 timeout_s=SHARD_TIMEOUT, args=(tmp, SHARDED_GLOO, True))
    t0 = phase("8: world size 2 (gloo, one card): B, C, D, E", t0)
    nccl = spawn(rank_step8, 1, backend="nccl", device="cuda",
                 timeout_s=SHARD_TIMEOUT, args=(tmp, SHARDED_NCCL, True))
    t0 = phase("8: world size 1 (NCCL): A, E", t0)
    by_tag = {}
    for ranks in (gloo, nccl):
        for i, r0 in enumerate(ranks[0]):
            by_tag[r0["tag"], len(ranks)] = [r[i] for r in ranks]
    loops, stage_rows = Counter(), Counter()
    shard = {}
    for (tag, ws), ranks in by_tag.items():
        if tag == "E":
            continue
        loop, total, shard[tag] = report_sharded(tag, ranks)
        loops.update(loop)
        want = (("solve_density", "wvt_displacement") if tag == "D" else
                ("stream_wvt",))
        for name in want:
            if loop[name] <= 0:
                fail(f"{tag}: the sharded loop launched {name} no time")
        if tag == "D" and total["stream_wvt"] != 0:
            fail("D: the xla engine's run launched stream_wvt")
        if sum(loop.values()) != sum(loop[name] for name in want):
            fail(f"{tag}: the sharded loop launched other kernels or list "
                 f"modes than {want}: {dict(loop)}")
    # B's first step against A's at the CPU tests' 1-vs-4 tolerances, and
    # B's final err_mean within 1% of A's
    fa, fb = (np.load(Path(tmp) / f"{t}_first.npz") for t in "AB")
    if not np.array_equal(fa["pos0"], fb["pos0"]):
        fail("A and B did not start from the same gas positions")
    worst = {k: _close(f"B vs A first step {k}", fb[k], fa[k], rtol)
             for k, rtol in (("rho", 2e-4), ("hsml", 2e-4))}
    worst["pos"] = _close("B vs A first step pos", fb["pos"], fa["pos"],
                          1e-4, 1e-2)
    ea, eb = shard["A"][-1]["err_mean"], shard["B"][-1]["err_mean"]
    say(f"[B vs A] first step: largest relative difference {worst}, "
        f"err_mean {float(fb['err_mean'])} vs {float(fa['err_mean'])}; "
        f"final err_mean {eb} vs {ea}")
    if not abs(eb - ea) <= 0.01 * ea:
        fail(f"B's final err_mean {eb} is not within 1% of A's {ea}")
    # A against step 5's single-card loop on the same scene: its first
    # and final err_mean within 1% (the loops differ in their caps,
    # retries and refreshes, so their trajectories may differ between)
    s5 = single_card_errs
    a_errs = [r["err_mean"] for r in shard["A"]]
    say(f"[A vs step 5] err_mean first {a_errs[0]} vs {s5[0]}, final "
        f"{a_errs[-1]} vs {s5[-1]} (single-card loop: {len(s5)} "
        f"iterations, sharded: {len(a_errs)})")
    for k in (0, -1):
        if not abs(a_errs[k] - s5[k]) <= 0.01 * s5[k]:
            fail(f"A's err_mean {a_errs[k]} is not within 1% of the "
                 f"single-card loop's {s5[k]} (index {k})")
    # ring against gather, bit for bit
    ring, gath, xla = (np.load(Path(tmp) / f"{t}_wvt.npz")
                       for t in ("C-ring", "C-gather", "D"))
    for k in ("pos", "rho", "hsml"):
        if not np.array_equal(ring[k], gath[k]):
            fail(f"C: ring and gather differ in {k} "
                 f"({int((ring[k] != gath[k]).sum())} values)")
    say("[C] ring halo and gather: relaxed pos, rho and hsml bit-equal")
    # D (the xla engine) against C (the stream engine), at the kernels'
    # tolerance against their plain versions
    c_errs = [r["err_mean"] for r in shard["C-ring"]]
    d_errs = [r["err_mean"] for r in shard["D"]]
    if len(d_errs) != len(c_errs) or not all(
            abs(d - c) <= 1e-3 * c for d, c in zip(d_errs, c_errs)):
        fail(f"D's err_mean trajectory {d_errs} is not C's {c_errs} within "
             f"1e-3 relative")
    box = float(np.load(Path(tmp) / "C-ring_stages_in.npz")["boxsize"])
    dpos = np.abs(xla["pos"] - ring["pos"])
    dpos = np.linalg.norm(np.minimum(dpos, box - dpos), axis=1)
    q = {k: _mostly_close(f"D vs C relaxed {k}",
                          np.abs(xla[k] - ring[k]) / np.abs(ring[k]), 2e-3)
         for k in ("rho", "hsml")}
    q["pos / hsml"] = _mostly_close("D vs C relaxed pos",
                                    dpos / ring["hsml"], 1e-2)
    say(f"[D vs C] err_mean trajectories equal within 1e-3; relaxed state "
        f"(median, p99, max) {q}")
    # E: the sharded stages at world size 2 against 1
    e1, e2 = (np.load(Path(tmp) / f"E_ws{ws}.npz") for ws in (1, 2))
    for (tag, ws), ranks in by_tag.items():
        if tag == "E":
            rows = Counter()
            for r in ranks:
                rows.update(r["stage_launches"])
            stage_rows.update(rows)
            say(f"[E] world size {ws}: wall {ranks[0]['wall']:.3f} s; "
                f"launches (ranks summed) by record {dict(rows)}")
            if rows["solve_density"] <= 0 or rows["stream_curl_blocks"] <= 0:
                fail(f"E at world size {ws}: block-list solve_density or "
                     f"stream_curl launched no time")
    worst = {k: _close(f"E sharded_density {k}", e2[k], e1[k], 2e-4)
             for k in ("rho", "hsml", "vf", "wk")}
    worst["b"] = _close("E sharded_curl", e2["b"], e1["b"], 3e-4, 1e-8)
    worst["bmax"] = _close("E bmax", e2["bmax"], e1["bmax"], 3e-4)
    say(f"[E] world size 2 against 1: largest relative difference {worst}")
    calls = check_sharded_calls(torch, sp, cp, tmp)
    phase("8: sharded-loop calls against their plain versions", t0)
    return loops, stage_rows, calls


# ---------------------------------------------- step 9: the variant slice

# run_configs presets 1 and 3 against the JAX package's records of the
# same presets (its configs/run_configs.py on a TPU; only the physics is
# read from them: the WVT err_mean at the first and at the last
# iteration), with how far the port's may lie from each, relative:
# (record file, first, final)
JAX_RECORDS = {1: ("FLAGSHIP_r07_config1.json", 0.02, 0.10),
               3: ("FLAGSHIP_r07_config3.json", 0.01, 0.05)}
PRESET_RUNS = ((1, "stream"), (1, "classed"), (3, "stream"))
# the flag variants of the repository's par (1e6): (tag, engine, CLI
# tokens, par lines added).  The cool cores need the Cuspy bits (without
# them the flag changes no halo) and their two tags in the par (the
# reference's io.c:435-443; the values are the Config defaults), the
# orbits a second halo.
VARIANTS = (
    ("cool cores", "classed", ("mass_ratio=0.5", "cuspy=3",
                               "double_beta_cool_cores=true"),
     ("Rho0_Fac 50", "Rc_Fac 40")),
    ("parabola", "stream", ("mass_ratio=0.5", "orbit=parabola"), ()),
    ("direct", "stream", ("mass_ratio=0.5", "orbit=direct"), ()),
    ("no_rcut_in_t=false", "stream", ("no_rcut_in_t=false",), ()),
    ("buote07", "stream", ("nfw_concentration_model=buote07",), ()),
    ("bfld_norm=0", "stream", ("bfld_norm=0",), ()),
    ("baryon_fraction=0", "stream", ("baryon_fraction=0",), ()),
)


def par_config(par=None, **over):
    """The Config of ``par`` (default: the repository's) with field
    overrides."""
    from toycluster_tpu_torch.config import parse_par_file
    return parse_par_file(par or ROOT / PKG / "data" / "cluster.par", **over)


def path_kernels(tag, engine, cfg, launches, recs):
    """Step 9's launch checks of a run of ``cfg`` on ``engine``: without
    gas no kernel at all; with gas the engine's displacement kernel
    (stream_wvt; fused_wvt or wvt_displacement), stream_curl exactly when
    there is a B field (superblock lists on the stream engine, block
    lists on the classed one), the far-tail records of solve_density and
    wvt_displacement when a WVT build had far-tail rows, and no
    stream_wvt on the classed engine; with or without gas the Eddington
    kernel once."""
    gas = cfg.baryon_fraction > 0
    curl = "stream_curl" if engine == "stream" else "stream_curl_blocks"
    eddington_once(tag, launches)
    launched = {k for k, v in launches.items() if v > 0} - {EDDINGTON[0]}
    if not gas:
        if launched:
            fail(f"{tag}: a run without gas launched {sorted(launched)}")
        return
    need = {"stream_wvt"} if engine == "stream" else set()
    if engine == "classed":
        if "stream_wvt" in launched:
            fail(f"{tag}: the classed engine launched stream_wvt")
        if not launched & {"fused_wvt", "wvt_displacement"}:
            fail(f"{tag}: the classed engine launched no displacement")
        if any(r.get("tail_rows", 0) for r in recs
               if r["stage"] == "wvt_build"):
            need |= {"solve_density_sb", "wvt_displacement_sb"}
    if cfg.bfld_norm:
        need.add(curl)
    elif launches["stream_curl"]:
        fail(f"{tag}: stream_curl launched without a B field")
    for name in sorted(need - launched):
        fail(f"{tag}: {name} launched no time")


def jax_record_gate(n, errs):
    """Fail unless the first and the final err_mean of preset ``n`` lie
    within JAX_RECORDS' bounds of the JAX package's record."""
    path, first, final = JAX_RECORDS[n]
    with open(ROOT / path) as fh:
        rec = json.load(fh)
    ref = (rec["wvt_err_mean_first"], rec["wvt_err_mean_final"])
    say(f"[config {n}] err_mean first {errs[0]} vs the JAX record's "
        f"{ref[0]} ({errs[0] / ref[0] - 1:+.4f}), final {errs[-1]} vs "
        f"{ref[1]} ({errs[-1] / ref[1] - 1:+.4f}); iterations {len(errs)} "
        f"vs {rec['wvt_iterations']} ({path})")
    for got, want, tol, what in ((errs[0], ref[0], first, "first"),
                                 (errs[-1], ref[1], final, "final")):
        if not abs(got - want) <= tol * want:
            fail(f"config {n}: {what} err_mean {got} is not within {tol} "
                 f"of the JAX record's {want}")


def run_preset(torch, sp, cp, tmp, n, engine):
    """Preset ``n`` of run_configs (full size) through ``make_ics(device=
    "cuda", engine=engine, check=True)``, counted without recording any
    kernel's inputs: ``report_run``, ``path_kernels``, the density audit
    <= 5e-3, ``jax_record_gate`` and the snapshot; prints the peak
    device memory."""
    from toycluster_tpu_torch.pipeline import make_ics
    from toycluster_tpu_torch.run_configs import PRESETS
    tag = f"config {n} {engine}"
    out = Path(tmp) / f"IC_config{n}"
    cfg = par_config(**{**PRESETS[n], "output_file": str(out)})
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _, launches, _, _, wall, t0 = counted(
        torch, sp, cp, lambda: make_ics(cfg, device="cuda", engine=engine,
                                        check=True, log=run_log()),
        record=False)
    peak = torch.cuda.max_memory_allocated()
    say(f"[{tag}] ntotal {cfg.ntotal}; wall {wall:.3f} s; launches "
        f"{launches}; peak device memory {peak / 2**30:.4f} GiB")
    recs = report_run(tag, t0)
    path_kernels(tag, engine, cfg, launches, recs)
    audit = [r for r in recs if r["stage"] == "check_density"]
    if not audit or not audit[0].get("worst_rel_err", 1.0) <= 5e-3:
        fail(f"{tag}: check_density {audit}")
    say(f"[{tag}] check_density worst rel err {audit[0]['worst_rel_err']} "
        f"on {audit[0]['n']} gas lanes")
    jax_record_gate(n, [r["err_mean"] for r in recs if r["stage"] == "wvt"])
    check_snapshot(out, cfg.ntotal, bfld=bool(cfg.bfld_norm))
    out.unlink()


def run_variant(torch, sp, cp, tmp, tag, engine, tokens, par_lines=()):
    """The CLI main path on cuda with ``engine`` and the field=value
    ``tokens`` on the repository's par with ``par_lines`` added, counted
    (``counted``): with gas step 4's checks (``report_run``: the
    contract, the fall of err_mean; the snapshot) and ``path_kernels``;
    without gas no pair kernel launched, no gas in the snapshot, the header's
    masses and box, the DM speeds finite and nonzero.  Returns
    (launches, recorded)."""
    import numpy as np
    from toycluster_tpu_torch import cli
    from toycluster_tpu_torch.scene import build_scene
    par = Path(tmp) / "variant.par"
    par.write_text("\n".join(
        [(ROOT / PKG / "data" / "cluster.par").read_text(), *par_lines, ""]))
    cfg = par_config(par, **{k: cli._coerce(v) for k, _, v in
                             (t.partition("=") for t in tokens)})
    out = Path(tmp) / "IC_variant"
    rc, launches, _, recorded, wall, t0 = counted(
        torch, sp, cp, lambda: cli.main(
            [str(par), *tokens, f"output_file={out}", "device=cuda",
             f"engine={engine}"], log=run_log()))
    if rc != 0:
        fail(f"[{tag}] cli.main returned {rc}")
    say(f"[{tag}] engine={engine} {' '.join(tokens)}: wall {wall:.3f} s, "
        f"launches {launches}")
    gas = cfg.baryon_fraction > 0
    if gas:
        recs = report_run(tag, t0)
    else:
        report_stages(tag, t0)
        recs = list(run_log())
    path_kernels(tag, engine, cfg, launches, recs)
    snap = check_snapshot(out, cfg.ntotal, bfld=bool(gas and cfg.bfld_norm))
    out.unlink()
    if not gas:
        scene, hdr = build_scene(cfg), snap["header"]
        v = np.linalg.norm(snap["vel"], axis=1)
        if not (hdr.npart[0] == 0 and hdr.npart[1] == scene.npart_dm
                and hdr.mass[0] == 0 and hdr.boxsize == scene.boxsize
                and abs(hdr.mass[1] / scene.mpart_dm - 1) < 1e-6):
            fail(f"[{tag}] header npart {hdr.npart}, mass {hdr.mass}, box "
                 f"{hdr.boxsize}: not the DM-only scene's")
        if not (np.isfinite(v).all() and (v > 0).mean() > 0.99):
            fail(f"[{tag}] DM speeds not finite or zero")
        say(f"[{tag}] {hdr.npart[1]} DM particles, no gas; speeds (median, "
            f"max) {float(np.median(v)):.6g}, {float(v.max()):.6g} km/s")
    return launches, recorded


def run_m4(torch, sp, cp, tmp):
    """The 1e6 par with sph_kernel=m4 on both engines (``run_variant``),
    then each kernel record's first M4 main-path call held against its
    plain version with step 3's tolerances, timed and bounded
    (``time_on_main_path_inputs``).  Fails unless the two runs launched
    each of the five kernels.  Returns (launches, results) by record."""
    launches, recorded = {}, {}
    for engine in ("stream", "classed"):
        run_launches, run_recorded = run_variant(
            torch, sp, cp, tmp, f"m4 {engine}", engine, ("sph_kernel=m4",))
        for name, _, _ in KERNELS:
            if run_launches.get(name, 0) > 0 and name in run_recorded:
                launches[name] = run_launches[name]
                recorded[name] = run_recorded[name]
    missing = set(LIBS) - {lib for name, lib, _ in KERNELS
                           if name in recorded}
    if missing:
        fail(f"the M4 main paths launched {sorted(missing)} no time")
    say(f"[m4] records on the M4 main paths {sorted(recorded)}; not on "
        f"them {sorted({n for n, _, _ in KERNELS} - set(recorded))}")
    for name, (_, kw) in recorded.items():
        if kw.get("kernel") != "m4":
            fail(f"[m4] {name}'s first call ran kernel={kw.get('kernel')}")
    res = time_on_main_path_inputs(torch, sp, cp, recorded,
                                   tag="m4 main-path")
    return launches, res


def run_variants(torch, sp, cp, tmp, t0):
    """Step 9: presets 1 (both engines) and 3, the M4 main paths and the
    flag variants.  Returns ``run_m4``'s (launches, results)."""
    for n, engine in PRESET_RUNS:
        run_preset(torch, sp, cp, tmp, n, engine)
        t0 = phase(f"9: config {n}, engine={engine}", t0)
    m4 = run_m4(torch, sp, cp, tmp)
    t0 = phase("9: the M4 main paths and their kernels", t0)
    for tag, engine, tokens, par_lines in VARIANTS:
        run_variant(torch, sp, cp, tmp, tag, engine, tokens, par_lines)
        t0 = phase(f"9: {tag}, engine={engine}", t0)
    return m4


# ------------------------------------------ step 10: speculative dispatch

# the runs of step 10, each with TOYCLUSTER_SPECULATE at 1 and at 0:
# (tag, engine, config-4 at this Ntotal or None for the 1e6 par)
# (config 4 at 5e6 keeps the script within its time)
SPEC_RUNS = (("1e6 par stream", "stream", None),
             ("1e6 par classed", "classed", None),
             ("config-4 5e6 stream", "stream", 5_000_000))
# the runs whose speculating half must adopt a queued iteration (the
# classed 1e6 par has far-tail rows at every build: nothing is queued)
SPEC_MUST_ADOPT = ("1e6 par stream", "config-4 5e6 stream")


def spec_run(torch, sp, cp, tmp, tag, engine, ntotal):
    """One run of step 10 through ``make_ics(device="cuda", check=True)``
    with step 4's gates (the 1e6 par: the engine's kernels, the contract,
    the fall of err_mean, the snapshot) or step 5's (config 4:
    ``check_config4`` and the snapshot), then the same configuration
    again under the profiler (``trace.trace_make_ics``).  Returns the
    row: iterations, queued ahead, adopted, dropped, loop s, updates/s,
    the device's idle share of the WVT loop's span and of the run."""
    from toycluster_tpu_torch import trace
    from toycluster_tpu_torch.pipeline import make_ics
    out = Path(tmp) / "IC_spec"
    cfg = (par_config(output_file=str(out)) if ntotal is None
           else config4(ntotal, out))
    (scene, parts), launches, totals, _, wall, t0 = counted(
        torch, sp, cp, lambda: make_ics(cfg, device="cuda", engine=engine,
                                        check=True, log=run_log()),
        record=False)
    say(f"[{tag}] wall {wall:.3f} s; launches {launches}")
    if ntotal is None:
        need = (("stream_wvt", "stream_curl") if engine == "stream" else
                CLASSED_NAMES)
        for name in need:
            if launches[name] <= 0:
                fail(f"{tag}: {name} launched no time")
        recs = report_run(tag, t0)
    else:
        recs = check_config4(torch, tag, cfg, engine, scene, parts, totals,
                             t0)
    del parts
    check_snapshot(out, cfg.ntotal)
    out.unlink()
    done = [r for r in recs if r["stage"] == "wvt_done"][0]
    drops = [(r["it"], r["reason"]) for r in recs
             if r["stage"] == "wvt_drop"]
    tr = trace.trace_make_ics(cfg, engine)
    row = dict(iterations=done["iterations"], speculated=done["speculated"],
               adopted=done["adopted"], dropped=done["dropped"],
               loop_s=done["seconds"],
               updates_per_s=done["particle_updates_per_s"],
               wvt_idle=tr["wvt_idle"], run_idle=tr["idle"],
               traced_wvt_s=tr["wvt_wall"], traced_wvt_busy=tr["wvt_busy"],
               errs=[r["err_mean"] for r in recs if r["stage"] == "wvt"])
    say(f"[{tag}] drops (it, reason) {drops}; traced run: WVT span "
        f"{tr['wvt_wall']:.6f} s, busy {tr['wvt_busy']:.6f} s, idle share "
        f"{tr['wvt_idle']:.6f}; run {tr['wall']:.6f} s, idle share "
        f"{tr['idle']:.6f}")
    return row


def run_speculation(torch, sp, cp, tmp, t0):
    """Step 10: SPEC_RUNS with TOYCLUSTER_SPECULATE at 1 and at 0
    (``spec_run``), the WVT loop's window between queuing an iteration
    and reading the last one's scalars under the sync check (a host sync
    there raises); the speculating run of each SPEC_MUST_ADOPT scene must
    adopt a queued iteration, no run at 0 may queue one; then preset 1
    at both settings against the JAX package's record."""
    import os
    from toycluster_tpu_torch.models import wvt
    if not wvt.SYNC_CHECK:
        fail("the sync check of the speculation window is off")
    rows = {}
    try:
        for tag, engine, ntotal in SPEC_RUNS:
            for spec in (1, 0):
                os.environ["TOYCLUSTER_SPECULATE"] = str(spec)
                rows[tag, spec] = spec_run(torch, sp, cp, tmp,
                                           f"{tag} speculate={spec}",
                                           engine, ntotal)
                t0 = phase(f"10: {tag}, TOYCLUSTER_SPECULATE={spec}", t0)
        for spec in (1, 0):
            os.environ["TOYCLUSTER_SPECULATE"] = str(spec)
            run_preset(torch, sp, cp, tmp, 1, "stream")
            t0 = phase(f"10: config 1, TOYCLUSTER_SPECULATE={spec}", t0)
    finally:
        os.environ.pop("TOYCLUSTER_SPECULATE", None)
    say("step 10 (WVT loop; idle shares from the traced second run): "
        "run, speculate, iterations, queued ahead, adopted, dropped, loop "
        "s, updates/s, traced WVT span s, its device busy s, idle share of "
        "the WVT span, of the run")
    for (tag, spec), r in rows.items():
        say(f"  {tag} | {spec} | {r['iterations']} | {r['speculated']} | "
            f"{r['adopted']} | {r['dropped']} | {r['loop_s']:.6f} | "
            f"{r['updates_per_s']:.6g} | {r['traced_wvt_s']:.6f} | "
            f"{r['traced_wvt_busy']:.6f} | {r['wvt_idle']:.6f} | "
            f"{r['run_idle']:.6f}")
        if spec == 0 and r["speculated"]:
            fail(f"{tag}: TOYCLUSTER_SPECULATE=0 queued {r['speculated']}")
        if spec == 1 and tag in SPEC_MUST_ADOPT and not r["adopted"] > 0:
            fail(f"{tag}: no queued iteration was adopted")
    for tag, _, _ in SPEC_RUNS:
        same = rows[tag, 1]["errs"] == rows[tag, 0]["errs"]
        say(f"[{tag}] err_mean trajectory the same at both settings: {same}")
    return t0


# ------------------------------------------- step 11: the superblock sweep

# CUDA-event timings of each sweep at each width, in turns: top-k,
# oracle, oracle, top-k
SWEEP_REPS = 2


def run_sweep_check(torch, first):
    """Step 11: the superblock sweep on the inputs of phase A's first
    superblock sweep (``first_sweep``; 5e7 gas), at the recorded width
    and at ``sph.SB_WIDTH_CAP``: the sweep the loop runs
    (``blk._find_candidates_super_k``, the kernel) and its oracle, the
    stable sort over every superblock
    (``blk._find_candidates_super_k_sorted``),
    must give the same lists, counts and overflow to the bit.  Prints
    each one's time (CUDA events, SWEEP_REPS calls each, in turns) and
    its peak device memory over what the inputs hold, and at the
    recorded width the time of the same sweep with no selection (its box
    distances, ranges and counts alone: what the top-k leaves)."""
    from toycluster_tpu_torch.models import sph
    from toycluster_tpu_torch.ops import blocks as blk
    if first is None:
        fail("phase A recorded no superblock sweep")
    bi, rec_ids, radius, radius_sym, boxsize, width = first
    say(f"step 11: receiver rows {rec_ids.shape[0]}, superblocks "
        f"{bi.sb_lo.shape[0]}, recorded width {width}")
    fns = {"top-k": blk._find_candidates_super_k,
           "oracle": blk._find_candidates_super_k_sorted}
    for w in (width, sph.SB_WIDTH_CAP):
        args = (bi, rec_ids, radius, radius_sym, boxsize, w)
        ms, peak, out = {n: [] for n in fns}, {}, {}
        for name in ("top-k", "oracle", "oracle", "top-k") * (
                SWEEP_REPS // 2):
            out.pop(name, None)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
            ev[0].record()
            out[name] = fns[name](*args)
            ev[1].record()
            torch.cuda.synchronize()
            ms[name].append(ev[0].elapsed_time(ev[1]))
            peak[name] = (torch.cuda.max_memory_allocated() - base) / 2**30
        got, ref = out["top-k"], out["oracle"]
        if not (torch.equal(got.idx, ref.idx)
                and torch.equal(got.count, ref.count)
                and got.overflow == ref.overflow):
            bad = int((got.idx != ref.idx).any(dim=1).sum())
            fail(f"step 11: the top-k sweep differs from its oracle at "
                 f"width {w}: {bad} rows, overflow {got.overflow} vs "
                 f"{ref.overflow}")
        say(f"[step 11, width {w}] top-k and oracle lists, counts and "
            f"overflow ({got.overflow}) the same to the bit; ms a sweep "
            f"(CUDA events) top-k {ms['top-k']}, oracle {ms['oracle']}; "
            f"mean {sum(ms['top-k']) / len(ms['top-k']):.3f} vs "
            f"{sum(ms['oracle']) / len(ms['oracle']):.3f}; peak GiB over "
            f"the inputs top-k {peak['top-k']:.4f}, oracle "
            f"{peak['oracle']:.4f}")
        del got, ref, out
        if w == width:
            def unselected(d2, hit, k):
                return torch.full((d2.shape[0], k), -1, dtype=torch.int64,
                                  device=d2.device)
            ev = [torch.cuda.Event(enable_timing=True) for _ in "se"]
            torch.cuda.synchronize()
            ev[0].record()
            blk._super_sweep(*blk._super_args(bi, rec_ids, radius,
                                              radius_sym),
                             boxsize=boxsize, max_cand=w, select=unselected)
            ev[1].record()
            torch.cuda.synchronize()
            say(f"[step 11, width {w}] the sweep with no selection (box "
                f"distances, ranges, counts): "
                f"{ev[0].elapsed_time(ev[1]):.3f} ms")


def main():
    import argparse
    import torch
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent-csrc", default=None, help="csrc directory of "
                    "another tree: time its fused_wvt and stream_curl "
                    "kernels beside this tree's")
    opts = ap.parse_args()
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
    libs = LIBS + (EDDINGTON[1], SUPER_SWEEP[1], DENSITY_MODEL[1])
    cuda_build.build(libs)
    say(f"build of {len(libs)} kernels (parallel nvcc): "
        f"{time.perf_counter() - t0:.3f} s")
    for name in libs:
        cuda_build.load(name)
        for line in cuda_build.build_log.get(name, "").splitlines():
            # the mangled name tells the instantiations apart (<kind,
            # flag>: ILi0E wc6, ILi1E m4; Lb1E set)
            if ("registers" in line or "spill" in line
                    or "Compiling entry" in line):
                say(f"  nvcc {name}: {line.strip()}")

    t0 = phase("build", t0)
    # every speculating WVT run of this script checks that the window
    # between queuing an iteration and reading the last one's scalars
    # holds no host sync (step 10 prints the counts)
    from toycluster_tpu_torch.models import wvt
    wvt.SYNC_CHECK = True
    check_kernels_on_cusp(torch, sp, cp, torch.device("cuda"))
    t0 = phase("kernels against plain versions on the cusp", t0)

    launches, recorded = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for engine, names in (("stream", ("stream_wvt", "stream_curl",
                                          EDDINGTON[0])),
                              ("classed", CLASSED_NAMES)):
            run_launches, run_recorded = run_main_path(torch, sp, cp, tmp,
                                                       engine)
            if engine == "stream":
                for name in (SUPER_SWEEP[0], DENSITY_MODEL[0]):
                    launches[name] = run_launches[name]
            for name in names:
                launches[name] = run_launches[name]
                if name not in run_recorded:
                    fail(f"no {name} call was recorded")
                recorded[name] = run_recorded[name]
            t0 = phase(f"1e6 main path, engine={engine}", t0)
        single_card_errs, eddington_calls, sweep_calls = {}, [], []
        for engine, ntotal, slow in SUBSTRUCTURE_RUNS:
            single_card_errs[engine, ntotal], call, sweep = run_substructure(
                torch, sp, cp, tmp, engine, ntotal, slow)
            eddington_calls.append(call)
            sweep_calls.append((f"config-4 {ntotal:.0e} {engine}", sweep))
            t0 = phase(f"config-4 {ntotal:.0e}, engine={engine}", t0)
        _, first = run_large(torch, sp, cp, tmp, "stream")
        t0 = phase(f"A: config-4 {LARGE_NTOTAL:.0e}, engine=stream", t0)
        run_offload_gate(torch)
        t0 = phase(f"A: the offload gate at {LARGE_NTOTAL:.0e}", t0)
        run_large(torch, sp, cp, tmp, "classed")
        t0 = phase(f"A2: config-4 {LARGE_NTOTAL:.0e}, engine=classed", t0)
        run_resume(torch, sp, cp, tmp)
        t0 = phase(f"B: config-4 {RESUME_NTOTAL:.0e} checkpoint -> resume, "
                   f"engine=classed", t0)
        loops, stage_rows, sharded_calls = run_sharded(
            torch, sp, cp, tmp, single_card_errs["stream", SHARDED_NTOTAL])
        t0 = phase("8: the sharded path", t0)
        m4_launches, m4_res = run_variants(torch, sp, cp, tmp, t0)
        t0 = phase("9: the variant slice", t0)
        t10 = t0
        run_speculation(torch, sp, cp, tmp, t0)
        t0 = phase("10: speculative dispatch", t10)
        run_sweep_check(torch, first)
        t0 = phase("11: the superblock sweep", t0)
    parent = None
    if opts.parent_csrc is not None:
        t0 = time.perf_counter()
        parent = ParentKernels(sp, opts.parent_csrc)
        say(f"build of the parent's fused_wvt and stream_curl "
            f"({opts.parent_csrc}): {time.perf_counter() - t0:.3f} s")
    res = time_on_main_path_inputs(torch, sp, cp, recorded, parent)
    res[EDDINGTON[0]] = check_eddington(torch, eddington_calls[0])
    res[SUPER_SWEEP[0]] = check_super_sweep(
        torch, [sweep_calls[0], (f"A: config-4 {LARGE_NTOTAL:.0e} stream",
                                 first)])
    del first
    res[DENSITY_MODEL[0]] = check_density_model(torch)
    phase("kernels on main-path inputs", t0)
    # no single PyTorch call computes a per-lane h solve or an SPH pair
    # sum over candidate lists: library_ms is null for every kernel
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": f"{PKG}/csrc/{lib}.cu",
         "replaces": rep, "launches": launches[name],
         "max_abs_err": res[name]["err"], "ms": res[name]["ms"],
         "plain_ms": res[name]["plain_ms"],
         "bound_ms": res[name]["bound_ms"],
         "bound_by": res[name]["bound_by"], "library_ms": None}
        for name, lib, rep in KERNELS + (EDDINGTON, SUPER_SWEEP,
                                         DENSITY_MODEL)]}
    # what a check measured besides (EXTRA_KEYS); each record's launches
    # in step 8's sharded loops and in its sharded stages (E), summed over
    # runs and ranks; on the records of the sharded loop's first calls,
    # their error against the plain version and the kernel's time there
    for k in record["kernels"]:
        for key in EXTRA_KEYS:
            if key in res[k["name"]]:
                k[key] = res[k["name"]][key]
        k["sharded_loop_launches"] = loops.get(k["name"], 0)
        k["sharded_stage_launches"] = stage_rows.get(k["name"], 0)
        if k["name"] in sharded_calls:
            k["sharded_call_max_abs_err"], k["sharded_call_ms"] = \
                sharded_calls[k["name"]]
        # step 9: the record's M4 instantiation on the first call of the
        # 1e6 M4 main paths (null where that path does not launch it)
        m4 = m4_res.get(k["name"], {})
        k["m4_launches"] = m4_launches.get(k["name"], 0)
        for key in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                    "bound_by"):
            k[f"m4_{key}"] = m4.get("err" if key == "max_abs_err" else key)
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
