"""Weighted-Voronoi-tessellation particle regularisation (reference
wvt_relax.c:25-225, after Diehl+ 2012), the hot loop of the pipeline.

JAX counterpart: ``toycluster_tpu/models/wvt.py`` (``_get_iter_fn`` and
``regularise_sph_particles``).  Each iteration: (1) SPH density and
adaptive hsml, (2) the WVT displacement, (3) the relative error against
the analytic model density and the reference's early-stop and
step-shrink rules; (4) a move with periodic wrap.  The block structure is
reused across iterations: candidate lists carry radius slack,
accumulated drift is budgeted, and saturated lanes force a retry or a
rebuild.  Relaxation runs in units of the boxsize.

Two engines (models/sph.py).  The stream engine runs (1) and (2) in one
``stream_wvt`` call over superblock lists, refreshes the lists when
drift spends their slack, and solves against a tight margin over the
warm h.  The count-class engine runs one ``fused_wvt`` per count class
of width <= FUSED_WIDTH blocks (the TPU design keeps such a class's
whole candidate set on chip), ``solve_density`` then
``wvt_displacement`` for wider classes and the far-tail rows, solves
against the build cap, rebuilds wherever the stream engine would
refresh, and rebuilds every iteration while its structure has far-tail
rows.

Dispatch, as in the JAX loop.  ``iterate`` leaves every result on the
device: the statistics, the step (an fp32 0-d tensor, shrunk on the
device) and the accept-path cap ratchet.  The loop reads one batch of
scalars per iteration, through a non-blocking copy into pinned host
memory and a CUDA event recorded after it.  Before it waits on that
event it queues the next iteration from this one's device outputs
(speculative dispatch), unless a rebuild, a list refresh or a stop is
predicted; the queued iteration is adopted when its index comes up and
dropped on a retry, a build, a refresh or a stop.  A plain ``.item()``
after the queuing would wait for the queued iteration as well (one
stream runs in order), so the window between queuing the next iteration
and reading this one's scalars holds no host sync.  Speculation is on
unless TOYCLUSTER_SPECULATE=0 and only up to SPECULATE_MAX_GAS gas
particles (the JAX package's switch and limit).

The iteration program, as in the JAX loop.  The JAX package compiles an
iteration (model density, metric, the pair kernels, scatters, error
statistics, the saturation count) into ONE program, cached by its shapes
(``_get_iter_fn``, ``_ITER_FN_CACHE``), with the iteration index, margin,
step and err_last as dynamic inputs.  Here that program is a CUDA graph
(``_IterProgram``, ``_Loop.make_program``, ``_Loop.programs``): at the
first iteration of a list shape the iteration runs eagerly and a graph of
the same body is captured on static buffers; every later iteration of
that shape, queued ones included, copies its inputs in, replays the graph
and clones the outputs out, so a replay runs the same kernels on the same
inputs as the eager call and gives the same bits.  The shapes repeat as
in the JAX loop: the stream engine's sticky list width
(``sph.trim_width``) lets a list refresh find the graph it has; the
count-class engine's sticky list, superblock and far-tail widths and its
quantized class and far-tail sizes (``sph.build_neighbours_blocks``,
``sph.classed_selections``, one memo a relaxation) let a build find it,
far-tail states included, which are rebuilt at every iteration.
Iterations run eagerly above the engine's PROGRAM_MAX_GAS gas (where a
replay saves no time or the card's memory runs short) and with
``ITER_PROGRAMS = False``.  On the CPU a
program runs the body on its static buffers, without a graph.  The
candidate sweeps of the builds and list refreshes are programs too, under
the same rules (``blk.Sweeps``, the counterpart of the JAX package's
``jax.jit`` on each sweep): the host reads what a build needs (the widest
row's count, the rows over the probe) between them.

The large-run memory path, as in the JAX loop.  The loop reads only the
gas positions and hsml of the particle set.  From OFFLOAD_N gas
particles on (TOYCLUSTER_WVT_OFFLOAD_N, the JAX package's variable), a
particle set handed over in a one-element list (the holder protocol)
is parked (``_Parked``): ids and halo membership go to host memory, the
DM half of the positions stays on the device, and every other buffer of
the set is freed; the set is rebuilt from those and the loop's results
at the end, with the same bits as without the offload.
"""

from __future__ import annotations

import contextlib
import math
import os
import time
import weakref
from collections import Counter, OrderedDict
from functools import partial

import numpy as np
import torch

from .. import constants as const
from ..ops import blocks as blk
from ..ops import class_pair as _cp
from ..ops import stream_pair as _sp
from ..ops.class_pair import (fused_wvt, pack_fused_sources, pack_sources,
                              solve_density, wvt_displacement)
from ..ops.stream_pair import stream_wvt
from ..particles import HaloArrays, Particles
from ..scene import Scene
from ..utils.graphs import CapturePool, capture
from ..utils.logging import Spans, stage_log
from ..utils.memory import stage_memory
from . import sph as sph_mod

NUMITER = 64            # wvt_relax.c:7
# hard cadence of full rebuilds (re-sort + lists); the reference rebuilds
# its tree every iteration (wvt_relax.c:6) because its lists are exact
REBUILD_EVERY = 32
# full rebuild once the max-lane drift since the last sort, in units of
# the local metric h, exceeds this (Hilbert-block compactness decay)
SORT_DRIFT_BUDGET = 2.0
SYM_MARGIN = 1.1        # displacement-radius slack for inter-build drift
FAC_MAX = 2.0           # cap-ratchet ceiling of the per-lane cap factor
# list-refresh drift budget: pair drift that candidate lists built with
# SYM_MARGIN slack absorb.  WC6 has 8th-order contact at u = 1, so a
# budget past the 0.1 slack loses weight far below the |wkNgb - 295| <
# 0.05 contract; M4 (3rd-order contact) keeps D < 0.1, where no pair can
# enter the uncovered region at all.
DRIFT_BUDGET = 0.25            # wc6
DRIFT_BUDGET_HARD_EDGE = 0.09  # kernels without high-order contact
# effective solve cap: min(build cap, margin * warm h).  Lanes that
# outgrow it saturate and re-enter through the retry machinery.
BITS_MARGIN_WARM = 1.02
BITS_MARGIN_COLD = 1.25
# widest count class the count-class engine runs through fused_wvt
FUSED_WIDTH = sph_mod.CLASS_EDGES[0]
# no speculative dispatch above this many gas particles (the JAX
# package's limit: the queued iteration's outputs add to the loop's
# standing memory; the speculative margin changes which lanes saturate)
SPECULATE_MAX_GAS = 20_000_000
# with True, the window between queuing the next iteration and reading
# this one's scalars runs under torch.cuda.set_sync_debug_mode("error"):
# a host sync there raises (the checks on a card set it)
SYNC_CHECK = False
# the scalars an iteration hands the host, in this order (float64)
SCALARS = ("err_max", "err_mean", "n_sat", "dmax_rel", "p999_rel",
           "n_contract", "step_new")
# with True (the default) the iterations run through iteration programs
# (module docstring); with False every iteration runs eagerly
ITER_PROGRAMS = True
# above this many gas particles every iteration of an engine runs
# eagerly, and so do the sweeps of its builds (measured on an NVIDIA H100
# 80GB HBM3 at 700.00 W).  Stream: the size at which the loop starts to
# park its set to save memory (OFFLOAD_N); past it an iteration is long
# enough that a replay saves no time, and the programs cost more memory
# than the offload saves: config 5 at 5e7 gas made its IC in 40.81 s
# with them and 40.95 s without, and they raised its peak from 14.13 to
# 20.52 GiB (137 B a gas particle).  Count-class: half of one 80 GiB
# card over the engine's own bytes a gas particle, the programs' (static
# buffers and graph pool) plus the eager peak, each measured by
# chip_smoke.py: the programs, the sweeps' among them, reserved
# 674.0-710.9 B more than an eager run at 5e6 gas (step 11, config 4 at
# 1e7, after empty_cache and reset_peak_memory_stats; 520.9-528.1 B
# before the sweeps were programs), the eager peak reserved 463.0-470.9
# B at 5e7 gas (step 6, A2); (710.9 + 470.9) B x 3.5e7 = 38.5 GiB, and
# 4e7 gas would need 44.0 GiB
PROGRAM_MAX_GAS = {"stream": 20_000_000, "classed": 35_000_000}
# at this many gas particles or more the loop keeps on the device only
# what it reads (``_Parked``): the JAX package's switch and default
OFFLOAD_N = 20_000_000
# live iteration programs of a loop: the current key and the one before
PROGRAMS_LIVE = 2
# the kernel launches that program replays made, by record name: the
# kernel's, the far-tail calls' under the kernel's name + "_sb" (the
# kernels' own ``launches`` counters hold them too)
REPLAYED_LAUNCHES: Counter = Counter()
# the hand-written kernels an iteration launches, and those of them that
# the far-tail rows launch in superblock mode (counted apart, under the
# kernel's name + "_sb")
_KERNELS = (_sp.stream_wvt, _cp.solve_density, _cp.wvt_displacement,
            _cp.fused_wvt)
_SB_KERNELS = (_cp.solve_density, _cp.wvt_displacement)
_KERNEL_OF = {k.__name__: k for k in _KERNELS}


def percentile(x, q):
    """numpy's default ("linear") ``q``-th percentile of the elements of
    float32 ``x`` at any length (``torch.quantile`` refuses more than
    2^24).  The rank and the weight are float32, as in numpy and
    ``torch.quantile``."""
    v = torch.sort(x.reshape(-1)).values
    rank = np.float32(q / 100.0) * np.float32(v.numel() - 1)
    lo = int(rank)
    return torch.lerp(v[lo], v[min(lo + 1, v.numel() - 1)],
                      float(rank - np.float32(lo)))


def class_shape(sels):
    """((width, rows), ...) of classed selections, or None: the JAX
    loop's ``class_shape``."""
    return None if sels is None else tuple(
        (m, int(ids.shape[0])) for m, ids in sels)


def tail_shape(state):
    """(rows, width) of a state's far-tail lists, or None: the JAX
    loop's ``tail_shape``."""
    return None if state.tail is None else tuple(state.tail[1].shape)


def _drift_budget(kernel):
    return DRIFT_BUDGET if kernel == "wc6" else DRIFT_BUDGET_HARD_EDGE


def speculation_enabled(n_gas):
    """The JAX package's switch: TOYCLUSTER_SPECULATE (default 1), and at
    most SPECULATE_MAX_GAS gas particles."""
    return (int(os.environ.get("TOYCLUSTER_SPECULATE", "1")) != 0
            and n_gas <= SPECULATE_MAX_GAS)


def speculation_blocked(it, max_iter, its_since_build, drift_acc,
                        sort_drift_acc, drift_inc_last, drift_budget, tail,
                        err_diff_last, err_limit):
    """Why iteration it+1 is not queued before the scalars of iteration
    it are read, or None: "end" at the last iteration; "rebuild" where a scheduled
    rebuild, a list refresh (drift budget), a sorting rebuild (sort-drift
    budget; both budgets against 1.5x the last increment) or the
    far-tail rows' rebuild is predicted; "stop" where the convergence
    stop is predicted (it >= 25 and the last err_diff under twice the
    limit).  The JAX loop's predict_rebuild and predict_stop."""
    if it >= max_iter:
        return "end"
    if (its_since_build + 1 >= REBUILD_EVERY
            or drift_acc + 1.5 * drift_inc_last > drift_budget
            or sort_drift_acc + 1.5 * drift_inc_last > SORT_DRIFT_BUDGET
            or tail is not None):
        return "rebuild"
    if it >= 25 and err_diff_last < err_limit * 2.0:
        return "stop"
    return None


def _accept_band(n_gas, it=None):
    """Saturated-lane count below which an iteration accepts the capped
    h instead of rebuilding (the NGBMAX-truncation role, globals.h:50):
    2% of lanes for the first three iterations, then the tight
    steady-state band."""
    base = max(32, n_gas // 20_000)
    if it is not None and it < 3:
        return max(base, n_gas // 50)
    return base


def _model_fields_from_rho(rho_model, mpart, desnngb):
    """(rho_model, h0_model, h_box): h0_model the metric base
    (DESNNGB m / rho / (4pi/3))^(1/3), h_box the metric renormalised so
    the kernel volumes fill the unit box (wvt_relax.c:108-124)."""
    base = desnngb * mpart / rho_model / const.FOURPITHIRD
    h0_model = base ** (1.0 / 3.0)
    h_box = h0_model * (desnngb / base.sum()
                        / const.FOURPITHIRD) ** (1.0 / 3.0)
    return rho_model, h0_model, h_box


def _metric_hsml(rho_model, mpart, desnngb):
    return _model_fields_from_rho(rho_model, mpart, desnngb)[2]


def _warm_ratio(rho_model, rho_model_prev):
    """Warm-start predictor: the converged h tracks rho_model^(-1/3), so
    the previous solved h is scaled by (rho_model(old)/rho_model(new))^(1/3),
    clipped to [1/1.5, 1.5]."""
    ratio = torch.where(
        rho_model_prev > 0,
        (rho_model_prev / torch.clamp(rho_model, min=1e-30)) ** (1.0 / 3.0),
        torch.ones_like(rho_model))
    return torch.clamp(ratio, 1.0 / 1.5, 1.5)


class _Loop:
    """Constants of one relaxation, its iteration programs' counts and its
    width memo (``widths``): the stream engine's sticky list width, or the
    count-class engine's sticky widths and class and far-tail sizes."""

    # (state, its classed selections), made once a state (``selections``);
    # the width memo (a loop made without __init__ has none: grid sizes);
    # the far-tail rows' superblock-mode launches of the eager runs of
    # ``body``, by record name (a capture sets them back)
    _sels = (None, None)
    widths = None
    sb_launches = Counter()
    # the pair-work counter (``__init__``): a loop made without it
    # counts no pairs
    pairs = None

    def __init__(self, scene: Scene, ha: HaloArrays, n_gas: int,
                 engine: str, device, log=stage_log):
        cfg = scene.config
        self.engine = engine
        self.ha = ha
        self.n_gas = n_gas
        self.boxsize = float(scene.boxsize)
        self.mpart = float(scene.mpart_gas)
        self.desnngb = cfg.desnngb
        self.kernel = cfg.sph_kernel
        self.cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                          if cfg.double_beta_cool_cores else None)
        self.beta = sph_mod.uniform_beta(scene)
        self.h_hard = sph_mod.hard_h_cap(self.boxsize, n_gas)
        # read once here: the model density of every iteration then
        # needs no host read of the halo masses
        self.gas_halos = sph_mod.gas_halos(ha)
        self.log = log
        self.widths = {}
        # the relaxation's spans (``wvt_done`` carries them) and its
        # pair-work counter: the 128 x 128-pair blocks that every pair
        # kernel call walked (``count_pairs``), on the device
        self.spans = Spans()
        self.pairs = torch.zeros((), dtype=torch.int64, device=device)
        # the eager iterations' dynamic scalars (``iterate``)
        self.it_d = torch.zeros((), dtype=torch.int32, device=device)
        self.margin_d = torch.zeros((), dtype=torch.float32, device=device)
        # programs made, replays, eager iterations; the eager rules logged
        self.captured = self.replayed = self.eager = 0
        self.eager_logged = set()
        # the iteration programs by key, least recently run first (the
        # counterpart of the JAX package's _ITER_FN_CACHE), the capture
        # stream and the memory pool of their graphs; True while
        # ``speculate`` queues an iteration
        self.programs = OrderedDict()
        self.graphs = CapturePool()
        self.in_window = False
        # the candidate sweeps of the builds and list refreshes: programs
        # under the iteration programs' rules, on the same stream and pool
        self.sweeps = blk.Sweeps(self.eager_rule() is None, self.graphs,
                                 spans=self.spans)

    def sweep_record(self, it):
        """The counts of the sweeps since the last build or refresh, for
        its record: ``sweeps`` run, programs ``replayed`` and
        ``captured`` (each made one logged as ``wvt_graph`` of kind
        "sweep"), and ``sweep_spills``, the rows whose hits overflowed
        the sweep kernel's on-chip buffer (read in the sweeps' own host
        reads and at the call's ``settle``)."""
        spills = self.sweeps.spills
        n, replayed, made = self.sweeps.tally()
        for rec in made:
            self.log("wvt_graph", it=it, kind="sweep", **rec)
        return dict(sweeps=n, replayed=replayed, captured=len(made),
                    sweep_spills=spills)

    def walk_stats(self, rows, cols, device):
        """A zeroed (rows, cols) int32 ``stats=`` output of a pair kernel
        call, or None where the loop counts no pairs."""
        if self.pairs is None:
            return None
        return torch.zeros((rows, cols), dtype=torch.int32, device=device)

    def count_pairs(self, walked):
        """Add a call's walked source blocks (per row, each 128 x 128
        pairs: 128 receiver lanes against one 128-lane source block) to
        the counter; queues work and reads nothing back."""
        self.pairs.add_(walked.sum())

    def model_fields(self, pos_gas):
        return _model_fields_from_rho(
            sph_mod.global_density_model(pos_gas, self.ha, self.boxsize,
                                         self.cool_core, beta=self.beta,
                                         halos=self.gas_halos),
            self.mpart, self.desnngb)

    def selections(self, state):
        """``sph.classed_selections`` of ``state``, made at its first
        iteration (it reads the counts on the host) and kept for the
        iterations after, speculative ones included."""
        if self._sels[0] is not state:
            self._sels = (state, sph_mod.classed_selections(state,
                                                            self.widths))
        return self._sels[1]

    def solve_classed(self, state, pos_pad, h0_s, cap_s, hm_s, hm_src,
                      valid, sels=None):
        """Density solve and displacement per count class (``sels``: the
        state's classed selections, ``selections(state)`` by default):
        (rho, hsml, vf, wk, done) as (nb, 128) and delta (nb, 128, 3),
        box units."""
        nb = state.index.n_blocks
        kw = dict(kernel=self.kernel, desnngb=self.desnngb,
                  n_sweeps=sph_mod.CLASSED_SWEEPS)
        pos_t = pos_pad.reshape(nb, blk.BLOCK, 3).transpose(1, 2).contiguous()
        hm_b = hm_s.reshape(nb, blk.BLOCK)
        hm_blocks = hm_src.reshape(nb, 1, blk.BLOCK)
        valid_t = valid.to(torch.float32).reshape(nb, 1, blk.BLOCK)
        h_b3 = hm_s.reshape(nb, 1, blk.BLOCK)
        h0_b = h0_s.reshape(nb, blk.BLOCK)
        cap_b = cap_s.reshape(nb, blk.BLOCK)
        packs = {}

        def packed(h_blocks):
            # the kernels' source records and chunk table, made once an
            # iteration for all the calls below (the CPU path reads none)
            if not pos_t.is_cuda:
                return None
            if (h_blocks is None) not in packs:
                packs[h_blocks is None] = pack_sources(
                    pos_t, valid_t, h_blocks, self.boxsize)
            return packs[h_blocks is None]

        def packed_fused():
            # hm_blocks is h_b3 on the valid lanes and 0 elsewhere: the
            # displacement's chunk table is the fused kernel's too
            if not pos_t.is_cuda:
                return None
            if "fused" not in packs:
                packs["fused"] = pack_fused_sources(
                    pos_t, hm_blocks, self.boxsize, ctab=packed(h_b3).ctab)
            return packs["fused"]

        # the pairs walked: the density blocks the fused kernel walked
        # over all its sweeps (its displacement shares sweep 0's walk),
        # and the blocks each two-pass kernel walked
        def fused(ids, rows, cnt):
            idc = torch.clamp(ids, min=0).long()
            st = self.walk_stats(rows.shape[0], 5, rows.device)
            res = fused_wvt(pos_t, hm_blocks, rows, cnt, pos_t[idc],
                            h0_b[idc], cap_b[idc], hm_b[idc], self.mpart,
                            self.boxsize, packed=packed_fused(), stats=st,
                            **kw)
            if st is not None:
                self.count_pairs(st[:, 3])
            return res

        def two_pass(ids, rows, sb_mode):
            idc = torch.clamp(ids, min=0).long()
            cluster = _sp.padded_cluster(rows, sb_mode)
            st = [self.walk_stats(rows.shape[0], 4, rows.device)
                  for _ in range(2)]
            res = solve_density(pos_t, valid_t, rows, pos_t[idc], h0_b[idc],
                                cap_b[idc], self.mpart, self.boxsize,
                                sb_mode=sb_mode, cluster=cluster,
                                packed=packed(None), stats=st[0], **kw)[:5]
            res += (wvt_displacement(
                pos_t, valid_t, h_b3, rows, pos_t[idc], hm_b[idc], 1.0,
                self.boxsize, kernel=self.kernel, sb_mode=sb_mode,
                cluster=cluster, packed=packed(h_b3), stats=st[1]),)
            if st[0] is not None:
                self.count_pairs(st[0][:, 3] + st[1][:, 3])
            return res

        def tail(ids, sb_rows, sb_cnt):
            n0 = [k.launches for k in _SB_KERNELS]
            res = two_pass(ids, sb_rows, True)
            self.sb_launches = self.sb_launches + Counter(
                {k.__name__ + "_sb": k.launches - n
                 for k, n in zip(_SB_KERNELS, n0)})
            return res

        return sph_mod.run_classed(
            state,
            lambda ids, rows, cnt, m: (fused(ids, rows, cnt)
                                       if m <= FUSED_WIDTH else
                                       two_pass(ids, rows, False)),
            tail, sels=self.selections(state) if sels is None else sels)

    def body(self, state, sels, pos_gas, h_prev, rhom_prev, sat_mask,
             margin_d, fac_gas, step, err_last, it_d):
        """One WVT iteration on the current structure: model density,
        metric, the density solve + displacement, error statistics, the
        step shrink, the move and the accept-path cap ratchet, all on the
        device.  ``step``, ``err_last``, the margin ``margin_d`` (fp32)
        and the iteration index ``it_d`` (int32) are 0-d tensors, so the
        same body serves every iteration (the JAX iteration function's
        dynamic inputs); ``sels``: the state's classed selections.
        Returns a dict of device tensors: the lane results, err_mean and
        step_new (0-d, for the next call), fac_new, and ``scalars``, the
        float64 (7,) tensor of SCALARS that the loop reads.  Queues work
        and reads nothing back."""
        n_gas = self.n_gas
        nb = state.index.n_blocks
        n_padded = nb * blk.BLOCK
        dev = pos_gas.device

        def pad1(x):
            return blk.pad_rows(x, n_padded)

        rho_model, h0_model, h_box = self.model_fields(pos_gas)
        h0 = torch.where(h_prev > 0, h_prev * _warm_ratio(rho_model,
                                                          rhom_prev),
                         h0_model)
        valid = torch.arange(n_padded, device=dev) < n_gas
        h0_s = pad1(h0)
        hm_s = pad1(h_box)
        hm_src = torch.where(valid, hm_s, torch.zeros_like(hm_s))
        h_cap_pad = state.h_cap
        if self.engine == "classed":
            cap_eff = h_cap_pad
            rho, hsml, vf, wk, done, delta = self.solve_classed(
                state, pad1(pos_gas), h0_s, cap_eff, hm_s, hm_src, valid,
                sels=sels)
        else:
            margin = torch.where(pad1(h_prev > 0), margin_d,
                                 torch.full_like(h0_s, BITS_MARGIN_COLD))
            cap_eff = torch.where(pad1(sat_mask), h_cap_pad,
                                  torch.minimum(h_cap_pad, h0_s * margin))
            src, pos_t = sph_mod.source_blocks(pad1(pos_gas), hm_src)
            st = self.walk_stats(nb, 4, dev)
            rho, hsml, vf, wk, done, delta = stream_wvt(
                src, state.cand.idx, state.cand.count, pos_t,
                h0_s.reshape(nb, blk.BLOCK), cap_eff.reshape(nb, blk.BLOCK),
                hm_s.reshape(nb, blk.BLOCK), self.mpart, self.boxsize,
                kernel=self.kernel, desnngb=self.desnngb, do_disp=True,
                stats=st)
            if st is not None:
                # sweep 0 walks the members kept for either consumer,
                # every later sweep those kept for the density
                self.count_pairs(st[:, 1] + (st[:, 0] - 1) * st[:, 2])
        rho, hsml, vf, wk, done = (x.reshape(-1)
                                   for x in (rho, hsml, vf, wk, done))
        delta = delta.reshape(-1, 3)

        # saturation against the cap the solve actually used
        growable = pad1(fac_gas < FAC_MAX * 0.999)
        saturated = (~done) | (hsml >= cap_eff * 0.999)
        still_growable = h_cap_pad < self.h_hard * 0.999
        n_sat_d = (valid & saturated & still_growable & growable).sum()
        err = torch.abs(rho[:n_gas] - rho_model) / rho_model
        # worst per-particle displacement in units of the metric hsml
        drel = torch.where(
            valid, torch.linalg.vector_norm(delta, dim=1)
            / torch.clamp(hm_s, min=1e-30), torch.zeros_like(hm_s))
        # p99.9 of the per-block max drift: bounds d_i + d_j for every
        # pair not touching a top-0.1% mover block
        row_drel = drel.reshape(-1, blk.BLOCK).amax(dim=1)
        # the neighbour contract |wkNgb - DESNNGB| < NNGBDEV (sph.c:159-166)
        n_contract = ((torch.abs(wk - self.desnngb) < const.NNGBDEV)
                      & valid).sum()
        err_mean = err.mean()
        # step shrink (from it = 2 on) + move (wvt_relax.c:94-101
        # ordering), in fp32
        err_diff = (err_last - err_mean) / err_mean
        step_new = torch.where((it_d > 1) & (err_diff < 0.01), step * 0.8,
                               step)
        pos_new = pos_gas + delta[:n_gas] * (step_new * self.boxsize)
        pos_new = pos_new - torch.floor(pos_new / self.boxsize) * self.boxsize
        # accept-path cap ratchet: applied where the host will accept
        # this iteration's capped h, so a queued it+1 starts from it
        band = torch.where(it_d < 3, _accept_band(n_gas, 0),
                           _accept_band(n_gas))
        accept = (n_sat_d > 0) & (n_sat_d <= band)
        fac_new = torch.where(
            accept & (hsml[:n_gas] >= h_cap_pad[:n_gas] * 0.999),
            torch.clamp(fac_gas * 1.6, max=FAC_MAX), fac_gas)
        scalars = torch.stack([x.to(torch.float64) for x in (
            err.max(), err_mean, n_sat_d, drel.max(),
            percentile(row_drel, 99.9), n_contract, step_new)])
        return dict(rho=rho[:n_gas], hsml=hsml[:n_gas], vf=vf[:n_gas],
                    pos_new=pos_new, rho_model=rho_model, err_mean=err_mean,
                    step_new=step_new, fac_new=fac_new,
                    saturated=saturated[:n_gas], scalars=scalars)

    def eager_rule(self):
        """Why an iteration runs eagerly, or None: "off" (ITER_PROGRAMS),
        "large" (more gas than the engine's PROGRAM_MAX_GAS)."""
        if not ITER_PROGRAMS:
            return "off"
        if self.n_gas > PROGRAM_MAX_GAS[self.engine]:
            return "large"
        return None

    def program_key(self, state, sels):
        """The shapes and constants an iteration program is made for:
        engine, gas, blocks, list width, the classed class shape
        (``class_shape``) and tail shape (``tail_shape``), kernel,
        desnngb, cool core and beta."""
        return (self.engine, self.n_gas, state.index.n_blocks,
                state.max_cand, class_shape(sels), tail_shape(state),
                self.kernel, self.desnngb, self.cool_core, self.beta)

    def iterate(self, state, pos_gas, h_prev, rhom_prev, sat_mask,
                margin_w, fac_gas, step, err_last, it):
        """One WVT iteration (``body``) at the Python margin ``margin_w``
        and index ``it``: through the iteration program of the state's
        shape, or eagerly by ``eager_rule``.  Where the shape has no
        program yet the iteration runs eagerly and the program is made
        (on a CUDA device captured) after it; inside the speculation
        window (``speculate``) that raises instead.  Returns ``body``'s
        dict; queues work and reads nothing back (but the classed
        selections at a state's first iteration).  Spanned as
        ``wvt_step`` of kind "queued" (inside the window), "replay" or
        "eager"."""
        with self.spans.span("wvt_step", it=it) as span:
            out, kind = self._iterate(state, pos_gas, h_prev, rhom_prev,
                                      sat_mask, margin_w, fac_gas, step,
                                      err_last, it)
            span["kind"] = "queued" if self.in_window else kind
        return out

    def _iterate(self, state, pos_gas, h_prev, rhom_prev, sat_mask,
                 margin_w, fac_gas, step, err_last, it):
        sels = self.selections(state) if self.engine == "classed" else None
        inputs = (pos_gas, h_prev, rhom_prev, sat_mask, fac_gas, step,
                  err_last)
        rule = self.eager_rule()
        key = None if rule else self.program_key(state, sels)
        prog = self.programs.get(key)
        if prog is not None:
            self.programs.move_to_end(key)
            self.replayed += 1
            return prog.run(self, state, sels, inputs, margin_w, it), "replay"
        if rule is None and self.in_window:
            raise RuntimeError(
                f"no iteration program for {key} at it = {it}: a capture "
                f"inside the speculation window")
        if rule is not None:
            self.eager += 1
            if rule not in self.eager_logged:
                self.eager_logged.add(rule)
                self.log("wvt_eager", it=it, rule=rule)
        self.it_d.fill_(it)
        self.margin_d.fill_(margin_w)
        out = self.body(state, sels, pos_gas, h_prev, rhom_prev, sat_mask,
                        self.margin_d, fac_gas, step, err_last, self.it_d)
        if rule is None:
            self.make_program(key, state, sels, inputs, it)
        return out, "eager"

    def make_program(self, key, state, sels, inputs, it):
        """Make the program for ``key`` (captured on a CUDA device; the
        state's first iteration ran eagerly just before, which also
        loaded the kernels), keep it with the one before it, free older
        ones, and log ``wvt_graph``.  A new key comes only from a build
        or a list refresh, whose synchronisation finished every replay
        of the programs freed here.  On a CUDA device the log also holds
        ``added_gib``, the device memory the allocator reserved for the
        program (its static buffers and the growth of the graphs' pool).
        Spanned as ``wvt_capture`` of kind "iteration"."""
        with self.spans.span("wvt_capture", kind="iteration") as span:
            graph = inputs[0].is_cuda
            reserved = torch.cuda.memory_reserved() if graph else 0
            while len(self.programs) >= PROGRAMS_LIVE:
                self.programs.popitem(last=False)
            prog = _IterProgram(state, sels, inputs)
            if graph:
                prog.capture(self)
            self.programs[key] = prog
            self.captured += 1
            added = ({"added_gib": (torch.cuda.memory_reserved() - reserved)
                      / 2**30} if graph else {})
        self.log("wvt_graph", it=it, kind="iteration", key=key, graph=graph,
                 seconds=span["seconds"], kernels=prog.launches, **added)

    def speculate(self, state, out, margin_w, sat_false, it):
        """Iteration ``it`` queued from the previous iteration's device
        outputs ``out``: the JAX loop's speculative call (its margin
        ``margin_w`` without the cold floor, no saturation mask)."""
        self.in_window = True
        try:
            return self.iterate(state, out["pos_new"], out["hsml"],
                                out["rho_model"], sat_false, margin_w,
                                out["fac_new"], out["step_new"],
                                out["err_mean"], it)
        finally:
            self.in_window = False


class _IterProgram:
    """The iteration ``body`` of one key on static buffers: the loop
    arrays and dynamic scalars (copied or filled in before each run) and
    the state's lists, counts, cap, class ids and far-tail rows (ids,
    superblock lists, counts), copied in when the state changes (a state
    with far-tail rows at every iteration: it is rebuilt at each).  On a
    CUDA device a graph captured on them is replayed; on the CPU the body
    runs on them.  Outputs are cloned out, so a queued run cannot
    overwrite what a retry still reads.  ``launches``: the kernel
    launches of one run, by record name (the far-tail calls' under the
    kernel's name + "_sb")."""

    def __init__(self, state, sels, inputs):
        self.inputs = [torch.empty_like(x) for x in inputs]
        dev = inputs[0].device
        self.margin = torch.zeros((), dtype=torch.float32, device=dev)
        self.it = torch.zeros((), dtype=torch.int32, device=dev)
        cand = state.cand
        self.lists = [torch.empty_like(x) for x in (
            cand.idx, cand.count, state.h_cap) + (state.tail or ())]
        # the body reads the block count of the index, nothing else
        none = cand.idx.new_empty((state.index.n_blocks, 0))
        self.state = state._replace(
            index=blk.BlockIndex(*(none,) * 7),
            cand=cand._replace(idx=self.lists[0], count=self.lists[1],
                               sb_count=None), h_cap=self.lists[2],
            tail=None if state.tail is None else tuple(self.lists[3:]))
        self.sels = (None if sels is None else
                     [(m, torch.empty_like(ids)) for m, ids in sels])
        self.source = None   # weak reference to the lists the buffers hold
        self.graph = self.outputs = None
        self.launches = {}

    def load(self, state, sels, inputs, margin_w, it):
        if self.source is None or self.source() is not state.cand.idx:
            for buf, x in zip(self.lists, (state.cand.idx, state.cand.count,
                                           state.h_cap) + (state.tail or ())):
                buf.copy_(x)
            for (_, buf), (_, ids) in zip(self.sels or (), sels or ()):
                buf.copy_(ids)
            self.source = weakref.ref(state.cand.idx)
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.margin.fill_(margin_w)
        self.it.fill_(it)

    def body(self, loop):
        pos_gas, h_prev, rhom_prev, sat_mask, fac_gas, step, err_last = \
            self.inputs
        return loop.body(self.state, self.sels, pos_gas, h_prev, rhom_prev,
                         sat_mask, self.margin, fac_gas, step, err_last,
                         self.it)

    def capture(self, loop):
        """Capture ``loop.body`` into a CUDA graph on the loop's capture
        stream and memory pool.  A capture launches nothing, so the
        kernels' counters (and the loop's ``sb_launches``) are set back
        and the launches it recorded are added at each replay instead.
        Raises where capture fails."""
        before = [k.launches for k in _KERNELS]
        sb_before = loop.sb_launches
        graph, out = capture(lambda: self.body(loop), loop.graphs)
        for k, n in zip(_KERNELS, before):
            name = k.__name__
            sb = loop.sb_launches[name + "_sb"] - sb_before[name + "_sb"]
            for rec, d in ((name, k.launches - n - sb), (name + "_sb", sb)):
                if d:
                    self.launches[rec] = d
            k.launches = n
        loop.sb_launches = sb_before
        self.graph, self.outputs = graph, out

    def run(self, loop, state, sels, inputs, margin_w, it):
        self.load(state, sels, inputs, margin_w, it)
        if self.graph is None:
            out = self.body(loop)
        else:
            self.graph.replay()
            for rec, n in self.launches.items():
                _KERNEL_OF[rec.removesuffix("_sb")].launches += n
                REPLAYED_LAUNCHES[rec] += n
            out = self.outputs
        return {k: v.clone() for k, v in out.items()}


class _HostRead:
    """One iteration's scalars to the host: a non-blocking copy into a
    pinned buffer and a CUDA event recorded right after it (``post``),
    waited on alone (``read``), so work queued between the two keeps the
    card busy.  On the CPU the copy is synchronous."""

    def __init__(self, device):
        cuda = device.type == "cuda"
        self.buf = torch.empty((len(SCALARS),), dtype=torch.float64,
                               pin_memory=cuda)
        self.event = torch.cuda.Event() if cuda else None

    def post(self, scalars):
        self.buf.copy_(scalars, non_blocking=self.event is not None)
        if self.event is not None:
            self.event.record()

    def read(self):
        if self.event is not None:
            self.event.synchronize()
        return dict(zip(SCALARS, self.buf.tolist()))


@contextlib.contextmanager
def _sync_free(device, on):
    """With ``on`` and SYNC_CHECK on a CUDA device, a host sync in the
    block raises."""
    if not (on and SYNC_CHECK and device.type == "cuda"):
        yield
        return
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def offload_enabled(n_gas):
    """The JAX package's switch: the particle set is parked from
    TOYCLUSTER_WVT_OFFLOAD_N gas particles on (default OFFLOAD_N)."""
    return n_gas >= int(os.environ.get("TOYCLUSTER_WVT_OFFLOAD_N",
                                       str(OFFLOAD_N)))


def _to_host(x):
    """A host copy of ``x``, in pinned memory when ``x`` is on a CUDA
    device (so the copy back is one transfer)."""
    if not x.is_cuda:
        return x.clone()
    out = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    out.copy_(x)
    return out


class _Parked:
    """A particle set while the WVT loop runs with the offload (the JAX
    loop's, toycluster_tpu/models/wvt.py:698-717): ``pid`` and ``halo``
    in host memory, the DM half of ``pos`` on the device, ``vel``,
    ``bfld`` and ``apot`` as they came (0 rows at this stage; ``restore``
    permutes any gas rows they have).  The gas half of ``pos`` and the
    gas fields are not kept: the loop holds its own gas positions and
    hsml, and ``restore`` makes the rest anew."""

    def __init__(self, parts: Particles):
        n_gas = parts.n_gas
        self.pid = _to_host(parts.pid)
        self.halo = _to_host(parts.halo)
        self.pos_dm = parts.pos[n_gas:].clone()
        self.vel, self.bfld, self.apot = parts.vel, parts.bfld, parts.apot

    def restore(self, order_acc, pos_gas, rho, hsml, vf, rho_model):
        """The particle set after the loop (JAX: :1096-1113): the gas
        permutation ``order_acc`` applied to ``pid`` and ``halo`` on the
        host, the loop's gas positions before the DM half, and the
        loop's fields (zeros where the loop wrote none, and for ``u``:
        the temperature stage writes it first)."""
        n_gas, dev = pos_gas.shape[0], pos_gas.device
        order = order_acc.cpu()
        for x in (self.pid, self.halo):
            x[:n_gas] = x[:n_gas][order]
        zeros = torch.zeros((n_gas,), dtype=torch.float32, device=dev)

        def field(x):
            return zeros if x is None else x

        return Particles(
            pos=torch.cat([pos_gas, self.pos_dm]),
            vel=sph_mod.permute_rows(self.vel, order_acc, n_gas),
            pid=self.pid.to(dev, non_blocking=True),
            halo=self.halo.to(dev, non_blocking=True), u=zeros,
            rho=field(rho), hsml=field(hsml), var_hsml_fac=field(vf),
            rho_model=field(rho_model),
            bfld=sph_mod.permute_rows(self.bfld, order_acc, n_gas),
            apot=sph_mod.permute_rows(self.apot, order_acc, n_gas))


def _load_checkpoint(path, n_gas, device):
    """(pos_gas, step, err_last, err_diff_last, it) of a checkpoint;
    pos_gas in the original particle order."""
    with np.load(path) as ck:
        pos = ck["pos_gas"]
        if pos.shape != (n_gas, 3):
            raise ValueError(f"checkpoint {path} holds pos_gas of shape "
                             f"{pos.shape}, not ({n_gas}, 3)")
        return (torch.as_tensor(pos, dtype=torch.float32, device=device),
                float(ck["step"]), float(ck["err_last"]),
                float(ck["err_diff_last"]), int(ck["it"]))


def _save_checkpoint(path, pos_gas, order_acc, step, err_last,
                     err_diff_last, it):
    """Write the loop state in the JAX package's format: a resumed run
    starts from a fresh sort, so the positions go back to the original
    particle order (scattered through the composed permutation).  The
    file is written through a handle, so ``path`` gets no suffix."""
    pos_ck = torch.empty_like(pos_gas)
    pos_ck[order_acc] = pos_gas
    with open(path, "wb") as fh:
        np.savez(fh, pos_gas=pos_ck.cpu().numpy(), step=step,
                 err_last=err_last, err_diff_last=err_diff_last, it=it)


def regularise_sph_particles(scene: Scene, ha: HaloArrays,
                             parts: Particles | list, *, log=stage_log,
                             engine: str = "stream",
                             checkpoint_path: str | None = None,
                             checkpoint_every: int = 16):
    """Relax the gas positions on ``engine`` ("stream" or "classed",
    models/sph.py).  Returns (parts, fresh): ``fresh`` means
    the loop stopped without a final move, so parts.rho/hsml/
    var_hsml_fac already hold the full-contract density solve at the
    final positions and the stand-alone density stage is redundant.
    ``last_contract_frac`` then holds that solve's contract fraction.

    ``checkpoint_path``: WVT checkpoint/resume, the JAX package's NPZ
    file (gas positions in the original order, step, err_last,
    err_diff_last, it), written every ``checkpoint_every`` iterations
    and read at the start when the file exists; the run then goes on at
    the iteration after the saved one.  The file holds no h, cap factors
    or order, so a resumed run starts cold.  A checkpoint written while
    the next iteration is queued holds the saved iteration's state.

    Dispatch as in the JAX loop (module docstring): ``wvt_done`` counts
    the iterations queued ahead (``speculated``), the ones adopted and
    the ones dropped, and each drop is logged (``wvt_drop``, with its
    reason).  It also counts the iteration programs made (``captured``;
    each logged as ``wvt_graph`` with its key, seconds, the kernel
    launches it holds and the memory it added), the iterations they ran
    (``replayed``) and the iterations run eagerly by rule (``eager``;
    each rule logged once as ``wvt_eager``).  ``wvt_build`` carries the
    list width, the count classes' and the far tail's shapes (``classes``,
    ``tail``: the JAX loop's ``class_shape`` and ``tail_shape``) and the
    far-tail rows; ``wvt_build`` and ``wvt_refresh`` carry the device
    memory (``mem_gib``, ``peak_gib``) on a CUDA device, the first and
    last width the candidate search tried (``searched``), the candidate
    sweeps the call ran (``sweeps``; a probe and its second pass are two)
    and the sweep programs it replayed and made (``replayed``,
    ``captured``; each made one logged as ``wvt_graph`` of kind
    "sweep", the iteration programs' of kind "iteration").

    ``wvt_done`` also carries ``pairs_walked``, the pairs that every pair
    kernel call of the loop walked (eager, replayed, queued, retried and
    dropped iterations alike; read once, after the loop's last
    synchronisation), and ``spans`` (``utils.logging.Spans``): the root
    ``wvt_loop`` (its seconds are ``wvt_done``'s), one ``wvt_iteration``
    a pass of the loop (``it``), and below it ``wvt_build`` (``it``,
    ``attempt``) and ``wvt_refresh`` (``it``) over the intervals that
    their records' seconds cover, ``wvt_sweep`` (each ``blk.Sweeps.run``
    call), ``wvt_capture`` (each program made, over what its
    ``wvt_graph`` seconds cover), ``wvt_step`` (each ``_Loop.iterate``
    call) and ``wvt_wait`` (the host waiting on an iteration's scalars);
    where the set is parked, ``wvt_offload`` before the first iteration
    and ``wvt_restore`` after the last, below the root, over what their
    records' seconds cover (both with the gas ``rows`` and the
    ``host_bytes`` of ``pid`` and ``halo`` in host memory); after the
    root, ``wvt_release`` (the programs freed).

    ``parts`` may come as a one-element list, the JAX package's holder
    protocol: the loop pops it, so where the caller keeps no reference
    of its own, a run of ``offload_enabled`` size frees the buffers the
    loop never reads (``_Parked``; logged as ``wvt_offload`` with the
    seconds, the host GiB and the device memory after, and the rebuild
    at the end as ``wvt_restore``).  A plain ``parts`` stays alive in
    the caller, so the loop keeps it and permutes it at the end.
    ``pipeline.make_ics`` passes a holder; ``pipeline._relax_sharded``
    and the sharded loop (``parallel.wvt_shard``) take the plain set, as
    the JAX package's sharded branch does, and have no offload."""
    global last_contract_frac
    sph_mod.check_engine(engine)
    held = isinstance(parts, list)
    if held:
        parts = parts.pop()
    cfg = scene.config
    n_gas = parts.n_gas
    if n_gas == 0:
        return parts, False
    dev = parts.device
    L = _Loop(scene, ha, n_gas, engine, dev, log)
    build = partial(sph_mod.build_neighbours if engine == "stream"
                    else sph_mod.build_neighbours_blocks, widths=L.widths,
                    sweeps=L.sweeps)
    desnngb, mpart, boxsize = L.desnngb, L.mpart, L.boxsize
    spans = L.spans
    # the loop's root span: its seconds are wvt_done's
    root = spans.open("wvt_loop", profile=False)

    # step size (wvt_relax.c:48-56)
    if cfg.sph_kernel == "m4":
        step = 0.035
    else:
        step = 0.0085
        if scene.mtotal < 1e5:
            step /= 2.0
    err_last = math.inf
    err_diff_last = math.inf
    max_iter = min(cfg.wvt_max_iter, NUMITER)
    err_limit = cfg.wvt_err_diff_limit

    # the loop works on gas-only arrays and composes the Hilbert
    # permutations of its builds into order_acc, applied once at the end
    pos_gas = parts.pos[:n_gas].clone()
    h_prev = parts.hsml[:n_gas].clone()
    parked = None
    if held and offload_enabled(n_gas):
        moved = dict(rows=n_gas, host_bytes=parts.pid.nbytes
                     + parts.halo.nbytes)
        with spans.span("wvt_offload", **moved) as span:
            parked = _Parked(parts)
            parts = None
            _sync(dev)
        log("wvt_offload", n_gas=n_gas, seconds=span["seconds"],
            host_gib=moved["host_bytes"] / 2**30, **stage_memory(dev))
    # model density at each particle's previous position (_warm_ratio);
    # 0 = no prediction
    rhom_prev = torch.zeros((n_gas,), dtype=torch.float32, device=dev)
    order_acc = torch.arange(n_gas, device=dev)
    rho_l = hsml_l = vf_l = rho_model_l = None
    it0 = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        pos_gas, step, err_last, err_diff_last, it_saved = _load_checkpoint(
            checkpoint_path, n_gas, dev)
        it0 = it_saved + 1
        log("wvt_resume", it=it0, step=step)
    # the step and err_last as the device carries them (fp32); the host
    # keeps their values for the log, the stop rules and checkpoints
    step_d = torch.tensor(step, dtype=torch.float32, device=dev)
    err_last_d = torch.tensor(err_last, dtype=torch.float32, device=dev)

    state = None
    its_since_build = 0
    drift_acc = 0.0        # since the last list refresh or build
    sort_drift_acc = 0.0   # since the last full (re-sorting) build
    drift_inc_last = 0.0   # the last iteration's increment of drift_acc
    fresh = False
    n_iter = 0
    # per-lane cap factor (loop order, permuted at each build), ratcheted
    # 1.6x for lanes that keep saturating, up to FAC_MAX
    fac_gas = torch.full((n_gas,), sph_mod.CAP_FACTOR, dtype=torch.float32,
                         device=dev)
    # cold start: the top-2% metric-h lanes (sparse outskirts) start at
    # the ratchet's end point instead of crossing two rebuild storms
    if not bool((h_prev > 0).any()):
        h0m = L.model_fields(pos_gas)[1]
        fac_gas = torch.where(h0m > percentile(h0m, 98.0),
                              torch.full_like(h0m, FAC_MAX),
                              torch.full_like(h0m, sph_mod.CAP_FACTOR))
        del h0m
    sat_false = torch.zeros((n_gas,), dtype=torch.bool, device=dev)
    # adaptive warm margin: widened 1.15x per retry, decayed after 8
    # quiet iterations
    margin_warm = BITS_MARGIN_WARM
    quiet_iters = 0
    drift_budget = _drift_budget(cfg.sph_kernel)
    # speculative dispatch: (it, outputs) of the iteration queued ahead
    speculate = speculation_enabled(n_gas)
    pending = None
    n_spec = n_adopted = n_dropped = 0
    host = _HostRead(dev)

    def drop(reason, it):
        nonlocal n_dropped
        if pending is not None:
            n_dropped += 1
            log("wvt_drop", it=pending[0], at=it, reason=reason)
        return None

    it_span = None
    for it in range(it0, max_iter + 1):
        if it_span is not None:
            spans.close(it_span)
        it_span = spans.open("wvt_iteration", it=it)
        if (its_since_build >= REBUILD_EVERY
                or sort_drift_acc > SORT_DRIFT_BUDGET
                or (state is not None and state.tail is not None)):
            state = None
            pending = drop("build", it)
        elif drift_acc > drift_budget and state is not None:
            # drift spent the lists' radius slack: refresh the lists only
            # (the sort and block membership stay valid); the count-class
            # engine rebuilds
            pending = drop("refresh", it)
            if engine == "stream" and rho_model_l is not None:
                with spans.span("wvt_refresh", it=it) as span:
                    hm_w = (_metric_hsml(rho_model_l, mpart, desnngb)
                            * boxsize * SYM_MARGIN)
                    state = sph_mod.refresh_candidates(
                        state, pos_gas, hm_w, boxsize, widths=L.widths,
                        sweeps=L.sweeps)
                    drift_acc = 0.0
                    L.sweeps.settle(dev)
                log("wvt_refresh", it=it, max_cand=state.max_cand,
                    seconds=span["seconds"], searched=state.cand.searched,
                    **L.sweep_record(it), **stage_memory(dev))
            else:
                state = None

        grow_mask = None   # only saturated lanes get the grown cap
        sat_mask = sat_false
        accept_note = None
        for attempt in range(sph_mod.MAX_REBUILDS + 1):
            if state is None:
                _, h0_model, h_box = L.model_fields(pos_gas)
                h0 = torch.where(h_prev > 0, h_prev, h0_model)
                if grow_mask is not None:
                    fac_gas = torch.where(
                        grow_mask, torch.clamp(fac_gas * 1.6, max=FAC_MAX),
                        fac_gas)
                h_cap_gas = torch.clamp(
                    torch.maximum(h0, h0_model) * fac_gas, max=L.h_hard)
                with spans.span("wvt_build", it=it, attempt=attempt) as span:
                    state = build(pos_gas, h_cap_gas, boxsize,
                                  radius_sym_gas=h_box * boxsize * SYM_MARGIN)
                    del h0_model, h_box, h0, h_cap_gas
                    # adopt the sorted layout on the loop arrays
                    order = state.index.order
                    order_acc = order_acc[order]
                    pos_gas = state.index.pos[:n_gas]
                    h_prev = h_prev[order]
                    rhom_prev = rhom_prev[order]
                    fac_gas = fac_gas[order]
                    if sat_mask is not sat_false:
                        sat_mask = sat_mask[order]
                    its_since_build = 0
                    drift_acc = 0.0
                    sort_drift_acc = 0.0
                    L.sweeps.settle(dev)
                log("wvt_build", it=it, attempt=attempt,
                    seconds=span["seconds"],
                    max_cand=state.max_cand, searched=state.cand.searched,
                    **L.sweep_record(it),
                    classes=class_shape(L.selections(state)
                                        if engine == "classed" else None),
                    tail=tail_shape(state),
                    tail_rows=(0 if state.tail is None
                               else int((state.tail[0] >= 0).sum())),
                    **stage_memory(dev))

            if pending is not None and pending[0] == it:
                out = pending[1]
                n_adopted += 1
            else:
                # the cold-start / big-move phase keeps the cold margin
                mw = (max(margin_warm, BITS_MARGIN_COLD)
                      if err_last > 0.15 else margin_warm)
                out = L.iterate(state, pos_gas, h_prev, rhom_prev, sat_mask,
                                mw, fac_gas, step_d, err_last_d, it)
            pending = None
            # queue it+1 from this iteration's device outputs, then read
            # this iteration's scalars
            queue = speculate and speculation_blocked(
                it, max_iter, its_since_build, drift_acc, sort_drift_acc,
                drift_inc_last, drift_budget, state.tail, err_diff_last,
                err_limit) is None
            with _sync_free(dev, queue):
                host.post(out["scalars"])
                if queue:
                    pending = (it + 1, L.speculate(state, out, margin_warm,
                                                   sat_false, it + 1))
                    n_spec += 1
            with spans.span("wvt_wait", it=it):
                sc = host.read()
            n_sat = int(sc["n_sat"])
            if n_sat == 0:
                fac_gas = out["fac_new"]
                break
            if n_sat <= _accept_band(n_gas, it):
                # accept the capped h of a handful of lanes (the cap
                # ratchet for the next build is in fac_new)
                fac_gas = out["fac_new"]
                accept_note = n_sat
                break
            # saturation: retry, growing the cap only for cap-limited lanes
            pending = drop("retry", it)
            grow_mask = out["hsml"] >= state.h_cap[:n_gas] * 0.999
            n_grow = int(grow_mask.sum())
            sat_mask = out["saturated"]   # lift the margin clamp for these
            margin_warm = min(margin_warm * 1.15, 1.6)
            quiet_iters = 0
            h_prev = out["hsml"]
            rhom_prev = out["rho_model"]  # positions unchanged: ratio 1
            # lanes that outgrew the build-time search radius force a
            # rebuild; otherwise re-solve on the same lists
            rebuild = n_grow > _accept_band(n_gas)
            log("wvt_retry", it=it, attempt=attempt, n_sat=n_sat,
                n_grow=n_grow, rebuild=rebuild)
            if rebuild:
                state = None
        else:
            raise RuntimeError(
                f"hsml solve saturated for {n_sat} particles after "
                f"{sph_mod.MAX_REBUILDS} rebuilds")
        n_iter += 1
        its_since_build += 1
        quiet_iters += 1
        if quiet_iters >= 8 and margin_warm > BITS_MARGIN_WARM:
            margin_warm = max(margin_warm / 1.15, BITS_MARGIN_WARM)
            quiet_iters = 0

        rho_l, hsml_l, vf_l = out["rho"], out["hsml"], out["vf"]
        last_contract_frac = sc["n_contract"] / n_gas
        rho_model_l = out["rho_model"]
        h_prev = hsml_l
        rhom_prev = rho_model_l
        err_mean = sc["err_mean"]
        err_diff = (err_last - err_mean) / err_mean
        log("wvt", it=it, err_max=round(sc["err_max"], 4),
            err_mean=round(err_mean, 5), err_diff=round(err_diff, 5),
            step=step, margin=round(margin_warm, 3))
        if accept_note is not None:
            log("wvt_accept", it=it, n_accept=accept_note)

        # stopping rules, then adopt the post-shrink move
        if err_diff < err_limit and it > 25:
            fresh = True
            pending = drop("stop", it)
            break
        if err_diff < 0 and err_diff_last < 0 and it > 10:
            fresh = True
            pending = drop("stop", it)
            break
        step, step_d = sc["step_new"], out["step_new"]
        err_last, err_last_d = err_mean, out["err_mean"]
        err_diff_last = err_diff
        pos_gas = out["pos_new"]
        # applied drift against the budgets (both pair ends move)
        pair_drel = (sc["p999_rel"] if cfg.sph_kernel == "wc6"
                     else sc["dmax_rel"])
        drift_inc_last = 2.0 * pair_drel * step
        drift_acc += drift_inc_last
        sort_drift_acc += 2.0 * sc["dmax_rel"] * step
        del out
        if checkpoint_path and (it + 1) % checkpoint_every == 0:
            t_ck = time.perf_counter()
            _save_checkpoint(checkpoint_path, pos_gas, order_acc, step,
                             err_last, err_diff_last, it)
            log("wvt_checkpoint", it=it, seconds=time.perf_counter() - t_ck)

    if it_span is not None:
        spans.close(it_span)
    state = None
    if parked is not None:
        with spans.span("wvt_restore", **moved) as span:
            parts = parked.restore(order_acc, pos_gas, rho_l, hsml_l, vf_l,
                                   rho_model_l)
            parked = None
            _sync(dev)
        log("wvt_restore", seconds=span["seconds"])
    else:
        parts = sph_mod.permute_gas(parts, order_acc)
        parts = parts.replace(pos=torch.cat([pos_gas, parts.pos[n_gas:]]))
        if rho_l is not None:
            parts = parts.replace(rho=rho_l, hsml=hsml_l, var_hsml_fac=vf_l,
                                  rho_model=rho_model_l)
    _sync(dev)
    dt = spans.close(root)
    pairs_walked = int(L.pairs) * blk.BLOCK * blk.BLOCK
    # freeing the programs' graphs takes tens of ms on a card: after the
    # loop's seconds, inside make_ics's WVT range
    with spans.span("wvt_release"):
        L.programs.clear()
        L.sweeps.clear()
    log("wvt_done", iterations=n_iter, seconds=dt,
        particle_updates_per_s=n_gas * n_iter / dt, speculated=n_spec,
        adopted=n_adopted, dropped=n_dropped, captured=L.captured,
        replayed=L.replayed, eager=L.eager, pairs_walked=pairs_walked,
        spans=spans.take())
    return parts, fresh


# neighbour-contract fraction of the last iteration's density solve
last_contract_frac: float = float("nan")
