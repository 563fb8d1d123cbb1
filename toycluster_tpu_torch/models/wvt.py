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
"""

from __future__ import annotations

import math
import time

import torch

from .. import constants as const
from ..ops import blocks as blk
from ..ops.class_pair import (fused_bounds, fused_wvt, pack_sources,
                              solve_density, wvt_displacement)
from ..ops.stream_pair import stream_wvt
from ..particles import HaloArrays, Particles
from ..scene import Scene
from ..utils.logging import stage_log
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


def _drift_budget(kernel):
    return DRIFT_BUDGET if kernel == "wc6" else DRIFT_BUDGET_HARD_EDGE


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
    """Constants of one relaxation."""

    def __init__(self, scene: Scene, ha: HaloArrays, n_gas: int,
                 engine: str):
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

    def model_fields(self, pos_gas):
        return _model_fields_from_rho(
            sph_mod.global_density_model(pos_gas, self.ha, self.boxsize,
                                         self.cool_core, beta=self.beta),
            self.mpart, self.desnngb)

    def solve_classed(self, state, pos_pad, h0_s, cap_s, hm_s, hm_src,
                      valid):
        """Density solve and displacement per count class: (rho, hsml,
        vf, wk, done) as (nb, 128) and delta (nb, 128, 3), box units."""
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
        # the fused kernel's exact-zero skips: block boxes at the
        # current positions
        bb_lo, bb_hi = sph_mod.block_boxes(pos_pad, self.boxsize)
        bhm = hm_blocks[:, 0].amax(dim=1)

        def fused(ids, rows, cnt):
            idc = ids.long()
            gdist, dkeep = fused_bounds(bb_lo, bb_hi, ids, rows,
                                        hm_b[idc].amax(dim=1), bhm,
                                        self.boxsize)
            return fused_wvt(pos_t, hm_blocks, rows, cnt, pos_t[idc],
                             h0_b[idc], cap_b[idc], hm_b[idc], self.mpart,
                             self.boxsize, gdist=gdist, dkeep=dkeep, **kw)

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

        def two_pass(ids, rows, sb_mode):
            idc = ids.long()
            res = solve_density(pos_t, valid_t, rows, pos_t[idc], h0_b[idc],
                                cap_b[idc], self.mpart, self.boxsize,
                                sb_mode=sb_mode, packed=packed(None),
                                **kw)[:5]
            return res + (wvt_displacement(
                pos_t, valid_t, h_b3, rows, pos_t[idc], hm_b[idc], 1.0,
                self.boxsize, kernel=self.kernel, sb_mode=sb_mode,
                packed=packed(h_b3)),)

        return sph_mod.run_classed(
            state,
            lambda ids, rows, cnt, m: (fused(ids, rows, cnt)
                                       if m <= FUSED_WIDTH else
                                       two_pass(ids, rows, False)),
            lambda ids, sb_rows, sb_cnt: two_pass(ids, sb_rows, True))

    def iterate(self, state, pos_gas, h_prev, rhom_prev, sat_mask,
                margin_w, fac_gas, step, err_last, it):
        """One WVT iteration on the current structure: model density,
        metric, the density solve + displacement, error statistics and
        the speculative move.  Returns a dict of results."""
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
                state, pad1(pos_gas), h0_s, cap_eff, hm_s, hm_src, valid)
        else:
            margin = torch.where(pad1(h_prev > 0),
                                 torch.full_like(h0_s, margin_w),
                                 torch.full_like(h0_s, BITS_MARGIN_COLD))
            cap_eff = torch.where(pad1(sat_mask), h_cap_pad,
                                  torch.minimum(h_cap_pad, h0_s * margin))
            src, pos_t = sph_mod.source_blocks(pad1(pos_gas), hm_src)
            rho, hsml, vf, wk, done, delta = stream_wvt(
                src, state.cand.idx, state.cand.count, pos_t,
                h0_s.reshape(nb, blk.BLOCK), cap_eff.reshape(nb, blk.BLOCK),
                hm_s.reshape(nb, blk.BLOCK), self.mpart, self.boxsize,
                kernel=self.kernel, desnngb=self.desnngb, do_disp=True)
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
        stats = torch.stack([
            err.max(), err.mean(), n_sat_d.to(torch.float32), drel.max(),
            torch.quantile(row_drel, 0.999),
            n_contract.to(torch.float32)]).tolist()
        err_max, err_mean, n_sat, dmax_rel, p999_rel, n_contract = stats
        n_sat = int(n_sat)
        # step shrink + move (wvt_relax.c:94-101 ordering)
        err_diff = (err_last - err_mean) / err_mean
        step_new = step * 0.8 if (err_diff < 0.01 and it > 1) else step
        pos_new = pos_gas + delta[:n_gas] * (step_new * self.boxsize)
        pos_new = pos_new - torch.floor(pos_new / self.boxsize) * self.boxsize
        # accept-path cap ratchet
        band = _accept_band(n_gas, 0) if it < 3 else _accept_band(n_gas)
        if 0 < n_sat <= band:
            fac_new = torch.where(
                hsml[:n_gas] >= h_cap_pad[:n_gas] * 0.999,
                torch.clamp(fac_gas * 1.6, max=FAC_MAX), fac_gas)
        else:
            fac_new = fac_gas
        return dict(rho=rho[:n_gas], hsml=hsml[:n_gas], vf=vf[:n_gas],
                    pos_new=pos_new, rho_model=rho_model, err_max=err_max,
                    err_mean=err_mean, n_sat=n_sat, dmax_rel=dmax_rel,
                    p999_rel=p999_rel, step_new=step_new, fac_new=fac_new,
                    saturated=saturated[:n_gas],
                    contract_frac=n_contract / n_gas)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def regularise_sph_particles(scene: Scene, ha: HaloArrays,
                             parts: Particles, *, log=stage_log,
                             engine: str = "stream"):
    """Relax the gas positions on ``engine`` ("stream" or "classed",
    models/sph.py).  Returns (parts, fresh): ``fresh`` means
    the loop stopped without a final move, so parts.rho/hsml/
    var_hsml_fac already hold the full-contract density solve at the
    final positions and the stand-alone density stage is redundant.
    ``last_contract_frac`` then holds that solve's contract fraction."""
    global last_contract_frac
    sph_mod.check_engine(engine)
    cfg = scene.config
    n_gas = parts.n_gas
    if n_gas == 0:
        return parts, False
    dev = parts.device
    L = _Loop(scene, ha, n_gas, engine)
    build = (sph_mod.build_neighbours if engine == "stream"
             else sph_mod.build_neighbours_blocks)
    desnngb, mpart, boxsize = L.desnngb, L.mpart, L.boxsize
    t_start = time.perf_counter()

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
    # model density at each particle's previous position (_warm_ratio);
    # 0 = no prediction
    rhom_prev = torch.zeros((n_gas,), dtype=torch.float32, device=dev)
    order_acc = torch.arange(n_gas, device=dev)
    rho_l = hsml_l = vf_l = rho_model_l = None

    state = None
    its_since_build = 0
    drift_acc = 0.0        # since the last list refresh or build
    sort_drift_acc = 0.0   # since the last full (re-sorting) build
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
        fac_gas = torch.where(h0m > torch.quantile(h0m, 0.98),
                              torch.full_like(h0m, FAC_MAX),
                              torch.full_like(h0m, sph_mod.CAP_FACTOR))
        del h0m
    sat_false = torch.zeros((n_gas,), dtype=torch.bool, device=dev)
    # adaptive warm margin: widened 1.15x per retry, decayed after 8
    # quiet iterations
    margin_warm = BITS_MARGIN_WARM
    quiet_iters = 0
    drift_budget = _drift_budget(cfg.sph_kernel)

    for it in range(max_iter + 1):
        if (its_since_build >= REBUILD_EVERY
                or sort_drift_acc > SORT_DRIFT_BUDGET
                or (state is not None and state.tail is not None)):
            state = None
        elif drift_acc > drift_budget and state is not None:
            # drift spent the lists' radius slack: refresh the lists only
            # (the sort and block membership stay valid); the count-class
            # engine rebuilds
            if engine == "stream" and rho_model_l is not None:
                hm_w = (_metric_hsml(rho_model_l, mpart, desnngb)
                        * boxsize * SYM_MARGIN)
                state = sph_mod.refresh_candidates(state, pos_gas, hm_w,
                                                   boxsize)
                drift_acc = 0.0
                log("wvt_refresh", it=it, max_cand=state.max_cand)
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
                log("wvt_build", it=it, attempt=attempt,
                    max_cand=state.max_cand,
                    tail_rows=(0 if state.tail is None
                               else int(state.tail[0].shape[0])))

            # the cold-start / big-move phase keeps the cold margin
            mw = (max(margin_warm, BITS_MARGIN_COLD)
                  if err_last > 0.15 else margin_warm)
            out = L.iterate(state, pos_gas, h_prev, rhom_prev, sat_mask, mw,
                            fac_gas, step, err_last, it)
            n_sat = out["n_sat"]
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
        last_contract_frac = out["contract_frac"]
        rho_model_l = out["rho_model"]
        h_prev = hsml_l
        rhom_prev = rho_model_l
        err_mean = out["err_mean"]
        err_diff = (err_last - err_mean) / err_mean
        log("wvt", it=it, err_max=round(out["err_max"], 4),
            err_mean=round(err_mean, 5), err_diff=round(err_diff, 5),
            step=step, margin=round(margin_warm, 3))
        if accept_note is not None:
            log("wvt_accept", it=it, n_accept=accept_note)

        # stopping rules, then adopt the post-shrink move
        if err_diff < err_limit and it > 25:
            fresh = True
            break
        if err_diff < 0 and err_diff_last < 0 and it > 10:
            fresh = True
            break
        step = out["step_new"]
        err_last = err_mean
        err_diff_last = err_diff
        pos_gas = out["pos_new"]
        # applied drift against the budgets (both pair ends move)
        pair_drel = (out["p999_rel"] if cfg.sph_kernel == "wc6"
                     else out["dmax_rel"])
        drift_acc += 2.0 * pair_drel * step
        sort_drift_acc += 2.0 * out["dmax_rel"] * step
        del out

    state = None
    parts = sph_mod.permute_gas(parts, order_acc)
    parts = parts.replace(pos=torch.cat([pos_gas, parts.pos[n_gas:]]))
    if rho_l is not None:
        parts = parts.replace(rho=rho_l, hsml=hsml_l, var_hsml_fac=vf_l,
                              rho_model=rho_model_l)
    _sync(dev)
    dt = time.perf_counter() - t_start
    log("wvt_done", iterations=n_iter, seconds=dt,
        particle_updates_per_s=n_gas * n_iter / dt)
    return parts, fresh


# neighbour-contract fraction of the last iteration's density solve
last_contract_frac: float = float("nan")
