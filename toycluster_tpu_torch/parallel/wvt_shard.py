"""The sharded production WVT iteration and relaxation loop over the
ranks of a ``Mesh`` (parallel/mesh.py).

JAX counterpart: ``toycluster_tpu/parallel/wvt_shard.py``.  Each rank
owns a contiguous range of Hilbert-sorted particle blocks and runs the
full iteration on it: block boxes, the candidate search, the adaptive-h
SPH density solve (sph.c:80-214), the error statistics, the metric
renormalisation and the WVT displacement (wvt_relax.c:126-171), with
collectives where the reference used shared memory: ``all_gather`` for
the block metadata and the sources, ``psum`` for the metric volume and
the mean error (wvt_relax.c:73-124), ``pmax`` for the largest error,
the drift and the overflow indicators.

Receiver-side arrays stay rank-local.  Source memory depends on the halo
mode of the stream engine:

* ``halo="ring"``: only the block metadata is all-gathered; the rank's
  sources travel the ring once an iteration (``Mesh.ring_shift``, size -
  1 passes), and each pass keeps the visiting superblocks that a local
  receiver's list names in a boundary buffer of ``R`` superblocks plus
  an all-zero dump slot (hm = 0 sources take part in no pair).  A rank
  holds O(N / size + R) sources.  Superblocks past the buffer are
  reported through ``cand_overflow``, and ``regularise_sharded`` raises
  on them;
* ``halo="gather"``: the sources are all-gathered, O(N) a rank.

The engines: ``"stream"`` runs ``ops/stream_pair.stream_wvt`` on
superblock lists (the kernel runs its member test itself, so no skip
bits are made here; the lists address slots of the combined ``[local |
halo]`` source array); ``"xla"`` runs ``ops/class_pair.solve_density``
and ``wvt_displacement`` on block lists of width ``max_cand`` over the
all-gathered sources, the port's counterpart of the JAX package's XLA
pair operators.  ``"auto"`` picks ``stream`` on a card and ``xla`` on
the CPU.  On a CUDA tensor every operator launches its kernel; on a CPU
tensor it runs its plain version.

List widths: ``max_cand`` (block lists; a quarter of it in superblocks)
is where a build starts, as in JAX, but where a rank's widest row needs
more the port builds again at that width (``_grown_candidates``; JAX,
whose shapes are static, truncates and reports) up to every block or
superblock (the stream kernel's MAX_LIST_WIDTH).  Overflow past that is
reported as the pmax'd count excess, and saturated lanes keep their
capped h.  A build syncs the host once for its width, an iteration once,
where ``regularise_sharded`` reads its scalars.
"""

from __future__ import annotations

import math
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from .. import constants as const
from ..models.sph import global_density_model, hard_h_cap
from ..models.wvt import REBUILD_EVERY, _drift_budget, _warm_ratio
from ..ops.blocks import BLOCK, SUPER, _interval_dist2
from ..ops.class_pair import solve_density, wvt_displacement
from ..ops.keys import hilbert_order
from ..ops.stream_pair import MAX_LIST_WIDTH, stream_wvt
from .mesh import Mesh

_CAP_FACTOR = 1.35   # candidate-radius margin over the warm-start hsml
_CAND_CHUNK = 64     # receiver blocks per candidate-sweep chunk
# Newton/bisection sweeps of the xla engine's solve: the budget of the
# JAX package's pair_ops.solve_density (max_iter=32)
_XLA_SWEEPS = 32
ENGINES = ("auto", "stream", "xla")
HALOS = ("auto", "ring", "gather")


class ShardStepResult(NamedTuple):
    pos: torch.Tensor        # (N, 3) new positions, original order
    rho: torch.Tensor        # (N,) SPH density
    hsml: torch.Tensor       # (N,) solved smoothing length (warm start)
    rho_model: torch.Tensor  # (N,) model density at the OLD positions:
    #                          feed back as rhom_prev (wvt._warm_ratio)
    err_mean: torch.Tensor   # () mean |rho - rho_model| / rho_model
    err_max: torch.Tensor    # ()
    n_saturated: torch.Tensor  # () lanes that hit the hsml cap
    cand_overflow: torch.Tensor  # () max candidate-count excess (<= 0 ok)


def _local_candidates(lo_l, hi_l, rad_l, lo_all, hi_all, rad_all, boxsize,
                      max_cand):
    """Per local receiver block, the ascending ids of the candidate
    blocks within max(rad_i, (rad_i + rad_j) / 2): the union of the
    density gather range (tree.c:25) and the WVT symmetric pair range
    (wvt_relax.c:158), so one list serves both passes.  Returns (idx
    (nbl, max_cand) int32, -1 padded; overflow () int64, the largest
    count minus max_cand, at least -1)."""
    nb = lo_all.shape[0]
    nbl = lo_l.shape[0]
    dev = lo_l.device
    ids = torch.arange(nb, dtype=torch.int32, device=dev)
    idx = torch.full((nbl, max_cand), -1, dtype=torch.int32, device=dev)
    count = torch.zeros((nbl,), dtype=torch.int64, device=dev)
    for s0 in range(0, nbl, _CAND_CHUNK):
        s1 = min(s0 + _CAND_CHUNK, nbl)
        d2 = _interval_dist2(lo_l[s0:s1, None], hi_l[s0:s1, None],
                             lo_all[None], hi_all[None], boxsize)
        r_i = rad_l[s0:s1, None]
        rng = torch.maximum(r_i, 0.5 * (r_i + rad_all[None]))
        hit = d2 <= rng * rng
        srt = torch.sort(torch.where(hit, ids, nb), dim=1).values
        k = min(max_cand, nb)
        idx[s0:s1, :k] = torch.where(srt[:, :k] >= nb, -1, srt[:, :k])
        count[s0:s1] = hit.sum(dim=1)
    return idx, torch.clamp(count.max() - max_cand, min=-1)


def _grown_candidates(lo_l, hi_l, rad_l, lo_all, hi_all, rad_all, boxsize,
                      width, cap):
    """``_local_candidates`` at ``width``, and once more at the width
    this rank's widest row needs (rounded up to 64, at most ``cap``) if
    that overflows: the JAX package's static width truncates such rows
    (keeping their lowest ids) and only reports it, and on the card the
    1e6 par and config 4 at 1e7 overflowed its default, after which the
    solve's caps ran away and err_mean rose.  The width is this rank's:
    the lists are rank-local.  Returns (idx, overflow past the final
    width)."""
    cand, overflow = _local_candidates(lo_l, hi_l, rad_l, lo_all, hi_all,
                                       rad_all, boxsize, width)
    need = width + int(overflow)   # the build's one host sync
    if need > width and width < cap:
        width = min(cap, -(-need // 64) * 64)
        cand, overflow = _local_candidates(lo_l, hi_l, rad_l, lo_all,
                                           hi_all, rad_all, boxsize, width)
    return cand, overflow


def _blocks_t(pos, nb):
    """(nb, 3, 128) coordinate rows of (nb * 128, 3) positions."""
    return pos.reshape(nb, BLOCK, 3).transpose(1, 2)


def sharded_wvt_iteration(mesh: Mesh, ha, *, n_real: int, boxsize: float,
                          mpart: float, desnngb: int, kernel: str = "wc6",
                          max_cand: int = 256, cool_core=None,
                          engine: str = "auto", halo: str = "auto",
                          max_remote_sb=None):
    """The sharded iteration, as an engine with a structure-reuse API
    (``_ShardEngine``).  Calling it runs one fresh iteration on the full
    (N, 3) / (N,) arrays, N = n_real padded by ``pad_for_mesh`` (the
    padding is masked out of every pair sum and reduction), given alike
    on every rank, and returns a ``ShardStepResult`` of full arrays,
    equal on every rank.

    ``engine`` and ``halo`` as in the module docstring; ``halo="auto"``
    is ``ring`` for the stream engine and ``gather`` for ``xla``, and
    ``ring`` needs the stream engine.  ``max_cand`` is the lists' first
    width (see the module docstring).  ``max_remote_sb`` sizes the ring's
    boundary buffer in superblocks (default: a rank's own superblock
    count, at least 256, at most the remote superblocks)."""
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, not {engine!r}")
    if halo not in HALOS:
        raise ValueError(f"halo must be one of {HALOS}, not {halo!r}")
    if engine == "auto":
        engine = "stream" if mesh.device.type == "cuda" else "xla"
    use_stream = engine == "stream"
    if halo == "auto":
        halo = "ring" if use_stream else "gather"
    if halo == "ring" and not use_stream:
        raise ValueError("halo='ring' requires the stream engine")
    n_dev, rank = mesh.size, mesh.rank
    boxsize = float(boxsize)
    mpart = float(mpart)
    h_hard = hard_h_cap(boxsize, n_real)
    # superblocks a rank owns, and the ring's boundary buffer: by default
    # one rank's worth (generous: the Hilbert boundary is a surface),
    # floored for small runs, never more than the remote superblocks
    nsl = -(-n_real // (BLOCK * SUPER * n_dev))
    R = (int(max_remote_sb) if max_remote_sb
         else min(max(nsl, 256), max((n_dev - 1) * nsl, 1)))

    def _prologue(pos_l, hprev_l, rhomp_l, valid_l):
        """Model density, warm-start caps, the metric hsml (global
        volume renormalisation) and the local block boxes and search
        radii; the same in the build and the iteration, so structure
        reuse never changes the arithmetic."""
        nbl = pos_l.shape[0] // BLOCK
        rho_model_l = global_density_model(pos_l, ha, boxsize, cool_core)
        h0_model_l = (desnngb * mpart / rho_model_l
                      / const.FOURPITHIRD) ** (1.0 / 3.0)
        h_guess_l = torch.where(
            hprev_l > 0, hprev_l * _warm_ratio(rho_model_l, rhomp_l),
            h0_model_l)
        cap_l = torch.clamp(torch.maximum(h_guess_l, h0_model_l)
                            * _CAP_FACTOR, max=h_hard)
        # WVT metric hsml, global volume renorm (wvt_relax.c:108-124)
        v_sum = mesh.psum(torch.where(valid_l, h0_model_l, 0.0).double()
                          .pow(3).sum())
        hm_l = h0_model_l * (desnngb / v_sum / const.FOURPITHIRD).pow(
            1.0 / 3.0).float()
        blocks_l = pos_l.reshape(nbl, BLOCK, 3)
        rad_part = torch.maximum(cap_l, hm_l * boxsize)
        return (rho_model_l, h_guess_l, cap_l, hm_l, blocks_l.amin(dim=1),
                blocks_l.amax(dim=1),
                rad_part.reshape(nbl, BLOCK).amax(dim=1))

    def cand_body(pos_l, hprev_l, rhomp_l, valid_l):
        """The candidate lists at the current positions (superblock ids
        for the stream engine, block ids for xla).  They carry
        _CAP_FACTOR slack, so they stay valid while the drift since the
        build is within the kernel's budget (models/wvt._drift_budget)."""
        lo_l, hi_l, rad_l = _prologue(pos_l, hprev_l, rhomp_l, valid_l)[4:]
        lo_all = mesh.all_gather(lo_l)
        hi_all = mesh.all_gather(hi_l)
        rad_all = mesh.all_gather(rad_l)
        if use_stream:
            ns = lo_all.shape[0] // SUPER
            sb_lo = lo_all.reshape(ns, SUPER, 3).amin(dim=1)
            sb_hi = hi_all.reshape(ns, SUPER, 3).amax(dim=1)
            sb_rad = rad_all.reshape(ns, SUPER).amax(dim=1)
            cand, overflow = _grown_candidates(
                lo_l, hi_l, rad_l, sb_lo, sb_hi, sb_rad, boxsize,
                min(max(16, max_cand // 4), ns), min(ns, MAX_LIST_WIDTH))
        else:
            cand, overflow = _grown_candidates(
                lo_l, hi_l, rad_l, lo_all, hi_all, rad_all, boxsize,
                max_cand, lo_all.shape[0])
        cnt = (cand >= 0).sum(dim=1).to(torch.int32)
        return cand, cnt, mesh.pmax(overflow)

    def ring_sources(src_l, cand):
        """The ring halo exchange: the combined [local | boundary buffer |
        dump slot] sources (nb, 4, 128), the lists mapped onto its
        superblock slots, the buffer fill and its overflow."""
        ns = n_dev * nsl
        dev = src_l.device
        src_sb = src_l.reshape(nsl, SUPER, 4, BLOCK)
        # which global superblocks some local receiver needs
        need = torch.zeros((ns + 1,), dtype=torch.bool, device=dev)
        need[torch.where(cand >= 0, cand, ns).long().reshape(-1)] = True
        # slots 0..R-1 the buffer, R the all-zero dump slot, R + 1 where
        # the superblocks that find no slot land (dropped)
        buf = src_l.new_zeros((R + 2, SUPER, 4, BLOCK))
        slot_map = torch.full((ns,), -1, dtype=torch.int64, device=dev)
        slot_map[rank * nsl:(rank + 1) * nsl] = torch.arange(nsl,
                                                             device=dev)
        visiting = src_sb
        off = torch.zeros((), dtype=torch.int64, device=dev)
        for k in range(1, n_dev):
            visiting = mesh.ring_shift(visiting)
            owner = (rank - k) % n_dev
            want = need[owner * nsl:(owner + 1) * nsl]
            slots = off + torch.cumsum(want, dim=0) - 1
            buf.index_copy_(0, torch.where(want & (slots < R), slots, R + 1),
                            visiting)
            slot_map[owner * nsl:(owner + 1) * nsl] = torch.where(
                want, nsl + torch.clamp(slots, max=R), -1)
            off = off + want.sum()
        buf[R + 1] = 0.0
        src = torch.cat([src_sb, buf[:R + 1]]).reshape(-1, 4, BLOCK)
        cand_k = torch.where(cand >= 0,
                             slot_map[torch.clamp(cand, 0, ns - 1).long()],
                             -1).to(torch.int32)
        return src.contiguous(), cand_k.contiguous(), off, off - R

    def body(pos_l, hprev_l, rhomp_l, valid_l, cand, cnt, step):
        nbl = pos_l.shape[0] // BLOCK
        (rho_model_l, h_guess_l, cap_l, hm_l, _, _, _) = _prologue(
            pos_l, hprev_l, rhomp_l, valid_l)
        cap_b = cap_l.reshape(nbl, BLOCK).contiguous()
        h0_b = h_guess_l.reshape(nbl, BLOCK).contiguous()
        hm_b = hm_l.reshape(nbl, BLOCK).contiguous()
        xi = _blocks_t(pos_l, nbl).contiguous()
        overflow = torch.full((), -1, dtype=torch.int64,
                              device=pos_l.device)
        fill = torch.full((), -1, dtype=torch.int64, device=pos_l.device)
        if use_stream:
            hm_src_l = torch.where(valid_l, hm_l, 0.0)
            src_l = torch.cat([_blocks_t(pos_l, nbl),
                               hm_src_l.reshape(nbl, 1, BLOCK)], dim=1)
            if halo == "ring":
                src, cand_k, fill, overflow = ring_sources(src_l, cand)
            else:
                src = mesh.all_gather(src_l.contiguous())
                cand_k = cand
            rho_b, h_b, _vf, wk_b, done_b, delta_b = stream_wvt(
                src, cand_k, cnt, xi, h0_b, cap_b, hm_b, mpart, boxsize,
                kernel=kernel, desnngb=desnngb, do_disp=True)
            sat_b = (~done_b) | (h_b >= cap_b * 0.999)
            # the stream delta is unscaled: the step is applied here, as
            # in the single-card loop
            delta = delta_b.reshape(-1, 3) * step
        else:
            nb_all = n_dev * nbl
            pos_all_t = _blocks_t(mesh.all_gather(pos_l), nb_all).contiguous()
            valid_all = mesh.all_gather(valid_l).to(torch.float32).reshape(
                nb_all, 1, BLOCK)
            hm_all = mesh.all_gather(hm_l).reshape(nb_all, 1, BLOCK)
            rho_b, h_b, _vf, wk_b, _done, sat_b = solve_density(
                pos_all_t, valid_all, cand, xi, h0_b, cap_b, mpart, boxsize,
                kernel=kernel, desnngb=desnngb, n_sweeps=_XLA_SWEEPS)
            delta = wvt_displacement(
                pos_all_t, valid_all, hm_all, cand, xi, hm_b, float(step),
                boxsize, kernel=kernel).reshape(-1, 3)
        rho_r, hsml_r = rho_b.reshape(-1), h_b.reshape(-1)
        # error statistics vs the model (wvt_relax.c:74-87) and the
        # neighbour contract (sph.c:159-166)
        err = torch.where(valid_l,
                          torch.abs(rho_r - rho_model_l) / rho_model_l, 0.0)
        contract = valid_l & (torch.abs(wk_b.reshape(-1) - desnngb)
                              < const.NNGBDEV)
        sums = mesh.psum(torch.stack([
            err.double().sum(), valid_l.sum().double(),
            (valid_l & sat_b.reshape(-1)).sum().double(),
            contract.sum().double()]))
        new_pos = pos_l + delta * boxsize
        new_pos = new_pos - torch.floor(new_pos / boxsize) * boxsize
        # the largest move this step in units of the local metric h: the
        # sharded drift accumulator (models/wvt._drift_budget)
        dr = torch.linalg.vector_norm(delta, dim=-1)
        maxes = mesh.pmax(torch.stack([
            err.max().double(), torch.where(valid_l, dr / hm_l, 0.0).max()
            .double(), overflow.double(), fill.double()]))
        return dict(pos=new_pos, rho=rho_r, hsml=hsml_r,
                    rho_model=rho_model_l,
                    err_mean=(sums[0] / sums[1]).float(),
                    err_max=maxes[0].float(), n_sat=sums[2].long(),
                    overflow=maxes[2].long(), drift=maxes[1].float(),
                    ring_fill=maxes[3].long(), n_contract=sums[3].long())

    def _assert_padded(n):
        if n != nsl * n_dev * BLOCK * SUPER:
            raise ValueError(f"N={n} is not n_real={n_real} padded to a "
                             f"multiple of BLOCK * SUPER * world size = "
                             f"{BLOCK * SUPER * n_dev}; pad with "
                             f"pad_for_mesh()")

    class _ShardEngine:
        """The step function with a structure-reuse API.  Calling it runs
        one fresh iteration (sort + build + iterate + unsort).  ``sort``,
        ``build`` and ``iterate`` let ``regularise_sharded`` keep the
        Hilbert order and the candidate lists across iterations within
        the drift budget, as the single-card loop does."""
        halo_ = halo
        ring_slots_ = R if halo == "ring" else 0

        def sort(self, pos, hsml_prev, rhom_prev):
            """Hilbert-sort the full arrays (given alike on every rank):
            returns this rank's rows of the sorted pos, hsml_prev and
            rhom_prev, its valid mask, and the full order."""
            _assert_padded(pos.shape[0])
            order = hilbert_order(pos, boxsize)
            return (mesh.rows(pos[order]), mesh.rows(hsml_prev[order]),
                    mesh.rows(rhom_prev[order]), mesh.rows(order < n_real),
                    order)

        def build(self, pos_l, hprev_l, rhomp_l, valid_l):
            """(cand, cnt, overflow) of this rank's rows."""
            return cand_body(pos_l, hprev_l, rhomp_l, valid_l)

        def iterate(self, pos_l, hprev_l, rhomp_l, valid_l, cand, cnt,
                    step):
            """One iteration on this rank's rows: a dict of the local
            pos (moved), rho, hsml, rho_model and the global scalars
            err_mean, err_max, n_sat, overflow, drift, ring_fill (the
            largest boundary-buffer fill, -1 without the ring) and
            n_contract (0-d tensors, equal on every rank)."""
            return body(pos_l, hprev_l, rhomp_l, valid_l, cand, cnt, step)

        def __call__(self, pos, hsml_prev, step, rhom_prev=None):
            if rhom_prev is None:
                rhom_prev = torch.zeros_like(hsml_prev)
            pos_l, h_l, rm_l, valid_l, order = self.sort(pos, hsml_prev,
                                                          rhom_prev)
            cand, cnt, overflow_b = self.build(pos_l, h_l, rm_l, valid_l)
            out = self.iterate(pos_l, h_l, rm_l, valid_l, cand, cnt, step)

            def full(x):
                return _unsort(mesh.all_gather(x), order)
            return ShardStepResult(
                pos=full(out["pos"]), rho=full(out["rho"]),
                hsml=full(out["hsml"]), rho_model=full(out["rho_model"]),
                err_mean=out["err_mean"], err_max=out["err_max"],
                n_saturated=out["n_sat"],
                cand_overflow=torch.maximum(out["overflow"], overflow_b))

    return _ShardEngine()


def _unsort(x, order):
    """x in sorted order -> original order (x[inv], inv the inverse of
    ``order``)."""
    inv = torch.empty_like(order)
    inv[order] = torch.arange(order.shape[0], device=order.device)
    return x[inv]


def pad_for_mesh(pos, n_dev):
    """Pad (N, 3) positions, repeating the last particle, to a multiple
    of BLOCK * SUPER * n_dev: every rank then holds whole superblocks
    (the ring moves whole superblocks); returns (padded, n_real)."""
    n = pos.shape[0]
    q = BLOCK * SUPER * n_dev
    n_pad = -(-n // q) * q
    if n_pad > n:
        pos = torch.cat([pos, pos[-1:].expand(n_pad - n, 3)])
    return pos, n


def shard_array(mesh: Mesh, x):
    """This rank's rows of x (x given alike on every rank)."""
    return mesh.rows(x)


def regularise_sharded(mesh: Mesh, ha, pos_gas, *, boxsize, mpart, desnngb,
                       kernel="wc6", max_cand=256, step=0.0085, max_iter=64,
                       err_diff_limit=0.01, cool_core=None, log=None,
                       engine="auto", halo="auto", max_remote_sb=None,
                       checkpoint_path=None, checkpoint_every=8):
    """The multi-rank WVT relaxation: the sharded iteration under the
    reference's host-side early-stop and step-shrink rules
    (wvt_relax.c:94-101), with the single-card loop's structure reuse (a
    full re-sort and rebuild every models/wvt.REBUILD_EVERY iterations,
    or once the accumulated largest drift exceeds the kernel's drift
    budget) and checkpoint/resume: the NPZ
    ``checkpoint_path`` (pos, hsml, rhom, it, step, err_last,
    err_diff_last; original padded order) is written by rank 0 every
    ``checkpoint_every`` iterations and resumed from when present.

    ``pos_gas`` (n, 3) is given alike on every rank, on ``mesh.device``
    (ValueError otherwise).  A ring halo whose boundary buffer cannot
    hold every remote superblock that a local list names raises
    RuntimeError: pass a larger ``max_remote_sb``.  Returns (pos, rho,
    hsml), each the full (n, ...) array in the original order on every
    rank: the positions before the rejected move, with the density and
    hsml of the final solve.  ``log`` (stage, **fields) is called on
    rank 0 only: ``wvt_shard_build`` and ``wvt_shard`` with the JAX
    package's fields, ``wvt_shard_resume``, ``wvt_shard_ring`` (the
    largest fill of the boundary buffer over the ranks, and its slots;
    ring halo only),
    ``wvt_shard_comm`` (collectives, host s and device ms of the
    iteration, when ``mesh.timing`` is set) and ``wvt_shard_done``
    (iterations, seconds, particle updates/s, the final contract
    fraction)."""
    if pos_gas.device != mesh.device:
        raise ValueError(f"pos_gas lies on {pos_gas.device}, the mesh's rank "
                         f"on {mesh.device}")
    drift_budget = _drift_budget(kernel)
    log = log if (log is not None and mesh.rank == 0) else None
    dev = mesh.device
    t_start = time.perf_counter()

    pos, n_real = pad_for_mesh(pos_gas, mesh.size)
    n = pos.shape[0]
    hsml = torch.zeros((n,), dtype=torch.float32, device=dev)
    rhom = torch.zeros((n,), dtype=torch.float32, device=dev)
    err_last = math.inf
    err_diff_last = math.inf
    it0 = 0
    if checkpoint_path and os.path.exists(checkpoint_path):
        with np.load(checkpoint_path) as ck:
            if ck["pos"].shape != (n, 3):
                raise ValueError(f"checkpoint {checkpoint_path} holds pos of "
                                 f"shape {ck['pos'].shape}, not ({n}, 3)")
            pos = torch.as_tensor(ck["pos"], dtype=torch.float32, device=dev)
            hsml = torch.as_tensor(ck["hsml"], dtype=torch.float32,
                                   device=dev)
            rhom = torch.as_tensor(ck["rhom"], dtype=torch.float32,
                                   device=dev)
            it0 = int(ck["it"]) + 1
            step = float(ck["step"])
            err_last = float(ck["err_last"])
            err_diff_last = float(ck["err_diff_last"])
        if log:
            log("wvt_shard_resume", it=it0, step=step, err_last=err_last)

    eng = sharded_wvt_iteration(
        mesh, ha, n_real=n_real, boxsize=boxsize, mpart=mpart,
        desnngb=desnngb, kernel=kernel, max_cand=max_cand,
        cool_core=cool_core, engine=engine, halo=halo,
        max_remote_sb=max_remote_sb)

    def full(x):
        return _unsort(mesh.all_gather(x), order_total)

    # the loop state lives in sorted space between rebuilds (this rank's
    # rows); order_total maps sorted slots back to original particles
    pos_l = h_l = rm_l = valid_l = cand = cnt = order_total = None
    its_since_build = 0
    drift_acc = 0.0
    out = None
    n_iter = 0
    for it in range(it0, max_iter + 1):
        if (pos_l is None or its_since_build >= REBUILD_EVERY
                or drift_acc > drift_budget):
            if pos_l is not None:
                # leave sorted space before re-sorting
                pos, hsml, rhom = full(pos_l), full(h_l), full(rm_l)
            pos_l, h_l, rm_l, valid_l, order_total = eng.sort(pos, hsml,
                                                              rhom)
            cand, cnt, overflow_b = eng.build(pos_l, h_l, rm_l, valid_l)
            its_since_build = 0
            drift_acc = 0.0
            if log:
                log("wvt_shard_build", it=it, overflow=int(overflow_b))
        out = eng.iterate(pos_l, h_l, rm_l, valid_l, cand, cnt, step)
        # the iteration's one host sync
        (err_mean, err_max, drift, overflow, fill,
         n_contract) = torch.stack([
             out[k].double() for k in ("err_mean", "err_max", "drift",
                                       "overflow", "ring_fill",
                                       "n_contract")]).tolist()
        if overflow > 0 and eng.halo_ == "ring":
            raise RuntimeError(
                f"wvt_shard: the ring's boundary buffer of {eng.ring_slots_} "
                f"superblocks is {int(overflow)} short at it = {it}; pass "
                f"max_remote_sb >= {eng.ring_slots_ + int(overflow)}")
        n_iter += 1
        drift_acc += drift
        its_since_build += 1
        err_diff = (err_last - err_mean) / err_mean
        if log:
            log("wvt_shard", it=it, err_max=round(err_max, 4),
                err_mean=round(err_mean, 5), err_diff=round(err_diff, 5),
                step=step, overflow=int(overflow), drift=round(drift, 4))
            if eng.halo_ == "ring":
                log("wvt_shard_ring", it=it, fill=int(fill),
                    slots=eng.ring_slots_)
            if mesh.timing:
                calls, host_s, dev_ms = mesh.collective_stats()
                log("wvt_shard_comm", it=it, collectives=calls,
                    host_s=host_s, device_ms=dev_ms)
        stop = ((err_diff < err_diff_limit and it > 25)
                or (err_diff < 0 and err_diff_last < 0 and it > 10))
        if err_diff < 0.01 and it > 1 and not stop:
            step *= 0.8
        if not stop:
            err_last = err_mean
            err_diff_last = err_diff
            pos_l, h_l, rm_l = out["pos"], out["hsml"], out["rho_model"]
        if checkpoint_path and not stop and (
                (it + 1 - it0) % checkpoint_every == 0):
            ck = [full(x).cpu().numpy() for x in (pos_l, h_l, rm_l)]
            if mesh.rank == 0:
                with open(checkpoint_path, "wb") as fh:
                    np.savez(fh, pos=ck[0], hsml=ck[1], rhom=ck[2], it=it,
                             step=step, err_last=err_last,
                             err_diff_last=err_diff_last)
        if stop:
            break

    # the final state in original order: the positions BEFORE the
    # rejected move (the reference keeps the last accepted state), with
    # the density and hsml of the final solve
    pos_f = full(pos_l)[:n_real]
    rho_f = full(out["rho"])[:n_real]
    hsml_f = full(out["hsml"])[:n_real]
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    if log:
        dt = time.perf_counter() - t_start
        log("wvt_shard_done", iterations=n_iter, seconds=dt,
            particle_updates_per_s=n_real * n_iter / dt,
            contract_frac=n_contract / n_real, n_devices=mesh.size)
    return pos_f, rho_f, hsml_f
