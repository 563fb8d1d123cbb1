"""SPH density and adaptive smoothing lengths (reference sph.c:13-75).

JAX counterpart: ``toycluster_tpu/models/sph.py``.  ``find_sph_quantities``
sorts the gas along the Hilbert curve, builds candidate lists
(ops/blocks.py) and solves density and hsml per receiver block, growing
the candidate radius for lanes that saturate it.  The initial guess comes
from the analytic model density.  Like the reference, the gas block is
physically permuted into curve order; halo membership rides along in
``parts.halo``.

Two engines, chosen by the callers' ``engine`` argument (the JAX package
chooses by TOYCLUSTER_ENGINE and the backend):

* ``"stream"``: superblock lists for every receiver block, one
  ``stream_wvt`` call over all rows (ops/stream_pair.py);
* ``"classed"``: block-granular lists (``find_candidates``), receiver
  blocks bucketed into count classes by list length, one pair-operator
  call per class (ops/class_pair.py), and superblock lists for the
  far-tail rows whose block lists would outgrow the budgets.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .. import constants as const
from ..ops import blocks as blk
from ..ops.class_pair import pack_sources, solve_density
from ..ops.stream_pair import stream_wvt
from ..particles import HaloArrays, Particles, gas_density
from ..scene import Scene

CAP_FACTOR = 1.2       # candidate radius margin over the model-based h0
MAX_REBUILDS = 5
SB_WIDTH_CAP = 1536    # superblock-list width ceiling: rows that need more
#                        keep their NEAREST superblocks (the reference's
#                        NGBMAX=2360 truncation plays this role,
#                        globals.h:50)
SB_WIDTH_START = 192   # first candidate-search width of a process
ENGINES = ("stream", "classed")
# the count-class engine's block-granular search: first list width,
# width ceiling (rows needing more become far-tail rows), superblock
# budget ceiling of the first level, and first far-tail list width
MAX_CAND_START = 2048
MAX_CAND_CAP = 4096
MS_CAP = 512
TAIL_WIDTH_START = 1024
CLASS_EDGES = (128, 512, 2048, 4096)
# Newton/bisection sweeps of the count-class engine's solves: the budget
# of the XLA pair operator the JAX count-class engine runs
# (pair_ops.solve_density, max_iter=32)
CLASSED_SWEEPS = 32


def check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, not {engine!r}")


def hard_h_cap(boxsize: float, n_gas: int) -> float:
    """Global hsml bound of the density solve.

    The reference grows hsml without bound (sph.c:36-64); candidate radii
    near the box make every superblock a candidate of every other, so
    the engine clamps at boxsize/3 -- or at 0.49*boxsize, the min-image
    limit, when the whole domain fits one candidate row (superblock count
    within SB_WIDTH_CAP), where box-corner lanes of tiny configurations
    genuinely need h beyond box/3."""
    n_blocks = -(-max(int(n_gas), 1) // blk.BLOCK)
    n_sb = -(-n_blocks // blk.SUPER)
    return 0.49 * boxsize if n_sb <= SB_WIDTH_CAP else boxsize / 3.0


def uniform_beta(scene) -> float | None:
    """The single beta of every gas-bearing halo, or None."""
    betas = {float(h.beta) for h in scene.halos if h.mass_gas > 0}
    return betas.pop() if len(betas) == 1 else None


def global_density_model(pos_box, ha: HaloArrays, boxsize, cool_core=None,
                         beta=None):
    """Max over gas-bearing halos of the beta-model density at a box
    position (wvt_relax.c:227-256)."""
    boxhalf = boxsize / 2.0
    rho = torch.zeros_like(pos_box[..., 0])
    mass_gas = ha.mass_gas.tolist()
    for j in range(ha.n_halos):
        if mass_gas[j] <= 0:
            continue
        r = torch.linalg.vector_norm(pos_box - (ha.d_com[j] + boxhalf),
                                     dim=-1)
        rho = torch.maximum(rho, gas_density(r, ha, j, cool_core, beta=beta))
    return rho


def model_hsml(pos_box, ha, mpart, desnngb, boxsize, cool_core=None,
               beta=None):
    """h0 = (DESNNGB m / rho_model / (4pi/3))^(1/3), the WVT metric form
    (wvt_relax.c:115), as the density solve's warm start."""
    rho = global_density_model(pos_box, ha, boxsize, cool_core, beta=beta)
    return (desnngb * mpart / rho / const.FOURPITHIRD) ** (1.0 / 3.0)


def permute_gas(parts: Particles, order) -> Particles:
    """Physically reorder the gas block (peano.c:85-126, as a gather)."""
    n_gas = parts.n_gas

    def perm(arr):
        if arr.shape[0] == 0:
            return arr
        return torch.cat([arr[:n_gas][order], arr[n_gas:]])

    return parts.replace(
        pos=perm(parts.pos), vel=perm(parts.vel), pid=perm(parts.pid),
        halo=perm(parts.halo), u=perm(parts.u), rho=perm(parts.rho),
        hsml=perm(parts.hsml), var_hsml_fac=perm(parts.var_hsml_fac),
        rho_model=perm(parts.rho_model), bfld=perm(parts.bfld),
        apot=perm(parts.apot))


class NeighbourState(NamedTuple):
    """Block structure of the (already permuted) gas positions.
    ``cand.idx`` holds superblock ids per receiver block (``sb``, the
    stream engine) or block ids (the count-class engine).  ``tail``:
    the count-class engine's far-tail rows, whose block lists would
    outgrow the budgets, with superblock lists instead: (ids (T,),
    sb_idx (T, M_sb), sb_count (T,)), or None."""
    index: blk.BlockIndex
    cand: blk.CandidateList
    h_cap: torch.Tensor    # (P,) padded sorted layout
    tail: Optional[tuple] = None
    sb: bool = True

    @property
    def max_cand(self) -> int:
        return self.cand.idx.shape[1]


def pad_sorted(x, order, n_padded):
    """x in sorted order, padded to n_padded by repeating the last row."""
    return blk.pad_rows(x[order], n_padded)


def build_neighbours(pos_gas, h_cap_gas, boxsize, *, radius_sym_gas=None):
    """Superblock candidate lists for every receiver block (the JAX
    package's ``_build_neighbours_sb``).  With ``radius_sym_gas`` (per
    particle, the WVT metric search length) the range is the union of
    the density gather range and the symmetric displacement pair range,
    so ONE structure serves a whole WVT iteration (the reference walks
    one tree twice, wvt_relax.c:66-171)."""
    bi = blk.build_blocks(pos_gas, boxsize)
    h_cap = pad_sorted(h_cap_gas, bi.order, bi.n_padded)
    radius = h_cap.reshape(bi.n_blocks, blk.BLOCK).amax(dim=1)
    if radius_sym_gas is not None:
        sym = pad_sorted(radius_sym_gas, bi.order, bi.n_padded)
        radius_sym = sym.reshape(bi.n_blocks, blk.BLOCK).amax(dim=1)
    else:
        radius_sym = torch.zeros_like(radius)
    return NeighbourState(index=bi, cand=_sb_candidates(
        bi, radius, radius_sym, boxsize), h_cap=h_cap)


def _sb_candidates(bi, radius, radius_sym, boxsize):
    """Superblock candidate search, grown on overflow up to the width
    cap, then cut to the widest row's count.  (The JAX package keeps
    process-wide sticky widths so that its compiled program shapes
    repeat; eager PyTorch compiles nothing, so widths follow the need.)"""
    ns = bi.sb_lo.shape[0]
    # an even width cap (an odd one at a tiny odd ns would drop every
    # row's farthest superblock); the column past ns is -1 padding
    width_cap = max(2, min(SB_WIDTH_CAP, (ns + 1) & ~1))
    m_sb = min(SB_WIDTH_START, width_cap)
    rec = torch.arange(bi.n_blocks, dtype=torch.int32, device=radius.device)
    while True:
        cand = blk.find_candidates_super(bi, rec, radius, radius_sym,
                                         boxsize, max_cand=m_sb)
        if cand.overflow <= 0 or m_sb >= width_cap:
            break
        m_sb = min(-(-int((m_sb + cand.overflow) * 1.12) // 64) * 64,
                   width_cap)
    width = min(max(int(cand.count.max()), 1), m_sb)
    return cand._replace(idx=cand.idx[:, :width].contiguous())


def block_boxes(pos_pad, boxsize):
    """Block boxes (nb, 3) of the padded sorted positions, wrap-aware:
    members of a boundary block may have drifted across the periodic
    edge, so each block is re-centred on its first particle with
    min-image deltas before taking min/max."""
    pb = pos_pad.reshape(-1, blk.BLOCK, 3)
    ref = pb[:, :1, :]
    d = pb - ref
    d = d - boxsize * torch.round(d / boxsize)
    return ref[:, 0] + d.amin(dim=1), ref[:, 0] + d.amax(dim=1)


def refresh_candidates(state: NeighbourState, pos_sorted_gas,
                       radius_sym_gas, boxsize) -> NeighbourState:
    """Rebuild the superblock lists from CURRENT positions, keeping the
    sort and block membership (once accumulated drift has spent the
    lists' radius slack)."""
    bi = state.index
    nb = bi.n_blocks
    n_gas = pos_sorted_gas.shape[0]
    pad = bi.n_padded - n_gas
    bb_lo, bb_hi = block_boxes(blk.pad_rows(pos_sorted_gas, bi.n_padded),
                               boxsize)
    sb_lo, sb_hi = blk.superblock_boxes(bb_lo, bb_hi)
    bi2 = bi._replace(bb_lo=bb_lo, bb_hi=bb_hi, sb_lo=sb_lo, sb_hi=sb_hi)
    radius = state.h_cap.reshape(nb, blk.BLOCK).amax(dim=1)
    sym = torch.cat([radius_sym_gas,
                     radius_sym_gas.new_zeros((pad,))]) if pad \
        else radius_sym_gas
    radius_sym = sym.reshape(nb, blk.BLOCK).amax(dim=1)
    return state._replace(index=bi2, cand=_sb_candidates(
        bi2, radius, radius_sym, boxsize))


# --------------------------------------------------------------------------
# The count-class engine: block-granular lists, count classes, far tail
# --------------------------------------------------------------------------

def build_neighbours_blocks(pos_gas, h_cap_gas, boxsize, *,
                            symmetric=False, radius_sym_gas=None):
    """Sort, blocks and block-granular candidate lists (the JAX package's
    ``_build_neighbours_blocks``).  The list width starts at
    MAX_CAND_START and grows on overflow up to MAX_CAND_CAP, the
    superblock budget grows up to MS_CAP; rows over either budget once
    the widths stop growing become far-tail rows with superblock lists
    (``NeighbourState.tail``).  With ``radius_sym_gas`` the range is the
    union of the gather and the symmetric displacement range.  (The JAX
    package remembers the widths of earlier builds so that its compiled
    shapes repeat; eager PyTorch compiles nothing, so every build starts
    from the first widths.)"""
    bi = blk.build_blocks(pos_gas, boxsize)
    nb = bi.n_blocks
    ns = bi.sb_lo.shape[0]
    h_cap = pad_sorted(h_cap_gas, bi.order, bi.n_padded)
    radius = h_cap.reshape(nb, blk.BLOCK).amax(dim=1)
    radius_sym = None
    if radius_sym_gas is not None:
        sym = pad_sorted(radius_sym_gas, bi.order, bi.n_padded)
        radius_sym = sym.reshape(nb, blk.BLOCK).amax(dim=1)
    max_cand, max_super, tail = MAX_CAND_START, None, None
    ms_cap = min(ns, MS_CAP)
    while True:
        ms = (min(max_super, ns) if max_super is not None
              else min(blk.default_max_super(ns, max_cand), ms_cap))
        cand = blk.find_candidates(bi, radius, boxsize, max_cand=max_cand,
                                   max_super=ms, symmetric=symmetric,
                                   radius_sym=radius_sym)
        if cand.sb_overflow > 0 and ms < ms_cap:
            # superblock budget too small: grow it, bounded (rows past
            # the ceiling become tail rows below)
            max_super = min(ms_cap, -(-int((ms + cand.sb_overflow) * 1.12)
                                      // 32) * 32)
            continue
        # rows over either budget get superblock lists (the level-2
        # counts of rows over the superblock budget are undercounted, so
        # those are flagged too)
        flagged = (cand.count > max_cand) | (cand.sb_count > ms)
        if not bool(flagged.any()):
            break
        need = int((max_cand + max(cand.overflow, 0)) * 1.12)
        if need <= MAX_CAND_CAP and cand.sb_overflow <= 0:
            max_cand = min(MAX_CAND_CAP, -(-need // 128) * 128)
            continue
        ids = torch.nonzero(flagged)[:, 0].to(torch.int32)
        sym = radius_sym if radius_sym is not None else radius
        m_sb = TAIL_WIDTH_START
        while True:
            cand_sb = blk.find_candidates_super(bi, ids, radius, sym,
                                                boxsize, max_cand=m_sb)
            if cand_sb.overflow <= 0:
                break
            m_sb = -(-int((m_sb + cand_sb.overflow) * 1.12) // 128) * 128
        width = max(int(cand_sb.count.max()), 1)
        tail = (ids, cand_sb.idx[:, :width].contiguous(), cand_sb.count)
        break
    return NeighbourState(index=bi, cand=cand, h_cap=h_cap, tail=tail,
                          sb=False)


def classed_selections(state: NeighbourState):
    """Receiver blocks bucketed by candidate count: [(m, ids)], ids (S,)
    int32 the blocks whose count lies in (previous edge, m], m =
    min(edge, list width) for the edges CLASS_EDGES.  Far-tail rows are
    in no class."""
    counts = state.cand.count
    if state.tail is not None:
        counts = counts.clone()
        counts[state.tail[0].long()] = torch.iinfo(torch.int32).max
    sels, lo = [], 0
    for edge in CLASS_EDGES:
        m = min(edge, state.max_cand)
        if m <= lo:
            break
        ids = torch.nonzero((counts > lo) & (counts <= m))[:, 0]
        lo = m
        if ids.numel():
            sels.append((m, ids.to(torch.int32)))
        if m >= state.max_cand:
            break
    return sels


def expand_tail_rows(sb_rows, nb):
    """(T, M_sb) superblock ids -> (T, M_sb * SUPER) block ids, -1 for
    empty entries and members past nb (so -1s are not confined to row
    tails)."""
    e = (torch.clamp(sb_rows, min=0)[:, :, None] * blk.SUPER
         + torch.arange(blk.SUPER, dtype=sb_rows.dtype,
                        device=sb_rows.device))
    ok = (sb_rows >= 0)[:, :, None] & (e < nb)
    return torch.where(ok, e, torch.full_like(e, -1)).reshape(
        sb_rows.shape[0], -1)


def run_classed(state: NeighbourState, fn, tail_fn=None):
    """Run ``fn(ids, rows, cnt, m)`` per count class (ids (S,), rows
    (S, m) block lists, cnt (S,)) and, on a state with far-tail rows,
    ``tail_fn(ids, sb_rows, sb_cnt)``; each returns a tuple of (S, 128,
    ...) tensors, scattered here into (nb, 128, ...) tensors."""
    outs = None

    def scatter(ids, res):
        nonlocal outs
        if outs is None:
            outs = [r.new_zeros((state.index.n_blocks,) + r.shape[1:])
                    for r in res]
        for o, r in zip(outs, res):
            o[ids.long()] = r

    for m, ids in classed_selections(state):
        idc = ids.long()
        rows = state.cand.idx[idc, :m].contiguous()
        cnt = torch.clamp(state.cand.count[idc], max=m)
        scatter(ids, fn(ids, rows, cnt, m))
    if state.tail is not None:
        if tail_fn is None:
            raise RuntimeError("the neighbour state carries far-tail rows "
                               "but the caller provided no tail_fn")
        scatter(state.tail[0], tail_fn(*state.tail))
    return outs


def source_blocks(pos_pad, hm_pad):
    """(nb, 4, 128) stream sources: coordinates plus the metric hsml (box
    units; 0 marks a lane that takes part in no pair)."""
    nb = pos_pad.shape[0] // blk.BLOCK
    pos_t = pos_pad.reshape(nb, blk.BLOCK, 3).transpose(1, 2)
    return torch.cat([pos_t, hm_pad.reshape(nb, 1, blk.BLOCK)],
                     dim=1).contiguous(), pos_t.contiguous()


def _solve_stream(state, h0_b, cfg, mpart, boxsize):
    """One stream_wvt call over every row, the displacement off (the
    validity mask rides in the hm row of the sources)."""
    bi = state.index
    nb = bi.n_blocks
    src, pos_t = source_blocks(bi.pos, bi.valid.to(torch.float32))
    return stream_wvt(
        src, state.cand.idx, state.cand.count, pos_t, h0_b,
        state.h_cap.reshape(nb, blk.BLOCK).contiguous(), h0_b, float(mpart),
        float(boxsize), kernel=cfg.sph_kernel, desnngb=cfg.desnngb,
        do_disp=False)[:5]


def _solve_classed(state, h0_b, cfg, mpart, boxsize):
    """One solve_density call per count class, and one in superblock
    mode over the far-tail rows."""
    bi = state.index
    nb = bi.n_blocks
    pos_t = bi.pos.reshape(nb, blk.BLOCK, 3).transpose(1, 2).contiguous()
    valid_t = bi.valid.to(torch.float32).reshape(nb, 1, blk.BLOCK)
    cap_b = state.h_cap.reshape(nb, blk.BLOCK)
    # the kernel's source records, packed once for every call
    packed = (pack_sources(pos_t, valid_t, None, float(boxsize))
              if pos_t.is_cuda else None)

    def solve(ids, rows, sb_mode):
        idc = ids.long()
        return solve_density(
            pos_t, valid_t, rows, pos_t[idc], h0_b[idc], cap_b[idc],
            float(mpart), float(boxsize), kernel=cfg.sph_kernel,
            desnngb=cfg.desnngb, n_sweeps=CLASSED_SWEEPS,
            sb_mode=sb_mode, packed=packed)[:5]

    return run_classed(state,
                       lambda ids, rows, cnt, m: solve(ids, rows, False),
                       lambda ids, sb_rows, sb_cnt: solve(ids, sb_rows, True))


def find_sph_quantities(scene: Scene, ha: HaloArrays, parts: Particles,
                        *, return_state: bool = False,
                        engine: str = "stream"):
    """Density + adaptive hsml for all gas particles (sph.c:13-75) on
    ``engine`` ("stream" or "classed").  Returns the gas-permuted
    Particles (and the NeighbourState, re-keyed to the permuted layout,
    for the B-field curl)."""
    global last_contract_frac
    check_engine(engine)
    cfg = scene.config
    n_gas = parts.n_gas
    if n_gas == 0:
        return (parts, None) if return_state else parts
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    boxsize = scene.boxsize
    mpart = scene.mpart_gas
    desnngb = cfg.desnngb

    pos_gas = parts.pos[:n_gas]
    h0_model = model_hsml(pos_gas, ha, mpart, desnngb, boxsize, cool_core)
    # warm start from the previous hsml when available (sph.c:23-26)
    h_prev = parts.hsml[:n_gas]
    h0 = torch.where(h_prev > 0, h_prev, h0_model)
    build, solve = ((build_neighbours, _solve_stream) if engine == "stream"
                    else (build_neighbours_blocks, _solve_classed))

    cap_factor = CAP_FACTOR
    h_hard = hard_h_cap(boxsize, n_gas)
    for _attempt in range(MAX_REBUILDS):
        # lanes at the global clamp accept their capped h
        h_cap_gas = torch.clamp(torch.maximum(h0, h0_model) * cap_factor,
                                max=h_hard)
        state = build(pos_gas, h_cap_gas, boxsize)
        bi = state.index
        h0_b = pad_sorted(h0, bi.order, bi.n_padded).reshape(
            bi.n_blocks, blk.BLOCK).contiguous()
        rho, h, vf, wk, done = (x.reshape(-1) for x in solve(
            state, h0_b, cfg, mpart, boxsize))
        saturated = (~done) | (h >= state.h_cap * 0.999)
        still_growable = state.h_cap < h_hard * 0.999
        n_sat = int((saturated & still_growable)[:n_gas].sum())
        if n_sat == 0:
            break
        # the reference's grow-and-research (sph.c:36-64)
        inv = torch.empty_like(bi.order)
        inv[bi.order] = torch.arange(n_gas, device=inv.device,
                                     dtype=inv.dtype)
        h0 = h[inv]
        cap_factor *= 1.6
    else:
        raise RuntimeError(f"hsml solve saturated for {n_sat} particles "
                           f"after {MAX_REBUILDS} rebuilds")

    # the neighbour contract (sph.c:159-166): fraction of gas lanes at
    # |wkNgb - DESNNGB| < NNGBDEV
    contract_ok = (torch.abs(wk - desnngb) < const.NNGBDEV) & bi.valid
    last_contract_frac = float(contract_ok.sum()) / n_gas

    parts = permute_gas(parts, bi.order)
    parts = parts.replace(rho=rho[:n_gas], hsml=h[:n_gas],
                          var_hsml_fac=vf[:n_gas])
    if not return_state:
        return parts
    # after permute_gas the particle layout IS the sorted layout
    state = state._replace(index=bi._replace(
        order=torch.arange(n_gas, device=bi.order.device)))
    return parts, state


# contract fraction of the most recent find_sph_quantities call
last_contract_frac: float = float("nan")
