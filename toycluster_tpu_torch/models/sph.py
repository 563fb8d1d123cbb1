"""SPH density and adaptive smoothing lengths (reference sph.c:13-75).

JAX counterpart: ``toycluster_tpu/models/sph.py`` (its stream-engine
half).  ``find_sph_quantities`` sorts the gas along the Hilbert curve,
builds superblock candidate lists (ops/blocks.py) and solves density and
hsml per receiver block with the ``stream_wvt`` operator
(ops/stream_pair.py), growing the candidate radius for lanes that
saturate it.  The initial guess comes from the analytic model density.
Like the reference, the gas block is physically permuted into curve
order; halo membership rides along in ``parts.halo``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from .. import constants as const
from ..ops import blocks as blk
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
    ``cand.idx`` holds superblock ids per receiver block."""
    index: blk.BlockIndex
    cand: blk.CandidateList
    h_cap: torch.Tensor    # (P,) padded sorted layout

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


def refresh_candidates(state: NeighbourState, pos_sorted_gas,
                       radius_sym_gas, boxsize) -> NeighbourState:
    """Rebuild the candidate lists from CURRENT positions, keeping the
    sort and block membership (once accumulated drift has spent the
    lists' radius slack).

    Block boxes are wrap-aware: members of a boundary block may have
    drifted across the periodic edge, so each block is re-centred on its
    first particle with min-image deltas before taking min/max."""
    bi = state.index
    nb = bi.n_blocks
    n_gas = pos_sorted_gas.shape[0]
    pad = bi.n_padded - n_gas
    pos_pad = blk.pad_rows(pos_sorted_gas, bi.n_padded)
    pb = pos_pad.reshape(nb, blk.BLOCK, 3)
    ref = pb[:, :1, :]
    d = pb - ref
    d = d - boxsize * torch.round(d / boxsize)
    bb_lo = ref[:, 0] + d.amin(dim=1)
    bb_hi = ref[:, 0] + d.amax(dim=1)
    sb_lo, sb_hi = blk.superblock_boxes(bb_lo, bb_hi)
    bi2 = bi._replace(bb_lo=bb_lo, bb_hi=bb_hi, sb_lo=sb_lo, sb_hi=sb_hi)
    radius = state.h_cap.reshape(nb, blk.BLOCK).amax(dim=1)
    sym = torch.cat([radius_sym_gas,
                     radius_sym_gas.new_zeros((pad,))]) if pad \
        else radius_sym_gas
    radius_sym = sym.reshape(nb, blk.BLOCK).amax(dim=1)
    return state._replace(index=bi2, cand=_sb_candidates(
        bi2, radius, radius_sym, boxsize))


def source_blocks(pos_pad, hm_pad):
    """(nb, 4, 128) stream sources: coordinates plus the metric hsml (box
    units; 0 marks a lane that takes part in no pair)."""
    nb = pos_pad.shape[0] // blk.BLOCK
    pos_t = pos_pad.reshape(nb, blk.BLOCK, 3).transpose(1, 2)
    return torch.cat([pos_t, hm_pad.reshape(nb, 1, blk.BLOCK)],
                     dim=1).contiguous(), pos_t.contiguous()


def find_sph_quantities(scene: Scene, ha: HaloArrays, parts: Particles,
                        *, return_state: bool = False):
    """Density + adaptive hsml for all gas particles (sph.c:13-75).
    Returns the gas-permuted Particles (and the NeighbourState, re-keyed
    to the permuted layout, for the B-field curl)."""
    global last_contract_frac
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

    cap_factor = CAP_FACTOR
    h_hard = hard_h_cap(boxsize, n_gas)
    for _attempt in range(MAX_REBUILDS):
        # lanes at the global clamp accept their capped h
        h_cap_gas = torch.clamp(torch.maximum(h0, h0_model) * cap_factor,
                                max=h_hard)
        state = build_neighbours(pos_gas, h_cap_gas, boxsize)
        bi = state.index
        nb = bi.n_blocks
        h0_b = pad_sorted(h0, bi.order, bi.n_padded).reshape(nb, blk.BLOCK)
        cap_b = state.h_cap.reshape(nb, blk.BLOCK)
        # the validity mask rides in the hm row of the sources; the
        # displacement part of the operator is off
        src, pos_t = source_blocks(bi.pos, bi.valid.to(torch.float32))
        rho, h, vf, wk, done, _ = stream_wvt(
            src, state.cand.idx, state.cand.count, pos_t, h0_b.contiguous(),
            cap_b.contiguous(), h0_b.contiguous(), float(mpart),
            float(boxsize), kernel=cfg.sph_kernel, desnngb=desnngb,
            do_disp=False)
        rho, h, vf, wk, done = (x.reshape(-1) for x in (rho, h, vf, wk,
                                                         done))
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
