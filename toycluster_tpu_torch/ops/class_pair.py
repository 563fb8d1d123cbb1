"""Count-class pair operators: the adaptive-h density solve, the WVT
displacement, and the two fused in one pass, over the block-granular
candidate lists of one count class (or superblock lists with
``sb_mode``: the far-tail rows).

JAX counterpart: ``toycluster_tpu/ops/pallas_pair.py``
(``solve_density_pallas``/``_density_kernel``,
``wvt_displacement_pallas``/``_displacement_kernel`` and
``fused_wvt_pallas``/``_fused_kernel``).  The plain version of each
operator is also the port's counterpart of the XLA pair operators
``toycluster_tpu/ops/pair_ops.py`` ``solve_density`` and
``wvt_displacement``.  Layouts are those of the Pallas wrappers:

* ``pos_blocks (nb, 3, 128)`` sorted coordinates; ``valid_blocks``,
  ``h_blocks``, ``hm_blocks (nb, 1, 128)``; a source lane with valid == 0
  (hm == 0 for ``fused_wvt``) takes part in no pair;
* ``cand (S, M)`` int32 block ids, -1 wherever an entry is empty (in
  expanded rows -1s are not confined to the row tail); with ``sb_mode``
  superblock ids, whose members past nb take part in no pair;
* receivers ``xi (S, 3, 128)`` and per-lane ``(S, 128)`` rows.

Each operator has two paths.  A CUDA tensor launches the hand-written
kernel of ``csrc/`` and counts the launch in ``<operator>.launches``; a
CPU tensor runs the plain PyTorch version beside it, which keeps the TPU
kernel's per-block sweep loop as a per-row mask.  Any other device
raises.

The kernels prune their listed blocks themselves with the chunk cross
test of ``stream_pair.member_keep`` (its plain oracles here:
``density_keep``, ``displacement_keep``, ``fused_keep``) and drop the
periodic wrap on the rows that ``stream_pair.interior_rows`` flags;
``solve_density`` and ``wvt_displacement`` split a row over a
thread-block cluster when a call has too few rows to fill the card
(``stream_pair._cluster_size``); in ``fused_wvt`` a warp also skips the
blocks whose tile of its 32 lanes and 32 sources the test drops
(``stream_pair._warp_tiles``).  Pruning and the dropped wrap change no
bit of the outputs; the cluster size changes the order of the sums.
"""

from __future__ import annotations

import torch

from .. import constants as const
from .blocks import BLOCK, SUPER, _interval_dist2
from .cuda_build import _check, _launch
from .kernels import WC6_NORM, m4_flat
from .stream_pair import (_INFL, _KIND, _PAIR_BUDGET, MAX_CLUSTER, MAX_SHARE,
                          PackedSources, _check_packed, _cluster_size,
                          _dens_sums, _keep_rows, _norm_sums, _pair_dx,
                          _recv_tab, _rho_corr, _row_chunks, _row_tables,
                          _update, build_chunk_tab, gather_sources,
                          list_entries, pair_range)

# sweep budgets of the TPU wrappers (solve_density_pallas,
# fused_wvt_pallas); the count-class engine chooses its own per call site
SOLVE_SWEEPS = 8
FUSED_SWEEPS = 16

def _check_lists(pos_blocks, cand, xi, src_rows, lane_rows):
    """Device, dtype, shape and contiguity checks; returns (dev, nb, S,
    M)."""
    dev = pos_blocks.device
    nb = pos_blocks.shape[0]
    S, M = cand.shape
    _check("pos_blocks", pos_blocks, torch.float32, (nb, 3, BLOCK), dev)
    for name, t in src_rows.items():
        _check(name, t, torch.float32, (nb, 1, BLOCK), dev)
    _check("cand", cand, torch.int32, (S, M), dev)
    _check("xi", xi, torch.float32, (S, 3, BLOCK), dev)
    for name, t in lane_rows.items():
        _check(name, t, torch.float32, (S, BLOCK), dev)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"no count-class kernel for device {dev}")
    return dev, nb, S, M


def _check_kernel(kernel):
    if kernel not in _KIND:
        raise ValueError(f"unknown kernel {kernel!r}")


def _record(kernel, h, acc, mpart, desnngb, done):
    """The recorded outputs from sums measured at h: (S, 128, 5) rho
    (with the Dehnen+12 WC6 correction), h, varHsmlFac, wkNgb, done."""
    sum_w, sum_rdw = _norm_sums(kernel, h, *acc)
    wk = const.FOURPITHIRD * (h * h * h) * sum_w
    rho = mpart * sum_w
    drho = -mpart * (3.0 / h * sum_w + sum_rdw / h)
    now_done = torch.abs(wk - desnngb) < const.NNGBDEV
    rho_out = rho + _rho_corr(desnngb, mpart, kernel) * (WC6_NORM
                                                         / (h * h * h))
    vf = 1.0 / (1.0 + h / (3.0 * torch.clamp(rho, min=1e-30)) * drho)
    return torch.stack([rho_out, h, vf, wk,
                        ((done > 0.5) | now_done).to(h.dtype)], dim=-1)


def _chunks(ok):
    """Row chunks within the pair budget, and each row's width in source
    blocks (up to its last valid one), from the (S, E) entry mask."""
    col = torch.arange(1, ok.shape[1] + 1, device=ok.device)
    width = (ok * col).amax(dim=1)
    return _row_chunks(width, _PAIR_BUDGET[ok.device.type],
                       BLOCK * BLOCK), width


def pack_sources(pos_blocks, valid_blocks, h_blocks, boxsize):
    """``PackedSources`` of ``solve_density`` (``h_blocks`` None: w is the
    validity, a source takes part where w > 0) or of ``wvt_displacement``
    (w = h on valid lanes, -1 elsewhere: a source takes part where w >=
    0, so no valid lane is lost whatever its h).  A caller with several
    calls over the same sources packs once and passes ``packed=``."""
    w = valid_blocks[:, 0]
    if h_blocks is not None:
        w = torch.where(w > 0.5, h_blocks[:, 0], torch.full_like(w, -1.0))
    src = torch.cat([pos_blocks, w[:, None]], dim=1).transpose(1, 2)
    w0 = torch.clamp(w, min=0.0)
    return PackedSources(src.contiguous(),
                         build_chunk_tab(pos_blocks, w0, boxsize), w0.amax())


def pack_fused_sources(pos_blocks, hm_blocks, boxsize, ctab=None):
    """``PackedSources`` of ``fused_wvt``: w = hm, the metric hsml in box
    units, which is range and validity at once (a source takes part
    where w > 0).  ``ctab`` takes the chunk table of
    ``pack_sources(pos_blocks, valid_blocks, h_blocks, boxsize)`` where
    hm is h on the valid lanes and 0 elsewhere: it is the same table."""
    hm = hm_blocks[:, 0]
    src = torch.cat([pos_blocks, hm_blocks], dim=1).transpose(1, 2)
    if ctab is None:
        ctab = build_chunk_tab(pos_blocks, hm, boxsize)
    return PackedSources(src.contiguous(), ctab, hm.amax())


def _list_keep(rtab, ctab, cand, boxsize, do_disp, sb_mode):
    """(kept, listed), each (S, E) bool: the listed source blocks the
    chunk cross test keeps, and the valid list entries."""
    cnt = torch.full((cand.shape[0],), cand.shape[1], dtype=torch.int32,
                     device=cand.device)
    dens, disp, ok = _keep_rows(rtab, ctab, cand, cnt, boxsize, do_disp,
                                sb_mode)
    return (disp if do_disp else dens), ok


def density_keep(pos_blocks, valid_blocks, cand, xi, cap, boxsize, *,
                 sb_mode=False):
    """The plain oracle of ``solve_density``'s member test: (kept,
    listed), each (S, E) bool, E = M or M * 8 with ``sb_mode``.  A listed
    block is kept if the minimum-image gap between one of its 16-particle
    chunk hulls and one of the receiver block's is at most that receiver
    chunk's largest cap (inflated as ``stream_pair.member_keep`` does);
    every operation rounds as in the kernel's test."""
    ctab = build_chunk_tab(pos_blocks, valid_blocks[:, 0], boxsize)
    rtab = _recv_tab(build_chunk_tab(xi, cap, boxsize), cap, None)
    return _list_keep(rtab, ctab, cand, boxsize, False, sb_mode)


def displacement_keep(pos_blocks, valid_blocks, h_blocks, cand, xi, h_i,
                      boxsize, *, sb_mode=False):
    """The plain oracle of ``wvt_displacement``'s member test, as
    ``density_keep`` with the range 0.5 (the receiver chunk's largest h_i
    + the source chunk's largest valid h) boxsize."""
    ctab = pack_sources(pos_blocks, valid_blocks, h_blocks, boxsize).ctab
    rtab = _recv_tab(build_chunk_tab(xi, h_i, boxsize), h_i, h_i)
    return _list_keep(rtab, ctab, cand, boxsize, True, sb_mode)


def fused_keep(pos_blocks, hm_blocks, cand, cnt, xi, cap, hm_i, boxsize, *,
               sb_mode=False, do_disp=True, gdist=None, dkeep=None,
               tiles=False):
    """The plain oracle of ``fused_wvt``'s member test: (density kept,
    displacement kept, listed), each (S, E) bool, over the first
    min(cnt, M) list entries: ``density_keep``'s test and, with
    ``do_disp``, ``displacement_keep``'s (hm == 0 lanes take part in no
    pair), each ANDed with the caller's bound where given.  With ``tiles``
    the two keeps are (S, E, 16), the verdict per warp tile
    (``stream_pair._warp_tiles``)."""
    ctab = build_chunk_tab(pos_blocks, hm_blocks[:, 0], boxsize)
    rtab = _recv_tab(build_chunk_tab(xi, cap, boxsize), cap,
                     hm_i if do_disp else None)
    dens, disp, ok = _keep_rows(rtab, ctab, cand, cnt, boxsize, do_disp,
                                sb_mode, tiles)
    if gdist is not None:
        by_gdist = gdist <= cap.amax(dim=1)[:, None]
        dens = dens & (by_gdist[..., None] if tiles else by_gdist)
    if dkeep is not None:
        disp = disp & (dkeep[..., None] if tiles else dkeep)
    return dens, disp, ok


def _fill_stats(stats, sweeps, keep):
    """(S, 4) int32 of a plain run: sweeps, blocks kept, blocks listed,
    kept x sweeps."""
    stats[:, 0] = sweeps
    stats[:, 1] = keep[0].sum(dim=1)
    stats[:, 2] = keep[1].sum(dim=1)
    stats[:, 3] = stats[:, 0] * stats[:, 1]


def fused_bounds(bb_lo, bb_hi, ids, cand, hmi_max, bhm, boxsize, *,
                 sb_mode=False):
    """``fused_wvt``'s (gdist, dkeep) for receiver blocks ``ids`` (S,)
    and their lists ``cand`` (S, M): the minimum-image distance between
    the receiver's and each listed block's box (world units; inf for an
    empty entry), and whether it lies within 0.5 (hmi_max_i + bhm_j)
    boxsize, the widest displacement pair range (hm in box units).
    ``bb_lo``/``bb_hi`` (nb, 3) are boxes at the current positions,
    ``hmi_max`` (S,) the receivers' and ``bhm`` (nb,) the sources' largest
    hm."""
    e, ok = list_entries(cand, bb_lo.shape[0], sb_mode)
    idc = ids.long()
    d2 = _interval_dist2(bb_lo[idc][:, None], bb_hi[idc][:, None],
                         bb_lo[e], bb_hi[e], boxsize)
    gd = torch.where(ok, torch.sqrt(d2), torch.full_like(d2, float("inf")))
    dk = gd <= 0.5 * (hmi_max[:, None] + bhm[e]) * boxsize
    return gd.to(torch.float32).contiguous(), dk.contiguous()


# --------------------------------------------------------------------------
# Density + hsml solve
# --------------------------------------------------------------------------

def solve_density(pos_blocks, valid_blocks, cand, xi, h0, cap, mpart,
                  boxsize, *, kernel="wc6", desnngb=295,
                  n_sweeps=SOLVE_SWEEPS, sb_mode=False, prune=True,
                  hoist=True, cluster=None, stats=None, packed=None):
    """Adaptive-hsml SPH density per receiver block (sph.c:13-214):
    ``n_sweeps`` Newton/bisection sweeps on (4pi/3) h^3 sum_j W(r, h) =
    DESNNGB, each lane frozen once |wkNgb - DESNNGB| < NNGBDEV.  A block
    whose lanes are all done skips its remaining sweeps except the last,
    which always measures: rho, wkNgb and varHsmlFac are recorded at the
    h that sweep measured (with the Dehnen+12 WC6 correction).  Returns
    (rho, hsml, var_hsml_fac, wk_ngb, done, saturated), each (S, 128),
    saturated = ~done | h >= 0.999 cap.

    The kernel walks only the listed blocks that ``density_keep`` keeps
    (in each sweep those of them within the sweep's own ranges, the
    current h of the lanes it still solves) and skips the periodic wrap
    on interior rows; ``prune=False`` / ``hoist=False`` turn that off,
    for the checks that neither changes a bit.  ``cluster`` (1..8) fixes
    the CTAs a row is split over (None: ``_cluster_size``).  ``stats``, an
    optional (S, 4) int32 output, receives per row the measuring sweeps,
    the blocks kept, the blocks listed and the blocks walked over all
    sweeps (the plain version evaluates every listed pair all the same
    and reports kept x sweeps).
    ``packed`` takes ``pack_sources(pos_blocks, valid_blocks, None,
    boxsize)`` from a caller that made it already."""
    dev, nb, S, M = _check_lists(pos_blocks, cand, xi,
                                 dict(valid_blocks=valid_blocks),
                                 dict(h0=h0, cap=cap))
    _check_kernel(kernel)
    if n_sweeps < 1:
        raise ValueError("n_sweeps must be >= 1")
    if stats is not None:
        _check("stats", stats, torch.int32, (S, 4), dev)
    if dev.type == "cpu":
        sweeps = None if stats is None else torch.zeros(
            S, dtype=torch.int32)
        out = _solve_density_reference(
            pos_blocks, valid_blocks, cand, xi, h0, cap, mpart, boxsize,
            kernel=kernel, desnngb=desnngb, n_sweeps=n_sweeps,
            sb_mode=sb_mode, sweeps=sweeps)
        if stats is not None:
            _fill_stats(stats, sweeps, density_keep(
                pos_blocks, valid_blocks, cand, xi, cap, boxsize,
                sb_mode=sb_mode))
    else:
        cluster = _cluster_size(S, M * SUPER if sb_mode else M, cluster)
        if packed is None:
            packed = pack_sources(pos_blocks, valid_blocks, None, boxsize)
        _check_packed(packed, nb, dev)
        rtab, flag, order = _row_tables(cand, xi, cap, None,
                                        cap.amax(dim=1), boxsize, hoist)
        out = torch.empty((S, BLOCK, 5), dtype=torch.float32, device=dev)
        _launch("solve_density", [
            packed.src, packed.ctab, rtab, cand, flag, order, xi, h0, cap,
            out, stats, S, M, nb, _KIND[kernel], bool(sb_mode), n_sweeps,
            bool(prune), cluster, float(mpart), float(boxsize),
            float(1.0 / boxsize), float(_INFL * boxsize), float(desnngb),
            float(_rho_corr(desnngb, mpart, kernel))])
        solve_density.launches += 1
    rho, h, vf, wk, done = (out[:, :, k] for k in range(5))
    done = done > 0.5
    return rho, h, vf, wk, done, (~done) | (h >= cap * 0.999)


solve_density.launches = 0


def _solve_density_reference(pos_blocks, valid_blocks, cand, xi, h0, cap,
                             mpart, boxsize, *, kernel, desnngb, n_sweeps,
                             sb_mode, sweeps=None):
    """Plain PyTorch version of ``solve_density``: chunks of receiver
    rows, their listed source blocks gathered, the per-block sweep loop
    as a per-row mask.  ``sweeps``, an optional (S,) int32 output,
    receives each row's measuring sweeps."""
    S = cand.shape[0]
    nb = pos_blocks.shape[0]
    src = torch.cat([pos_blocks, valid_blocks], dim=1)
    out = torch.zeros((S, BLOCK, 5), dtype=torch.float32,
                      device=pos_blocks.device)
    e_all, ok_all = list_entries(cand, nb, sb_mode)
    chunks, width = _chunks(ok_all)
    for s0, s1 in chunks:
        w = max(int(width[s0:s1].max()), 1)
        g, okl = gather_sources(src, e_all[s0:s1, :w], ok_all[s0:s1, :w])
        vj = ((g[:, 3] > 0) & okl).to(torch.float32)[:, None, :]
        dx = _pair_dx(xi[s0:s1], g[:, :3], boxsize)
        r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
        del dx, g
        c_cap = cap[s0:s1]
        h = torch.minimum(h0[s0:s1], c_cap)
        zero = torch.zeros_like(h)
        state = (0, h, h, zero, c_cap, zero)
        active = torch.ones(s1 - s0, dtype=torch.bool, device=h.device)
        if sweeps is not None:
            sweeps[s0:s1] = 1
        for k in range(n_sweeps - 1):
            # a block whose lanes are all done skips to the last sweep
            active = active & ~(state[5] > 0.5).all(dim=1)
            if not bool(active.any()):
                break
            if sweeps is not None:
                sweeps[s0:s1] += active.to(torch.int32)
            acc = _dens_sums(kernel, r2, vj, state[1])
            new = _update(kernel, state, acc, c_cap, mpart, desnngb, 0.0)
            a = active[:, None]
            state = (k + 1,) + tuple(torch.where(a, n, o) for n, o in
                                     zip(new[1:], state[1:]))
        h = state[1]
        acc = _dens_sums(kernel, r2, vj, h)
        out[s0:s1] = _record(kernel, h, acc, mpart, desnngb, state[5])
    return out


# --------------------------------------------------------------------------
# WVT displacement
# --------------------------------------------------------------------------

def wvt_displacement(pos_blocks, valid_blocks, h_blocks, cand, xi, h_i,
                     step, boxsize, *, kernel="wc6", sb_mode=False,
                     prune=True, hoist=True, cluster=None, stats=None,
                     packed=None):
    """WVT repulsion (wvt_relax.c:126-171): delta_i = step sum_j h_i
    W(r/hbar) dx/r in box units over valid j with 0 < r < hbar = (h_i +
    h_j)/2, h the metric hsml in box units (>= 0).  Returns (S, 128, 3).

    ``prune``, ``hoist``, ``cluster`` and ``stats`` as for
    ``solve_density`` (the member test is ``displacement_keep``; one
    pass, so stats column 0 is 1 and column 3 the blocks kept);
    ``packed`` takes ``pack_sources(pos_blocks,
    valid_blocks, h_blocks, boxsize)``."""
    dev, nb, S, M = _check_lists(pos_blocks, cand, xi,
                                 dict(valid_blocks=valid_blocks,
                                      h_blocks=h_blocks), dict(h_i=h_i))
    _check_kernel(kernel)
    if stats is not None:
        _check("stats", stats, torch.int32, (S, 4), dev)
    if dev.type == "cpu":
        if stats is not None:
            _fill_stats(stats, 1, displacement_keep(
                pos_blocks, valid_blocks, h_blocks, cand, xi, h_i, boxsize,
                sb_mode=sb_mode))
        return _wvt_displacement_reference(
            pos_blocks, valid_blocks, h_blocks, cand, xi, h_i, step,
            boxsize, kernel=kernel, sb_mode=sb_mode)
    cluster = _cluster_size(S, M * SUPER if sb_mode else M, cluster)
    if packed is None:
        packed = pack_sources(pos_blocks, valid_blocks, h_blocks, boxsize)
    _check_packed(packed, nb, dev)
    r_pair = 0.5 * (h_i.amax(dim=1) + packed.w_max) * boxsize
    rtab, flag, order = _row_tables(cand, xi, None, h_i, r_pair, boxsize,
                                    hoist)
    out = torch.empty((S, BLOCK, 3), dtype=torch.float32, device=dev)
    _launch("wvt_displacement", [
        packed.src, packed.ctab, rtab, cand, flag, order, xi, h_i, out,
        stats, S, M, nb, _KIND[kernel], bool(sb_mode), bool(prune), cluster,
        float(step), float(boxsize), float(1.0 / boxsize),
        float(_INFL * boxsize)])
    wvt_displacement.launches += 1
    return out


wvt_displacement.launches = 0


def _disp_sums(kernel, dx, r2, hbar, mask):
    """sum_j wflat(r/hbar) dx / r over the masked pairs (box units);
    wflat without the WC6 norm."""
    r = torch.sqrt(r2)
    u = torch.where(mask, r / hbar, torch.ones_like(r))
    if kernel == "m4":
        wflat = m4_flat(u)
    else:
        t = torch.clamp(1.0 - u, min=0.0)
        t4 = (t * t) ** 2
        wflat = t4 * t4 * (1.0 + u * (8.0 + u * (25.0 + 32.0 * u)))
    coef = torch.where(mask, wflat / torch.clamp(r, min=1e-30),
                       torch.zeros_like(r))
    return torch.stack([(coef * dx[d]).sum(-1) for d in range(3)], dim=-1)


def _wvt_displacement_reference(pos_blocks, valid_blocks, h_blocks, cand, xi,
                                h_i, step, boxsize, *, kernel, sb_mode):
    """Plain PyTorch version of ``wvt_displacement``."""
    S = cand.shape[0]
    nb = pos_blocks.shape[0]
    src = torch.cat([pos_blocks, valid_blocks, h_blocks], dim=1)
    out = torch.zeros((S, BLOCK, 3), dtype=torch.float32,
                      device=pos_blocks.device)
    e_all, ok_all = list_entries(cand, nb, sb_mode)
    chunks, width = _chunks(ok_all)
    norm = 1.0 if kernel == "m4" else WC6_NORM
    for s0, s1 in chunks:
        w = max(int(width[s0:s1].max()), 1)
        g, okl = gather_sources(src, e_all[s0:s1, :w], ok_all[s0:s1, :w])
        vj = ((g[:, 3] > 0.5) & okl)[:, None, :]
        dx = [d * (1.0 / boxsize) for d in _pair_dx(xi[s0:s1], g[:, :3],
                                                    boxsize)]
        r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
        hi = h_i[s0:s1]
        hbar = 0.5 * (g[:, 4][:, None, :] + hi[..., None])
        mask = (r2 < hbar * hbar) & (r2 > 0.0) & vj
        acc = _disp_sums(kernel, dx, r2, hbar, mask)
        out[s0:s1] = (step * norm) * hi[..., None] * acc
    return out


# --------------------------------------------------------------------------
# Fused density solve + displacement
# --------------------------------------------------------------------------

def fused_wvt(pos_blocks, hm_blocks, cand, cnt, xi, h0, cap, hm_i, mpart,
              boxsize, *, kernel="wc6", desnngb=295, n_sweeps=FUSED_SWEEPS,
              sb_mode=False, do_disp=True, gdist=None, dkeep=None,
              prune=True, hoist=True, stats=None, packed=None):
    """The density solve and the WVT displacement of one count class in
    one pass.  Sources with hm == 0 take part in no pair; the first
    min(cnt, M) list entries are read.  Newton/bisection sweeps repeat
    until all 128 lanes of the block are done or ``n_sweeps`` were taken;
    the record reuses the last sweep's sums at the final h.  With
    ``do_disp``, delta = hm_i sum_j W(r/hbar) dx/r in box units (without
    the step) over 0 < r < hbar = (hm_i + hm_j)/2.

    ``gdist`` (S, M_blocks) float32, world units (M_blocks = M, or M*8
    with ``sb_mode``): a lower bound on the distance between the receiver
    block and each listed source block; a block farther than the row's
    largest cap is skipped in the density sweeps.  ``dkeep`` (same shape,
    bool): False where no pair of the block is within the displacement
    range; such blocks are skipped in the displacement pass.  Both skip
    exact-zero contributions only, so the outputs do not change.  Rows
    with cnt <= 0 return zeros.  Returns (rho, hsml, var_hsml_fac,
    wk_ngb, done, delta).

    The kernel walks only the listed blocks that ``fused_keep`` keeps (in
    each sweep those of them within the sweep's own ranges, the current h
    of the lanes it still solves; each warp only the blocks whose tile of
    its 32 lanes and 32 sources the test keeps) and skips the periodic
    wrap on interior rows; ``prune=False`` / ``hoist=False`` turn that
    off, for the checks that neither changes a bit (the caller's bounds
    apply either way).  ``stats``, an optional (S, 5) int32 output,
    receives per row the sweeps, the blocks kept for either consumer, the
    blocks listed, and the density blocks and the density warp tiles (16
    a block) walked over all sweeps (the plain version evaluates every
    listed pair all the same and reports the oracle's density blocks and
    tiles x sweeps).  ``packed`` takes ``pack_fused_sources(pos_blocks,
    hm_blocks, boxsize)``."""
    dev, nb, S, M = _check_lists(pos_blocks, cand, xi,
                                 dict(hm_blocks=hm_blocks),
                                 dict(h0=h0, cap=cap, hm_i=hm_i))
    _check("cnt", cnt, torch.int32, (S,), dev)
    _check_kernel(kernel)
    if n_sweeps < 1:
        raise ValueError("n_sweeps must be >= 1")
    mb = M * SUPER if sb_mode else M
    if gdist is not None:
        _check("gdist", gdist, torch.float32, (S, mb), dev)
    if dkeep is not None:
        _check("dkeep", dkeep, torch.bool, (S, mb), dev)
    if stats is not None:
        _check("stats", stats, torch.int32, (S, 5), dev)
    if dev.type == "cpu":
        sweeps = None if stats is None else torch.zeros(
            S, dtype=torch.int32)
        out = _fused_wvt_reference(
            pos_blocks, hm_blocks, cand, cnt, xi, h0, cap, hm_i, mpart,
            boxsize, kernel=kernel, desnngb=desnngb, n_sweeps=n_sweeps,
            sb_mode=sb_mode, do_disp=do_disp, gdist=gdist, dkeep=dkeep,
            sweeps=sweeps)
        if stats is not None:
            dens, disp, ok = fused_keep(
                pos_blocks, hm_blocks, cand, cnt, xi, cap, hm_i, boxsize,
                sb_mode=sb_mode, do_disp=do_disp, gdist=gdist, dkeep=dkeep,
                tiles=True)
            stats[:, 0] = sweeps
            stats[:, 1] = (dens | disp).any(dim=2).sum(dim=1)
            stats[:, 2] = ok.sum(dim=1)
            stats[:, 3] = sweeps * dens.any(dim=2).sum(dim=1)
            stats[:, 4] = sweeps * dens.sum(dim=(1, 2))
    else:
        out = _fused_wvt_cuda(
            pos_blocks, hm_blocks, cand, cnt, xi, h0, cap, hm_i, mpart,
            boxsize, kernel=kernel, desnngb=desnngb, n_sweeps=n_sweeps,
            sb_mode=sb_mode, do_disp=do_disp, gdist=gdist, dkeep=dkeep,
            prune=prune, hoist=hoist, stats=stats, packed=packed)
    rho, h, vf, wk, done = (out[:, :, k] for k in range(5))
    return rho, h, vf, wk, done > 0.5, out[:, :, 5:8]


fused_wvt.launches = 0


def _fused_wvt_cuda(pos_blocks, hm_blocks, cand, cnt, xi, h0, cap, hm_i,
                    mpart, boxsize, *, kernel, desnngb, n_sweeps, sb_mode,
                    do_disp, gdist, dkeep, prune, hoist, stats, packed,
                    debug=0):
    """Launch the ``fused_wvt`` kernel on checked CUDA arguments; returns
    its (S, 128, 8) output.  ``debug`` is the C entry point's, for the
    checks and timings on the card: 1, frozen lanes are swept like the
    others; 2, every warp runs every kept block, whatever its tile says.
    No output bit depends on it."""
    dev = pos_blocks.device
    nb = pos_blocks.shape[0]
    S, M = cand.shape
    # one CTA a row: the lists of a row must fit its shared memory
    _cluster_size(S, M * SUPER if sb_mode else M, 1)
    if packed is None:
        packed = pack_fused_sources(pos_blocks, hm_blocks, boxsize)
    _check_packed(packed, nb, dev)
    hm_rows = hm_i if do_disp else None
    r_pair = pair_range(cap, hm_rows, packed.w_max if do_disp else None,
                        boxsize)
    rtab, flag, order = _row_tables(cand, xi, cap, hm_rows, r_pair, boxsize,
                                    hoist, cnt=cnt)
    out = torch.empty((S, BLOCK, 8), dtype=torch.float32, device=dev)
    _launch("fused_wvt", [
        packed.src, packed.ctab, rtab, cand, cnt, flag, order, xi, h0, cap,
        hm_i, gdist, None if dkeep is None else dkeep.to(torch.uint8), out,
        stats, S, M, nb, _KIND[kernel], bool(sb_mode), bool(do_disp),
        n_sweeps, bool(prune), debug, float(mpart), float(boxsize),
        float(1.0 / boxsize), float(_INFL * boxsize), float(desnngb),
        float(_rho_corr(desnngb, mpart, kernel))])
    fused_wvt.launches += 1
    return out


def _fused_wvt_reference(pos_blocks, hm_blocks, cand, cnt, xi, h0, cap,
                         hm_i, mpart, boxsize, *, kernel, desnngb, n_sweeps,
                         sb_mode, do_disp, gdist, dkeep, sweeps=None):
    """Plain PyTorch version of ``fused_wvt``.  The bounds mask the
    skipped blocks' pairs, so a bound that skipped a pair in range would
    change the result.  ``sweeps``, an optional (S,) int32 output,
    receives each row's density sweeps."""
    S, M = cand.shape
    nb = pos_blocks.shape[0]
    dev = pos_blocks.device
    src = torch.cat([pos_blocks, hm_blocks], dim=1)
    out = torch.zeros((S, BLOCK, 8), dtype=torch.float32, device=dev)
    cnt = torch.clamp(cnt, min=0, max=M)
    slot = torch.arange(M, device=dev)
    listed = torch.where(slot[None] < cnt[:, None], cand,
                         torch.full_like(cand, -1))
    e_all, ok_all = list_entries(listed, nb, sb_mode)
    keep_w = ok_all if gdist is None else \
        ok_all & (gdist <= cap.amax(dim=1)[:, None])
    keep_d = ok_all if dkeep is None else ok_all & dkeep
    chunks, width = _chunks(ok_all)
    norm = 1.0 if kernel == "m4" else WC6_NORM
    for s0, s1 in chunks:
        w = max(int(width[s0:s1].max()), 1)
        g, okl = gather_sources(src, e_all[s0:s1, :w], ok_all[s0:s1, :w])
        hmj = torch.where(okl, g[:, 3], torch.zeros_like(g[:, 3]))
        lanes = BLOCK
        kw_l = keep_w[s0:s1, :w, None].expand(-1, -1, lanes).reshape(
            s1 - s0, -1)
        vj = ((hmj > 0) & kw_l).to(torch.float32)[:, None, :]
        dx = _pair_dx(xi[s0:s1], g[:, :3], boxsize)
        r2 = dx[0] * dx[0] + dx[1] * dx[1] + dx[2] * dx[2]
        hmi = hm_i[s0:s1]
        if do_disp:
            kd_l = keep_d[s0:s1, :w, None].expand(-1, -1, lanes).reshape(
                s1 - s0, -1)
            dxb = [d * (1.0 / boxsize) for d in dx]
            r2b = dxb[0] * dxb[0] + dxb[1] * dxb[1] + dxb[2] * dxb[2]
            hbar = 0.5 * (hmj[:, None, :] + hmi[..., None])
            mask = (r2b < hbar * hbar) & (r2b > 0.0) & (hmj > 0)[:, None] \
                & kd_l[:, None, :]
            out[s0:s1, :, 5:8] = (norm * hmi)[..., None] * _disp_sums(
                kernel, dxb, r2b, hbar, mask)
            del dxb, r2b, hbar, mask
        del dx, g
        c_cap = cap[s0:s1]
        h = torch.minimum(h0[s0:s1], c_cap)
        zero = torch.zeros_like(h)
        state = (0, h, h, zero, c_cap, zero)
        acc = (zero, zero)
        active = cnt[s0:s1] > 0
        if sweeps is not None:
            sweeps[s0:s1] = 0
        k = 0
        while k < n_sweeps and bool(active.any()):
            if sweeps is not None:
                sweeps[s0:s1] += active.to(torch.int32)
            acc_n = _dens_sums(kernel, r2, vj, state[1])
            new = _update(kernel, state, acc_n, c_cap, mpart, desnngb, 0.0)
            a = active[:, None]
            state = (k + 1,) + tuple(torch.where(a, n, o) for n, o in
                                     zip(new[1:], state[1:]))
            acc = tuple(torch.where(a, n, o) for n, o in zip(acc_n, acc))
            k += 1
            active = active & ~(state[5] > 0.5).all(dim=1)
        rec = _record(kernel, state[1], acc, mpart, desnngb, state[5])
        has = (cnt[s0:s1] > 0)[:, None, None]
        out[s0:s1, :, :5] = torch.where(has, rec, torch.zeros_like(rec))
        out[s0:s1, :, 5:8] *= has
    return out
