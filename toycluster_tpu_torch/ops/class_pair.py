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
kernel of ``csrc/`` (one CTA of 128 threads per receiver block) and
counts the launch in ``<operator>.launches``; a CPU tensor runs the plain
PyTorch version beside it, which keeps the TPU kernel's per-block sweep
loop as a per-row mask.  Any other device raises.
"""

from __future__ import annotations

import torch

from .. import constants as const
from .blocks import BLOCK, SUPER, _interval_dist2
from .kernels import WC6_NORM, m4_flat
from .stream_pair import (_KIND, _PAIR_BUDGET, _check, _dens_sums, _launch,
                          _norm_sums, _pair_dx, _rho_corr, _row_chunks,
                          _update, gather_sources, list_entries)

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
                  n_sweeps=SOLVE_SWEEPS, sb_mode=False):
    """Adaptive-hsml SPH density per receiver block (sph.c:13-214):
    ``n_sweeps`` Newton/bisection sweeps on (4pi/3) h^3 sum_j W(r, h) =
    DESNNGB, each lane frozen once |wkNgb - DESNNGB| < NNGBDEV.  A block
    whose lanes are all done skips its remaining sweeps except the last,
    which always measures: rho, wkNgb and varHsmlFac are recorded at the
    h that sweep measured (with the Dehnen+12 WC6 correction).  Returns
    (rho, hsml, var_hsml_fac, wk_ngb, done, saturated), each (S, 128),
    saturated = ~done | h >= 0.999 cap."""
    dev, nb, S, M = _check_lists(pos_blocks, cand, xi,
                                 dict(valid_blocks=valid_blocks),
                                 dict(h0=h0, cap=cap))
    _check_kernel(kernel)
    if n_sweeps < 1:
        raise ValueError("n_sweeps must be >= 1")
    if dev.type == "cpu":
        out = _solve_density_reference(
            pos_blocks, valid_blocks, cand, xi, h0, cap, mpart, boxsize,
            kernel=kernel, desnngb=desnngb, n_sweeps=n_sweeps,
            sb_mode=sb_mode)
    else:
        out = torch.empty((S, BLOCK, 5), dtype=torch.float32, device=dev)
        _launch("solve_density", [
            pos_blocks, valid_blocks, cand, xi, h0, cap, out, S, M, nb,
            _KIND[kernel], bool(sb_mode), n_sweeps, float(mpart),
            float(boxsize), float(desnngb),
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
                     step, boxsize, *, kernel="wc6", sb_mode=False):
    """WVT repulsion (wvt_relax.c:126-171): delta_i = step sum_j h_i
    W(r/hbar) dx/r in box units over valid j with 0 < r < hbar = (h_i +
    h_j)/2, h the metric hsml in box units.  Returns (S, 128, 3)."""
    dev, nb, S, M = _check_lists(pos_blocks, cand, xi,
                                 dict(valid_blocks=valid_blocks,
                                      h_blocks=h_blocks), dict(h_i=h_i))
    _check_kernel(kernel)
    if dev.type == "cpu":
        return _wvt_displacement_reference(
            pos_blocks, valid_blocks, h_blocks, cand, xi, h_i, step,
            boxsize, kernel=kernel, sb_mode=sb_mode)
    out = torch.empty((S, BLOCK, 3), dtype=torch.float32, device=dev)
    _launch("wvt_displacement", [
        pos_blocks, valid_blocks, h_blocks, cand, xi, h_i, out, S, M, nb,
        _KIND[kernel], bool(sb_mode), float(step), float(boxsize)])
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
              sb_mode=False, do_disp=True, gdist=None, dkeep=None):
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
    wk_ngb, done, delta)."""
    dev, nb, S, M = _check_lists(pos_blocks, cand, xi,
                                 dict(hm_blocks=hm_blocks),
                                 dict(h0=h0, cap=cap, hm_i=hm_i))
    _check("cnt", cnt, torch.int32, (S,), dev)
    _check_kernel(kernel)
    mb = M * SUPER if sb_mode else M
    if gdist is not None:
        _check("gdist", gdist, torch.float32, (S, mb), dev)
    if dkeep is not None:
        _check("dkeep", dkeep, torch.bool, (S, mb), dev)
    if dev.type == "cpu":
        out = _fused_wvt_reference(
            pos_blocks, hm_blocks, cand, cnt, xi, h0, cap, hm_i, mpart,
            boxsize, kernel=kernel, desnngb=desnngb, n_sweeps=n_sweeps,
            sb_mode=sb_mode, do_disp=do_disp, gdist=gdist, dkeep=dkeep)
    else:
        out = torch.empty((S, BLOCK, 8), dtype=torch.float32, device=dev)
        _launch("fused_wvt", [
            pos_blocks, hm_blocks, cand, cnt, xi, h0, cap, hm_i, gdist,
            None if dkeep is None else dkeep.to(torch.uint8), out, S, M,
            nb, _KIND[kernel], bool(sb_mode), bool(do_disp), n_sweeps,
            float(mpart), float(boxsize), float(desnngb),
            float(_rho_corr(desnngb, mpart, kernel))])
        fused_wvt.launches += 1
    rho, h, vf, wk, done = (out[:, :, k] for k in range(5))
    return rho, h, vf, wk, done > 0.5, out[:, :, 5:8]


fused_wvt.launches = 0


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
