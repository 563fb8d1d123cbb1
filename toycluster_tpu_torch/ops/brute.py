"""O(N^2) reference implementations: test oracles, and the density audit
of ``make_ics(check=True)``.

JAX counterpart: ``toycluster_tpu/ops/brute.py``.  The analogue of the
reference's ``Find_ngb_simple`` brute-force fallback
(wvt_relax.c:296-340): the density solve, the WVT displacement and the
SPH curl over a full pairwise-distance matrix, for small N; and the
direct-summation density at given lanes, chunked over the sources, for
any N.  Plain torch on any device: no kernel and no candidate list.
"""

from __future__ import annotations

import torch

from .. import constants as const
from .kernels import kernel_fns


def _pair_diffs(pos, boxsize):
    d = pos[:, None, :] - pos[None, :, :]
    return d - boxsize * torch.round(d / boxsize)


def _self_term(h, mpart, desnngb, w_fn):
    """The WC6 self-contribution correction (sph.c:130-132)."""
    return (-0.0116 * (desnngb * 0.01) ** (-2.236) * mpart
            * w_fn(torch.zeros_like(h), h))


def brute_density(pos, hsml0, mpart, boxsize, *, kernel="wc6",
                  desnngb=295, max_iter=64):
    """The Newton/bisection hsml solve of the density kernels over all
    pairs, bounds [0, sqrt3 * 4 h0] (sph.c:86).  Returns (rho, h,
    var_hsml_fac, wkNgb, done)."""
    w_fn, dw_fn, _ = kernel_fns(kernel)
    d = _pair_diffs(pos, boxsize)
    r = torch.sqrt((d * d).sum(-1))

    def sums(h):
        w = w_fn(r, h[:, None])
        dw = dw_fn(r, h[:, None])
        wk_ngb = const.FOURPITHIRD * h ** 3 * w.sum(-1)
        rho = mpart * w.sum(-1)
        drho = -mpart * ((3.0 / h)[:, None] * w
                         + (r / h[:, None]) * dw).sum(-1)
        return wk_ngb, rho, drho

    h, lo = hsml0, torch.zeros_like(hsml0)
    hi = hsml0 * const.SQRT3 * 4
    done = torch.zeros(hsml0.shape, dtype=torch.bool, device=pos.device)
    for _ in range(max_iter):
        wk_ngb, rho, drho = sums(h)
        dev = torch.abs(wk_ngb - desnngb)
        now = dev < const.NNGBDEV
        omega = 1.0 + drho * h / (3.0 * torch.clamp(rho, min=1e-30))
        fac = torch.clamp(1.0 - (wk_ngb - desnngb)
                          / (3.0 * torch.clamp(wk_ngb, min=1e-30) * omega),
                          1.0 / 1.24, 1.24)
        hi = torch.where(wk_ngb > desnngb, h, hi)
        lo = torch.where(wk_ngb < desnngb, h, lo)
        h_new = torch.where(dev < 0.5 * desnngb, h * fac,
                            (0.5 * (lo ** 3 + hi ** 3)) ** (1.0 / 3.0))
        h = torch.where(done | now, h, h_new)
        done = done | now
    wk_ngb, rho, drho = sums(h)
    var_fac = 1.0 / (1.0 + h / (3.0 * rho) * drho)
    if kernel == "wc6":
        rho = rho + _self_term(h, mpart, desnngb, w_fn)
    return rho, h, var_fac, wk_ngb, done


def density_at(pos_q, h_q, pos_src, mpart, boxsize, *, kernel="wc6",
               desnngb=295, chunk=65536):
    """Direct-summation SPH density at given positions and smoothing
    lengths against every source, ``chunk`` sources at a time (the
    analogue of swapping Find_ngb_simple for the tree, wvt_relax.c:134)."""
    w_fn, _, _ = kernel_fns(kernel)
    rho = torch.zeros((pos_q.shape[0],), dtype=torch.float32,
                      device=pos_q.device)
    for start in range(0, pos_src.shape[0], chunk):
        src = pos_src[start:start + chunk]
        d = pos_q[:, None, :] - src[None, :, :]
        d = d - boxsize * torch.round(d / boxsize)
        r = torch.sqrt((d * d).sum(-1))
        rho = rho + mpart * w_fn(r, h_q[:, None]).sum(-1)
    if kernel == "wc6":
        rho = rho + _self_term(h_q, mpart, desnngb, w_fn)
    return rho


def brute_wvt_displacement(pos, hsml_box, step, boxsize, *, kernel="wc6"):
    """The WVT displacement over all pairs (wvt_relax.c:110-160), with
    hsml in box units."""
    _, _, wflat = kernel_fns(kernel)
    d = _pair_diffs(pos, boxsize) / boxsize
    r2 = (d * d).sum(-1)
    r = torch.sqrt(r2)
    hbar = 0.5 * (hsml_box[:, None] + hsml_box[None, :])
    mask = (r2 < hbar * hbar) & (r2 > 0)
    w = torch.where(mask, wflat(r / hbar), torch.zeros_like(r))
    inv_r = torch.where(mask, 1.0 / torch.clamp(r, min=1e-30),
                        torch.zeros_like(r))
    coef = step * hsml_box[:, None] * w * inv_r
    return (coef[..., None] * d).sum(dim=1)


def brute_curl(pos, hsml, rho, var_fac, apot, mpart, boxsize, *,
               kernel="wc6"):
    """The SPH curl of the vector potential over all pairs
    (sph.c:216-300)."""
    _, dw_fn, _ = kernel_fns(kernel)
    d = _pair_diffs(pos, boxsize)
    r2 = (d * d).sum(-1)
    r = torch.sqrt(r2)
    h = hsml[:, None]
    mask = (r2 < h * h) & (r2 > 0)
    dw = torch.where(mask, dw_fn(r, h), torch.zeros_like(r))
    inv_r = torch.where(mask, 1.0 / torch.clamp(r, min=1e-30),
                        torch.zeros_like(r))
    weight = (-mpart / rho[:, None]) * dw * inv_r * var_fac[:, None]
    dA = apot[:, None, :] - apot[None, :, :]
    bx = (weight * (d[..., 2] * dA[..., 1] - d[..., 1] * dA[..., 2])).sum(1)
    by = (weight * (d[..., 0] * dA[..., 2] - d[..., 2] * dA[..., 0])).sum(1)
    bz = (weight * (d[..., 1] * dA[..., 0] - d[..., 0] * dA[..., 1])).sum(1)
    return torch.stack([bx, by, bz], dim=-1)
