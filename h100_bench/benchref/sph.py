"""Plain SPH sums that judge a finished initial-conditions set.

Every function takes plain tensors and runs in the dtype of its inputs
(float64 for the reference; the precision control passes lower ones).
Sums are taken over every source, ``chunk`` at a time, with the minimal
periodic image: no neighbour list, no kernel of the program.  The
formulas are the reference code's (Toycluster sph.c, wvt_relax.c,
magnetic_field.c):

* Wendland C6 and the cubic spline M4 with the 1/h^3 norm, and their
  radial derivatives;
* the kernel-weighted neighbour count wkNgb = 4 pi / 3 h^3 sum_j W(r_ij,
  h_i) and the density rho = m sum_j W (with the WC6 self-term
  correction), the grad-h factor 1 / (1 + h / (3 rho) drho/dh);
* the beta-model gas density of each halo, the model density as their
  maximum, and the vector potential (rho_j / rho0_j)^eta;
* the SPH curl of that potential.
"""

from __future__ import annotations

import math

import torch

FOURPITHIRD = 4.0 * math.pi / 3.0
WC6_NORM = 1365.0 / (64.0 * math.pi)


def kernel(kind, r, h):
    """(W, dW/dr) at separations ``r`` for smoothing lengths ``h``."""
    u = r / h
    if kind == "wc6":
        t = torch.clamp(1.0 - u, min=0.0)
        t2 = t * t
        t4 = t2 * t2
        w = (WC6_NORM / h**3) * t4 * t4 * (1.0 + u * (8.0 + u * (
            25.0 + 32.0 * u)))
        dw = ((WC6_NORM / h**4) * (-22.0) * t4 * t2 * t * u
              * (16.0 * u * u + 7.0 * u + 1.0))
        return w, dw
    if kind == "m4":
        zero = torch.zeros_like(u)
        w = torch.where(u < 0.5, 2.546479089470 + 15.278874536822
                        * (u - 1.0) * u * u,
                        torch.where(u < 1.0, 5.092958178941
                                    * torch.clamp(1.0 - u, min=0.0) ** 3,
                                    zero)) / h**3
        dw = torch.where(u < 0.5, u * (45.836623610466 * u
                                       - 30.557749073644),
                         torch.where(u < 1.0, -15.278874536822
                                     * (1.0 - u) ** 2, zero)) / h**4
        return w, dw
    raise ValueError(f"unknown kernel {kind!r}")


def wc6_self_term(h, mpart, desnngb):
    """The WC6 self-contribution correction of the density (sph.c:
    130-132)."""
    return -0.0116 * (desnngb * 0.01) ** (-2.236) * mpart * WC6_NORM / h**3


def _separations(pos_q, src, boxsize):
    d = pos_q[:, None, :] - src[None, :, :]
    return d - boxsize * torch.round(d / boxsize)


def density_sums(pos_q, h_q, pos_src, boxsize, kind, *, chunk=1 << 18,
                 acc=None):
    """(sum_j W, sum_j (3 W / h + r / h dW/dr)) of each query lane over
    every source.  The separations are taken in the dtype of the
    positions; ``acc`` (default: the same) is the dtype of the kernel and
    of the sums."""
    acc = acc or pos_q.dtype
    s_w = torch.zeros(pos_q.shape[0], dtype=acc, device=pos_q.device)
    s_dh = torch.zeros_like(s_w)
    h = h_q.to(acc)[:, None]
    for start in range(0, pos_src.shape[0], chunk):
        d = _separations(pos_q, pos_src[start:start + chunk], boxsize)
        r = torch.sqrt((d * d).sum(-1)).to(acc)
        w, dw = kernel(kind, r, h)
        s_w += w.sum(-1, dtype=acc)
        s_dh += (3.0 / h * w + r / h * dw).sum(-1, dtype=acc)
    return s_w, s_dh


def density(pos_q, h_q, pos_src, boxsize, mpart, desnngb, kind, *,
            acc=None, chunk=1 << 18):
    """(rho, wkNgb, grad-h factor) at the query lanes, at their given
    smoothing lengths, over every source."""
    s_w, s_dh = density_sums(pos_q, h_q, pos_src, boxsize, kind, acc=acc,
                             chunk=chunk)
    h = h_q.to(s_w.dtype)
    rho = mpart * s_w
    wk = FOURPITHIRD * h**3 * s_w
    vf = 1.0 / (1.0 - h / (3.0 * rho) * mpart * s_dh)
    if kind == "wc6":
        rho = rho + wc6_self_term(h, mpart, desnngb)
    return rho, wk, vf


def halo_density(r, halo, cool_core=None):
    """Beta-model gas density of one halo at radius ``r`` (setup.c:
    598-615): rho0 (1 + (r/rc)^2)^(-3 beta / 2) / (1 + (r/rcut)^4), plus
    the cool core where the halo has one."""
    taper = 1.0 + (r / halo["rcut"]) ** 4
    rho = halo["rho0"] * (1.0 + (r / halo["rcore"]) ** 2) ** (
        -1.5 * halo["beta"]) / taper
    if cool_core is not None and halo["cuspy"]:
        rho0_fac, rc_fac = cool_core
        rho = rho + (halo["rho0"] * rho0_fac
                     / (1.0 + (r / (halo["rcore"] / rc_fac)) ** 2) / taper)
    return rho


def _radius(pos, halo, boxsize):
    c = torch.tensor(halo["center"], dtype=pos.dtype, device=pos.device)
    return torch.linalg.vector_norm(pos - (c + 0.5 * boxsize), dim=-1)


def model_density(pos, halos, boxsize, cool_core=None):
    """The model density at box positions: the largest of the gas
    halos' beta models (wvt_relax.c:227-256)."""
    rho = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
    for halo in halos:
        rho = torch.maximum(rho, halo_density(_radius(pos, halo, boxsize),
                                              halo, cool_core))
    return rho


def vector_potential(pos, halos, boxsize, eta, cool_core=None):
    """A = max over the gas halos of (rho_j / rho0_j)^eta, the same in
    each component (magnetic_field.c:33-69); returns its one component."""
    a = torch.zeros(pos.shape[0], dtype=pos.dtype, device=pos.device)
    for halo in halos:
        rho = halo_density(_radius(pos, halo, boxsize), halo, cool_core)
        a = torch.maximum(a, (rho / halo["rho0"]) ** eta)
    return a


def curl(pos_q, h_q, rho_q, vf_q, a_q, pos_src, a_src, boxsize, mpart,
         kind, *, acc=None, chunk=1 << 18):
    """SPH curl of a potential whose three components are equal, at the
    query lanes (sph.c:216-300): B_i = -m vf_i / rho_i sum_j dW(r_ij,
    h_i) / r_ij (A_i - A_j) x (x_i - x_j).  The separations are taken
    in the dtype of the positions, the rest in ``acc`` (default: the
    same)."""
    acc = acc or pos_q.dtype
    out = torch.zeros((pos_q.shape[0], 3), dtype=acc, device=pos_q.device)
    h = h_q.to(acc)[:, None]
    a_q, a_src = a_q.to(acc), a_src.to(acc)
    for start in range(0, pos_src.shape[0], chunk):
        d = _separations(pos_q, pos_src[start:start + chunk],
                         boxsize).to(acc)
        r = torch.sqrt((d * d).sum(-1))
        _, dw = kernel(kind, r, h)
        inside = (r < h) & (r > 0)
        g = torch.where(inside, dw / torch.where(inside, r, 1.0), 0.0)
        da = a_q[:, None] - a_src[None, start:start + chunk]
        # (dA x d) with dA = (da, da, da)
        cx = d[..., 2] - d[..., 1]
        cy = d[..., 0] - d[..., 2]
        cz = d[..., 1] - d[..., 0]
        gd = g * da
        out[:, 0] += (gd * cx).sum(-1, dtype=acc)
        out[:, 1] += (gd * cy).sum(-1, dtype=acc)
        out[:, 2] += (gd * cz).sum(-1, dtype=acc)
    return out * (-mpart * vf_q / rho_q).to(acc)[:, None]
