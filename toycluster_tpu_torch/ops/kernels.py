"""SPH smoothing kernels on tensors, branch-free.

JAX counterpart: ``toycluster_tpu/ops/kernels.py``.  Wendland C6 (the
default), cubic spline M4 (SPH_CUBIC_SPLINE) and Wendland C2 (the
bulk-velocity taper), in the reference's forms (sph.c:426-466,
wvt_relax.c:258-294).  Support u = r/h < 1 is a mask, so out-of-support
pairs contribute exactly zero.
"""

from __future__ import annotations

import torch

from .. import constants as const

WC6_NORM = 1365.0 / (64.0 * const.PI)


def wc6(r, h):
    """W_WC6(r, h) with the 1/h^3 normalisation (sph.c:426-432)."""
    u = r / h
    t = torch.clamp(1.0 - u, min=0.0)
    t4 = (t * t) ** 2
    poly = 1.0 + u * (8.0 + u * (25.0 + 32.0 * u))
    return WC6_NORM / (h * h * h) * t4 * t4 * poly


def wc6_flat(u):
    """1365/(64 pi) t^8 (1 + 8u + 25u^2 + 32u^3), no 1/h^3
    (wvt_relax.c:275-281)."""
    t = torch.clamp(1.0 - u, min=0.0)
    t4 = (t * t) ** 2
    return WC6_NORM * t4 * t4 * (1.0 + u * (8.0 + u * (25.0 + 32.0 * u)))


def wc6_deriv(r, h):
    """dW_WC6/dr (sph.c:434-440)."""
    u = r / h
    t = torch.clamp(1.0 - u, min=0.0)
    t3 = t * t * t
    return (WC6_NORM / (h * h * h * h) * (-22.0) * t3 * t3 * t * u
            * (16.0 * u * u + 7.0 * u + 1.0))


def m4_flat(u):
    """Dimensionless cubic-spline weight (wvt_relax.c:283-294)."""
    inner = 2.546479089470 + 15.278874536822 * (u - 1.0) * u * u
    outer = 5.092958178941 * (1.0 - u) ** 3
    zero = torch.zeros_like(u)
    return torch.where(u < 0.5, inner, torch.where(u < 1.0, outer, zero))


def m4(r, h):
    """Cubic spline (sph.c:442-453)."""
    return m4_flat(r / h) / (h * h * h)


def m4_deriv(r, h):
    """dM4/dr (sph.c:455-466)."""
    u = r / h
    inner = u * (45.836623610466 * u - 30.557749073644)
    outer = -15.278874536822 * (1.0 - u) ** 2
    zero = torch.zeros_like(u)
    dwk = torch.where(u < 0.5, inner, torch.where(u < 1.0, outer, zero))
    return dwk / (h * h * h * h)


def wc2(r, h):
    """WC2 with 1/h^3, the subhalo gas-velocity taper
    (velocities.c:161-167)."""
    u = r / h
    t = torch.clamp(1.0 - u, min=0.0)
    return 21.0 / (2.0 * const.PI) / (h * h * h) * t ** 4 * (1.0 + 4.0 * u)


def kernel_fns(kind: str):
    """(W, dW/dr, flat W) for 'wc6' or 'm4'."""
    if kind == "m4":
        return m4, m4_deriv, m4_flat
    return wc6, wc6_deriv, wc6_flat
