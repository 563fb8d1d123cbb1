"""The Eddington integral of many halos' f(E) tables at once, in float64.

For each halo h, with K ascending psi knots ``x[h]``, the rho(psi)
spline's second derivatives ``m2[h]`` there and M energies ``E[h]``:

  I(E) = 2 m2_0 sqrt((E - x_0)_+) + (4/3) sum_k d_k ((E - x_k)_+)^(3/2),
  d_0 = c1_0,  d_k = c1_k - c1_{k-1},  c1_k = (m2_{k+1} - m2_k) / (x_{k+1} - x_k)

(``models/eddington._exact_eddington_integral``, the NumPy form of one
halo, derives it).  A CUDA tensor launches the hand-written kernel of
``csrc/eddington.cu`` and counts the launch in
``eddington_integral.launches``; a CPU tensor runs the plain PyTorch
version beside it (``_eddington_integral_reference``), one halo's
(M, K-1) terms at a time.  Any other device raises.

JAX counterpart: none; the JAX package computes the integral on the
host, one halo at a time, in ``models/eddington.py``.
"""

from __future__ import annotations

import torch

from .cuda_build import _check, _launch


def _eddington_integral_reference(x, m2, E):
    """The plain version: (H, M) float64 integrals and (H, M) int32
    counts of the knots below each energy."""
    out, terms = [], []
    for xh, mh, eh in zip(x, m2, E):
        c1 = torch.diff(mh) / torch.diff(xh)
        d = torch.cat([c1[:1], torch.diff(c1)])
        s = torch.clamp(eh[:, None] - xh[None, :-1], min=0.0)
        out.append(2.0 * mh[0] * torch.sqrt(torch.clamp(eh - xh[0], min=0.0))
                   + (4.0 / 3.0) * ((s * torch.sqrt(s)) @ d))
        terms.append(torch.searchsorted(xh[:-1], eh).to(torch.int32))
    return torch.stack(out), torch.stack(terms)


def eddington_integral(x, m2, E):
    """Eddington integrals of H halos: ``x``, ``m2`` (H, K) and ``E``
    (H, M) float64, contiguous, on one device, each row of ``x``
    ascending.  Returns (I (H, M) float64, terms (H, M) int32), where
    ``terms`` counts the knots x_k < E that each energy summed."""
    dev = x.device
    H, K = x.shape
    M = E.shape[1]
    _check("x", x, torch.float64, (H, K), dev)
    _check("m2", m2, torch.float64, (H, K), dev)
    _check("E", E, torch.float64, (H, M), dev)
    if K < 2:
        raise ValueError(f"{K} knots: the integral needs at least 2")
    if dev.type == "cpu":
        return _eddington_integral_reference(x, m2, E)
    if dev.type != "cuda":
        raise ValueError(f"no Eddington kernel for device {dev}")
    out = torch.empty((H, M), dtype=torch.float64, device=dev)
    terms = torch.empty((H, M), dtype=torch.int32, device=dev)
    _launch("eddington", [x, m2, E, out, terms, H, K, M])
    eddington_integral.launches += 1
    return out, terms


eddington_integral.launches = 0
