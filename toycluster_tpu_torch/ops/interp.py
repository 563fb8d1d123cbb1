"""Spline evaluation on tensors.

JAX counterpart: ``toycluster_tpu/ops/interp.py``.  Tables are built on
the host in float64 (utils/splines.py) and moved to the device as a
``SplineTable``; evaluation is searchsorted plus the natural cubic
spline formula, vectorised over the queries (the reference calls
gsl_spline_eval per particle).  ``linear_eval`` is ``jnp.interp``'s
counterpart for monotone tables; the pipeline does not call it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SplineTable(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    m2: torch.Tensor


def spline_eval(table: SplineTable, xq):
    """Natural-cubic-spline evaluation, clamped to the knot span.  Knots
    of shape (H, K) evaluate row by row, against queries (H, m)."""
    x, y, m2 = table
    i = torch.clamp(torch.searchsorted(x, xq.contiguous()) - 1, 0,
                    x.shape[-1] - 2)

    def at(t, j):
        return t[j] if t.dim() == 1 else torch.gather(t, -1, j)

    x0, x1 = at(x, i), at(x, i + 1)
    h = x1 - x0
    A = (x1 - xq) / h
    B = 1.0 - A
    return (A * at(y, i) + B * at(y, i + 1)
            + ((A ** 3 - A) * at(m2, i) + (B ** 3 - B) * at(m2, i + 1))
            * h * h / 6.0)


def flat_gather(tab, row, col):
    """tab[row, col] for a 2-D table and 1-D index vectors."""
    return tab.reshape(-1)[row * tab.shape[1] + col]


def batched_spline_eval(table: SplineTable, hid, xq):
    """spline_eval against per-halo knot rows: table fields are (H, K),
    hid/xq are (n,).  Bisection with flat gathers, since searchsorted
    cannot index a different row per query."""
    x, y, m2 = table
    k = x.shape[1]
    hid = hid.long()
    lo = torch.zeros_like(hid)
    hi = torch.full_like(hid, k - 1)
    for _ in range(10):  # 2^10 >= NTABLE
        mid = (lo + hi) // 2
        go_hi = xq >= flat_gather(x, hid, mid)
        lo = torch.where(go_hi, mid, lo)
        hi = torch.where(go_hi, hi, mid)
    i = torch.clamp(lo, 0, k - 2)
    x0 = flat_gather(x, hid, i)
    x1 = flat_gather(x, hid, i + 1)
    h = x1 - x0
    A = torch.clamp((x1 - xq) / h, 0.0, 1.0)  # clamp to the knot span
    B = 1.0 - A
    return (A * flat_gather(y, hid, i) + B * flat_gather(y, hid, i + 1)
            + ((A ** 3 - A) * flat_gather(m2, hid, i)
               + (B ** 3 - B) * flat_gather(m2, hid, i + 1)) * h * h / 6.0)


def linear_eval(xs, ys, xq):
    """Piecewise-linear interpolation of the table (xs, ys) at xq, the
    counterpart of ``jnp.interp(xq, xs, ys)``: xs ascending, queries
    below xs[0] take ys[0] and above xs[-1] take ys[-1], an interval
    narrower than float spacing takes its left value."""
    i = torch.clamp(torch.searchsorted(xs, xq.contiguous(), right=True), 1,
                    xs.shape[0] - 1)
    x0, y0 = xs[i - 1], ys[i - 1]
    dx = xs[i] - x0
    flat = dx.abs() <= torch.finfo(xs.dtype).eps ** 2  # spacing(eps)
    t = (xq - x0) / torch.where(flat, torch.ones_like(dx), dx)
    # one fused multiply-add, as XLA evaluates jnp.interp's y0 + t * dy
    f = torch.where(flat, y0, torch.addcmul(y0, t, ys[i] - y0))
    f = torch.where(xq < xs[0], ys[0], f)
    return torch.where(xq > xs[-1], ys[-1], f)
