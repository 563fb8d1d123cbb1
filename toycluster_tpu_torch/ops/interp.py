"""Spline evaluation on tensors.

JAX counterpart: ``toycluster_tpu/ops/interp.py``.  Tables are built on
the host in float64 (utils/splines.py) and moved to the device as a
``SplineTable``; evaluation is searchsorted plus the natural cubic
spline formula, vectorised over the queries (the reference calls
gsl_spline_eval per particle).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class SplineTable(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    m2: torch.Tensor


def spline_eval(table: SplineTable, xq):
    """Natural-cubic-spline evaluation, clamped to the knot span."""
    x, y, m2 = table
    i = torch.clamp(torch.searchsorted(x, xq.contiguous()) - 1, 0,
                    x.shape[0] - 2)
    h = x[i + 1] - x[i]
    A = (x[i + 1] - xq) / h
    B = 1.0 - A
    return (A * y[i] + B * y[i + 1]
            + ((A ** 3 - A) * m2[i] + (B ** 3 - B) * m2[i + 1]) * h * h / 6.0)


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
