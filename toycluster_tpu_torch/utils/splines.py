"""Natural cubic splines (host-side, float64).

The reference interpolates every tabulated profile with GSL's `cspline`
(natural cubic spline).  We build the same spline host-side with
scipy.interpolate.CubicSpline(bc_type="natural") and expose the knot second
derivatives so device code (ops/interp.py) can evaluate the identical
polynomial with a searchsorted + Hermite formula.

JAX counterpart: ``toycluster_tpu/utils/splines.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
from scipy.interpolate import CubicSpline


@dataclass(frozen=True)
class NaturalSpline:
    """Natural cubic spline over strictly increasing knots (float64)."""
    x: np.ndarray
    y: np.ndarray
    m2: np.ndarray  # second derivatives at the knots

    @classmethod
    def build(cls, x, y) -> "NaturalSpline":
        x = np.asarray(x, dtype=np.float64)
        y = np.asarray(y, dtype=np.float64)
        cs = CubicSpline(x, y, bc_type="natural")
        return cls(x=x, y=y, m2=cs(x, 2))

    def __call__(self, xq):
        return _eval(self.x, self.y, self.m2, np.asarray(xq, np.float64))

    def deriv2(self, xq):
        """Second derivative: piecewise linear between knot values."""
        xq = np.asarray(xq, np.float64)
        return np.interp(xq, self.x, self.m2)


def _eval(x, y, m2, xq):
    i = np.clip(np.searchsorted(x, xq) - 1, 0, len(x) - 2)
    h = x[i + 1] - x[i]
    A = (x[i + 1] - xq) / h
    B = 1.0 - A
    return (A * y[i] + B * y[i + 1]
            + ((A ** 3 - A) * m2[i] + (B ** 3 - B) * m2[i + 1]) * h * h / 6.0)
