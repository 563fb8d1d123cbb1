"""Eddington inversion: f(E) tables (host-side float64).

Numerical construction of the ergodic distribution function for the
spherical DM+gas potential (reference velocities.c:186-321, after
Kazantzidis+ 2004 / Binney & Tremaine sect. 4.3.1):

  f(E) = 1/(sqrt(8) pi^2) * int_0^E  d2rho/dpsi2 / sqrt(E - psi)  dpsi

The reference samples rho(psi) on a 4096-point log-r grid r in [0.1, 1e20],
takes d2rho/dpsi2 from a natural cubic spline, and evaluates the singular
integral with adaptive QAGS.  Since the spline's second derivative is
piecewise *linear* in psi, the integral has a closed form per knot segment —
we integrate it exactly instead, then build the same 1024-point f(E) table.

``build_distribution_function`` is ``prepare_distribution_function``
(the potential, the rho(psi) spline, the E grid), the integral in NumPy
and ``finish_distribution_function`` (the f(E) spline); the velocity
stage (models/velocities.py) runs the first and last a halo at a time
and the integrals of all halos in one device call (ops/eddington.py).

JAX counterpart: ``toycluster_tpu/models/eddington.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as const
from ..models import profiles
from ..models.tables import MassTable, PotentialTable, build_potential_table
from ..utils.splines import NaturalSpline

NTABLE = 1024          # velocities.c:5
NSAMPLE = 4 * NTABLE   # velocities.c:6
RMIN = 0.1             # velocities.c:7
INFINITY_R = 1e20      # velocities.c:27


@dataclass(frozen=True)
class PotentialProfile:
    """Total relative potential psi(r) = psi_DM + psi_gas of one halo."""
    a_hernq: float
    mass_dm: float
    G: float
    gas: PotentialTable | None   # None when the halo has no gas particles

    def __call__(self, r):
        r = np.asarray(r, np.float64)
        psi = profiles.hernquist_psi(r, self.mass_dm, self.a_hernq, self.G)
        if self.gas is not None:
            psi = psi + self.gas(r)
        return psi


@dataclass(frozen=True)
class DistributionFunction:
    """Tabulated f(E) with its potential; E ascending for interpolation."""
    E: np.ndarray
    fE: np.ndarray
    spline: NaturalSpline
    psi: PotentialProfile

    def __call__(self, E):
        return self.spline(np.asarray(E, np.float64))


def _exact_eddington_integral(psi_knots, m2, E_values):
    """Exact int_0^E rho''(psi)/sqrt(E-psi) dpsi for each E, where rho'' is
    the piecewise-linear second derivative of the rho(psi) spline.

    On segment [x_k, x_{k+1}] with rho'' = c0_k + c1_k psi the
    antiderivative in s = E - psi is
    G_k(s) = 2 (c0_k + c1_k E) sqrt(s) - (2/3) c1_k s^(3/2), and the
    per-segment telescoping sum sum_k [G_k(E-x_k) - G_k(E-min(x_{k+1},E))]
    collapses at the knots: continuity of rho''
    (c0_k + c1_k x_k = m2_k = c0_{k-1} + c1_{k-1} x_k) reduces each
    interior-knot term [G_k - G_{k-1}](E - x_k) to
    (4/3) (c1_k - c1_{k-1}) (E - x_k)^{3/2}, so

        I(E) = 2 m2_0 sqrt((E-x_0)_+)
             + (4/3) sum_k d_k ((E-x_k)_+)^{3/2},
        d_0 = c1_0,  d_k = c1_k - c1_{k-1}

    — knots above E drop out through the clamp, so the whole (M, K)
    evaluation is one clamped power and a matvec (the naive per-segment
    form materialised ~15 (M, K) float64 temporaries and dominated the
    per-halo table build).
    """
    x = psi_knots
    c1 = np.diff(m2) / np.diff(x)                      # (K-1,)
    d = np.concatenate([c1[:1], np.diff(c1)])          # (K-1,)
    s = np.maximum(E_values[:, None] - x[None, :-1], 0.0)
    return (2.0 * m2[0] * np.sqrt(np.maximum(E_values - x[0], 0.0))
            + (4.0 / 3.0) * ((s * np.sqrt(s)) @ d))


@dataclass(frozen=True)
class EddingtonInputs:
    """One halo's inputs to the Eddington integral: the ascending-psi
    knots ``x`` (NSAMPLE,) and the rho(psi) spline's second derivatives
    ``m2`` there, the E grid ``E`` (NTABLE,) (psi on a log-r grid, so
    descending), and the potential."""
    x: np.ndarray
    m2: np.ndarray
    E: np.ndarray
    psi: PotentialProfile


def prepare_distribution_function(*, mass_dm, a_hernq, G,
                                  mass_table: MassTable | None,
                                  r_sample_gas: float | None,
                                  has_gas: bool) -> EddingtonInputs:
    """The potential, the rho(psi) spline and the E grid of
    calc_distribution_function_table (velocities.c:186-247)."""
    gas_pot = None
    if has_gas and mass_table is not None:
        gas_pot = build_potential_table(mass_table, G, r_sample_gas)
    psi_prof = PotentialProfile(a_hernq=a_hernq, mass_dm=mass_dm, G=G,
                                gas=gas_pot)

    # sample rho_DM(psi) on the oversampled grid (velocities.c:199-221)
    rstep = np.log10(INFINITY_R / RMIN) / NSAMPLE
    r = RMIN * 10.0 ** (rstep * np.arange(NSAMPLE))
    rho = profiles.hernquist_density(r, mass_dm, a_hernq)
    psi = psi_prof(r)
    psi[-1] = 0.0  # ensure E == 0 is covered (velocities.c:209)

    # ascending-psi spline of rho(psi) (velocities.c:217-234)
    x = psi[::-1].copy()
    y = rho[::-1].copy()
    rho_spline = NaturalSpline.build(x, y)

    # E grid: E_i = psi(r_i) on a 1024-point log-r grid (velocities.c:236-247)
    rstep = np.log10(INFINITY_R / RMIN) / NTABLE
    rE = RMIN * 10.0 ** (rstep * np.arange(NTABLE))
    return EddingtonInputs(x=x, m2=rho_spline.m2, E=psi_prof(rE),
                           psi=psi_prof)


def finish_distribution_function(inp: EddingtonInputs, integral
                                 ) -> DistributionFunction:
    """f(E) from the Eddington integral (NTABLE,) on ``inp.E``: the
    normalisation, the endpoint fixes and the ascending-E spline
    (velocities.c:249-304).  ``integral`` is overwritten."""
    fE = integral
    fE /= np.sqrt(8.0) * const.PI ** 2
    E = inp.E.copy()

    fE[0] = fE[1]          # avoid the r=0 singularity (velocities.c:259)
    E[-1] = 0.0            # r -> inf (velocities.c:261-262)
    fE[-1] = 0.0

    # ascending-E spline (velocities.c:273-287)
    spline = NaturalSpline.build(E[::-1].copy(), fE[::-1].copy())
    return DistributionFunction(E=E[::-1].copy(), fE=fE[::-1].copy(),
                                spline=spline, psi=inp.psi)


def build_distribution_function(*, mass_dm, a_hernq, G,
                                mass_table: MassTable | None,
                                r_sample_gas: float | None,
                                has_gas: bool) -> DistributionFunction:
    """calc_distribution_function_table (velocities.c:186-304), the
    integral in NumPy."""
    inp = prepare_distribution_function(
        mass_dm=mass_dm, a_hernq=a_hernq, G=G, mass_table=mass_table,
        r_sample_gas=r_sample_gas, has_gas=has_gas)
    return finish_distribution_function(
        inp, _exact_eddington_integral(inp.x, inp.m2, inp.E))
