"""Analytic cluster profiles.

Pure functions written with plain arithmetic so they evaluate identically on
NumPy float64 host arrays (setup tables) and on device arrays.

Physics references (reference file:line):
* beta-model gas density with rcut^4 taper             setup.c:598-615
* optional double-beta cool core                        setup.c:604-612
* closed-form M(<r) for beta=2/3                        setup.c:724-762
* Hernquist density / mass / potential                  setup.c:715, velocities.c:337-368
* Hernquist analytic distribution function              velocities.c:346-358
* NFW concentration (Duffy+08 / Buote+07 / Pieri+09)    setup.c:503-552
* beta-model core radius rule                           setup.c:555-592
* analytic hydrostatic internal energy (Donnert+16)     temperature.c:51-83

JAX counterpart: ``toycluster_tpu/models/profiles.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

from __future__ import annotations

import math

import numpy as np

from .. import constants as const


# --------------------------------------------------------------------------
# beta-model gas profile
# --------------------------------------------------------------------------

def gas_density(r, rho0, beta, rc, rcut, is_cuspy=False,
                cool_core=None):
    """Beta-model density with quartic cutoff taper (setup.c:598-615).

    rho(r) = rho0 (1 + (r/rc)^2)^(-3 beta/2) / (1 + (r/rcut)^4)

    `cool_core=(rho0_fac, rc_fac)` adds the DOUBLE_BETA_COOL_CORES second
    component when `is_cuspy` holds.
    """
    taper = 1.0 + (r / rcut) ** 3 * (r / rcut)
    rho = rho0 * (1.0 + (r / rc) ** 2) ** (-1.5 * beta) / taper
    if cool_core is not None:
        rho0_fac, rc_fac = cool_core
        rho_cc = (rho0 * rho0_fac) / (1.0 + (r / (rc / rc_fac)) ** 2) / taper
        rho = rho + is_cuspy * rho_cc
    return rho


def mass_profile_beta23(r, rho0, rc, rcut, is_cuspy=False, cool_core=None):
    """Closed-form M(<r) of the tapered beta=2/3 model (setup.c:724-762).

    Used as the quadrature oracle in tests.
    """
    sqrt2 = const.SQRT2
    r2 = r * r
    rc2 = rc * rc
    rcut2 = rcut * rcut

    def _m(rc, rc2):
        return (rc2 * rcut2 * rcut / (8 * (rcut2**2 + rc2**2))
                * (sqrt2 * ((rc2 - rcut2)
                            * (np.log(rcut2 - sqrt2 * rcut * r + r2)
                               - np.log(rcut2 + sqrt2 * rcut * r + r2))
                            - 2 * (rc2 + rcut2) * np.arctan(1 - sqrt2 * r / rcut)
                            + 2 * (rc2 + rcut2) * np.arctan(sqrt2 * r / rcut + 1))
                   - 8 * rc * rcut * np.arctan(r / rc)))

    mr = rho0 * _m(rc, rc2)
    if cool_core is not None and np.any(is_cuspy):
        rho0_fac, rc_fac = cool_core
        rc_cc = rc / rc_fac
        # NB the reference's cool-core closed form reuses (rc2 - rcut2) from
        # the primary component (setup.c:753); we reproduce that verbatim.
        rc2_cc = rc_cc * rc_cc
        mr_cc = (rho0 * rho0_fac) * (
            rc2_cc * rcut2 * rcut / (8 * (rcut2**2 + rc2_cc**2))
            * (sqrt2 * ((rc2 - rcut2)
                        * (np.log(rcut2 - sqrt2 * rcut * r + r2)
                           - np.log(rcut2 + sqrt2 * rcut * r + r2))
                        - 2 * (rc2_cc + rcut2) * np.arctan(1 - sqrt2 * r / rcut)
                        + 2 * (rc2_cc + rcut2) * np.arctan(sqrt2 * r / rcut + 1))
               - 8 * rc_cc * rcut * np.arctan(r / rc)))
        mr = mr + is_cuspy * mr_cc
    return 4 * const.PI * mr


# --------------------------------------------------------------------------
# Hernquist dark-matter profile (Hernquist 1990)
# --------------------------------------------------------------------------

def hernquist_density(r, m, a):
    """rho_DM(r) = m a / (2 pi r (r+a)^3)  (setup.c:715-718)."""
    return m / (2 * const.PI) * a / (r * (r + a) ** 3)


def hernquist_mass(r, m, a):
    """M(<r) = m r^2/(r+a)^2."""
    return m * r * r / (r + a) ** 2


def hernquist_psi(r, m, a, G):
    """Relative potential Psi = -Phi = G m/(r+a) >= 0 (velocities.c:360-368)."""
    return G * m / (r + a)


def hernquist_sample_radius(q, a):
    """Invert the Hernquist cumulative mass: r = a sqrt(q)/(1-sqrt(q))
    with q = M(<r)/M_tot in [0,1)  (positions.c:67-68)."""
    sq = q ** 0.5
    return a * sq / (1.0 - sq)


def hernquist_fE(E, m, a, G):
    """Analytic Hernquist distribution function (velocities.c:346-358);
    oracle for the numerical Eddington inversion."""
    prefac = 1.0 / (const.SQRT2 * (2 * const.PI) ** 3 * (G * m * a) ** 1.5)
    q2 = a * E / (G * m)
    return (prefac * m * np.sqrt(q2) / (1 - q2) ** 2
            * ((1 - 2 * q2) * (8 * q2 * q2 - 8 * q2 - 3)
               + 3 * np.arcsin(np.sqrt(q2)) / np.sqrt(q2 * (1 - q2))))


# --------------------------------------------------------------------------
# scaling relations
# --------------------------------------------------------------------------

def concentration_duffy08(m200_cgs, redshift, h_100):
    """Duffy+ 2008 NFW concentration fit, WMAP5 (setup.c:512-521).
    `m200_cgs` in grams."""
    A, B, C = 5.74, -0.097, -0.47
    mpivot = 2e12 / h_100  # Msol
    mass = m200_cgs / const.MSOL2CGS
    return A * (mass / mpivot) ** B * (1 + redshift) ** C


def concentration_buote07(m200_cgs):
    """Buote+ 2007 observational fit (setup.c:523-527)."""
    mass = m200_cgs / const.MSOL2CGS
    return 9 * (mass / 1e14) ** (-0.172)


def concentration_pieri09(msub_cgs, d_vir, redshift):
    """Pieri+ 2009 subhalo concentration, distance-dependent
    (setup.c:529-547). `d_vir` is the halo-centric distance in units of the
    host R200."""
    aR, c1, c2, a1, a2 = 0.237, 232.15, -181.74, 0.0146, 0.008
    mass = msub_cgs / const.MSOL2CGS
    c = d_vir ** (-aR) * (c1 * mass ** (-a1) + c2 * mass ** (-a2))
    return c / (1 + redshift)


def hernquist_a_from_nfw(rs, c_nfw):
    """Springel & Farrar 07 matching (setup.c:62)."""
    return rs * math.sqrt(2 * (math.log(1 + c_nfw) - c_nfw / (1 + c_nfw)))


def gas_core_radius(rs, have_cuspy, double_beta_cool_cores=False):
    """rc = Rs/9 for cool-core (cuspy) halos, Rs/3 otherwise; under
    DOUBLE_BETA_COOL_CORES the cuspy single-beta core reverts to Rs/3 and the
    cuspiness moves into the second beta component (setup.c:555-592)."""
    if have_cuspy and not double_beta_cool_cores:
        return rs / 9.0
    return rs / 3.0


# --------------------------------------------------------------------------
# analytic hydrostatic internal energy (Donnert+ 2016; temperature.c:51-83)
# --------------------------------------------------------------------------

def _F1(r, rc, a):
    rc2 = rc * rc
    a2 = a * a
    res = ((a2 - rc2) * np.arctan(r / rc) - rc * (a2 + rc2) / (a + r)
           + a * rc * np.log((a + r) ** 2 / (rc2 + r * r)))
    return res * rc / (a2 + rc2) ** 2


def _F2(r, rc):
    return np.arctan(r / rc) ** 2 / (2 * rc) + np.arctan(r / rc) / r


def internal_energy_beta23_analytic(r, rho0, rc, a_hernq, mdm, rmax, G):
    """u(r) closed form for the untapered beta=2/3 model; reference keeps it
    as an in-code oracle (temperature.c:69-83)."""
    return (G / (const.ADIABATIC_INDEX - 1) * (1 + (r / rc) ** 2)
            * (mdm * (_F1(rmax, rc, a_hernq) - _F1(r, rc, a_hernq))
               + 4 * const.PI * rho0 * rc ** 3 * (_F2(rmax, rc) - _F2(r, rc))))
