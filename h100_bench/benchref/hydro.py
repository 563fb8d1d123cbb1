"""Plain profiles that judge the temperatures and the DM velocities of a
finished initial-conditions set, in float64 NumPy on dense log grids.

The physics is the reference code's (Toycluster temperature.c,
velocities.c; Donnert 2014 eq. 9), worked out here by plain cumulative
trapezoids and not by its spline tables:

* the gas's cumulative mass M_gas(<r), held at the halo's gas sampling
  radius beyond it (Mass_profile, setup.c:643-708), and the
  Hernquist DM mass M_dm(<r) = m r^2 / (r + a)^2;
* u(r) = G / ((gamma - 1) rho_gas(r)) int_r^rmax rho_gas (M_gas + M_dm)
  / r'^2 dr', rmax = sqrt(3) boxsize, with NO_RCUT_IN_T's rcut of 1e5
  inside the integral and 1e6 in front of it (temperature.c:114-171);
* the gas owner of a point: the largest beta-model density among the
  halos that are not stripped and whose gas sampling radius holds it,
  else halo 0 (positions.c:363-385);
* the isotropic Jeans mean square speed of a halo's DM, <v^2>(r) = 3 /
  rho_dm(r) int_r^inf rho_dm G M(<r') / r'^2 dr', M the DM's and (where
  the halo has gas) the gas's mass: the second moment of an ergodic f(E)
  of the Hernquist DM in that potential (velocities.c:38-95, 323-447).
"""

from __future__ import annotations

import math

import numpy as np

GAMMA = 5.0 / 3.0
RMIN_TABLE = 0.1          # the energy table's first radius (temperature.c)
RMIN_MASS = 1e-4
NGRID = 1 << 15


def gas_density(r, halo, cool_core=None, rcut=None):
    """Beta-model gas density of ``halo`` at ``r`` (setup.c:598-615),
    with ``rcut`` in place of the halo's where given."""
    rcut = halo["rcut"] if rcut is None else rcut
    taper = 1.0 + (r / rcut) ** 4
    rho = halo["rho0"] * (1.0 + (r / halo["rcore"]) ** 2) ** (
        -1.5 * halo["beta"]) / taper
    if cool_core is not None and halo["cuspy"]:
        rho0_fac, rc_fac = cool_core
        rho = rho + (halo["rho0"] * rho0_fac
                     / (1.0 + (r / (halo["rcore"] / rc_fac)) ** 2) / taper)
    return rho


def _cumtrapz(y, x, acc=None):
    """Cumulative trapezoid; summed in the torch dtype ``acc`` where
    given (the precision control)."""
    out = np.zeros_like(y)
    terms = 0.5 * (y[1:] + y[:-1]) * np.diff(x)
    if acc is None:
        out[1:] = np.cumsum(terms)
    else:
        import torch
        out[1:] = torch.cumsum(torch.as_tensor(terms).to(acc),
                               0).double().numpy()
    return out


def gas_mass(halo, cool_core, r):
    """M_gas(<r), held beyond the gas sampling radius."""
    rs = halo["r_sample_gas"]
    grid = np.geomspace(RMIN_MASS, rs, NGRID)
    m = _cumtrapz(4 * math.pi * grid**2 * gas_density(grid, halo, cool_core),
                  grid) + 4 * math.pi / 3 * RMIN_MASS**3 * gas_density(
                      0.0, halo, cool_core)
    r = np.clip(np.asarray(r, np.float64), RMIN_MASS, rs)
    return np.interp(np.log(r), np.log(grid), m)


def dm_mass(halo, r):
    return halo["mass_dm"] * r * r / (r + halo["a_hernq"]) ** 2


def internal_energy(halo, r, *, boxsize, G, cool_core=None,
                    no_rcut_in_t=True):
    """u(r) of the gas of ``halo`` at radii ``r`` (temperature.c)."""
    rmax = boxsize * math.sqrt(3.0)
    rcut_int = 1e5 if no_rcut_in_t else halo["rcut"]
    rcut_pre = 1e6 if no_rcut_in_t else halo["rcut"]
    grid = np.geomspace(RMIN_TABLE, rmax, NGRID)
    g = (gas_density(grid, halo, cool_core, rcut=rcut_int) / grid**2
         * (gas_mass(halo, cool_core, grid) + dm_mass(halo, grid)))
    above = _cumtrapz(g, grid)
    above = above[-1] - above                      # int_r^rmax
    r = np.asarray(r, np.float64)
    at = np.interp(np.log(np.clip(r, RMIN_TABLE, rmax)), np.log(grid), above)
    return G / ((GAMMA - 1.0)
                * gas_density(r, halo, cool_core, rcut=rcut_pre)) * at


def gas_owner(pos, halos, boxsize, cool_core=None):
    """(owner, runner-up, their densities) of each point of ``pos``
    (box coordinates, (n, 3)): the owner is the halo index of the largest
    beta-model density among the halos that are not stripped and hold
    the point within their gas sampling radius, halo 0 where none does,
    and -1 where the point lies a box length past the box's centre
    (positions.c:337-338)."""
    n = pos.shape[0]
    best = np.zeros(n, dtype=np.int64)
    second = np.full(n, -1)
    rho_b = np.zeros(n)
    rho_s = np.zeros(n)
    for j, h in enumerate(halos):
        if h["stripped"]:
            continue
        r = np.linalg.norm(pos - (np.asarray(h["center"]) + 0.5 * boxsize),
                           axis=-1)
        rho = np.where(r < h["r_sample_gas"],
                       gas_density(r, h, cool_core), 0.0)
        top = rho > rho_b
        runner = ~top & (rho > rho_s)
        second = np.where(top, best, np.where(runner, j, second))
        rho_s = np.where(top, rho_b, np.where(runner, rho, rho_s))
        best = np.where(top, j, best)
        rho_b = np.where(top, rho, rho_b)
    outside = (pos - 0.5 * boxsize > boxsize).any(axis=-1)
    return np.where(outside, -1, best), second, rho_b, rho_s


def dm_mean_square_speed(halo, r, *, G, cool_core=None, acc=None):
    """Isotropic Jeans <v^2>(r) of the Hernquist DM of ``halo``; the
    integral summed in ``acc`` where given."""
    a, m = halo["a_hernq"], halo["mass_dm"]
    hi = 1e4 * max(a, halo["r_sample_gas"], 1.0)
    grid = np.geomspace(1e-3, hi, NGRID)
    rho = m * a / (2 * math.pi * grid * (grid + a) ** 3)
    mass = dm_mass(halo, grid)
    if halo["has_gas"]:
        mass = mass + gas_mass(halo, cool_core, grid)
    g = rho * G * mass / grid**2
    above = _cumtrapz(g, grid, acc)
    above = above[-1] - above
    r = np.clip(np.asarray(r, np.float64), grid[0], hi)
    rho_r = m * a / (2 * math.pi * r * (r + a) ** 3)
    return 3.0 * np.interp(np.log(r), np.log(grid), above) / rho_r
