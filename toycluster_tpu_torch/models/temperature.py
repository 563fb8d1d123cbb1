"""Gas internal energy from hydrostatic equilibrium (reference
temperature.c:8-44, Donnert 2014 eq. 9).

JAX counterpart: ``toycluster_tpu/models/temperature.py``.  The u(r)
tables are built on the host per halo (models/tables.py: QUADPACK and a
natural spline on a 1024-point log grid), stacked, and evaluated on the
device for every gas particle against its own halo's row.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import constants as const
from ..models.tables import build_energy_table
from ..ops.interp import SplineTable, batched_spline_eval
from ..particles import Particles
from ..scene import Scene


def build_energy_tables_stacked(scene: Scene, device):
    """Per-halo u(r) spline tables stacked to (H, K) rows.  Every halo
    shares one log knot grid, so halos without a mass table get a zero
    row and their gas evaluates to u = 0."""
    cfg = scene.config
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    rows, x_ref = [], None
    for h in scene.halos:
        if h.mass_table is None:
            rows.append(None)
            continue
        etab = build_energy_table(
            h.mass_table, rho0=h.rho0, beta=h.beta, rc=h.rcore,
            rcut=h.rcut, is_cuspy=h.have_cuspy, a_hernq=h.a_hernq,
            mdm=h.mass_dm, boxsize=scene.boxsize, G=scene.units.G,
            no_rcut_in_t=cfg.no_rcut_in_t, cool_core=cool_core)
        rows.append(tuple(np.asarray(a, np.float32) for a in
                          (etab.spline.x, etab.spline.y, etab.spline.m2)))
        x_ref = rows[-1][0]
    if x_ref is None:
        return None
    zero = (x_ref, np.zeros_like(x_ref), np.zeros_like(x_ref))
    rows = [r if r is not None else zero for r in rows]
    return SplineTable(*(torch.as_tensor(np.stack([r[k] for r in rows]),
                                         device=device) for k in range(3)))


def make_temperatures(scene: Scene, parts: Particles) -> Particles:
    n_gas = parts.n_gas
    if n_gas == 0:
        return parts
    tables = build_energy_tables_stacked(scene, parts.device)
    if tables is None:
        return parts
    d_com = torch.as_tensor(np.stack([h.d_com for h in scene.halos]),
                            dtype=torch.float32, device=parts.device)
    return parts.replace(u=temperature_eval(
        tables, d_com, scene.boxhalf, parts.pos[:n_gas], parts.halo[:n_gas]))


def temperature_eval(tables, d_com, boxhalf, pos_gas, gas_halo):
    """u of each gas particle from its own halo's row of the stacked
    tables (halo < 0: out of the box, u = 0)."""
    hid = torch.clamp(gas_halo, min=0).long()
    r = torch.linalg.vector_norm(pos_gas - (d_com[hid] + boxhalf), dim=-1)
    u = batched_spline_eval(tables, hid, r)
    return torch.where(gas_halo < 0, torch.zeros_like(u),
                       u).to(torch.float32)


def internal_energy_analytic(scene: Scene, i: int, r):
    """Donnert+2016 closed-form u(r) for the untapered beta = 2/3 model
    (temperature.c:51-83), a cross-check oracle (valid where r << rcut)."""
    h = scene.halos[i]
    G = scene.units.G
    rho0, a, rc = h.rho0, h.a_hernq, h.rcore
    rmax = scene.boxsize
    mdm = h.mass_dm
    r = np.asarray(r, np.float64)

    def f1(x):
        rc2, a2 = rc * rc, a * a
        res = ((a2 - rc2) * np.arctan(x / rc) - rc * (a2 + rc2) / (a + x)
               + a * rc * np.log((a + x) ** 2 / (rc2 + x * x)))
        return res * rc / (a2 + rc2) ** 2

    def f2(x):
        return (np.arctan(x / rc) ** 2 / (2 * rc)
                + np.arctan(x / rc) / x)

    return (G / (const.ADIABATIC_INDEX - 1.0) * (1.0 + (r / rc) ** 2)
            * (mdm * (f1(rmax) - f1(r))
               + 4.0 * const.PI * rho0 * rc ** 3 * (f2(rmax) - f2(r))))
