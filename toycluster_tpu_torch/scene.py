"""Scene construction — the reference's `Setup()` (setup.c:21-344) redesigned
as pure host-side functions producing an immutable `Scene`.

Given a Config, derives per-halo model parameters (R200, NFW concentration,
Hernquist scale, beta-model normalisation), particle counts (static shapes
for the device pipeline), the box, and the two-body merger kinematics.
All arithmetic float64 on host; tables built here are exported to the device
by the samplers.

JAX counterpart: ``toycluster_tpu/scene.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Optional

import numpy as np

from . import constants as const
from .config import Config
from .cosmology import Cosmology, cosmology_from_config
from .units import Units, units_from_config
from .models import profiles
from .models.tables import MassTable, build_mass_table


@dataclass(frozen=True)
class HaloModel:
    """Per-halo model parameters (struct HaloProperties, globals.h:132-159).

    Particle-slice pointers of the reference are replaced by (npart_gas,
    npart_dm) counts; particle <-> halo membership lives in a device array.
    """
    index: int
    mtotal200: float = 0.0
    mass200_gas: float = 0.0
    mass200_dm: float = 0.0
    c_nfw: float = 0.0
    rs: float = 0.0
    r200: float = 0.0
    r500: float = 0.0
    a_hernq: float = 0.0
    rho0: float = 0.0
    beta: float = 2.0 / 3.0
    rcore: float = 0.0
    rcut: float = 0.0
    r_sample_gas: float = 0.0   # R_Sample[0]
    r_sample_dm: float = 0.0    # R_Sample[1]
    have_cuspy: bool = False
    is_stripped: bool = False
    mass_corr_fac: float = 1.0  # qmax for Hernquist sampling
    mass_gas: float = 0.0       # total sampled gas mass  (Mass[0])
    mass_dm: float = 0.0        # total sampled DM mass   (Mass[1])
    mtotal: float = 0.0
    bf_eff: float = 0.0
    npart_gas: int = 0
    npart_dm: int = 0
    d_com: tuple = (0.0, 0.0, 0.0)
    bulk_vel: tuple = (0.0, 0.0, 0.0)
    mass_table: Optional[MassTable] = None

    @property
    def ntotal(self) -> int:
        return self.npart_gas + self.npart_dm


@dataclass(frozen=True)
class Scene:
    config: Config
    units: Units
    cosmo: Cosmology
    halos: tuple          # main halos first, then substructure
    boxsize: float
    mpart_gas: float
    mpart_dm: float
    npart_gas: int
    npart_dm: int
    mtotal: float
    grav_softening: float
    vel_merger: tuple = (0.0, 0.0)
    d_clusters: float = 0.0
    sub_first: int = 1    # index of first subhalo (io.c:498-504)

    @property
    def ntotal(self) -> int:
        return self.npart_gas + self.npart_dm

    @property
    def nhalos(self) -> int:
        return len(self.halos)

    @property
    def boxhalf(self) -> float:
        return 0.5 * self.boxsize

    @property
    def dm_only(self) -> bool:
        return self.cosmo.baryon_fraction == 0.0


def _concentration(cfg: Config, cosmo: Cosmology, i: int, m200_cgs: float
                   ) -> float:
    """Concentration_parameter for main halos (setup.c:503-527)."""
    if cfg.give_params and i < len(cfg.c_nfw_given):
        return cfg.c_nfw_given[i]
    if cfg.nfw_concentration_model == "buote07":
        return profiles.concentration_buote07(m200_cgs)
    return profiles.concentration_duffy08(m200_cgs, cfg.redshift,
                                          cosmo.h_100)


def _core_radius(cfg: Config, i: int, rs: float, have_cuspy: bool) -> float:
    if cfg.give_params and i < len(cfg.rc_given):
        return cfg.rc_given[i]
    return profiles.gas_core_radius(rs, have_cuspy,
                                    cfg.double_beta_cool_cores)


def build_scene(cfg: Config) -> Scene:
    cfg = cfg.validate()
    units = units_from_config(cfg)
    cosmo = cosmology_from_config(cfg)

    bf = cosmo.baryon_fraction
    xm = cfg.mass_ratio
    z = cfg.redshift
    rho_crit = cosmo.critical_density(z)
    delta = cosmo.overdensity_parameter()
    G = units.G
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)

    nhalos = cfg.nhalos
    # halo masses inside R200 (setup.c:36-37)
    m200 = [cfg.mtot200 / (1 + xm),
            cfg.mtot200 - cfg.mtot200 / (1 + xm)][:nhalos]

    halos = []
    for i in range(nhalos):
        h = HaloModel(index=i, mtotal200=m200[i])
        beta = (cfg.beta_given[i] if cfg.give_params else cfg.beta)
        mass200_dm = h.mtotal200 / (1 + bf)            # setup.c:50-51
        mass200_gas = h.mtotal200 - mass200_dm
        c_nfw = _concentration(cfg, cosmo, i, h.mtotal200 * units.mass)
        # R200: Kitayama & Suto 99 (setup.c:56-57)
        r200 = ((h.mtotal200 * units.mass
                 / (delta * rho_crit * const.FOURPITHIRD)) ** (1.0 / 3.0)
                / units.length)
        rs = r200 / c_nfw
        a_hernq = profiles.hernquist_a_from_nfw(rs, c_nfw)  # setup.c:62
        halos.append(replace(h, mass200_dm=mass200_dm,
                             mass200_gas=mass200_gas, c_nfw=c_nfw, r200=r200,
                             rs=rs, a_hernq=a_hernq, beta=beta))

    boxsize = math.floor(2 * const.R200_TO_RMAX_RATIO * halos[0].r200)

    mtot_gas_sum = 0.0
    mtot_dm_sum = 0.0
    mtotal_sum = 0.0
    for i, h in enumerate(halos):
        # sampling radii (setup.c:69-77): halo 0 provides the background and
        # fills the box (gas out to the corner, DM to the face)
        r_sample_gas = h.r200 * 1.8
        r_sample_dm = h.r200 * 1.8
        if i == 0:
            r_sample_dm = boxsize / 2.0
            r_sample_gas = math.sqrt(3.0) * boxsize / 2.0
        rcut = 1.4 * h.r200

        have_cuspy = bool(cfg.cuspy & (1 << i))        # setup.c:567
        rcore = _core_radius(cfg, i, h.rs, have_cuspy)

        # gas rho0 calibration: M_gas(R200) = mass200_gas (setup.c:93-99)
        if bf and h.mass200_gas:
            table = build_mass_table(1.0, h.beta, rcore, rcut, have_cuspy,
                                     r_sample_gas, cool_core)
            rho0 = h.mass200_gas / table.mass(h.r200)
            table = build_mass_table(rho0, h.beta, rcore, rcut, have_cuspy,
                                     r_sample_gas, cool_core)
            mass_gas = float(table.mass(r_sample_gas))  # setup.c:103
        else:  # DM only: gas tables are never used (main.c:50)
            table = None
            rho0 = 0.0
            mass_gas = 0.0
        # DM finite-sampling correction (setup.c:105-108)
        a = h.a_hernq
        mass_corr_fac = 1.0 / (1 + 2 * a / r_sample_dm
                               + (a / r_sample_dm) ** 2)
        mass_dm = (h.mass200_dm * (1 + 2 * a / h.r200 + (a / h.r200) ** 2)
                   * mass_corr_fac)
        mtotal = mass_gas + mass_dm
        if not bf:  # DM only (setup.c:112-115)
            mass_dm += mass_gas
            mass_gas = 0.0

        # effective baryon fraction in R500 (setup.c:156-182)
        r500 = bf_eff = 0.0
        if bf and h.mtotal200:
            r500 = ((h.mtotal200 * units.mass
                     / (500 * rho_crit * const.FOURPITHIRD)) ** (1.0 / 3.0)
                    / units.length)
            r500_cgs = r500 * units.length
            mdm_cgs = mass_dm * units.mass
            rho0_cgs = units.density_cgs(rho0)
            a_cgs = a * units.length
            rc_cgs = rcore * units.length
            bf_eff = (4 * const.PI * rc_cgs ** 3 * rho0_cgs
                      * (r500_cgs / rc_cgs - math.atan(r500_cgs / rc_cgs))
                      / (mdm_cgs * r500_cgs ** 2 / (a_cgs + r500_cgs) ** 2))

        halos[i] = replace(h, r_sample_gas=r_sample_gas,
                           r_sample_dm=r_sample_dm, rcut=rcut,
                           have_cuspy=have_cuspy, rcore=rcore, rho0=rho0,
                           mass_gas=mass_gas, mass_dm=mass_dm, mtotal=mtotal,
                           mass_corr_fac=mass_corr_fac, r500=r500,
                           bf_eff=bf_eff, mass_table=table)
        mtot_gas_sum += mass_gas
        mtot_dm_sum += mass_dm
        mtotal_sum += mtotal

    # particle numbers from global (sampled) masses (setup.c:187-215)
    n_dm = int(0.5 * cfg.ntotal)
    n_gas = int(0.5 * cfg.ntotal)
    if bf:
        mpart_gas = mtot_gas_sum / n_gas
        mpart_dm = mtot_dm_sum / n_dm
        for i, h in enumerate(halos):
            halos[i] = replace(h,
                               npart_gas=round(h.mass_gas / mpart_gas),
                               npart_dm=round(h.mass_dm / mpart_dm))
    else:
        mpart_gas = 0.0
        n_gas = 0
        mpart_dm = mtotal_sum / cfg.ntotal
        for i, h in enumerate(halos):
            halos[i] = replace(h, npart_gas=0,
                               npart_dm=round(h.mtotal / mpart_dm))

    npart_gas = sum(h.npart_gas for h in halos)
    npart_dm = sum(h.npart_dm for h in halos)

    # grav softening from the larger cluster (setup.c:267-268)
    grav_soft = (halos[0].r_sample_dm ** 3 / cfg.ntotal) ** (1.0 / 3.0) / 7.0

    # two-body merger kinematics (setup.c:274-337)
    vel_merger = (0.0, 0.0)
    d_clusters = 0.0
    if xm:
        d_clusters = 0.9 * (halos[0].r200 + halos[1].r200)
        d0x = -halos[1].mtotal200 * d_clusters / cfg.mtot200
        d1x = d_clusters + d0x
        d0y = -halos[1].mtotal200 * cfg.impact_param / cfg.mtot200
        d1y = cfg.impact_param + d0y
        if cfg.give_params:
            vel_merger = (cfg.v_com_given[0], cfg.v_com_given[1])
        else:
            v0 = math.sqrt(2 * G * halos[1].mtotal200
                           / (d_clusters * (1 + 1 / xm)))
            v1 = -cfg.mtot200 / halos[1].mtotal200 * v0
            vel_merger = (v0 * cfg.zero_e_orbit_frac,
                          v1 * cfg.zero_e_orbit_frac)
        bulk0 = bulk1 = (0.0, 0.0, 0.0)
        if cfg.orbit == "direct":  # no PARABOLA/COMET: stamp at setup
            bulk0 = (vel_merger[0], 0.0, 0.0)
            bulk1 = (vel_merger[1], 0.0, 0.0)
        halos[0] = replace(halos[0], d_com=(d0x, d0y, 0.0), bulk_vel=bulk0)
        halos[1] = replace(halos[1], d_com=(d1x, d1y, 0.0), bulk_vel=bulk1)

    return Scene(config=cfg, units=units, cosmo=cosmo, halos=tuple(halos),
                 boxsize=float(boxsize), mpart_gas=mpart_gas,
                 mpart_dm=mpart_dm, npart_gas=npart_gas, npart_dm=npart_dm,
                 mtotal=mtotal_sum, grav_softening=grav_soft,
                 vel_merger=vel_merger, d_clusters=d_clusters,
                 sub_first=1 if xm == 0 else 2)
