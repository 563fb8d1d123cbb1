"""Structured stage logging.

The reference's printf tables are its de-facto UX (unit.c:9-17,
setup.c:117-142, wvt_relax.c:91-92); we reproduce the key stage reports
through one logger that also records machine-readable metrics.

JAX counterpart: ``toycluster_tpu/utils/logging.py``, host-side NumPy
without JAX, carried over unchanged so that both packages build
identical scenes.
"""

from __future__ import annotations

import json
import sys
import time

_T0 = time.perf_counter()
METRICS: list = []


def stage_log(stage: str, **kw):
    t = time.perf_counter() - _T0
    scene = kw.pop("scene", None)
    rec = {"t": round(t, 3), "stage": stage, **{k: v for k, v in kw.items()
                                                if _jsonable(v)}}
    METRICS.append(rec)
    msg = f"[{t:8.2f}s] {stage}"
    if scene is not None:
        msg += (f": nhalos={scene.nhalos} box={scene.boxsize:g} "
                f"ngas={scene.npart_gas} ndm={scene.npart_dm}")
        for h in scene.halos:
            msg += (f"\n            halo<{h.index}> M200={h.mtotal200:g} "
                    f"R200={h.r200:.1f} c={h.c_nfw:.3f} a={h.a_hernq:.1f} "
                    f"rc={h.rcore:.2f} rho0={h.rho0:g} bf500={h.bf_eff:.3f}")
    else:
        extras = " ".join(f"{k}={v}" for k, v in kw.items())
        if extras:
            msg += ": " + extras
    print(msg, file=sys.stderr, flush=True)


def _jsonable(v):
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


def silent_log(stage: str, **kw):
    pass


# -------------------------------------------------------------------------
# Reference stdout tables — the de-facto UX of the original program,
# reproduced field by field so runs can be diffed against it.
# -------------------------------------------------------------------------

def _p(msg):
    print(msg, file=sys.stderr, flush=True)


def report_units(units):
    """unit.c:9-17."""
    _p("Setting System of Units: \n"
       f"   Unit Length = {units.length:g} cm \n"
       f"   Unit Time   = {units.time:g} sec\n"
       f"   Unit Mass   = {units.mass:g} g  \n"
       f"   Unit Vel    = {units.vel:g} cm/s\n"
       f"   Unit Density= {units.density:g} g/cm^3\n"
       f"   Unit Energy = {units.energy:g} erg\n")


def report_cosmology(cosmo, z):
    """cosmo.c:22-33."""
    from .. import constants as const
    _p(f"System at:   z = {z:g} \n"
       f"   H/100       = {cosmo.h_100:g}\n"
       f"   Omega_M     = {cosmo.omega_m:g}\n"
       f"   rho_crit(0) = {cosmo.rho_crit0:g} g/cm^3\n"
       f"   rho_crit(z) = {cosmo.critical_density(z):g} g/cm^3\n"
       f"   mean mol. w.= {const.MEAN_MOL_WEIGHT:g}\n"
       f"   E(z)        = {cosmo.Ez(z):g}\n"
       f"   Delta       = {cosmo.overdensity_parameter():g}\n")


def report_halo_setup(scene):
    """setup.c:117-190 (incl. the R500 / effective-bf block)."""
    from .. import constants as const
    units = scene.units
    cfg = scene.config
    for h in scene.halos:
        kind = "Subhalo" if h.index >= scene.sub_first else (
            "DM only" if scene.dm_only else "Gas & DM")
        rho0_cgs = units.density_cgs(h.rho0)
        _p(f"Halo Setup : <{h.index}>\n"
           f"   Model             = {kind}\n"
           f"   Sample Radius Gas = {h.r_sample_gas:g} kpc\n"
           f"   Sample Radius DM  = {h.r_sample_dm:g} kpc\n"
           f"   qmax              = {h.mass_corr_fac:g} \n"
           f"   Mass              = {h.mtotal:g} 10^10 MSol\n"
           f"   Mass in DM        = {h.mass_dm:g} 10^10 MSol\n"
           f"   Mass in Gas       = {h.mass_gas:g} 10^10 MSol\n"
           f"   Mass in R200      = {h.mtotal200:g} 10^10 MSol\n"
           f"   c_nfw             = {h.c_nfw:g} \n"
           f"   R200              = {h.r200:g} kpc\n"
           f"   a_hernquist       = {h.a_hernq:g} kpc\n"
           f"   rho0_gas          = {rho0_cgs:g} g/cm^3\n"
           f"   rho0_gas          = {h.rho0:g} [gadget]\n"
           f"   rho0_gas          = {rho0_cgs / (0.6 * const.M_PROTON):g}"
           " [cm^-3]\n"
           f"   beta              = {h.beta:g} \n"
           f"   rc                = {h.rcore:g} kpc\n"
           f"   Rcut              = {h.rcut:g} kpc")
        if cfg.double_beta_cool_cores and h.have_cuspy:
            _p(f"   rho0_cc           = "
               f"{units.density_cgs(h.rho0 * cfg.rho0_fac):g} g/cm^3\n"
               f"   rho0_cc           = {h.rho0 * cfg.rho0_fac:g}"
               " [gadget]\n"
               f"   rc_cc             = {h.rcore / cfg.rc_fac:g} kpc")
        if not scene.dm_only and h.mtotal200:
            _p(f"   R500              = {h.r500:g} kpc\n"
               f"   bf_200            = {scene.cosmo.baryon_fraction:g} \n"
               f"   bf_500            = {h.bf_eff:g} \n")


def report_kinematics(scene):
    """setup.c:313-327 — only for multi-cluster setups."""
    if scene.sub_first < 2:
        return
    cfg = scene.config
    h0, h1 = scene.halos[0], scene.halos[1]
    d = scene.d_clusters
    _p("Kinematics of Collision : \n"
       f"   Zero-E fraction     = {cfg.zero_e_orbit_frac:g} \n"
       f"   Initial Distance    = {d:g} kpc\n"
       f"   CoM Distance of <0> = {h0.d_com[0]:g} kpc\n"
       f"   CoM Distance of <1> = {h1.d_com[0]:g} kpc\n"
       f"   CoM Velocity of <0> = {scene.vel_merger[0]:g} km/s\n"
       f"   CoM Velocity of <1> = {scene.vel_merger[1]:g} km/s\n\n"
       f"   Impact Parameter    = {cfg.impact_param:g} kpc\n"
       f"   CoM Impact of <0>   = {h0.d_com[1]:g} kpc\n"
       f"   CoM Impact of <1>   = {h1.d_com[1]:g} kpc\n")


def report_subhalos(scene):
    """REPORTSUBHALOS per-subhalo table (substructure.c:74-103)."""
    for h in scene.halos[scene.sub_first:]:
        _p(f"Subhalo <{h.index}> :\n"
           f"   Npart         = {h.npart_gas}, {h.npart_dm} \n"
           f"   Mass          = {h.mtotal:g} | {h.mass_gas:g}"
           f" {h.mass_dm:g} \n"
           f"   Mass200       = {h.mtotal200:g} | {h.mass200_gas:g}"
           f" {h.mass200_dm:g} \n"
           f"   bf in rsample = "
           f"{h.mass_gas / h.mtotal if h.mtotal else 0.0:g} \n"
           f"   Mass Fraction = "
           f"{h.mtotal200 / scene.halos[0].mtotal:g} \n"
           f"   DM  Mass      = {h.mass_dm:g} \n"
           f"   Gas Mass      = {h.mass_gas:g} \n"
           f"   c_nfw         = {h.c_nfw:g} \n"
           f"   r_sample      = {h.r_sample_dm:g} \n"
           f"   R200          = {h.r200:g} \n"
           f"   r_s           = {h.rs:g} \n"
           f"   Hernquist a   = {h.a_hernq:g} \n"
           f"   core radius   = {h.rcore:g} \n"
           f"   rho0          = {h.rho0:g} \n"
           f"   MassCorrect.  = {h.mass_corr_fac:g} \n"
           f"   x, y, z       = {h.d_com[0]:g} {h.d_com[1]:g}"
           f" {h.d_com[2]:g}\n"
           f"   vx,vy,vz      = {h.bulk_vel[0]:g} {h.bulk_vel[1]:g}"
           f" {h.bulk_vel[2]:g}")
