"""Structured stage logging, and the spans carried on it.

The reference's printf tables are its de-facto UX (unit.c:9-17,
setup.c:117-142, wvt_relax.c:91-92); we reproduce the key stage reports
through one logger.  A ``log=`` callable receives ``log(stage,
**fields)`` at the end of each stage and stamps its own clock:
``stage_log`` prints the record, ``Records`` keeps every record as a
dict and can print it too.

JAX counterpart: ``toycluster_tpu/utils/logging.py`` (the tables are
carried over unchanged, so that both packages print identical scenes).
The port adds ``Spans``: named intervals on ``time.perf_counter``, the
clock that the log's receivers stamp with, kept in memory while a stage
runs and handed on as the list field ``spans`` of the record that
closes the stage.
"""

from __future__ import annotations

import contextlib
import json
import sys
import time
from collections import defaultdict

import torch

_T0 = time.perf_counter()


def _fields(kw):
    return {k: v for k, v in kw.items() if k != "scene" and _jsonable(v)}


def _say(t, stage, kw):
    scene = kw.get("scene")
    msg = f"[{t:8.2f}s] {stage}"
    if scene is not None:
        msg += (f": nhalos={scene.nhalos} box={scene.boxsize:g} "
                f"ngas={scene.npart_gas} ndm={scene.npart_dm}")
        for h in scene.halos:
            msg += (f"\n            halo<{h.index}> M200={h.mtotal200:g} "
                    f"R200={h.r200:.1f} c={h.c_nfw:.3f} a={h.a_hernq:.1f} "
                    f"rc={h.rcore:.2f} rho0={h.rho0:g} bf500={h.bf_eff:.3f}")
    else:
        extras = " ".join(f"{k}={span_summary(v) if k == 'spans' else v}"
                          for k, v in kw.items())
        if extras:
            msg += ": " + extras
    print(msg, file=sys.stderr, flush=True)


def stage_log(stage: str, **kw):
    _say(time.perf_counter() - _T0, stage, kw)


class Records(list):
    """A ``log=`` callable that keeps each record, in order, as a dict of
    ``t`` (seconds since this module was imported, as ``stage_log``
    prints it), ``stage`` and the record's JSON-able fields; with
    ``echo`` it also prints each one as ``stage_log`` does."""

    def __init__(self, echo=False):
        super().__init__()
        self.echo = echo

    def __call__(self, stage: str, **kw):
        t = time.perf_counter() - _T0
        self.append({"t": round(t, 3), "stage": stage, **_fields(kw)})
        if self.echo:
            _say(t, stage, kw)


def span_summary(spans):
    """{name: [count, seconds]} of a ``spans`` list, in first-seen order."""
    out = defaultdict(lambda: [0, 0.0])
    for s in spans:
        out[s["name"]][0] += 1
        out[s["name"]][1] += s["seconds"]
    return {k: [n, round(sec, 6)] for k, (n, sec) in out.items()}


def _jsonable(v):
    try:
        json.dumps(v)
        return True
    except TypeError:
        return False


def silent_log(stage: str, **kw):
    pass


# True inside ``profiler_ranges``
_RANGES = [False]


@contextlib.contextmanager
def profiler_ranges():
    """Inside the block, a span opened with ``profile`` (the default) also
    opens a ``torch.profiler.record_function`` of its name while a
    profiler runs, so that the trace shows it on its own timeline: the
    traces of ``make_ics(profile_dir=)`` and ``python -m
    toycluster_tpu_torch.trace``.  Any other profiler sees no span: with
    the ranges on under the benchmark's CUDA profiler, the WVT loop's
    traced timings moved on an H100 (PERF.md)."""
    prev, _RANGES[0] = _RANGES[0], True
    try:
        yield
    finally:
        _RANGES[0] = prev


class Spans:
    """The spans of one stage, in the order they opened: each a dict of
    ``name``, ``parent`` (the index of the enclosing open span in the same
    list, -1 for a root), ``t0`` (``time.perf_counter`` at its start),
    ``seconds`` and the caller's fields (``it``, ``attempt``, ``halo``,
    ``kind``).  ``take`` hands the list to the record that closes the
    stage.  A span costs two clock reads and an append, and a profiler
    range inside ``profiler_ranges``."""

    def __init__(self):
        self.spans = []
        self._open = []   # (index, record_function or None), innermost last

    def open(self, name, profile=True, **fields):
        """Open span ``name`` inside the innermost open one; returns its
        dict (``close`` sets its ``seconds``)."""
        rng = None
        if profile and _RANGES[0] and torch.autograd._profiler_enabled():
            rng = torch.profiler.record_function(name)
            rng.__enter__()
        rec = {"name": name,
               "parent": self._open[-1][0] if self._open else -1, **fields}
        self._open.append((len(self.spans), rng))
        self.spans.append(rec)
        rec["t0"] = time.perf_counter()
        return rec

    def close(self, rec):
        """Close ``rec``, the innermost open span; returns its seconds."""
        t = time.perf_counter()
        i, rng = self._open.pop()
        if self.spans[i] is not rec:
            raise RuntimeError(f"span {rec['name']} closed inside "
                               f"{self.spans[i]['name']}")
        rec["seconds"] = t - rec["t0"]
        if rng is not None:
            rng.__exit__(None, None, None)
        return rec["seconds"]

    @contextlib.contextmanager
    def span(self, name, profile=True, **fields):
        """``open`` ... ``close`` around a block; yields the span's dict."""
        rec = self.open(name, profile, **fields)
        try:
            yield rec
        finally:
            self.close(rec)

    def take(self):
        """The spans so far (every one closed), and an empty list after."""
        if self._open:
            names = [self.spans[i]["name"] for i, _ in self._open]
            raise RuntimeError(f"spans still open: {names}")
        out, self.spans = self.spans, []
        return out


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
