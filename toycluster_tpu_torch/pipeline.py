"""End-to-end initial-conditions pipeline, the reference's ``main()``
(main.c:11-72) as a library function.

JAX counterpart: ``toycluster_tpu/pipeline.py``.  Stages (the gas stages
are skipped at zero baryon fraction, main.c:50-63):
  setup -> positions -> ids -> shift origin -> [WVT relax -> SPH density
  -> B field -> reassign -> temperatures] -> velocities -> kinematics ->
  output
On CUDA every stage ends in ``torch.cuda.synchronize()`` before it is
logged, so stage times are device times, not enqueue times.
"""

from __future__ import annotations

import time
from typing import Optional

import torch

from .config import Config
from .models import ids as ids_mod
from .models import positions as pos_mod
from .particles import halo_arrays_from_scene
from .scene import build_scene
from .utils.logging import stage_log


def _barrier(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_ics(cfg: Config, *, device, seed: Optional[int] = None,
             write: bool = True, log=stage_log):
    """Run the full pipeline on ``device``; returns (scene, particles)."""
    device = torch.device(device)
    if cfg.substructure:
        raise NotImplementedError(
            "substructure is not ported yet (the next port slice, after "
            "the stream feeders; see ROADMAP.md)")
    t0 = time.perf_counter()
    scene = build_scene(cfg)
    log("setup", scene=scene)
    if log is stage_log:  # the reference's stdout tables
        from .utils import logging as tlog
        tlog.report_units(scene.units)
        tlog.report_cosmology(scene.cosmo, cfg.redshift)
        tlog.report_halo_setup(scene)
        tlog.report_kinematics(scene)

    ha = halo_arrays_from_scene(scene, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed if seed is None else seed)

    parts = pos_mod.make_positions(gen, scene, ha)
    _barrier(device)
    log("positions", n=parts.n_total)

    pid = ids_mod.make_ids(scene.npart_gas, scene.ntotal)
    parts = parts.replace(pid=torch.as_tensor(pid.astype("int64"),
                                              device=device))
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    _barrier(device)
    log("shift_origin")
    pos_mod.show_mass_in_r200(scene, parts, log=log)  # main.c:48

    if not scene.dm_only:
        from .models import bfield, sph, temperature, wvt
        parts, wvt_fresh = wvt.regularise_sph_particles(scene, ha, parts,
                                                        log=log)
        if wvt_fresh:
            # the loop stopped before a final move: parts already hold
            # the full-contract density solve at the final positions
            nstate = None
            sph.last_contract_frac = wvt.last_contract_frac
            log("sph_quantities", reused="wvt-final",
                contract_frac=sph.last_contract_frac)
        else:
            parts, nstate = sph.find_sph_quantities(scene, ha, parts,
                                                    return_state=True)
            _barrier(device)
            log("sph_quantities",
                contract_frac=sph.last_contract_frac)
        if cfg.bfld_norm:
            parts = bfield.make_magnetic_field(scene, ha, parts, nstate)
            _barrier(device)
            log("magnetic_field")
        cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                     if cfg.double_beta_cool_cores else None)
        parts, _ = pos_mod.reassign_gas_to_halos(parts, ha, scene.boxsize,
                                                 cool_core)
        _barrier(device)
        log("reassign")
        pos_mod.show_mass_in_r200(scene, parts, log=log)  # main.c:60
        parts = temperature.make_temperatures(scene, parts)
        _barrier(device)
        log("temperatures")

    from .models import kinematics, velocities
    parts = velocities.make_velocities(gen, scene, ha, parts)
    _barrier(device)
    log("velocities")
    parts = kinematics.apply_kinematics(scene, parts)
    _barrier(device)
    log("kinematics")

    if write:
        from .io.gadget import write_scene_snapshot
        write_scene_snapshot(cfg.output_file, scene, parts)
        log("output", path=cfg.output_file, dt=time.perf_counter() - t0)
    return scene, parts
