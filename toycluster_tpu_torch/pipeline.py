"""End-to-end initial-conditions pipeline, the reference's ``main()``
(main.c:11-72) as a library function.

JAX counterpart: ``toycluster_tpu/pipeline.py``.  Stages (the gas stages
are skipped at zero baryon fraction, main.c:50-63):
  setup -> positions -> ids -> shift origin -> [WVT relax -> SPH density
  -> B field -> reassign -> temperatures] -> velocities -> kinematics ->
  output
with the substructure stage after the setup when ``cfg.substructure``.
On CUDA every stage ends in ``torch.cuda.synchronize()`` before it is
logged, so stage times are device times, not enqueue times.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Optional

import numpy as np
import torch

from .config import Config
from .models import ids as ids_mod
from .models import positions as pos_mod
from .particles import halo_arrays_from_scene
from .scene import build_scene
from .utils.logging import Spans, profiler_ranges, stage_log
from .utils.memory import reset_peak, stage_memory
from .utils.profiling import profiler


def _barrier(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def make_ics(cfg: Config, *, device, engine: str = "stream",
             seed: Optional[int] = None, write: bool = True, log=stage_log,
             check: bool = False, profile_dir: Optional[str] = None,
             wvt_checkpoint: Optional[str] = None, mesh=None):
    """Run the full pipeline on ``device`` with the neighbour ``engine``
    ("stream" or "classed", models/sph.py); returns (scene, particles).

    check: audit the solved SPH densities on 512 gas lanes against
      direct summation over every gas particle (``ops/brute.py``); a
      worst relative error above 5e-3 raises RuntimeError.
    profile_dir: capture a ``torch.profiler`` trace of the WVT hot loop
      (host, and the device on CUDA) as the Chrome trace
      ``profile_dir/wvt_trace.json``; the directory is made if needed.
    wvt_checkpoint: NPZ path for WVT checkpoint/resume
      (``wvt.regularise_sph_particles``; with a mesh, the sharded loop's
      file, ``parallel.wvt_shard.regularise_sharded``).
    mesh: a ``parallel.mesh.Mesh`` whose every rank calls make_ics alike
      (``device`` must then be ``mesh.device``): the WVT relaxation runs
      sharded over the ranks (``regularise_sharded``; engine "stream" is
      its stream engine with the ring halo, "classed" its xla engine)
      from rank 0's gas positions, and every rank then holds the relaxed
      positions and runs the remaining stages unsharded.  Rank 0 alone
      logs (``wvt_sharded`` with ``n_devices`` after the loop) and writes
      the snapshot.

    On CUDA the positions, sph_quantities, magnetic_field, temperatures
    and velocities records carry the allocator's ``mem_gib`` and
    ``peak_gib`` (the peak since this call began).  The velocities
    record carries the spans of the velocity tables and ``wvt_done``
    those of the WVT loop (``spans``: ``utils.logging.Spans``).
    """
    from .models.sph import check_engine
    check_engine(engine)
    device = torch.device(device)
    if (mesh is not None and device.type == "cuda"
            and device.index is None):
        device = torch.device("cuda", torch.cuda.current_device())
    if mesh is not None and device != mesh.device:
        raise ValueError(f"make_ics: device {device} is not the mesh's "
                         f"rank device {mesh.device}")
    # the ranks of a mesh but rank 0 neither log, print nor write
    talk = mesh is None or mesh.rank == 0
    if not talk:
        from .utils.logging import silent_log
        log, write = silent_log, False
    reset_peak(device)
    t0 = time.perf_counter()
    scene = build_scene(cfg)
    log("setup", scene=scene)
    if log is stage_log:  # the reference's stdout tables
        from .utils import logging as tlog
        tlog.report_units(scene.units)
        tlog.report_cosmology(scene.cosmo, cfg.redshift)
        tlog.report_halo_setup(scene)
        tlog.report_kinematics(scene)

    if cfg.substructure:
        from .models.substructure import setup_substructure
        scene = setup_substructure(scene, seed=cfg.seed + 7)
        log("substructure", nhalos=scene.nhalos,
            nsub=scene.nhalos - scene.sub_first)
        if cfg.report_subhalos and log is stage_log:
            from .utils import logging as tlog
            tlog.report_subhalos(scene)  # substructure.c:74-103

    ha = halo_arrays_from_scene(scene, device)
    gen = torch.Generator(device=device)
    gen.manual_seed(cfg.seed if seed is None else seed)

    parts = pos_mod.make_positions(gen, scene, ha)
    _barrier(device)
    log("positions", n=parts.n_total, **stage_memory(device))

    pid = ids_mod.make_ids(scene.npart_gas, scene.ntotal)
    parts = parts.replace(pid=torch.as_tensor(pid.astype("int64"),
                                              device=device))
    parts = pos_mod.shift_origin(parts, ha, scene.boxsize)
    _barrier(device)
    log("shift_origin")
    if talk:
        pos_mod.show_mass_in_r200(scene, parts, log=log)  # main.c:48

    if not scene.dm_only:
        from .models import bfield, sph, temperature, wvt
        prof, ranges = ((profiler(device), profiler_ranges()) if profile_dir
                        else (contextlib.nullcontext(),) * 2)
        # the span of the WVT loop in a trace (``trace.WVT_SPAN``)
        with prof, ranges, torch.profiler.record_function("wvt_loop"):
            if mesh is not None:
                parts = _relax_sharded(mesh, scene, ha, parts, engine, log,
                                       wvt_checkpoint)
                wvt_fresh = False
            else:
                # the holder protocol (JAX: toycluster_tpu/pipeline.py:
                # 108-116): this frame drops its reference, so that a
                # large run's loop frees the buffers it never reads
                holder = [parts]
                del parts
                parts, wvt_fresh = wvt.regularise_sph_particles(
                    scene, ha, holder, log=log, engine=engine,
                    checkpoint_path=wvt_checkpoint)
        if profile_dir:
            os.makedirs(profile_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(profile_dir,
                                                  "wvt_trace.json"))
        if wvt_fresh:
            # the loop stopped before a final move: parts already hold
            # the full-contract density solve at the final positions
            nstate = None
            sph.last_contract_frac = wvt.last_contract_frac
            log("sph_quantities", reused="wvt-final",
                contract_frac=sph.last_contract_frac,
                **stage_memory(device))
        else:
            parts, nstate = sph.find_sph_quantities(scene, ha, parts,
                                                    return_state=True,
                                                    engine=engine)
            _barrier(device)
            log("sph_quantities",
                contract_frac=sph.last_contract_frac,
                **stage_memory(device))
        if check:
            try:
                _check_density(scene, parts, log)
            except torch.cuda.OutOfMemoryError:
                # the audit is advisory: an allocator failure after the
                # relaxation must not end the run; a failed audit raises
                log("check_density", skipped="out of device memory")
        if cfg.bfld_norm:
            parts = bfield.make_magnetic_field(scene, ha, parts, nstate,
                                               engine=engine)
            _barrier(device)
            log("magnetic_field", **stage_memory(device))
        cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                     if cfg.double_beta_cool_cores else None)
        parts, _ = pos_mod.reassign_gas_to_halos(parts, ha, scene.boxsize,
                                                 cool_core)
        _barrier(device)
        log("reassign")
        if talk:
            pos_mod.show_mass_in_r200(scene, parts, log=log)  # main.c:60
        parts = temperature.make_temperatures(scene, parts)
        _barrier(device)
        log("temperatures", **stage_memory(device))

    from .models import kinematics, velocities
    spans = Spans()
    parts = velocities.make_velocities(gen, scene, ha, parts, spans=spans)
    _barrier(device)
    log("velocities", spans=spans.take(), **stage_memory(device))
    parts = kinematics.apply_kinematics(scene, parts)
    _barrier(device)
    log("kinematics")

    if write:
        from .io.gadget import write_scene_snapshot
        write_scene_snapshot(cfg.output_file, scene, parts)
        log("output", path=cfg.output_file, dt=time.perf_counter() - t0)
    return scene, parts


def _relax_sharded(mesh, scene, ha, parts, engine, log, checkpoint):
    """The WVT relaxation over ``mesh`` (JAX: toycluster_tpu/
    pipeline.py:86-108): rank 0's gas positions are broadcast first, so
    that no rank depends on bit-identical sampling; every rank returns
    with the relaxed positions and their model density."""
    from .models import sph, wvt
    from .parallel import wvt_shard
    cfg = scene.config
    n_gas = parts.n_gas
    cool_core = ((cfg.rho0_fac, cfg.rc_fac)
                 if cfg.double_beta_cool_cores else None)
    step = 0.035 if cfg.sph_kernel == "m4" else (
        0.0085 / (2.0 if scene.mtotal < 1e5 else 1.0))
    pos_gas = mesh.broadcast(parts.pos[:n_gas], src=0)
    pos_gas, _, _ = wvt_shard.regularise_sharded(
        mesh, ha, pos_gas, boxsize=scene.boxsize, mpart=scene.mpart_gas,
        desnngb=cfg.desnngb, kernel=cfg.sph_kernel, step=step,
        max_iter=min(cfg.wvt_max_iter, wvt.NUMITER),
        err_diff_limit=cfg.wvt_err_diff_limit, cool_core=cool_core,
        log=log, engine="stream" if engine == "stream" else "xla",
        checkpoint_path=checkpoint)
    rhom = sph.global_density_model(pos_gas, ha, scene.boxsize, cool_core)
    log("wvt_sharded", n_devices=mesh.size)
    return parts.replace(pos=torch.cat([pos_gas, parts.pos[n_gas:]]),
                         rho_model=rhom)


def _check_density(scene, parts, log, n_sample=512):
    """Audit the neighbour engine against direct summation on evenly
    spaced gas lanes; raises on disagreement beyond the float32 pair-sum
    tolerance."""
    from .ops.brute import density_at
    n_gas = parts.n_gas
    idx = torch.as_tensor(
        np.linspace(0, n_gas - 1, min(n_sample, n_gas)).astype(np.int64),
        device=parts.device)
    rho_direct = density_at(parts.pos[idx], parts.hsml[idx],
                            parts.pos[:n_gas], scene.mpart_gas,
                            scene.boxsize, kernel=scene.config.sph_kernel,
                            desnngb=scene.config.desnngb)
    rel = torch.abs(rho_direct - parts.rho[idx]) / parts.rho[idx]
    worst = float(rel.max())
    log("check_density", n=len(idx), worst_rel_err=round(worst, 6))
    if worst > 5e-3:
        raise RuntimeError(
            f"density check failed: worst rel err {worst:.2e}")
