"""Shared pieces of tests/test_torch_parallel*.py: the scene, the spawn
helper and the bodies that the spawned ranks run.  The ranks import this
module to find their bodies, so it imports no JAX at its top."""

import os

import numpy as np
import torch

from toycluster_tpu_torch.parallel import mesh as tmesh
from toycluster_tpu_torch.parallel import stages, wvt_shard

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(REPO, "toycluster_tpu_torch", "data", "cluster.par")
OVER = dict(ntotal=6144, sph_kernel="m4")
STEP = 0.035
MAX_CAND = 64
# (engine, halo, max_remote_sb) of each sharded step
MODES = {"ring": ("stream", "ring", None), "gather": ("stream", "gather", None),
         "xla": ("xla", "auto", None), "overflow": ("stream", "ring", 1)}
TIMEOUT = 240
# the counter-based samplers' keys and sizes (tests/test_multichip.py)
SPEED_KEY, VEL_KEY, SAMPLE_KEY, N_SAMPLE = 11, 13, 21, 4096
BULK = (120.0, -40.0, 7.0)


def spawn(fn, world_size, *args):
    return tmesh.spawn(fn, world_size, backend="gloo", device="cpu",
                       timeout_s=TIMEOUT, args=args)


def np_of(x):
    return x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def jax_scene():
    """The JAX scene, halo arrays and particles of the repository's par
    at OVER (PRNGKey(3), as tests/test_multichip.py), and the gas as
    NumPy for the ranks."""
    import jax
    from toycluster_tpu import parse_par_file
    from toycluster_tpu.models import positions as pos_mod
    from toycluster_tpu.particles import halo_arrays_from_scene
    from toycluster_tpu.scene import build_scene
    cfg = parse_par_file(PAR).replace(**OVER)
    sc = build_scene(cfg)
    ha = halo_arrays_from_scene(sc)
    parts = pos_mod.shift_origin(
        pos_mod.make_positions(jax.random.PRNGKey(3), sc, ha), ha,
        sc.boxsize)
    data = dict(pos=np.asarray(parts.pos[:parts.n_gas]),
                ha={k: np.asarray(v) for k, v in ha._asdict().items()},
                kw=dict(boxsize=float(sc.boxsize), mpart=float(sc.mpart_gas),
                        desnngb=cfg.desnngb, kernel=cfg.sph_kernel))
    return cfg, sc, ha, parts, data


def port_scene(ntotal):
    """The repository's par at OVER and ``ntotal``, gas positions drawn
    by the port from seed 3, as the NumPy data the ranks take (no JAX:
    the card machine has none)."""
    import dataclasses
    from toycluster_tpu_torch.config import parse_par_file
    from toycluster_tpu_torch.models import positions as tpos
    from toycluster_tpu_torch.particles import halo_arrays_from_scene
    from toycluster_tpu_torch.scene import build_scene
    cfg = parse_par_file(PAR, **dict(OVER, ntotal=ntotal))
    sc = build_scene(cfg)
    ha = halo_arrays_from_scene(sc, "cpu")
    gen = torch.Generator().manual_seed(3)
    parts = tpos.shift_origin(tpos.make_positions(gen, sc, ha), ha,
                              sc.boxsize)
    return dict(pos=parts.pos[:parts.n_gas].numpy(),
                ha={f.name: getattr(ha, f.name).numpy()
                    for f in dataclasses.fields(ha)},
                kw=dict(boxsize=float(sc.boxsize), mpart=float(sc.mpart_gas),
                        desnngb=cfg.desnngb, kernel=cfg.sph_kernel))


def _ha(mesh, data):
    from toycluster_tpu_torch.from_reference import halo_arrays_from_numpy
    return halo_arrays_from_numpy(data["ha"], mesh.device)


def rank_steps(mesh, data, modes, max_cand=MAX_CAND):
    """One sharded step in each of ``modes``; rank 0's results."""
    ha = _ha(mesh, data)
    pos, n_real = wvt_shard.pad_for_mesh(
        torch.as_tensor(data["pos"], device=mesh.device), mesh.size)
    hsml = torch.zeros((pos.shape[0],), device=mesh.device)
    res = {}
    for name in modes:
        engine, halo, msb = MODES[name]
        eng = wvt_shard.sharded_wvt_iteration(
            mesh, ha, n_real=n_real, max_cand=max_cand, engine=engine,
            halo=halo, max_remote_sb=msb, **data["kw"])
        out = eng(pos, hsml, STEP)
        res[name] = {k: np_of(v[:n_real] if v.dim() else v)
                     for k, v in out._asdict().items()}
    if "overflow" in modes:
        # the loop on the same one-superblock buffer raises at it = 0
        try:
            wvt_shard.regularise_sharded(
                mesh, ha, pos[:n_real], max_cand=max_cand, step=STEP,
                max_iter=0, engine="stream", halo="ring", max_remote_sb=1,
                **data["kw"])
        except RuntimeError as exc:
            res["loop_overflow"] = str(exc)
    from toycluster_tpu_torch.ops import class_pair, stream_pair
    res["launches"] = {f.__name__: f.launches for f in (
        stream_pair.stream_wvt, class_pair.solve_density,
        class_pair.wvt_displacement)}
    return res if mesh.rank == 0 else None


def rank_loop(mesh, data, max_iter, checkpoint=None, checkpoint_every=8):
    """regularise_sharded on the default engine with the collectives
    timed; rank 0's (pos, rho, hsml, stage records)."""
    logs = []
    mesh.timing = True
    pos, rho, hsml = wvt_shard.regularise_sharded(
        mesh, _ha(mesh, data), torch.as_tensor(data["pos"]),
        max_cand=MAX_CAND, step=STEP, max_iter=max_iter,
        log=lambda s, **kw: logs.append((s, kw)), checkpoint_path=checkpoint,
        checkpoint_every=checkpoint_every, **data["kw"])
    return (np_of(pos), np_of(rho), np_of(hsml), logs) \
        if mesh.rank == 0 else None


def rank_make_ics(mesh, out_file):
    """make_ics(mesh=) at OVER with 4 WVT iterations: each rank's
    (stage records, gas count)."""
    from toycluster_tpu_torch.config import parse_par_file
    from toycluster_tpu_torch.pipeline import make_ics
    logs = []
    cfg = parse_par_file(PAR, wvt_max_iter=4, output_file=out_file, **OVER)
    _, parts = make_ics(cfg, device="cpu", mesh=mesh,
                        log=lambda s, **kw: logs.append((s, kw)))
    return logs, parts.n_gas


def rank_raises(mesh):
    if mesh.rank == 1:
        raise KeyError("rank 1 fails")
    # rank 0 waits in a collective that rank 1 never joins
    return mesh.psum(torch.ones(()))


def rank_stages(mesh, data):
    """Every stage of parallel/stages.py on the scene; rank 0's
    results.  ``data`` adds to the gas: the solved rho, hsml, var_fac
    (the curl's inputs), the DM radii about halo 0 and the gas halo
    ids."""
    from toycluster_tpu_torch.config import parse_par_file
    from toycluster_tpu_torch.models import temperature as ttemp
    from toycluster_tpu_torch.models import velocities as tvel
    from toycluster_tpu_torch.scene import build_scene
    dev = mesh.device
    ha = _ha(mesh, data)
    kw = data["kw"]
    pos = torch.as_tensor(data["pos"])
    t = {k: torch.as_tensor(data[k]) for k in ("rho", "hsml", "vf", "r_dm",
                                                "gas_halo")}
    sc = build_scene(parse_par_file(PAR, **OVER))
    res = {}
    res["density"] = stages.sharded_density(
        mesh, ha, pos, boxsize=kw["boxsize"], mpart=kw["mpart"],
        desnngb=kw["desnngb"], kernel=kw["kernel"], max_cand=MAX_CAND)
    res["curl"] = stages.sharded_curl(
        mesh, pos, t["hsml"], t["rho"], t["vf"], apot_of(pos, kw["boxsize"]),
        boxsize=kw["boxsize"], mpart=kw["mpart"], kernel=kw["kernel"],
        max_cand=MAX_CAND)
    vt = tvel.build_velocity_tables(sc, 0, dev)
    res["speeds"] = stages.sharded_dm_speeds(mesh, vt, t["r_dm"],
                                             key=SPEED_KEY)
    res["velocities"] = stages.sharded_dm_velocities(
        mesh, vt, t["r_dm"], key=VEL_KEY, bulk_vel=BULK)
    bulk_stack = torch.as_tensor(
        np.stack([h.bulk_vel for h in sc.halos]) + 55.0, dtype=torch.float32)
    sub_hh = torch.as_tensor([h.r_sample_gas * 1.1 for h in sc.halos],
                             dtype=torch.float32)
    d_com = torch.as_tensor(np.stack([h.d_com for h in sc.halos]),
                            dtype=torch.float32)
    bulk_args = (pos, t["gas_halo"], bulk_stack, ha.d_com, sub_hh,
                 sc.sub_first, sc.boxhalf)
    res["gas_bulk"] = stages.sharded_gas_bulk(
        mesh, *bulk_args[:5], sub_first=sc.sub_first, n_halos=sc.nhalos,
        boxhalf=sc.boxhalf)
    res["gas_bulk_single"] = tvel.gas_bulk_velocities(*bulk_args)
    tables = ttemp.build_energy_tables_stacked(sc, dev)
    res["temperature"] = stages.sharded_temperature(
        mesh, tables, d_com, pos, t["gas_halo"], boxhalf=sc.boxhalf)
    res["temperature_single"] = ttemp.temperature_eval(
        tables, d_com, sc.boxhalf, pos, t["gas_halo"])
    for kind in ("gas", "dm"):
        res[f"sample_{kind}"] = stages.sharded_halo_sample(
            mesh, ha, 0, N_SAMPLE, kind, boxsize=kw["boxsize"],
            key=SAMPLE_KEY, sub_first=sc.sub_first, cool_core=None)
    res = {k: (tuple(np_of(x) for x in v) if isinstance(v, tuple)
               else np_of(v)) for k, v in res.items()}
    return res if mesh.rank == 0 else None


def apot_of(pos, box):
    """A smooth synthetic vector potential (tests/test_multichip.py)."""
    return torch.stack([torch.sin(pos[:, 0] / box * 6.0),
                        torch.cos(pos[:, 1] / box * 6.0), pos[:, 2] / box],
                       dim=1)


def rank_loop_width(mesh, data, max_cand, engine, max_iter):
    """regularise_sharded from the first list width ``max_cand`` on
    ``engine``; rank 0's (pos, rho, hsml, stage records)."""
    logs = []
    pos, rho, hsml = wvt_shard.regularise_sharded(
        mesh, _ha(mesh, data), torch.as_tensor(data["pos"]),
        max_cand=max_cand, step=STEP, max_iter=max_iter, engine=engine,
        log=lambda s, **kw: logs.append((s, kw)), **data["kw"])
    return (np_of(pos), np_of(rho), np_of(hsml), logs) \
        if mesh.rank == 0 else None
