"""WVT checkpoint/resume of the port against the JAX package's
(``toycluster_tpu/models/wvt.py``: load :726-733, save :1083-1090), on
the CPU from the same start as tests/test_torch_wvt.py: the JAX
make_positions at ntotal = 3000, M4 kernel, the JAX loop on the Pallas
stream kernel in interpret mode.  Bounds of tests/test_torch_wvt.py:
err_mean rtol 2e-2, periodic position difference < 2e-3 box
(pid-matched)."""

import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.models import positions as jpos
from toycluster_tpu.models import wvt as jwvt
from toycluster_tpu.ops import pallas_pair
from toycluster_tpu.particles import halo_arrays_from_scene
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.from_reference import (halo_arrays_from_numpy,
                                                 particles_from_numpy)
from toycluster_tpu_torch.models import wvt as twvt
from toycluster_tpu_torch.pipeline import make_ics
from toycluster_tpu_torch.scene import build_scene

torch.set_num_threads(2)

PAR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "toycluster_tpu_torch", "data", "cluster.par")
OVER = dict(ntotal=3000, sph_kernel="m4")
KEYS = ["err_diff_last", "err_last", "it", "pos_gas", "step"]


@pytest.fixture(scope="module")
def start():
    """The JAX start (pids 1..n_gas on the gas, so states match by
    particle) and both packages' scenes by wvt_max_iter."""
    jscene = jax_build_scene(jax_parse(PAR, **OVER))
    ha = halo_arrays_from_scene(jscene)
    parts = jpos.make_positions(jax.random.PRNGKey(5), jscene, ha)
    parts = jpos.shift_origin(parts, ha, jscene.boxsize)
    n_gas = parts.n_gas
    parts = parts._replace(pid=parts.pid.at[:n_gas].set(
        np.arange(1, n_gas + 1, dtype=np.uint32)))
    tparts = particles_from_numpy(
        {k: np.asarray(v) for k, v in parts._asdict().items()})
    tha = halo_arrays_from_numpy(
        {k: np.asarray(v) for k, v in ha._asdict().items()})

    def jax_scene(m):
        return jax_build_scene(jax_parse(PAR, wvt_max_iter=m, **OVER))

    def port_scene(m):
        return build_scene(parse_par_file(PAR, wvt_max_iter=m, **OVER))
    return jax_scene, port_scene, ha, parts, tha, tparts


@pytest.fixture
def pallas_engine(monkeypatch):
    monkeypatch.setenv("TOYCLUSTER_ENGINE", "pallas")
    monkeypatch.setattr(
        pallas_pair, "stream_wvt_pallas",
        partial(pallas_pair.stream_wvt_pallas, interpret=True))


def _recorder(logs):
    def log(stage, **kw):
        logs.append((stage, kw))
    return log


def _errs(logs):
    return [kw["err_mean"] for stage, kw in logs if stage == "wvt"]


def _resumed(logs):
    return [kw for stage, kw in logs if stage == "wvt_resume"]


def _by_pid(pid, pos):
    return np.asarray(pos)[np.argsort(np.asarray(pid))]


def _periodic_max(a, b, box):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, box - d).max()


def test_checkpoints_cross_between_packages(start, pallas_engine, tmp_path):
    """Each package writes the other's file format at it = 1, and each
    resumes from the other's file at it = 2 to the same trajectory."""
    jax_scene, port_scene, ha, parts, tha, tparts = start
    fj, ft = str(tmp_path / "jax_ck"), str(tmp_path / "port_ck")
    jwvt.regularise_sph_particles(jax_scene(2), ha, parts,
                                  log=lambda *a, **k: None,
                                  checkpoint_path=fj, checkpoint_every=2)
    twvt.regularise_sph_particles(port_scene(2), tha, tparts,
                                  log=lambda *a, **k: None,
                                  checkpoint_path=ft, checkpoint_every=2)
    box = port_scene(2).boxsize
    with np.load(fj) as cj, np.load(ft) as ct:
        assert sorted(cj.files) == sorted(ct.files) == KEYS
        for k in KEYS:
            assert cj[k].dtype == ct[k].dtype and cj[k].shape == ct[k].shape
        assert ct["pos_gas"].dtype == np.float32
        assert ct["pos_gas"].shape == (parts.n_gas, 3)
        assert int(cj["it"]) == int(ct["it"]) == 1
        # the JAX loop carries the step as a float32 on the device
        step_j, step_t = float(cj["step"]), float(ct["step"])
        assert np.float32(step_j) == np.float32(step_t)
        # both files are in the original order, the start's pid order
        assert _periodic_max(cj["pos_gas"], ct["pos_gas"], box) < 2e-3 * box

    logs_t, logs_j = [], []
    got, _ = twvt.regularise_sph_particles(port_scene(4), tha, tparts,
                                           log=_recorder(logs_t),
                                           checkpoint_path=fj,
                                           checkpoint_every=2)
    ref = jwvt.regularise_sph_particles(jax_scene(4), ha, parts,
                                        log=_recorder(logs_j),
                                        checkpoint_path=ft,
                                        checkpoint_every=2)
    assert _resumed(logs_t) == [dict(it=2, step=step_j)]
    assert _resumed(logs_j) == [dict(it=2, step=step_t)]
    errs_t, errs_j = _errs(logs_t), _errs(logs_j)
    assert len(errs_t) == len(errs_j) == 3
    np.testing.assert_allclose(errs_t, errs_j, rtol=2e-2)
    n = ref.n_gas
    pt = _by_pid(got.pid[:n].numpy(), got.pos[:n].numpy())
    pj = _by_pid(ref.pid[:n], ref.pos[:n])
    assert _periodic_max(pt, pj, box) < 2e-3 * box


def test_checkpoint_is_in_the_original_order(start, tmp_path):
    """The loop sorts the gas at its first build; the file holds the
    positions at the saved iteration scattered back to the original
    order, so position p of the file is the particle of pid p + 1."""
    _, port_scene, _, _, tha, tparts = start
    ck = str(tmp_path / "ck")
    got, _ = twvt.regularise_sph_particles(port_scene(1), tha, tparts,
                                           log=lambda *a, **k: None,
                                           checkpoint_path=ck,
                                           checkpoint_every=2)
    n = got.n_gas
    pid = got.pid[:n].numpy().astype(np.int64)
    assert not np.array_equal(pid, np.arange(1, n + 1))  # it was sorted
    with np.load(ck) as f:
        assert int(f["it"]) == 1
        np.testing.assert_array_equal(f["pos_gas"][pid - 1],
                                      got.pos[:n].numpy())


def test_classed_engine_resumes(start, tmp_path):
    _, port_scene, _, _, tha, tparts = start
    ck = str(tmp_path / "ck")
    twvt.regularise_sph_particles(port_scene(2), tha, tparts,
                                  log=lambda *a, **k: None, engine="classed",
                                  checkpoint_path=ck, checkpoint_every=2)
    with np.load(ck) as f:
        step = float(f["step"])
    logs = []
    got, _ = twvt.regularise_sph_particles(port_scene(4), tha, tparts,
                                           log=_recorder(logs),
                                           engine="classed",
                                           checkpoint_path=ck,
                                           checkpoint_every=2)
    assert _resumed(logs) == [dict(it=2, step=step)]
    assert len(_errs(logs)) == 3
    for k in ("pos", "rho", "hsml"):
        assert bool(torch.isfinite(getattr(got, k)).all()), k


def test_make_ics_resumes_from_its_checkpoint(tmp_path, monkeypatch):
    """make_ics(wvt_checkpoint=p) writes the file; a second call with the
    same path resumes from it."""
    monkeypatch.setattr(twvt, "regularise_sph_particles",
                        partial(twvt.regularise_sph_particles,
                                checkpoint_every=2))
    ck = str(tmp_path / "ck")
    cfg = parse_par_file(PAR, ntotal=3000, sph_kernel="m4", wvt_max_iter=2)
    make_ics(cfg, device="cpu", write=False, log=lambda *a, **k: None,
             wvt_checkpoint=ck)
    with np.load(ck) as f:
        assert int(f["it"]) == 1
    logs = []
    make_ics(cfg.replace(wvt_max_iter=3), device="cpu", write=False,
             log=_recorder(logs), wvt_checkpoint=ck)
    assert [kw["it"] for kw in _resumed(logs)] == [2]
    assert len(_errs(logs)) == 2


def test_checkpoint_of_another_scene_raises(start, tmp_path):
    _, port_scene, _, _, tha, tparts = start
    ck = str(tmp_path / "ck")
    np.savez(ck + ".npz", pos_gas=np.zeros((7, 3), np.float32), step=0.1,
             err_last=1.0, err_diff_last=1.0, it=1)
    with pytest.raises(ValueError, match="pos_gas of shape"):
        twvt.regularise_sph_particles(port_scene(2), tha, tparts,
                                      log=lambda *a, **k: None,
                                      checkpoint_path=ck + ".npz")


def test_sharded_checkpoints_cross_between_packages(tmp_path):
    """The sharded loop's file (toycluster_tpu/parallel/wvt_shard.py:
    load :524-536, save :600-606): the JAX package's regularise_sharded
    on a mesh of 2 and the port's on 2 gloo ranks each write it at it = 1
    with the same keys, and each resumes from the other's at it = 2 with
    the saved step, on trajectories within err_mean rtol 2e-2 and 2e-3
    box of each other."""
    from toycluster_tpu.parallel import wvt_shard as jws
    from toycluster_tpu.parallel.mesh import make_mesh
    from torch_parallel_ranks import MAX_CAND, STEP, jax_scene, rank_loop
    from torch_parallel_ranks import spawn as spawn_ranks
    cfg, sc, ha, parts, data = jax_scene()
    fj, ft = str(tmp_path / "jax_ck.npz"), str(tmp_path / "port_ck.npz")

    def jax_loop(max_iter, ck):
        logs = []
        pos, _, _ = jws.regularise_sharded(
            make_mesh(2), ha, parts.pos[:parts.n_gas], boxsize=sc.boxsize,
            mpart=sc.mpart_gas, desnngb=cfg.desnngb, kernel=cfg.sph_kernel,
            max_cand=MAX_CAND, step=STEP, max_iter=max_iter,
            log=_recorder(logs), checkpoint_path=ck, checkpoint_every=2)
        return np.asarray(pos), logs

    def port_loop(max_iter, ck):
        pos, _, _, logs = spawn_ranks(rank_loop, 2, data, max_iter, ck, 2)[0]
        return pos, logs

    jax_loop(1, fj)
    port_loop(1, ft)
    with np.load(fj) as cj, np.load(ft) as ct:
        keys = ["err_diff_last", "err_last", "hsml", "it", "pos", "rhom",
                "step"]
        assert sorted(cj.files) == sorted(ct.files) == keys
        for k in keys:
            assert cj[k].dtype == ct[k].dtype and cj[k].shape == ct[k].shape
        assert int(cj["it"]) == int(ct["it"]) == 1
        step_j, step_t = float(cj["step"]), float(ct["step"])
        assert np.float32(step_j) == np.float32(step_t)
        assert _periodic_max(cj["pos"], ct["pos"], sc.boxsize) \
            < 2e-3 * sc.boxsize
    pos_t, logs_t = port_loop(3, fj)
    pos_j, logs_j = jax_loop(3, ft)

    def resumed(logs):
        return [(kw["it"], kw["step"]) for s, kw in logs
                if s == "wvt_shard_resume"]

    def errs(logs):
        return [kw["err_mean"] for s, kw in logs if s == "wvt_shard"]

    assert resumed(logs_t) == [(2, step_j)]
    assert resumed(logs_j) == [(2, step_t)]
    assert len(errs(logs_t)) == len(errs(logs_j)) == 2
    np.testing.assert_allclose(errs(logs_t), errs(logs_j), rtol=2e-2)
    assert _periodic_max(pos_t, pos_j, sc.boxsize) < 2e-3 * sc.boxsize
