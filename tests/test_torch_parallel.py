"""The port's sharded WVT iteration, loop and make_ics(mesh=)
(toycluster_tpu_torch/parallel/) against the JAX package's
(toycluster_tpu/parallel/) on the CPU.

The JAX side runs on the conftest's 8 virtual CPU devices (a mesh of 4),
the port in 1 or 4 gloo CPU ranks started by ``parallel.mesh.spawn``;
both take the same NumPy gas positions of the repository's par at ntotal
6144, M4 (tests/test_multichip.py:22-31).  Tolerances: the port against
JAX those of the kernels against their Pallas counterparts
(tests/test_torch_stream_wvt.py, tests/test_torch_class_pair.py: h and
rho rtol 2e-3, the displacement rtol 2e-4 / atol 1e-6 max|delta|); world
size 1 against 4 JAX's own 1-vs-8 tolerances (tests/test_multichip.py:
rho and hsml rtol 2e-4, positions rtol 1e-4 / atol 1e-2); ring against
gather bit for bit.  The loop and make_ics(mesh=) are in
tests/test_torch_parallel_loop.py, the stages in
tests/test_torch_parallel_stages.py; the ranks' bodies in
tests/torch_parallel_ranks.py."""

import time

import numpy as np
import pytest
import torch

from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.from_reference import halo_arrays_from_numpy
from toycluster_tpu_torch.parallel import mesh as tmesh
from toycluster_tpu_torch.parallel import wvt_shard
from toycluster_tpu_torch.pipeline import make_ics
from torch_parallel_ranks import (MAX_CAND, OVER, PAR, STEP, jax_scene,
                                  rank_raises, rank_steps, spawn)


@pytest.fixture(scope="module")
def scene():
    return jax_scene()


@pytest.fixture(scope="module")
def port(scene):
    """{world size: rank 0's results}; the overflow case at 4 only."""
    return {4: spawn(rank_steps, 4, scene[4], ("ring", "gather", "xla",
                                               "overflow"))[0],
            1: spawn(rank_steps, 1, scene[4], ("ring", "gather", "xla"))[0]}


@pytest.fixture(scope="module")
def jax_steps(scene):
    """The JAX sharded step at mesh 4 on the stream engine (Pallas
    interpreter, ring halo) and the XLA engine."""
    import jax.numpy as jnp
    from toycluster_tpu.parallel import wvt_shard as jws
    from toycluster_tpu.parallel.mesh import make_mesh
    cfg, sc, ha, parts, _ = scene
    mesh = make_mesh(4)
    pos, n_real = jws.pad_for_mesh(parts.pos[:parts.n_gas], 4)
    pos = jws.shard_array(mesh, pos)
    hsml = jws.shard_array(mesh, jnp.zeros((pos.shape[0],), jnp.float32))
    out = {}
    for engine in ("stream_interpret", "xla"):
        fn = jws.sharded_wvt_iteration(
            mesh, ha, n_real=n_real, boxsize=sc.boxsize,
            mpart=sc.mpart_gas, desnngb=cfg.desnngb, kernel=cfg.sph_kernel,
            max_cand=MAX_CAND, engine=engine)
        r = fn(pos, hsml, STEP)
        out[engine] = {k: np.asarray(v)[:n_real] if np.ndim(v)
                       else np.asarray(v) for k, v in r._asdict().items()}
    return out


# ----------------------------------------------------------------- tests

def _disp(new, old, box):
    d = new - old
    return d - box * np.round(d / box)


@pytest.mark.parametrize("mode,jax_engine", [
    ("ring", "stream_interpret"), ("gather", "stream_interpret"),
    ("xla", "xla")])
def test_step_at_four_ranks_matches_jax_mesh(scene, port, jax_steps, mode,
                                             jax_engine):
    """(a) One sharded step at world size 4 against the JAX sharded step
    at mesh 4: rho and hsml rtol 2e-3 on >= 98% of the gas, the
    displacement rtol 2e-4 / atol 1e-6 max|delta|, err_mean and err_max
    rel 1e-3, no overflow."""
    data = scene[4]
    got, ref = port[4][mode], jax_steps[jax_engine]
    assert int(got["cand_overflow"]) <= 0
    for k in ("rho", "hsml"):
        ok = np.isclose(got[k], ref[k], rtol=2e-3)
        assert ok.mean() >= 0.98, f"{k}: {(~ok).sum()} lanes off"
    box = data["kw"]["boxsize"]
    a = _disp(ref["pos"], data["pos"], box)
    b = _disp(got["pos"], data["pos"], box)
    assert np.abs(a).max() > 0
    np.testing.assert_allclose(b, a, rtol=2e-4, atol=1e-6 * np.abs(a).max())
    for k in ("err_mean", "err_max"):
        assert float(got[k]) == pytest.approx(float(ref[k]), rel=1e-3)


@pytest.mark.parametrize("mode", ["ring", "gather", "xla"])
def test_one_rank_matches_four(port, mode):
    """(b) World size 1 against 4 at JAX's 1-vs-8 tolerances."""
    a, b = port[1][mode], port[4][mode]
    np.testing.assert_allclose(a["rho"], b["rho"], rtol=2e-4)
    np.testing.assert_allclose(a["hsml"], b["hsml"], rtol=2e-4)
    np.testing.assert_allclose(a["pos"], b["pos"], rtol=1e-4, atol=1e-2)
    for k in ("err_mean", "err_max"):
        assert float(a[k]) == pytest.approx(float(b[k]), rel=1e-3)


@pytest.mark.parametrize("world_size", [1, 4])
def test_ring_halo_matches_gather_bitwise(port, world_size):
    """(c) The ring exchange hands the kernel the same sources as the
    gather, relocated through the boundary buffer's slots: bit-equal."""
    a, b = port[world_size]["gather"], port[world_size]["ring"]
    for k in ("pos", "rho", "hsml", "rho_model"):
        np.testing.assert_array_equal(a[k], b[k])
    assert int(a["cand_overflow"]) <= 0 and int(b["cand_overflow"]) <= 0


def test_ring_overflow_is_reported(port):
    """(d) A one-superblock boundary buffer cannot hold what the other
    ranks' receivers need: the step reports the overflow, and the loop
    raises on it rather than run on without those sources."""
    assert int(port[4]["overflow"]["cand_overflow"]) > 0
    assert "boundary buffer of 1 superblocks" in port[4]["loop_overflow"]


def test_error_paths(scene):
    """(i) Unpadded input and halo='ring' with xla raise; the loop's
    input and make_ics's device off the mesh's device raise; make_mesh
    without a process group raises; a rank that raises fails the spawn
    well within its timeout; spawn on cuda raises without a card."""
    data = scene[4]
    mesh = tmesh.Mesh(None, 0, 4, "cpu", "gloo")
    ha = halo_arrays_from_numpy(data["ha"])
    with pytest.raises(ValueError, match="ring"):
        wvt_shard.sharded_wvt_iteration(mesh, ha, n_real=8, engine="xla",
                                        halo="ring", **data["kw"])
    eng = wvt_shard.sharded_wvt_iteration(mesh, ha, n_real=1000,
                                          engine="stream", **data["kw"])
    with pytest.raises(ValueError, match="pad_for_mesh"):
        eng(torch.zeros((1000, 3)), torch.zeros((1000,)), STEP)
    meta = tmesh.Mesh(None, 0, 4, "meta", "gloo")
    with pytest.raises(ValueError, match="lies on cpu"):
        wvt_shard.regularise_sharded(meta, ha, torch.zeros((1000, 3)),
                                     **data["kw"])
    with pytest.raises(ValueError, match="rank device meta"):
        make_ics(parse_par_file(PAR, **OVER), device="cpu", mesh=meta)
    with pytest.raises(RuntimeError, match="process group"):
        tmesh.make_mesh()
    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank 1 fails"):
        tmesh.spawn(rank_raises, 2, backend="gloo", device="cpu",
                    timeout_s=120)
    assert time.monotonic() - t0 < 60
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tmesh.spawn(rank_raises, 2, backend="gloo")
