"""The port's sharded relaxation loop and make_ics(mesh=)
(toycluster_tpu_torch/parallel/wvt_shard.py, pipeline.py) on the CPU, in
gloo CPU ranks started by ``parallel.mesh.spawn``, on the scene of
tests/test_torch_parallel.py (the repository's par at ntotal 6144, M4,
the JAX package's gas positions).  The bounds are those of the JAX
package's tests/test_multichip.py."""

import os

import numpy as np

from torch_parallel_ranks import (jax_scene, rank_loop, rank_make_ics,
                                  spawn)


def test_regularise_sharded_converges():
    """(e) The four-rank loop (default engine: xla on the CPU) drives
    err_mean down (wvt_relax.c:91-92), and its final solve meets the
    neighbour contract: the median |(4pi/3) h^3 rho / m / DESNNGB - 1| <
    0.05 and the contract fraction of the last iteration >= 0.99; with
    ``Mesh.timing`` set rank 0 logs its collectives every iteration."""
    cfg, sc, _, _, data = jax_scene()
    pos, rho, hsml, logs = spawn(rank_loop, 4, data, 8)[0]
    errs = [kw["err_mean"] for s, kw in logs if s == "wvt_shard"]
    assert len(errs) >= 5
    assert errs[-1] < 0.7 * errs[0]
    assert np.isfinite(pos).all() and pos.shape == data["pos"].shape
    ngb = 4.0 * np.pi / 3.0 * hsml ** 3 * rho / sc.mpart_gas
    assert np.median(np.abs(ngb / cfg.desnngb - 1.0)) < 0.05
    done = [kw for s, kw in logs if s == "wvt_shard_done"]
    assert done[0]["contract_frac"] >= 0.99
    assert done[0]["iterations"] == len(errs)
    assert all(kw["overflow"] <= 0 for s, kw in logs
               if s in ("wvt_shard_build", "wvt_shard"))
    # rank 0's collectives, timed on the host (no device off the card):
    # the metric volume, the statistics, the maxima and at builds the
    # gathers of the block metadata and of the state
    comm = [kw for s, kw in logs if s == "wvt_shard_comm"]
    assert len(comm) == len(errs)
    assert all(kw["collectives"] >= 3 and kw["host_s"] > 0
               and kw["device_ms"] is None for kw in comm)


def test_make_ics_on_two_ranks_writes_one_snapshot(tmp_path):
    """(h) make_ics(mesh=) at world size 2: the WVT stage sharded (the
    stream engine with the ring halo), rank 0 alone logs and writes, and
    the JAX reader reads the snapshot."""
    from toycluster_tpu.io.gadget import read_snapshot
    out = str(tmp_path / "mesh_ics")
    (logs0, n_gas), (logs1, _) = spawn(rank_make_ics, 2, out)
    stages = [s for s, _ in logs0]
    assert logs1 == []
    assert [kw for s, kw in logs0 if s == "wvt_sharded"] == [
        {"n_devices": 2}]
    assert "wvt_shard_ring" in stages and "output" in stages
    assert os.listdir(tmp_path) == ["mesh_ics"]
    snap = read_snapshot(out)
    assert snap["header"].npart[0] == n_gas
    for k in ("pos", "vel", "rho", "hsml", "u", "bfld"):
        assert np.isfinite(snap[k]).all()
    assert (snap["rho"][:n_gas] > 0).all() and (snap["u"][:n_gas] > 0).all()


def test_narrow_lists_grow_where_jax_truncates():
    """The JAX package's sharded build truncates rows past its static
    list width and only reports it (toycluster_tpu/parallel/
    wvt_shard.py:108, :121); the port builds such rows again at the width
    they need.  From a first width of 8 blocks (xla engine, four ranks /
    a mesh of 4) JAX reports overflow at its builds and the port none,
    and the port's loop stays on JAX's loop from a width that fits (64):
    err_mean rtol 2e-2, positions within 2e-3 box (tests/test_torch_wvt.py
    bounds)."""
    from toycluster_tpu.parallel import wvt_shard as jws
    from toycluster_tpu.parallel.mesh import make_mesh
    from torch_parallel_ranks import STEP, rank_loop_width
    cfg, sc, ha, parts, data = jax_scene()

    def jax_loop(max_cand):
        logs = []
        pos, _, _ = jws.regularise_sharded(
            make_mesh(4), ha, parts.pos[:parts.n_gas], boxsize=sc.boxsize,
            mpart=sc.mpart_gas, desnngb=cfg.desnngb, kernel=cfg.sph_kernel,
            max_cand=max_cand, step=STEP, max_iter=3, engine="xla",
            log=lambda s, **kw: logs.append((s, kw)))
        return np.asarray(pos), logs

    def builds(logs):
        return [kw["overflow"] for s, kw in logs if s == "wvt_shard_build"]

    def errs(logs):
        return [kw["err_mean"] for s, kw in logs if s == "wvt_shard"]

    _, logs_j8 = jax_loop(8)
    pos_j, logs_j = jax_loop(64)
    pos_t, _, _, logs_t = spawn(rank_loop_width, 4, data, 8, "xla", 3)[0]
    assert max(builds(logs_j8)) > 0
    assert max(builds(logs_j)) <= 0 and max(builds(logs_t)) <= 0
    np.testing.assert_allclose(errs(logs_t), errs(logs_j), rtol=2e-2)
    d = np.abs(pos_t - pos_j)
    assert np.minimum(d, sc.boxsize - d).max() < 2e-3 * sc.boxsize
