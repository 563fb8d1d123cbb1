"""The port's sharded stages (toycluster_tpu_torch/parallel/stages.py) and
its counter-based generator (utils/counter_rng.py) on the CPU.

The port runs in 1 and 4 gloo CPU ranks (``parallel.mesh.spawn``), the
JAX package's stages on a mesh of 4 of the conftest's virtual CPU
devices, on the scene of tests/test_torch_parallel.py.  The pair stages
are held world size 1 against 4 at the JAX package's 1-vs-8 tolerances
(tests/test_multichip.py: the density rtol 2e-4, the curl rtol 3e-4 /
atol 1e-8) and against JAX at the kernels' (h and rho rtol 2e-3; the
curl rtol 5e-4 / atol 2e-5 max|B|, tests/test_torch_class_pair.py).  The
elementwise stages and the samplers are bit-equal at 1 and 4 ranks; the
samplers draw other numbers than JAX's and are held to JAX's sharded
samplers by distribution (two-sample KS, p > 0.01, and means within 5
standard errors)."""

import numpy as np
import pytest
import torch
from scipy import stats

from toycluster_tpu_torch.utils.counter_rng import threefry2x32, uniforms
from torch_parallel_ranks import (MAX_CAND, N_SAMPLE, SAMPLE_KEY, SPEED_KEY,
                                  apot_of, jax_scene, rank_stages, spawn)

ELEMENTWISE = ("speeds", "velocities", "gas_bulk", "temperature",
               "sample_gas", "sample_dm")


@pytest.fixture(scope="module")
def scene():
    """The scene, the JAX sharded density at mesh 4 (the curl's inputs
    on both sides) and the rest of the ranks' inputs."""
    import jax.numpy as jnp
    from toycluster_tpu.parallel import stages as jst
    from toycluster_tpu.parallel.mesh import make_mesh
    cfg, sc, ha, parts, data = jax_scene()
    n_gas = parts.n_gas
    dens = jst.sharded_density(
        make_mesh(4), ha, parts.pos[:n_gas], boxsize=sc.boxsize,
        mpart=sc.mpart_gas, desnngb=cfg.desnngb, kernel=cfg.sph_kernel,
        max_cand=MAX_CAND)
    rho, hsml, vf, wk = (np.asarray(x) for x in dens)
    r_dm = jnp.linalg.norm(parts.pos[n_gas:] - (ha.d_com[0] + sc.boxhalf),
                           axis=-1)
    data = dict(data, rho=rho, hsml=hsml, vf=vf, wk=wk,
                r_dm=np.asarray(r_dm), gas_halo=np.asarray(parts.halo[:n_gas]))
    return cfg, sc, ha, parts, data


@pytest.fixture(scope="module")
def port(scene):
    return {ws: spawn(rank_stages, ws, scene[4])[0] for ws in (4, 1)}


@pytest.fixture(scope="module")
def jax_samples(scene):
    """JAX's sharded samplers at mesh 4: halo 0's gas and DM positions
    and its DM speeds."""
    import jax
    from toycluster_tpu.models import velocities as jvel
    from toycluster_tpu.parallel import stages as jst
    from toycluster_tpu.parallel.mesh import make_mesh
    cfg, sc, ha, parts, data = scene
    mesh = make_mesh(4)
    kw = dict(boxsize=sc.boxsize, key=jax.random.PRNGKey(SAMPLE_KEY),
              sub_first=sc.sub_first, cool_core=None)
    out = {f"sample_{k}": np.asarray(jst.sharded_halo_sample(
        mesh, ha, 0, N_SAMPLE, k, **kw)) for k in ("gas", "dm")}
    out["speeds"] = np.asarray(jst.sharded_dm_speeds(
        mesh, jvel.build_velocity_tables(sc, 0), data["r_dm"],
        key=jax.random.PRNGKey(SPEED_KEY)))
    return out


def test_density_one_rank_matches_four_and_jax(scene, port):
    """(f) sharded_density: rho, hsml, var_fac and wk at 1 against 4
    ranks rtol 2e-4; rho and hsml against JAX's rtol 2e-3 on >= 98% of
    the gas; the solve hits the neighbour window."""
    cfg, data = scene[0], scene[4]
    for a, b in zip(port[1]["density"], port[4]["density"]):
        np.testing.assert_allclose(a, b, rtol=2e-4)
    rho, hsml, _, wk = port[4]["density"]
    for got, ref in ((rho, data["rho"]), (hsml, data["hsml"])):
        assert np.isclose(got, ref, rtol=2e-3).mean() >= 0.98
    assert np.median(np.abs(wk - cfg.desnngb)) < 1.0


def test_curl_one_rank_matches_four_and_jax(scene, port):
    """(f) sharded_curl on JAX's solved density: B at 1 against 4 ranks
    rtol 3e-4 / atol 1e-8 and bmax rtol 3e-4; B against JAX's sharded
    curl rtol 5e-4 / atol 2e-5 max|B|."""
    from toycluster_tpu.parallel import stages as jst
    from toycluster_tpu.parallel.mesh import make_mesh
    import jax.numpy as jnp
    cfg, sc, _, parts, data = scene
    (b1, m1), (b4, m4) = port[1]["curl"], port[4]["curl"]
    np.testing.assert_allclose(b1, b4, rtol=3e-4, atol=1e-8)
    np.testing.assert_allclose(float(m1), float(m4), rtol=3e-4)
    assert float(m4) > 0
    apot = apot_of(torch.as_tensor(np.array(data["pos"])),
                   sc.boxsize).numpy()
    bj, mj = jst.sharded_curl(
        make_mesh(4), jnp.asarray(data["pos"]), jnp.asarray(data["hsml"]),
        jnp.asarray(data["rho"]), jnp.asarray(data["vf"]),
        jnp.asarray(apot), boxsize=sc.boxsize, mpart=sc.mpart_gas,
        kernel=cfg.sph_kernel, max_cand=MAX_CAND)
    bj = np.asarray(bj)
    np.testing.assert_allclose(b4, bj, rtol=5e-4, atol=2e-5 * np.abs(bj).max())
    np.testing.assert_allclose(float(m4), float(mj), rtol=5e-4)


@pytest.mark.parametrize("name", ELEMENTWISE)
def test_elementwise_and_samplers_bit_equal_at_one_and_four(port, name):
    """(g) The counter-based draws and the elementwise stages do not
    depend on the world size: bit-equal."""
    np.testing.assert_array_equal(port[1][name], port[4][name])
    assert np.isfinite(port[4][name]).all()


def test_elementwise_stages_match_the_unsharded_stage(port):
    """(g) The gas bulk velocities and the temperatures equal the
    unsharded stage's functions on the same inputs, bit for bit."""
    np.testing.assert_array_equal(port[4]["gas_bulk"],
                                  port[4]["gas_bulk_single"])
    np.testing.assert_array_equal(port[4]["temperature"],
                                  port[4]["temperature_single"])
    assert (port[4]["temperature"] > 0).all()


def _same_distribution(a, b):
    d, p = stats.ks_2samp(a, b)
    assert p > 0.01, f"KS D={d:.4f} p={p:.4g}"
    se = np.sqrt(a.var() / a.size + b.var() / b.size)
    assert abs(a.mean() - b.mean()) < 5 * se


@pytest.mark.parametrize("name", ["sample_gas", "sample_dm", "speeds"])
def test_samplers_match_jax_in_distribution(scene, port, jax_samples, name):
    """(g) The port's sharded samplers against JAX's: radii (positions)
    and speeds by KS and means; the supports hold."""
    sc, ha, data = scene[1], scene[2], scene[4]
    got, ref = port[4][name], jax_samples[name]
    if name == "speeds":
        _same_distribution(got, ref)
        assert (got > 0).mean() > 0.999
        return
    r_got = np.linalg.norm(got, axis=-1)
    _same_distribution(r_got, np.linalg.norm(ref, axis=-1))
    if name == "sample_gas":
        assert (np.abs(got) <= sc.boxsize / 2 + 1e-3).all()
    else:
        assert (r_got <= float(ha.r_sample_dm[0]) * 1.001).all()


def test_dm_velocities_are_isotropic_about_the_bulk(port):
    """(g) sharded_dm_velocities: the speeds of sharded_dm_speeds (other
    key) around the bulk velocity, in isotropic directions."""
    from torch_parallel_ranks import BULK
    pec = port[4]["velocities"] - np.asarray(BULK, np.float32)
    sp = np.linalg.norm(pec, axis=-1)
    nz = sp > 0
    assert np.abs((pec[nz] / sp[nz, None]).mean(axis=0)).max() < 0.05
    _same_distribution(sp, port[4]["speeds"])


def test_counter_rng_known_answers_and_uniformity():
    """Threefry-2x32-20 against the Random123 known-answer vectors, and
    the uniforms: in [0, 1), uniform by KS, independent of the other
    lanes drawn beside them, different across streams."""
    t = lambda v: torch.tensor([v], dtype=torch.int64)  # noqa: E731
    m = 0xFFFFFFFF
    for key, ctr, want in (((0, 0), (0, 0), (0x6B200159, 0x99BA4EFE)),
                           ((m, m), (m, m), (0x1CB996FC, 0xBB002BE7)),
                           ((0x13198A2E, 0x03707344), (0x243F6A88, 0x85A308D3),
                            (0xC4923A9C, 0x483DF7A0))):
        got = threefry2x32(*key, t(ctr[0]), t(ctr[1]))
        assert tuple(int(x) for x in got) == want
    ids = torch.arange(50_000)
    u = uniforms(123, 4, ids, 3)
    assert u.dtype == torch.float32 and u.shape == (50_000, 3)
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0
    for j in range(3):
        assert stats.kstest(u[:, j].numpy(), "uniform").pvalue > 0.01
    torch.testing.assert_close(uniforms(123, 4, ids[777:1234], 3),
                               u[777:1234], rtol=0, atol=0)
    assert not torch.equal(uniforms(123, 5, ids[:64], 3), u[:64])
