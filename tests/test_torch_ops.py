"""The port's SPH kernels (ops/kernels.py) and spline evaluation
(ops/interp.py) against the JAX package's on the same inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.ops import interp as jinterp
from toycluster_tpu.ops import kernels as jkern
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu.models.temperature import \
    build_energy_tables_stacked as jax_energy_tables
from toycluster_tpu_torch.ops import interp as tinterp
from toycluster_tpu_torch.ops import kernels as tkern
from toycluster_tpu_torch.models.temperature import \
    build_energy_tables_stacked as torch_energy_tables
from test_torch_setup import PAR

torch.set_num_threads(2)


@pytest.mark.parametrize("name", ["wc6", "wc6_deriv", "m4", "m4_deriv",
                                  "wc2"])
def test_kernel_values_match_jax(name):
    rng = np.random.default_rng(1)
    r = (rng.random(4096) * 1.3).astype(np.float32)   # beyond the support
    h = (0.5 + rng.random(4096)).astype(np.float32)
    a = np.asarray(getattr(jkern, name)(jnp.asarray(r), jnp.asarray(h)))
    b = getattr(tkern, name)(torch.from_numpy(r), torch.from_numpy(h))
    np.testing.assert_allclose(b.numpy(), a, rtol=2e-6,
                               atol=1e-7 * np.abs(a).max())
    assert (b.numpy()[r >= h] == 0).all()


@pytest.mark.parametrize("name", ["wc6_flat", "m4_flat"])
def test_flat_kernels_match_jax(name):
    u = np.linspace(0.0, 1.2, 2001, dtype=np.float32)
    a = np.asarray(getattr(jkern, name)(jnp.asarray(u)))
    b = getattr(tkern, name)(torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(b, a, rtol=2e-6, atol=1e-7 * np.abs(a).max())


def test_kernel_fns_pick_the_same_triplet():
    for kind in ("wc6", "m4"):
        assert [f.__name__ for f in tkern.kernel_fns(kind)] == \
            [f.__name__ for f in jkern.kernel_fns(kind)]


def test_spline_evaluation_matches_jax():
    """spline_eval on a halo's inverse mass table and batched_spline_eval
    on the stacked u(r) tables, at the same query points."""
    scene = jax_build_scene(jax_parse(PAR, ntotal=20000))
    sp = scene.halos[0].mass_table.inv_spline
    jt = jinterp.SplineTable.from_host(sp)
    tt = tinterp.SplineTable(*(torch.as_tensor(np.asarray(a),
                                               dtype=torch.float32)
                               for a in (sp.x, sp.y, sp.m2)))
    q = np.linspace(0.0, float(sp.x[-1]) * 1.05, 5000, dtype=np.float32)
    np.testing.assert_allclose(
        tinterp.spline_eval(tt, torch.from_numpy(q)).numpy(),
        np.asarray(jinterp.spline_eval(jt, jnp.asarray(q))), rtol=1e-5)

    jtab = jax_energy_tables(scene)
    ttab = torch_energy_tables(scene, "cpu")
    for a, b in zip(jtab, ttab):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    r = np.geomspace(0.5, scene.boxsize, 3000).astype(np.float32)
    hid = np.zeros(r.shape, np.int32)
    np.testing.assert_allclose(
        tinterp.batched_spline_eval(ttab, torch.from_numpy(hid),
                                    torch.from_numpy(r)).numpy(),
        np.asarray(jinterp.batched_spline_eval(jtab, jnp.asarray(hid),
                                               jnp.asarray(r))),
        rtol=1e-5)
