"""The port's pipeline on a two-cluster scene (the port's cluster.par with
mass_ratio = 0.3125: a 1e15 Msun host and a 3.1e14 Msun companion on a
merger orbit) against the JAX package's make_ics on the same
configuration: ntotal = 4000, M4 kernel, the B field on.  Samplers draw
from other generators, so the outputs are held by distribution, per halo
and particle type: membership counts after the gas reassignment, centres
of mass, mean velocities (the merger's bulk velocities) and the DM speed
distribution (two-sample KS, p > 1e-3).  The snapshot is read by the JAX
package's reader."""

import os
from functools import partial

import numpy as np
import pytest
import torch
from scipy import stats

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.io.gadget import read_snapshot
from toycluster_tpu.ops import pallas_pair
from toycluster_tpu.pipeline import make_ics as jax_make_ics
from toycluster_tpu.utils.logging import silent_log
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.pipeline import make_ics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(REPO, "toycluster_tpu_torch", "data", "cluster.par")
OVER = dict(ntotal=4000, wvt_max_iter=3, sph_kernel="m4", mass_ratio=0.3125)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ics") / "ic_two_halo")
    scene, parts = make_ics(parse_par_file(PAR, output_file=out, **OVER),
                            device="cpu", log=silent_log)
    # the JAX side on its stream engine, Pallas in interpret mode
    mp = pytest.MonkeyPatch()
    mp.setenv("TOYCLUSTER_ENGINE", "pallas")
    mp.setattr(pallas_pair, "stream_wvt_pallas",
               partial(pallas_pair.stream_wvt_pallas, interpret=True))
    try:
        _, jparts = jax_make_ics(jax_parse(PAR, **OVER), write=False,
                                 log=silent_log)
    finally:
        mp.undo()
    port = {k: getattr(parts, k).numpy() for k in ("pos", "vel", "halo")}
    ref = {k: np.asarray(getattr(jparts, k)) for k in ("pos", "vel", "halo")}
    return scene, port, ref, read_snapshot(out)


def _groups(scene, d):
    """(halo, type) -> boolean mask over all particles."""
    n_gas = scene.npart_gas
    is_gas = np.arange(scene.ntotal) < n_gas
    return {(k, t): (d["halo"] == k) & (is_gas if t == "gas" else ~is_gas)
            for k in range(scene.nhalos) for t in ("gas", "dm")}


def test_scene_has_two_halos_on_an_orbit(runs):
    scene, *_ = runs
    assert scene.nhalos == 2
    assert scene.npart_gas == scene.npart_dm == 2000
    assert scene.vel_merger[0] > 0 > scene.vel_merger[1]


def test_membership_counts_match_jax(runs):
    """Particles per halo and type agree within 5 sigma of the binomial
    noise of two independent samples."""
    scene, port, ref, _ = runs
    g_t, g_j = _groups(scene, port), _groups(scene, ref)
    for key in g_t:
        n_all = scene.npart_gas if key[1] == "gas" else scene.npart_dm
        n_t, n_j = int(g_t[key].sum()), int(g_j[key].sum())
        p = n_j / n_all
        assert n_j > 0
        assert abs(n_t - n_j) < 5 * np.sqrt(2 * n_all * p * (1 - p)) + 1, \
            (key, n_t, n_j)


@pytest.mark.parametrize("field", ["pos", "vel"])
def test_per_halo_means_match_jax(runs, field):
    """Centres of mass and mean velocities per halo and type agree within
    5 standard errors of the difference of two sample means (and 1e-3 of
    the mean, for the gas velocities, which only carry the bulk
    velocity)."""
    scene, port, ref, _ = runs
    g_t, g_j = _groups(scene, port), _groups(scene, ref)
    for key in g_t:
        a, b = port[field][g_t[key]], ref[field][g_j[key]]
        m_a, m_b = a.mean(axis=0), b.mean(axis=0)
        se = np.sqrt(a.var(axis=0) / len(a) + b.var(axis=0) / len(b))
        assert (np.abs(m_a - m_b) <= 5 * se + 1e-3 * np.abs(m_b)).all(), \
            (key, field, m_a, m_b)


def test_dm_speeds_per_halo_match_jax(runs):
    scene, port, ref, _ = runs
    g_t, g_j = _groups(scene, port), _groups(scene, ref)
    for k in range(scene.nhalos):
        v_t = np.linalg.norm(port["vel"][g_t[k, "dm"]], axis=1)
        v_j = np.linalg.norm(ref["vel"][g_j[k, "dm"]], axis=1)
        assert stats.ks_2samp(v_t, v_j).pvalue > 1e-3, k


def test_snapshot_read_by_jax_reader(runs):
    scene, port, _, snap = runs
    assert snap["header"].npart[:2] == [scene.npart_gas, scene.npart_dm]
    np.testing.assert_array_equal(snap["pos"], port["pos"])
    for k in ("pos", "vel", "u", "rho", "hsml", "bfld", "rho_model"):
        assert np.isfinite(snap[k]).all(), k
    assert (snap["rho"] > 0).all() and (snap["u"] > 0).all()
    assert (np.linalg.norm(snap["bfld"], axis=1) > 0).mean() > 0.99
