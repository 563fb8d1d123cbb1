"""The port's whole pipeline (make_ics on the CPU) against the JAX
package's make_ics on the same configuration: ntotal = 4000, M4 kernel,
the B field on.  Samplers draw from other generators, so the outputs are
held by distribution: the R200 mass census, the gas density against its
model, u(r) against the JAX tables and the analytic profile, and the DM
speed distribution (two-sample KS, p > 1e-3).  The snapshot is read by
the JAX package's reader, and the port's writer reproduces the compiled
reference writer's bytes."""

import os
from functools import partial

import numpy as np
import pytest
import torch
from scipy import stats

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.io.gadget import read_snapshot
from toycluster_tpu.models.temperature import (build_energy_tables_stacked,
                                               internal_energy_analytic)
from toycluster_tpu.ops import pallas_pair
from toycluster_tpu.ops.interp import batched_spline_eval
from toycluster_tpu.pipeline import make_ics as jax_make_ics
from toycluster_tpu.utils.logging import silent_log
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.io.gadget import GadgetHeader, write_snapshot
from toycluster_tpu_torch.models import positions as tpos
from toycluster_tpu_torch.pipeline import make_ics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(REPO, "toycluster_tpu_torch", "data", "cluster.par")
OVER = dict(ntotal=4000, wvt_max_iter=3, sph_kernel="m4")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ics") / "ic_port")
    cfg = parse_par_file(PAR, output_file=out, **OVER)
    census = []
    orig = tpos.show_mass_in_r200

    def spy(scene, parts, log=None):
        census.append(orig(scene, parts, log=log))
        return census[-1]

    mp = pytest.MonkeyPatch()
    mp.setattr(tpos, "show_mass_in_r200", spy)
    try:
        scene, parts = make_ics(cfg, device="cpu", log=silent_log)
    finally:
        mp.undo()
    # the JAX side on its stream engine, Pallas in interpret mode
    mp = pytest.MonkeyPatch()
    mp.setenv("TOYCLUSTER_ENGINE", "pallas")
    mp.setattr(pallas_pair, "stream_wvt_pallas",
               partial(pallas_pair.stream_wvt_pallas, interpret=True))
    try:
        jscene, jparts = jax_make_ics(jax_parse(PAR, **OVER), write=False,
                                      log=silent_log)
    finally:
        mp.undo()
    return scene, parts, read_snapshot(out), jscene, jparts, census


def test_snapshot_read_by_jax_reader(runs):
    scene, parts, snap, *_ = runs
    hdr = snap["header"]
    assert hdr.npart[:2] == [scene.npart_gas, scene.npart_dm]
    assert snap["pos"].shape == (scene.ntotal, 3)
    for k in ("pos", "vel", "u", "rho", "hsml", "bfld", "rho_model"):
        assert np.isfinite(snap[k]).all(), k
    assert (snap["rho"] > 0).all() and (snap["hsml"] > 0).all()
    assert (snap["u"] > 0).all()
    assert set(snap["ids"].tolist()) == set(range(1, scene.ntotal + 1))
    np.testing.assert_array_equal(snap["pos"], parts.pos.numpy())
    b = np.linalg.norm(snap["bfld"], axis=1)
    assert b.max() == pytest.approx(scene.config.bfld_norm / np.sqrt(3),
                                    rel=1e-3)
    rho = snap["rho"]
    assert (b[rho > np.percentile(rho, 90)].mean()
            > 3 * b[rho < np.percentile(rho, 10)].mean())


def test_mass_census_matches_jax_by_distribution(runs):
    """Gas/DM particles inside R200 after sampling and after the
    relaxation: counts agree within 5 sigma of the binomial noise of
    two independent samples."""
    scene, parts, _, jscene, jparts, census = runs
    from toycluster_tpu.models.positions import show_mass_in_r200
    assert len(census) == 2
    j_after = show_mass_in_r200(jscene, jparts)[0]
    msph = scene.mpart_gas * scene.units.mass / 1.98892e33
    mdm = scene.mpart_dm * scene.units.mass / 1.98892e33
    for rec in census:
        t = rec[0]
        for key, m, n_all in (("gas_mass_r200", msph, scene.npart_gas),
                              ("dm_mass_r200", mdm, scene.npart_dm)):
            n_t, n_j = t[key] / m, j_after[key] / m
            p = n_j / n_all
            sigma = np.sqrt(2 * n_all * p * (1 - p))
            assert abs(n_t - n_j) < 5 * sigma, (key, n_t, n_j)


def test_gas_density_tracks_model_like_jax(runs):
    scene, parts, _, jscene, jparts, _ = runs
    rel_t = np.abs(parts.rho.numpy() - parts.rho_model.numpy()) \
        / parts.rho_model.numpy()
    rel_j = np.abs(np.asarray(jparts.rho) - np.asarray(jparts.rho_model)) \
        / np.asarray(jparts.rho_model)
    assert abs(np.median(rel_t) - np.median(rel_j)) < 0.03
    assert np.median(rel_t) < 0.3
    # radial profile of the SPH density against the model: per radial
    # quintile of the JAX gas, port vs JAX
    n_gas = scene.npart_gas
    r_j = np.linalg.norm(np.asarray(jparts.pos)[:n_gas] - scene.boxhalf,
                         axis=1)
    bins = np.quantile(r_j, np.linspace(0.0, 1.0, 6))
    bins[-1] = np.inf

    def profile(pos, rho, rho_model):
        r = np.linalg.norm(pos[:n_gas] - scene.boxhalf, axis=1)
        idx = np.digitize(r, bins)
        assert min((idx == k).sum() for k in range(1, len(bins))) >= 200
        return np.array([np.median((rho / rho_model)[idx == k])
                         for k in range(1, len(bins))])

    p_t = profile(parts.pos.numpy(), parts.rho.numpy(),
                  parts.rho_model.numpy())
    p_j = profile(np.asarray(jparts.pos), np.asarray(jparts.rho),
                  np.asarray(jparts.rho_model))
    np.testing.assert_allclose(p_t, p_j, atol=0.1)


def test_temperatures_match_jax_tables_and_analytic(runs):
    scene, parts, _, jscene, _, _ = runs
    n_gas = scene.npart_gas
    pos = parts.pos[:n_gas].numpy()
    halo = parts.halo[:n_gas].numpy()
    assert (halo == 0).all()
    r = np.linalg.norm(pos - scene.boxhalf, axis=1)
    tables = build_energy_tables_stacked(jscene)
    u_j = np.asarray(batched_spline_eval(tables, np.zeros(n_gas, np.int32),
                                         r.astype(np.float32)))
    np.testing.assert_allclose(parts.u.numpy(), u_j, rtol=1e-4)
    h = scene.halos[0]
    sel = (r > 0.02 * h.r200) & (r < 0.8 * h.r200)
    u_ana = internal_energy_analytic(scene, 0, r[sel])
    rel = np.abs(parts.u.numpy()[sel] - u_ana) / u_ana
    assert np.median(rel) < 0.25   # the rcut taper, as in the JAX test


def test_dm_speeds_match_jax_distribution(runs):
    scene, parts, _, _, jparts, _ = runs
    n_gas = scene.npart_gas
    v_t = np.linalg.norm(parts.vel[n_gas:].numpy(), axis=1)
    v_j = np.linalg.norm(np.asarray(jparts.vel)[n_gas:], axis=1)
    assert stats.ks_2samp(v_t, v_j).pvalue > 1e-3
    # gas carries the (zero) bulk velocity of the single halo
    assert np.abs(parts.vel[:n_gas].numpy()).max() == 0.0


def _golden_particles(n_gas, n_dm):
    """The synthetic particles of tests/golden/gen_golden.c."""
    i = np.arange(n_gas + n_dm, dtype=np.float64)
    d = np.arange(3, dtype=np.float64)
    g = np.arange(n_gas, dtype=np.float64)
    return dict(
        pos=((i[:, None] * 8 + d) * 0.5).astype(np.float32),
        vel=((i[:, None] * 4 + d) * 0.25 - 3.0).astype(np.float32),
        ids=(np.arange(n_gas + n_dm) + 1000).astype(np.uint32),
        u=(g * 1.5).astype(np.float32),
        rho=(g * 0.75 + 0.5).astype(np.float32),
        hsml=(g * 2.0 + 1.0).astype(np.float32),
        bfld=((g[:, None] * 4 + d) * 0.125 - 1.0).astype(np.float32),
        rho_model=(g * 0.375).astype(np.float32))


@pytest.mark.parametrize("golden,n_gas,n_dm,m_gas", [
    ("golden_mixed.bin", 7, 9, 0.25),
    ("golden_dmonly.bin", 0, 9, 0.0),
])
def test_writer_matches_reference_bytes(tmp_path, golden, n_gas, n_dm,
                                        m_gas):
    d = {k: torch.from_numpy(v.astype(np.int64) if k == "ids" else v)
         for k, v in _golden_particles(n_gas, n_dm).items()}
    header = GadgetHeader(npart=[n_gas, n_dm, 0, 0, 0, 0],
                          mass=[m_gas, 0.5, 0, 0, 0, 0], boxsize=6400.0,
                          hubble_param=0.7)
    p = str(tmp_path / "snap")
    write_snapshot(p, header=header, **d)
    ref = os.path.join(REPO, "tests", "golden", golden)
    assert open(p, "rb").read() == open(ref, "rb").read()
