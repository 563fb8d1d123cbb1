"""The port's make_ics on flag variants of the port's cluster.par against
the JAX package's make_ics on the same Config, on the CPU.

DM-only (Bfld and gas stages skipped at zero baryon fraction, main.c:50):
one halo and a two-halo comet merger at 10,000 particles, held by the
snapshot header, the sequential ids and the DM speeds per halo (KS).

One two-halo gas scene with every gas-model flag away from its default:
double-beta cool cores (Cuspy 3; the Config's Rho0_Fac 50, Rc_Fac 40, set
with ``Config.replace`` as the par lacks their tags), the parabola orbit,
beta = 2/3, NO_RCUT_IN_T off and the M4 kernel, at 4,000 particles (the B
field on), compared as tests/test_torch_two_halo.py compares: membership
counts, per-halo means, the DM speeds, the temperatures against the JAX
package's u(r) tables at the port's gas positions, and a snapshot that
the JAX package's reader reads.  The same scene at Bfld_Norm 0 skips the
B-field stage in both packages."""

import os
from functools import partial

import numpy as np
import pytest
import torch
from scipy import stats

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.io.gadget import read_snapshot
from toycluster_tpu.models.temperature import build_energy_tables_stacked
from toycluster_tpu.ops import pallas_pair
from toycluster_tpu.ops.interp import batched_spline_eval
from toycluster_tpu.pipeline import make_ics as jax_make_ics
from toycluster_tpu.utils.logging import silent_log
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.pipeline import make_ics

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(REPO, "toycluster_tpu_torch", "data", "cluster.par")
DM_ONLY = {"one_halo": dict(ntotal=10_000, baryon_fraction=0.0),
           "comet": dict(ntotal=10_000, baryon_fraction=0.0, mass_ratio=0.5,
                         orbit="comet")}
GAS = dict(ntotal=4000, wvt_max_iter=3, sph_kernel="m4", mass_ratio=0.5,
           cuspy=3, orbit="parabola", beta=2.0 / 3.0, no_rcut_in_t=False)
GAS_REPLACE = dict(double_beta_cool_cores=True)


def _groups(scene, halo):
    """(halo, type) -> boolean mask over all particles."""
    is_gas = np.arange(scene.ntotal) < scene.npart_gas
    return {(k, t): (halo == k) & (is_gas if t == "gas" else ~is_gas)
            for k in range(scene.nhalos) for t in ("gas", "dm")
            if (t == "dm" or scene.npart_gas)}


# ------------------------------------------------------------- DM only

@pytest.fixture(scope="module", params=sorted(DM_ONLY))
def dm_runs(request, tmp_path_factory):
    over = DM_ONLY[request.param]
    out = str(tmp_path_factory.mktemp("dm") / "ic_dm")
    scene, parts = make_ics(parse_par_file(PAR, output_file=out, **over),
                            device="cpu", log=silent_log)
    _, jparts = jax_make_ics(jax_parse(PAR, **over), write=False,
                             log=silent_log)
    port = {k: getattr(parts, k).numpy() for k in ("pos", "vel", "halo")}
    ref = {k: np.asarray(getattr(jparts, k)) for k in ("pos", "vel", "halo")}
    return request.param, scene, port, ref, read_snapshot(out)


def test_dm_only_snapshot_header_and_ids(dm_runs):
    name, scene, port, _, snap = dm_runs
    hdr = snap["header"]
    assert scene.dm_only and scene.npart_gas == 0
    assert hdr.npart[:2] == [0, scene.npart_dm] == [0, scene.ntotal]
    assert hdr.mass[0] == 0.0
    assert hdr.mass[1] == pytest.approx(scene.mpart_dm, rel=1e-12)
    assert hdr.boxsize == scene.boxsize
    assert hdr.redshift == 0 and hdr.time == 0
    np.testing.assert_array_equal(
        snap["ids"], np.arange(1, scene.npart_dm + 1, dtype=np.uint32))
    for k in ("u", "rho", "hsml", "bfld", "rho_model"):
        assert snap[k].shape[0] == 0, k
    pos = snap["pos"]
    np.testing.assert_array_equal(pos, port["pos"])
    assert pos.min() >= 0 and pos.max() <= scene.boxsize
    v = np.linalg.norm(snap["vel"], axis=1)
    assert np.isfinite(v).all() and (v > 0).mean() > 0.99
    assert scene.nhalos == (2 if name == "comet" else 1)


def test_dm_only_speeds_per_halo_match_jax(dm_runs):
    """Per halo: the DM counts equal (the sampler fills each halo's
    budget) and the speeds, the merger's bulk velocities included, agree
    by KS, p > 1e-3."""
    _, scene, port, ref, _ = dm_runs
    g_t, g_j = _groups(scene, port["halo"]), _groups(scene, ref["halo"])
    for k in range(scene.nhalos):
        assert g_t[k, "dm"].sum() == g_j[k, "dm"].sum() > 0
        v_t = np.linalg.norm(port["vel"][g_t[k, "dm"]], axis=1)
        v_j = np.linalg.norm(ref["vel"][g_j[k, "dm"]], axis=1)
        assert stats.ks_2samp(v_t, v_j).pvalue > 1e-3, k
        assert stats.ks_2samp(port["vel"][g_t[k, "dm"], 0],
                              ref["vel"][g_j[k, "dm"], 0]).pvalue > 1e-3, k


# ------------------------------------------------- the flagged gas scene

@pytest.fixture(scope="module")
def gas_runs(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("ics") / "ic_flags")
    cfg = parse_par_file(PAR, output_file=out, **GAS).replace(**GAS_REPLACE)
    scene, parts = make_ics(cfg, device="cpu", log=silent_log)
    # the JAX side on its stream engine, Pallas in interpret mode
    mp = pytest.MonkeyPatch()
    mp.setenv("TOYCLUSTER_ENGINE", "pallas")
    mp.setattr(pallas_pair, "stream_wvt_pallas",
               partial(pallas_pair.stream_wvt_pallas, interpret=True))
    try:
        jscene, jparts = jax_make_ics(
            jax_parse(PAR, **GAS).replace(**GAS_REPLACE), write=False,
            log=silent_log)
    finally:
        mp.undo()
    keys = ("pos", "vel", "halo", "u")
    port = {k: getattr(parts, k).numpy() for k in keys}
    ref = {k: np.asarray(getattr(jparts, k)) for k in keys}
    return scene, jscene, port, ref, read_snapshot(out)


def test_gas_scene_flags(gas_runs):
    scene, *_ = gas_runs
    cfg = scene.config
    assert (cfg.double_beta_cool_cores, cfg.orbit, cfg.sph_kernel,
            cfg.no_rcut_in_t, cfg.beta) == (True, "parabola", "m4", False,
                                            2.0 / 3.0)
    assert scene.nhalos == 2 and all(h.have_cuspy for h in scene.halos)
    assert scene.vel_merger[0] > 0 > scene.vel_merger[1]


def test_gas_scene_membership_counts_match_jax(gas_runs):
    """Particles per halo and type after the gas reassignment agree within
    5 sigma of the binomial noise of two independent samples."""
    scene, _, port, ref, _ = gas_runs
    g_t, g_j = _groups(scene, port["halo"]), _groups(scene, ref["halo"])
    for key in g_t:
        n_all = scene.npart_gas if key[1] == "gas" else scene.npart_dm
        n_t, n_j = int(g_t[key].sum()), int(g_j[key].sum())
        p = n_j / n_all
        assert n_j > 0
        assert abs(n_t - n_j) < 5 * np.sqrt(2 * n_all * p * (1 - p)) + 1, \
            (key, n_t, n_j)


@pytest.mark.parametrize("field", ["pos", "vel"])
def test_gas_scene_per_halo_means_match_jax(gas_runs, field):
    """Centres of mass and mean velocities (the parabola's stamped bulk
    velocities) per halo and type within 5 standard errors of the
    difference of two sample means."""
    scene, _, port, ref, _ = gas_runs
    g_t, g_j = _groups(scene, port["halo"]), _groups(scene, ref["halo"])
    for key in g_t:
        a, b = port[field][g_t[key]], ref[field][g_j[key]]
        m_a, m_b = a.mean(axis=0), b.mean(axis=0)
        se = np.sqrt(a.var(axis=0) / len(a) + b.var(axis=0) / len(b))
        assert (np.abs(m_a - m_b) <= 5 * se + 1e-3 * np.abs(m_b)).all(), \
            (key, field, m_a, m_b)


def test_gas_scene_dm_speeds_match_jax(gas_runs):
    scene, _, port, ref, _ = gas_runs
    g_t, g_j = _groups(scene, port["halo"]), _groups(scene, ref["halo"])
    for k in range(scene.nhalos):
        v_t = np.linalg.norm(port["vel"][g_t[k, "dm"]], axis=1)
        v_j = np.linalg.norm(ref["vel"][g_j[k, "dm"]], axis=1)
        assert stats.ks_2samp(v_t, v_j).pvalue > 1e-3, k


def test_gas_scene_temperatures_match_jax_tables(gas_runs):
    """The port's u at its own gas positions against the JAX package's
    u(r) tables of the same scene (cool cores, beta 2/3, NO_RCUT_IN_T
    off), rtol 1e-4 as in tests/test_torch_pipeline.py."""
    scene, jscene, port, _, _ = gas_runs
    n_gas = scene.npart_gas
    halo = port["halo"][:n_gas]
    inside = halo >= 0
    assert inside.mean() > 0.99
    d_com = np.array([h.d_com for h in scene.halos])
    hid = np.maximum(halo, 0)
    r = np.linalg.norm(port["pos"][:n_gas] - (d_com[hid] + scene.boxhalf),
                       axis=1).astype(np.float32)
    u_j = np.asarray(batched_spline_eval(
        build_energy_tables_stacked(jscene), hid.astype(np.int32), r))
    np.testing.assert_allclose(port["u"][inside], u_j[inside], rtol=1e-4)
    assert (port["u"][~inside] == 0).all()
    assert (port["u"][inside] > 0).all()


@pytest.fixture(scope="module")
def no_bfield_runs(gas_runs, tmp_path_factory):
    """The same scene at Bfld_Norm 0 through both packages (the JAX
    package's compiled programs of gas_runs serve again): both skip the
    B-field stage (pipeline.py's ``if cfg.bfld_norm``)."""
    out = str(tmp_path_factory.mktemp("ics") / "ic_no_bfield")
    over = dict(GAS, bfld_norm=0.0)
    logs = {"port": [], "jax": []}
    make_ics(parse_par_file(PAR, output_file=out, **over).replace(
        **GAS_REPLACE), device="cpu",
        log=lambda stage, **kw: logs["port"].append(stage))
    mp = pytest.MonkeyPatch()
    mp.setenv("TOYCLUSTER_ENGINE", "pallas")
    mp.setattr(pallas_pair, "stream_wvt_pallas",
               partial(pallas_pair.stream_wvt_pallas, interpret=True))
    try:
        _, jparts = jax_make_ics(
            jax_parse(PAR, **over).replace(**GAS_REPLACE), write=False,
            log=lambda stage, **kw: logs["jax"].append(stage))
    finally:
        mp.undo()
    return logs, np.asarray(jparts.bfld), read_snapshot(out)


def test_no_bfield_stage_at_zero_bfld_norm(no_bfield_runs):
    logs, jbfld, snap = no_bfield_runs
    assert "magnetic_field" not in logs["port"]
    assert "magnetic_field" not in logs["jax"]
    outer = [s for s in logs["port"] if not s.startswith("wvt")]
    assert outer == [s for s in logs["jax"] if not s.startswith("wvt")
                     and s != "output"] + ["output"]
    # neither writes a field: the JAX package keeps it unallocated, the
    # snapshot carries zeros
    assert jbfld.size == 0
    assert (snap["bfld"] == 0).all() and snap["bfld"].shape[0] > 0
    assert (snap["u"] > 0).all() and (snap["rho"] > 0).all()


def test_gas_scene_snapshot_read_by_jax_reader(gas_runs):
    scene, _, port, _, snap = gas_runs
    assert snap["header"].npart[:2] == [scene.npart_gas, scene.npart_dm]
    np.testing.assert_array_equal(snap["pos"], port["pos"])
    np.testing.assert_array_equal(snap["u"], port["u"])
    for k in ("pos", "vel", "u", "rho", "hsml", "bfld", "rho_model"):
        assert np.isfinite(snap[k]).all(), k
    assert (snap["rho"] > 0).all() and (snap["u"] > 0).all()
    assert (np.linalg.norm(snap["bfld"], axis=1) > 0).mean() > 0.99
