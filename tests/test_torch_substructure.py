"""The port's substructure path against the JAX package on the CPU.

Scenes: the port's cluster.par with Giocoli substructure.  The subhalo
population is host NumPy on both sides and must match float for float;
the samplers draw from other generators and are held by distribution (KS
tests per subhalo); the deterministic stages (the WC2 gas-bulk taper,
the SLOW_SUBSTRUCTURE orbits, the O(N^2) oracles, the WVT loop on a
three-halo scene carried over with ``from_reference``) are fed the same
inputs; and the pipeline runs end to end, M4, 3 WVT iterations,
against the JAX make_ics with its Pallas kernel in interpret mode, on
two flag sets: config 4's (mass ratio 1/3 with substructure: three
halos) at ntotal 4,000, and config 5's (mass ratio 1/2, comet orbit,
substructure and the third subhalo of 1e13 Msun with the SubFirst* tags
of ``data/cluster_config5.par``: four halos, the third subhalo and one
Giocoli subhalo) at ntotal 2,000, about the smallest size at which both
packages sample it: at 1,500 the first cluster's DM budget is negative
in both and the JAX sampler raises; at 1,800 it holds 20 DM, at 2,000
90."""

import dataclasses
import os
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.io.gadget import read_snapshot
from toycluster_tpu.models import positions as jpos
from toycluster_tpu.models import substructure as jsub
from toycluster_tpu.models import velocities as jvel
from toycluster_tpu.models import wvt as jwvt
from toycluster_tpu.models.eddington import \
    build_distribution_function as jax_df
from toycluster_tpu.ops import brute as jbrute
from toycluster_tpu.ops import pallas_pair
from toycluster_tpu.particles import \
    halo_arrays_from_scene as jax_halo_arrays
from toycluster_tpu.pipeline import make_ics as jax_make_ics
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu.utils.logging import silent_log
from toycluster_tpu_torch import cli
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.from_reference import (halo_arrays_from_numpy,
                                                 particles_from_numpy,
                                                 scene_from_numpy)
from toycluster_tpu_torch.models import positions as tpos
from toycluster_tpu_torch.models import substructure as tsub
from toycluster_tpu_torch.models import velocities as tvel
from toycluster_tpu_torch.models import wvt as twvt
from toycluster_tpu_torch.models.bfield import BMAX_SUB
from toycluster_tpu_torch.models.eddington import build_distribution_function
from toycluster_tpu_torch.ops import brute as tbrute
from toycluster_tpu_torch.particles import halo_arrays_from_scene
from toycluster_tpu_torch.pipeline import _check_density, make_ics
from toycluster_tpu_torch.scene import build_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(REPO, "toycluster_tpu_torch", "data", "cluster.par")
PAR5 = os.path.join(REPO, "toycluster_tpu_torch", "data",
                    "cluster_config5.par")
E2E = dict(ntotal=4000, wvt_max_iter=3, sph_kernel="m4",
           mass_ratio=1.0 / 3.0, substructure=True)
# the end-to-end flag sets: (par, overrides)
E2E_SETS = {
    "config4": (PAR, E2E),
    "config5": (PAR5, dict(E2E, ntotal=2000, mass_ratio=0.5,
                           orbit="comet", add_third_subhalo=True,
                           sub_first_mass=1e3)),
}
# (overrides, Config.replace fields, setup_substructure seed)
SCENES = {
    "single_host": (dict(ntotal=200_000, sph_kernel="m4"), {}, 5),
    "merger": (dict(ntotal=60_000, mass_ratio=1.0 / 3.0), {}, 11),
    "third_subhalo": (dict(ntotal=60_000, mass_ratio=1.0 / 3.0),
                      dict(add_third_subhalo=True, sub_first_mass=1e3,
                           sub_first_pos=(300.0, 200.0, 0.0)), 11),
}


def _scenes(name):
    over, rep, seed = SCENES[name]
    jcfg = jax_parse(PAR, substructure=True, **over).replace(**rep)
    tcfg = parse_par_file(PAR, substructure=True, **over).replace(**rep)
    tbase = build_scene(tcfg)
    return (jsub.setup_substructure(jax_build_scene(jcfg), seed=seed),
            tbase, tsub.setup_substructure(tbase, seed=seed))


def _same(a, b, what):
    """Equal to rel 1e-12 (numbers, tuples, arrays), or equal."""
    if isinstance(a, (bool, str, type(None))) or isinstance(
            a, (int, np.integer)):
        assert a == b, what
    else:
        np.testing.assert_allclose(np.asarray(b, np.float64),
                                   np.asarray(a, np.float64), rtol=1e-12,
                                   atol=0, err_msg=what)


# ------------------------------------------------------------- the scene

@pytest.mark.parametrize("name", sorted(SCENES))
def test_scene_matches_jax(name):
    """Every HaloModel field and mass table equal to rel 1e-12."""
    jscene, _, tscene = _scenes(name)
    assert tscene.nhalos == jscene.nhalos > tscene.sub_first
    assert tscene.sub_first == jscene.sub_first
    if name == "third_subhalo":
        assert tscene.nhalos == 5
        np.testing.assert_array_equal(tscene.halos[2].d_com,
                                      (300.0, 200.0, 0.0))
    for hj, ht in zip(jscene.halos, tscene.halos):
        for f in dataclasses.fields(hj):
            a, b = getattr(hj, f.name), getattr(ht, f.name)
            if f.name != "mass_table":
                _same(a, b, f"halo {hj.index} {f.name}")
            elif a is None:
                assert b is None
            else:
                for k in ("r", "m", "r_clip"):
                    _same(getattr(a, k), getattr(b, k), f"table {k}")
                for k in ("spline", "inv_spline"):
                    for c in ("x", "y", "m2"):
                        _same(getattr(getattr(a, k), c),
                              getattr(getattr(b, k), c), f"{k}.{c}")


@pytest.mark.parametrize("name", sorted(SCENES))
def test_particle_budget_conserved(name):
    _, base, scene = _scenes(name)
    assert sum(h.npart_gas for h in scene.halos) == base.npart_gas
    assert sum(h.npart_dm for h in scene.halos) == base.npart_dm
    assert all(h.npart_dm > 0 for h in scene.halos[scene.sub_first:])


def test_helpers_match_jax_on_a_grid():
    for c in (2.0, 4.0, 8.0):
        for q in np.linspace(0.01, 0.99, 25):
            assert tsub.gao04_radius_fraction(q, c) == \
                jsub.gao04_radius_fraction(q, c)
    kw = dict(host_m200_dm=8e4, redshift=0.5, unit_mass=1.989e43)
    for m in np.logspace(-1, 4, 30):
        _same(jsub.subhalo_mass_function(m, **kw),
              tsub.subhalo_mass_function(m, **kw), m)
    kw = dict(overdensity=180.0, rho_crit0_code=2.7e-8)
    for c in (3.0, 7.0, 15.0):
        for rs in (5.0, 50.0):
            for r in np.logspace(0, 3, 10):
                _same(jsub.nfw_mass(c, rs, r, **kw),
                      tsub.nfw_mass(c, rs, r, **kw), (c, rs, r))


# ------------------------------------------------------- batched sampler

@pytest.fixture(scope="module")
def sub60():
    """The 60,000-particle M4 merger with 7 subhalos, both packages, and
    the JAX make_positions of it (subhalos through its batched
    sampler), in box coordinates."""
    over = dict(ntotal=60_000, mass_ratio=1.0 / 3.0, substructure=True,
                sph_kernel="m4")
    jscene = jsub.setup_substructure(
        jax_build_scene(jax_parse(PAR, **over)), seed=11)
    tscene = tsub.setup_substructure(build_scene(parse_par_file(PAR, **over)),
                                     seed=11)
    assert tscene.nhalos - tscene.sub_first == 7
    jha = jax_halo_arrays(jscene)
    jparts = jpos.make_positions(jax.random.PRNGKey(3), jscene, jha)
    jparts = jpos.shift_origin(jparts, jha, jscene.boxsize)
    return (jscene, jha, tscene, halo_arrays_from_scene(tscene, "cpu"),
            np.asarray(jparts.pos), np.asarray(jparts.halo))


@pytest.mark.parametrize("ns", [[1000, 1200, 9000, 64, 80, 70000],
                                [5, 5, 5], [1394, 32573, 11000, 1500, 8000],
                                [614, 652, 705, 643, 651, 654, 661]])
def test_size_classes_match_jax(ns):
    ns = np.asarray(ns)
    got, ref = tpos._size_classes(ns), jpos._size_classes(ns)
    assert [c.tolist() for c in got] == [c.tolist() for c in ref]
    for c in got:
        assert ns[c].max() <= 8 * ns[c].min()


@pytest.mark.parametrize("kind", ["dm", "gas"])
def test_batched_fill_counts_and_support(sub60, kind):
    _, _, scene, ha, _, _ = sub60
    idxs = list(range(scene.sub_first, scene.nhalos))
    ns = [getattr(scene.halos[i], f"npart_{kind}") for i in idxs]
    gen = torch.Generator().manual_seed(2)
    res = tpos._batched_fill(gen, ha, idxs, ns, kind, scene.boxsize,
                             sub_first=scene.sub_first)
    assert set(res) == set(idxs)
    r_max = ha.r_sample_dm if kind == "dm" else ha.r_sample_gas
    for i, n in zip(idxs, ns):
        pos, filled = res[i]
        assert pos.shape == (n, 3) and filled == n
        r = torch.linalg.vector_norm(pos, dim=-1)
        assert bool((r <= r_max[i] * 1.001).all())
        assert bool((r > 0).all())


def _radii(pos, halo, n_gas, i, kind, d_com, boxhalf):
    sel = halo == i
    sel[n_gas:] &= kind == "dm"
    sel[:n_gas] &= kind == "gas"
    return np.linalg.norm(pos[sel] - (np.asarray(d_com) + boxhalf), axis=1)


@pytest.mark.parametrize("kind", ["dm", "gas"])
def test_batched_radii_match_jax_and_sequential(sub60, kind):
    """Per subhalo: the port's radii, drawn with the subhalos' size class,
    against the JAX make_positions (its batched sampler) and against the
    port's sampler with the subhalo drawn alone, two-sample KS p > 1e-3."""
    jscene, _, scene, ha, jpos_box, jhalo = sub60
    gen = torch.Generator().manual_seed(7)
    parts = tpos.shift_origin(tpos.make_positions(gen, scene, ha), ha,
                              scene.boxsize)
    pos, halo = parts.pos.numpy(), parts.halo.numpy()
    for i in range(scene.sub_first, scene.nhalos):
        h = scene.halos[i]
        n = getattr(h, f"npart_{kind}")
        r_t = _radii(pos, halo.copy(), scene.npart_gas, i, kind, h.d_com,
                     scene.boxhalf)
        r_j = _radii(jpos_box, jhalo.copy(), scene.npart_gas, i, kind,
                     h.d_com, scene.boxhalf)
        assert len(r_t) == len(r_j) == n
        alone, filled = tpos._batched_fill(gen, ha, [i], [n], kind,
                                           scene.boxsize,
                                           sub_first=scene.sub_first)[i]
        assert filled == n
        r_s = torch.linalg.vector_norm(alone, dim=-1).numpy()
        assert stats.ks_2samp(r_t, r_j).pvalue > 1e-3, (i, "jax")
        assert stats.ks_2samp(r_t, r_s).pvalue > 1e-3, (i, "alone")


def test_make_positions_orders_by_halo(sub60):
    _, _, scene, ha, _, _ = sub60
    parts = tpos.make_positions(torch.Generator().manual_seed(9), scene, ha)
    halo, pos = parts.halo.numpy(), parts.pos.numpy()
    n_gas = scene.npart_gas
    assert (np.diff(halo[:n_gas]) >= 0).all()
    assert (np.diff(halo[n_gas:]) >= 0).all()
    for i, h in enumerate(scene.halos):
        assert (halo[:n_gas] == i).sum() == h.npart_gas
        assert (halo[n_gas:] == i).sum() == h.npart_dm
    for i in range(scene.sub_first, scene.nhalos):
        sel = (halo == i) & (np.arange(scene.ntotal) >= n_gas)
        r = np.linalg.norm(pos[sel], axis=-1)
        assert (r <= scene.halos[i].r_sample_dm * 1.001).all()


# ------------------------------------------------------------ velocities

def test_gas_bulk_taper_matches_jax(sub60):
    """The WC2-tapered gas bulk velocities on the JAX positions and halo
    ids of the 7-subhalo scene, against JAX _gas_bulk_jit."""
    jscene, jha, scene, ha, jpos_box, jhalo = sub60
    n_gas = scene.npart_gas
    rng = np.random.default_rng(1)
    bulk = rng.normal(0.0, 300.0, (scene.nhalos, 3)).astype(np.float32)
    sub_hh = np.array([h.r_sample_gas * 1.1 for h in scene.halos],
                      np.float32)
    ref = np.asarray(jvel._gas_bulk_jit(
        jnp.asarray(jpos_box[:n_gas]), jnp.asarray(jhalo[:n_gas]),
        jnp.asarray(bulk), jha.d_com, jnp.asarray(sub_hh), scene.sub_first,
        scene.nhalos, scene.boxhalf))
    got = tvel.gas_bulk_velocities(
        torch.tensor(jpos_box[:n_gas]), torch.tensor(jhalo[:n_gas]),
        torch.as_tensor(bulk), ha.d_com, torch.as_tensor(sub_hh),
        scene.sub_first, scene.boxhalf).numpy()
    tapered = jhalo[:n_gas] >= scene.sub_first
    assert tapered.sum() > 1000
    w = np.linalg.norm(got[tapered], axis=1) / np.linalg.norm(
        bulk[jhalo[:n_gas][tapered]], axis=1)
    assert 0.0 <= w.min() and w.max() <= 1.0 and w.min() < 0.9
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6 * 300.0)


def test_slow_substructure_bulks_match_jax(sub60):
    jscene, _, scene, _, _, _ = sub60
    h0 = scene.halos[0]
    kw = dict(mass_dm=h0.mass_dm, a_hernq=h0.a_hernq, G=scene.units.G,
              mass_table=h0.mass_table, r_sample_gas=h0.r_sample_gas,
              has_gas=True)
    got = tvel.slow_substructure_bulk_velocities(
        scene, build_distribution_function(**kw), np.random.default_rng(99))
    kw["mass_table"] = jscene.halos[0].mass_table
    ref = jvel.slow_substructure_bulk_velocities(
        jscene, jax_df(**kw), np.random.default_rng(99))
    np.testing.assert_allclose(np.array(got), np.array(ref), rtol=1e-10,
                               atol=0)
    assert all(np.linalg.norm(got[i]) > 0
               for i in range(scene.sub_first, scene.nhalos))
    np.testing.assert_array_equal(got[0], scene.halos[0].bulk_vel)


# -------------------------------------------------------- brute oracles

@pytest.fixture(scope="module")
def cloud():
    rng = np.random.default_rng(17)
    n = 600
    return dict(pos=rng.random((n, 3)).astype(np.float32),
                h=(0.22 + 0.03 * rng.random(n)).astype(np.float32),
                rho=(1.0 + rng.random(n)).astype(np.float32),
                vf=(0.9 + 0.2 * rng.random(n)).astype(np.float32),
                apot=rng.random((n, 3)).astype(np.float32))


def _both(fn_name, args, kw):
    ref = getattr(jbrute, fn_name)(*(jnp.asarray(a) if isinstance(
        a, np.ndarray) else a for a in args), **kw)
    got = getattr(tbrute, fn_name)(*(torch.as_tensor(a) if isinstance(
        a, np.ndarray) else a for a in args), **kw)
    return got, ref


@pytest.mark.parametrize("kernel,desnngb", [("wc6", 64), ("m4", 50)])
@pytest.mark.parametrize("what", ["density", "density_at", "displacement",
                                  "curl"])
def test_brute_oracles_match_jax(cloud, kernel, desnngb, what):
    c, box, mpart = cloud, 1.0, 1.0 / 600
    if what == "density":
        got, ref = _both("brute_density", (c["pos"], c["h"], mpart, box),
                         dict(kernel=kernel, desnngb=desnngb))
        np.testing.assert_array_equal(got[4].numpy(), np.asarray(ref[4]))
        assert bool(got[4].all())
        pairs = list(zip(got[:4], ref[:4]))
    elif what == "density_at":
        got, ref = _both("density_at", (c["pos"][:100], c["h"][:100],
                                        c["pos"], mpart, box),
                         dict(kernel=kernel, desnngb=desnngb, chunk=256))
        pairs = [(got, ref)]
    elif what == "displacement":
        got, ref = _both("brute_wvt_displacement",
                         (c["pos"], c["h"], 0.035, box), dict(kernel=kernel))
        pairs = [(got, ref)]
    else:
        got, ref = _both("brute_curl", (c["pos"], c["h"], c["rho"], c["vf"],
                                        c["apot"], mpart, box),
                         dict(kernel=kernel))
        pairs = [(got, ref)]
    for g, r in pairs:
        r = np.asarray(r)
        assert np.abs(r).max() > 0
        np.testing.assert_allclose(g.numpy(), r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())


# ------------------------------------------------------------ end to end

def _capture_wvt(rec):
    """Wrap the JAX WVT loop: keep its input (as NumPy), its output and
    its 'wvt' log records."""
    orig = jwvt.regularise_sph_particles

    def run(scene, ha, parts, *, log, **kw):
        start = parts[0] if isinstance(parts, list) else parts
        rec["start"] = {k: np.asarray(v) for k, v in start._asdict().items()}
        rec["ha"] = {k: np.asarray(v) for k, v in ha._asdict().items()}
        rec["scene"] = scene

        def tee(stage, **kv):
            if stage == "wvt":
                rec["wvt"].append(kv)
            log(stage, **kv)

        out = orig(scene, ha, parts, log=tee, **kw)
        rec["end"] = {k: np.asarray(v) for k, v in out[0]._asdict().items()}
        return out
    return run


@pytest.fixture(scope="module", params=sorted(E2E_SETS))
def e2e(request, tmp_path_factory):
    par, over = E2E_SETS[request.param]
    out = str(tmp_path_factory.mktemp("ics") / "ic_sub")
    logs = []
    scene, parts = make_ics(parse_par_file(par, output_file=out, **over),
                            device="cpu", check=True,
                            log=lambda stage, **kw: logs.append((stage, kw)))
    rec = {"wvt": []}
    mp = pytest.MonkeyPatch()
    mp.setenv("TOYCLUSTER_ENGINE", "pallas")
    mp.setattr(pallas_pair, "stream_wvt_pallas",
               partial(pallas_pair.stream_wvt_pallas, interpret=True))
    mp.setattr(jwvt, "regularise_sph_particles", _capture_wvt(rec))
    try:
        jscene, jparts = jax_make_ics(jax_parse(par, **over), write=False,
                                      log=silent_log)
    finally:
        mp.undo()
    port = {k: getattr(parts, k).numpy() for k in ("pos", "vel", "halo")}
    ref = {k: np.asarray(getattr(jparts, k)) for k in ("pos", "vel", "halo")}
    return dict(name=request.param, par=par, over=over, scene=scene,
                parts=parts, port=port, ref=ref, logs=logs, jscene=jscene,
                rec=rec, snap=read_snapshot(out))


def _groups(scene, d):
    n_gas = scene.npart_gas
    is_gas = np.arange(scene.ntotal) < n_gas
    return {(k, t): (d["halo"] == k) & (is_gas if t == "gas" else ~is_gas)
            for k in range(scene.nhalos) for t in ("gas", "dm")}


def test_e2e_scene_has_three_halos(e2e):
    """Config 4's set: the two clusters and one Giocoli subhalo.  Config
    5's: the third subhalo first after the clusters, at the par's
    SubFirstPos with its mass and the par's SubFirstVel as its bulk
    velocity, as JAX's, then one Giocoli subhalo."""
    scene, jscene = e2e["scene"], e2e["jscene"]
    n = 3 if e2e["name"] == "config4" else 4
    assert scene.nhalos == jscene.nhalos == n and scene.sub_first == 2
    assert [h.npart_gas for h in scene.halos] == \
        [h.npart_gas for h in jscene.halos]
    assert [h.npart_dm for h in scene.halos] == \
        [h.npart_dm for h in jscene.halos]
    assert ("substructure", dict(nhalos=n, nsub=n - 2)) in e2e["logs"]
    plain = build_scene(parse_par_file(
        e2e["par"], **dict(e2e["over"], substructure=False)))
    np.testing.assert_allclose(scene.vel_merger, plain.vel_merger,
                               rtol=1e-12, atol=0)
    if e2e["name"] == "config5":
        third, jthird = scene.halos[2], jscene.halos[2]
        np.testing.assert_array_equal(third.d_com, (300.0, 200.0, 0.0))
        for k in ("d_com", "mtotal200", "mass_dm", "mass_gas", "bulk_vel"):
            _same(getattr(jthird, k), getattr(third, k), f"third {k}")
        np.testing.assert_array_equal(third.bulk_vel, (-500.0, 100.0, 0.0))
        assert third.mass_dm > 0 and third.mass_gas > 0


def test_e2e_membership_counts_match_jax(e2e):
    scene, port, ref = e2e["scene"], e2e["port"], e2e["ref"]
    g_t, g_j = _groups(scene, port), _groups(scene, ref)
    for key in g_t:
        n_all = scene.npart_gas if key[1] == "gas" else scene.npart_dm
        n_t, n_j = int(g_t[key].sum()), int(g_j[key].sum())
        p = n_j / n_all
        assert n_j > 0
        assert abs(n_t - n_j) < 5 * np.sqrt(2 * n_all * p * (1 - p)) + 1, \
            (key, n_t, n_j)


@pytest.mark.parametrize("field", ["pos", "vel"])
def test_e2e_per_halo_means_match_jax(e2e, field):
    """Centres of mass and mean velocities per halo and type within 5
    standard errors of the difference of two sample means (and 1e-3 of
    the mean)."""
    scene, port, ref = e2e["scene"], e2e["port"], e2e["ref"]
    g_t, g_j = _groups(scene, port), _groups(scene, ref)
    for key in g_t:
        a, b = port[field][g_t[key]], ref[field][g_j[key]]
        m_a, m_b = a.mean(axis=0), b.mean(axis=0)
        se = np.sqrt(a.var(axis=0) / len(a) + b.var(axis=0) / len(b))
        assert (np.abs(m_a - m_b) <= 5 * se + 1e-3 * np.abs(m_b)).all(), \
            (key, field, m_a, m_b)


def test_e2e_dm_speeds_per_halo_match_jax(e2e):
    scene, port, ref = e2e["scene"], e2e["port"], e2e["ref"]
    g_t, g_j = _groups(scene, port), _groups(scene, ref)
    for k in range(scene.nhalos):
        v_t = np.linalg.norm(port["vel"][g_t[k, "dm"]], axis=1)
        v_j = np.linalg.norm(ref["vel"][g_j[k, "dm"]], axis=1)
        assert stats.ks_2samp(v_t, v_j).pvalue > 1e-3, k


def test_e2e_subhalo_field_capped(e2e):
    scene, parts = e2e["scene"], e2e["parts"]
    n_gas = scene.npart_gas
    sub = parts.halo[:n_gas] >= scene.sub_first
    assert int(sub.sum()) > 0
    b = torch.linalg.vector_norm(parts.bfld[sub], dim=-1)
    assert float(b.max()) <= BMAX_SUB * (1 + 1e-5)
    assert float(torch.linalg.vector_norm(parts.bfld, dim=-1).max()) \
        > BMAX_SUB


def test_e2e_density_audit(e2e):
    """check=True logs the audit; a corrupted rho makes it raise."""
    audits = [kw for stage, kw in e2e["logs"] if stage == "check_density"]
    assert len(audits) == 1 and audits[0]["n"] == 512
    assert audits[0]["worst_rel_err"] <= 5e-3
    scene, parts = e2e["scene"], e2e["parts"]
    bad = parts.replace(rho=parts.rho * 1.01)
    with pytest.raises(RuntimeError, match="density check failed"):
        _check_density(scene, bad, lambda *a, **k: None)


def test_e2e_snapshot_read_by_jax_reader(e2e):
    scene, port, snap = e2e["scene"], e2e["port"], e2e["snap"]
    assert snap["header"].npart[:2] == [scene.npart_gas, scene.npart_dm]
    np.testing.assert_array_equal(snap["pos"], port["pos"])
    for k in ("pos", "vel", "u", "rho", "hsml", "bfld", "rho_model"):
        assert np.isfinite(snap[k]).all(), k
    assert (snap["rho"] > 0).all() and (snap["u"] > 0).all()


def test_wvt_loop_on_three_halos_matches_jax(e2e):
    """From the JAX loop's own input in the run above (carried over with
    from_reference: scene, halo arrays, particles), the port's loop
    against the JAX loop: err_mean rtol 2e-2, the margin trajectory
    (which grows by 1.15 on each saturation retry) equal, periodic
    position difference < 2e-3 box, rho rtol 2e-2 (pid-matched)."""
    rec = e2e["rec"]
    js = rec["scene"]
    fields = {f.name: getattr(js, f.name) for f in dataclasses.fields(js)
              if f.name not in ("config", "units", "cosmo", "halos")}
    tscene = scene_from_numpy(parse_par_file(e2e["par"], **e2e["over"]),
                              fields, [dataclasses.asdict(h)
                                       for h in js.halos])
    assert tscene.nhalos == e2e["scene"].nhalos
    tha = halo_arrays_from_numpy(rec["ha"])
    ref_ha = halo_arrays_from_scene(tscene, "cpu")
    for f in ("d_com", "r_sample_gas", "rho0", "minv_x", "minv_m2"):
        assert torch.equal(getattr(tha, f), getattr(ref_ha, f)), f
    logs = []
    got, _ = twvt.regularise_sph_particles(
        tscene, tha, particles_from_numpy(rec["start"]),
        log=lambda stage, **kw: logs.append(kw) if stage == "wvt" else None)
    errs_j = [r["err_mean"] for r in rec["wvt"]]
    assert len(logs) == len(errs_j) >= 3
    np.testing.assert_allclose([r["err_mean"] for r in logs], errs_j,
                               rtol=2e-2)
    assert [r["margin"] for r in logs] == [r["margin"] for r in rec["wvt"]]
    end, n = rec["end"], got.n_gas

    def by_pid(pid, *arrays):
        order = np.argsort(pid)
        return [a[order] for a in arrays]

    pj, rj = by_pid(end["pid"][:n], end["pos"][:n], end["rho"])
    pt, rt = by_pid(got.pid[:n].numpy(), got.pos[:n].numpy(),
                    got.rho.numpy())
    d = np.abs(pt - pj)
    d = np.minimum(d, js.boxsize - d)
    assert d.max() < 2e-3 * js.boxsize
    np.testing.assert_allclose(rt, rj, rtol=2e-2)


def test_cli_classed_slow_substructure(tmp_path):
    """The CLI with engine=classed and SLOW_SUBSTRUCTURE (one WVT
    iteration) writes a snapshot of finite blocks that the JAX reader
    reads."""
    out = tmp_path / "ic_classed"
    args = [f"{k}={v}" for k, v in dict(E2E, wvt_max_iter=1).items()]
    assert cli.main([PAR, *args, "slow_substructure=true", "device=cpu",
                     "engine=classed", f"output_file={out}"]) == 0
    snap = read_snapshot(str(out))
    assert snap["header"].npart[0] + snap["header"].npart[1] == \
        E2E["ntotal"]
    for k in ("pos", "vel", "u", "rho", "hsml", "bfld", "rho_model"):
        assert np.isfinite(snap[k]).all(), k
    assert (snap["rho"] > 0).all()
