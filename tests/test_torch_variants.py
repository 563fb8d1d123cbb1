"""Every model flag of ``Config`` held against the JAX package, stage by
stage, on the CPU.

Scenes: the port's cluster.par with one flag (or one set of flags) each;
the parser, the scene and every halo field must be equal (the host layer
is float64 NumPy on both sides).  Deterministic stages (the gas model
density, the u(r) tables and temperatures, the vector potential and the
field normalisation, the merger kinematics, the SLOW_SUBSTRUCTURE orbits
about another host) are fed the same NumPy arrays, made from a seed, on
both sides; the gas sampler is held by distribution (KS on the radius per
halo).  The cool-core scenes set the flag with ``Config.replace``: the
par lacks the ``Rho0_Fac`` / ``Rc_Fac`` tags that parsing it would need,
so the Config defaults 50 and 40 apply; their ``Cuspy`` bits are set, or
the flag would change no halo."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu import particles as jparticles
from toycluster_tpu.models import bfield as jbf
from toycluster_tpu.models import kinematics as jkin
from toycluster_tpu.models import positions as jpos
from toycluster_tpu.models import sph as jsph
from toycluster_tpu.models import substructure as jsub
from toycluster_tpu.models import temperature as jtemp
from toycluster_tpu.models import velocities as jvel
from toycluster_tpu.models.eddington import \
    build_distribution_function as jax_df
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu_torch import particles as tparticles
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.from_reference import particles_from_numpy
from toycluster_tpu_torch.models import bfield as tbf
from toycluster_tpu_torch.models import kinematics as tkin
from toycluster_tpu_torch.models import positions as tpos
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.models import substructure as tsub
from toycluster_tpu_torch.models import temperature as ttemp
from toycluster_tpu_torch.models import velocities as tvel
from toycluster_tpu_torch.models.eddington import build_distribution_function
from toycluster_tpu_torch.scene import build_scene

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(REPO, "toycluster_tpu_torch", "data", "cluster.par")
RTOL = 1e-5   # the bound of tests/test_setup_parity.py
COOL = (dict(cuspy=3, mass_ratio=0.5), dict(double_beta_cool_cores=True))
# flag -> (parse_par_file overrides, Config.replace fields)
FLAGS = {
    "buote07": (dict(nfw_concentration_model="buote07"), {}),
    "cool_cores": COOL,
    "cool_cores_one_halo": (dict(cuspy=1), dict(double_beta_cool_cores=True)),
    "no_rcut_in_t_false": (dict(no_rcut_in_t=False), {}),
    "beta_2_3": (dict(beta=2.0 / 3.0), {}),
    "parabola": (dict(mass_ratio=0.5, orbit="parabola"), {}),
    "direct": (dict(mass_ratio=0.5, orbit="direct"), {}),
    "dm_only": (dict(baryon_fraction=0.0), {}),
    "dm_only_merger": (dict(baryon_fraction=0.0, mass_ratio=0.5), {}),
    "bfld_norm_0": (dict(bfld_norm=0.0), {}),
}
# substructure scenes with test SubFirst* values (the par has no such
# tags): (overrides, Config.replace fields, setup_substructure seed).
# sub_host = 1 at 60,000 particles leaves the host a positive DM budget
# (at 20,000 the sampler raises in both packages).
SUB_FLAGS = {
    "third_halo_only": (dict(ntotal=60_000, mass_ratio=1.0 / 3.0),
                        dict(add_third_subhalo=True, third_halo_only=True,
                             sub_first_mass=1e3,
                             sub_first_pos=(300.0, 200.0, 0.0),
                             sub_first_vel=(-500.0, 100.0, 0.0)), 11),
    "sub_host_1": (dict(ntotal=60_000, mass_ratio=0.5, sub_host=1), {}, 11),
    # Cuspy bits on every halo, subhalos too (substructure.py's
    # _subhalo_properties: a cuspy subhalo's core moves with the flag)
    "cool_cores": (dict(ntotal=60_000, mass_ratio=1.0 / 3.0, cuspy=4095),
                   dict(double_beta_cool_cores=True), 11),
}


def _configs(name, **extra):
    over, rep = FLAGS[name]
    over = dict(ntotal=20_000, **over, **extra)
    return (jax_parse(PAR, **over).replace(**rep),
            parse_par_file(PAR, **over).replace(**rep))


def _scenes(name, **extra):
    jcfg, tcfg = _configs(name, **extra)
    return jax_build_scene(jcfg), build_scene(tcfg)


def _sub_scenes(name):
    over, rep, seed = SUB_FLAGS[name]
    jcfg = jax_parse(PAR, substructure=True, **over).replace(**rep)
    tcfg = parse_par_file(PAR, substructure=True, **over).replace(**rep)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return (jsub.setup_substructure(jax_build_scene(jcfg), seed=seed),
            tsub.setup_substructure(build_scene(tcfg), seed=seed))


def _same(a, b, what):
    """Equal (numbers, tuples, arrays, strings, None)."""
    if isinstance(a, (bool, str, type(None))) or isinstance(
            a, (int, np.integer)):
        assert a == b, what
    else:
        np.testing.assert_array_equal(np.asarray(b, np.float64),
                                      np.asarray(a, np.float64),
                                      err_msg=what)


def _same_scene(jscene, tscene):
    for f in ("boxsize", "mtotal", "mpart_gas", "mpart_dm", "npart_gas",
              "npart_dm", "sub_first", "nhalos", "vel_merger",
              "d_clusters", "grav_softening"):
        _same(getattr(jscene, f), getattr(tscene, f), f)
    assert len(jscene.halos) == len(tscene.halos)
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


# ------------------------------------------------------------- the scene

@pytest.mark.parametrize("name", sorted(FLAGS))
def test_parser_and_scene_match_jax(name):
    jcfg, tcfg = _configs(name)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    jscene, tscene = _scenes(name)
    _same_scene(jscene, tscene)
    assert tscene.dm_only == (name.startswith("dm_only"))
    if name.startswith("cool_cores"):
        assert all(h.have_cuspy for h in tscene.halos)


@pytest.mark.parametrize("name", sorted(SUB_FLAGS))
def test_substructure_scene_matches_jax(name):
    jscene, tscene = _sub_scenes(name)
    assert tscene.nhalos > tscene.sub_first
    _same_scene(jscene, tscene)
    if name == "third_halo_only":
        # one subhalo, the third halo itself, at its given place
        assert tscene.nhalos == tscene.sub_first + 1
        np.testing.assert_array_equal(tscene.halos[2].d_com,
                                      (300.0, 200.0, 0.0))
    host = tscene.halos[tscene.config.sub_host]
    assert host.npart_dm > 0 and host.npart_gas > 0
    if name == "cool_cores":
        subs = tscene.halos[tscene.sub_first:]
        assert all(h.have_cuspy for h in subs)
        np.testing.assert_allclose([h.rcore for h in subs],
                                   [h.rs / 3.0 for h in subs], rtol=1e-12)


def test_cool_core_par_needs_its_tags():
    """Both parsers raise the reference's missing-tag error for the
    cool-core tags the repository's par lacks."""
    for parse in (jax_parse, parse_par_file):
        with pytest.raises(ValueError, match="Rho0_Fac"):
            parse(PAR, double_beta_cool_cores=True)


# --------------------------------------------------- gas model density

def _halo_arrays(jscene, tscene):
    return (jparticles.halo_arrays_from_scene(jscene),
            tparticles.halo_arrays_from_scene(tscene, "cpu"))


def _box_points(scene, n=20_000, seed=7):
    """Seeded points over the box, denser towards the halo centres."""
    rng = np.random.default_rng(seed)
    u = rng.random((n, 3))
    pts = [u * scene.boxsize]
    for h in scene.halos:
        r = scene.boxsize * 0.5 * rng.random(n // 4) ** 3
        d = rng.normal(size=(n // 4, 3))
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        pts.append(np.asarray(h.d_com) + scene.boxhalf + r[:, None] * d)
    return np.mod(np.concatenate(pts), scene.boxsize).astype(np.float32)


@pytest.mark.parametrize("name,static_beta", [
    ("cool_cores", False), ("cool_cores_one_halo", False),
    ("beta_2_3", False), ("beta_2_3", True), ("buote07", True)])
def test_global_density_model_matches_jax(name, static_beta):
    """sph.global_density_model with the scene's cool_core and with the
    static beta the WVT loop passes (uniform_beta) or none."""
    jscene, tscene = _scenes(name)
    jha, tha = _halo_arrays(jscene, tscene)
    cfg = tscene.config
    cc = ((cfg.rho0_fac, cfg.rc_fac) if cfg.double_beta_cool_cores
          else None)
    assert tsph.uniform_beta(tscene) == jsph.uniform_beta(jscene)
    beta = tsph.uniform_beta(tscene) if static_beta else None
    pos = _box_points(tscene)
    want = np.asarray(jsph.global_density_model(
        jnp.asarray(pos), jha, jscene.boxsize, cc, beta=beta))
    got = tsph.global_density_model(torch.from_numpy(pos), tha,
                                    tscene.boxsize, cc, beta=beta).numpy()
    assert (want > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


@pytest.mark.parametrize("name", ["cool_cores", "cool_cores_one_halo",
                                  "beta_2_3"])
@pytest.mark.parametrize("beta", [None, 2.0 / 3.0, 0.54])
def test_gas_density_matches_jax(name, beta):
    """particles.gas_density against gas_density_device per halo, radii
    from the centre to past rcut, with and without the cool core."""
    jscene, tscene = _scenes(name)
    jha, tha = _halo_arrays(jscene, tscene)
    cfg = tscene.config
    for cc in {None, (cfg.rho0_fac, cfg.rc_fac)}:
        for j, h in enumerate(tscene.halos):
            r = np.geomspace(1e-2, 2 * h.rcut, 4000).astype(np.float32)
            want = np.asarray(jparticles.gas_density_device(
                jnp.asarray(r), jha, j, cc, beta=beta))
            got = tparticles.gas_density(torch.from_numpy(r), tha, j, cc,
                                         beta=beta).numpy()
            np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


# -------------------------------------------------------- temperatures

def _gas_particles(scene, seed=11):
    """Particles fields (NumPy) of gas at seeded positions with a seeded
    halo membership (a few out of the box, halo -1)."""
    rng = np.random.default_rng(seed)
    pos = _box_points(scene, n=8000, seed=seed)
    n_gas = pos.shape[0]
    halo = rng.integers(0, scene.nhalos, n_gas).astype(np.int32)
    halo[::997] = -1
    f = np.zeros(n_gas, np.float32)
    return dict(pos=pos, vel=np.zeros((0, 3), np.float32),
                pid=np.arange(1, n_gas + 1, dtype=np.uint32), halo=halo,
                u=f, rho=f, hsml=f, var_hsml_fac=f, rho_model=f,
                bfld=np.zeros((0, 3), np.float32),
                apot=np.zeros((0, 3), np.float32))


def _both_parts(d):
    return (jparticles.Particles(**{k: jnp.asarray(v) for k, v in d.items()}),
            particles_from_numpy(d))


@pytest.mark.parametrize("no_rcut", [True, False])
@pytest.mark.parametrize("name", ["cool_cores", "beta_2_3"])
def test_temperatures_match_jax(name, no_rcut):
    """build_energy_tables_stacked and make_temperatures on the same gas
    positions, cool cores (or beta = 2/3) x NO_RCUT_IN_T on and off."""
    jscene, tscene = _scenes(name, no_rcut_in_t=no_rcut)
    jtab = jtemp.build_energy_tables_stacked(jscene)
    ttab = ttemp.build_energy_tables_stacked(tscene, "cpu")
    for a, b in zip(jtab, ttab):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=RTOL,
                                   atol=0)
    jp, tp = _both_parts(_gas_particles(tscene))
    want = np.asarray(jtemp.make_temperatures(jscene, jp).u)
    got = ttemp.make_temperatures(tscene, tp).u.numpy()
    assert (want[tp.halo.numpy() >= 0] > 0).all()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)


def test_no_rcut_in_t_changes_u():
    """The flag's two settings give different u(r) tables (so the test
    above holds two branches, not one)."""
    a = ttemp.build_energy_tables_stacked(_scenes("beta_2_3")[1], "cpu")
    b = ttemp.build_energy_tables_stacked(
        _scenes("beta_2_3", no_rcut_in_t=False)[1], "cpu")
    assert not torch.equal(a.y, b.y)


# ------------------------------------------------------------- B field

def test_vector_potential_and_normalisation_match_jax():
    """set_vector_potential and normalise_field with cool cores, on the
    same gas positions and the same seeded raw field."""
    jscene, tscene = _scenes("cool_cores")
    jha, tha = _halo_arrays(jscene, tscene)
    d = _gas_particles(tscene)
    jp, tp = _both_parts(d)
    want = np.asarray(jbf.set_vector_potential(jscene, jha, jp).apot)
    got = tbf.set_vector_potential(tscene, tha, tp).apot.numpy()
    assert want.shape == got.shape == (d["pos"].shape[0], 3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=0)
    rng = np.random.default_rng(13)
    raw = (rng.normal(size=(d["pos"].shape[0], 3))
           * np.exp(rng.normal(size=(d["pos"].shape[0], 1)))).astype(
               np.float32)
    want = np.asarray(jbf.normalise_field(jscene, jha, jnp.asarray(raw),
                                          jnp.asarray(d["pos"])))
    got = tbf.normalise_field(tscene, tha, torch.from_numpy(raw),
                              torch.from_numpy(d["pos"])).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=1e-6 * np.abs(want).max())


# ---------------------------------------------------------- kinematics

@pytest.mark.parametrize("orbit", ["comet", "parabola", "direct"])
def test_kinematics_match_jax(orbit):
    """apply_kinematics on the JAX stage's input particles."""
    over = dict(mass_ratio=0.5, orbit=orbit, ntotal=20_000)
    jscene = jax_build_scene(jax_parse(PAR, **over))
    tscene = build_scene(parse_par_file(PAR, **over))
    rng = np.random.default_rng(17)
    n = tscene.ntotal
    d = _gas_particles(tscene)
    d.update(pos=(rng.random((n, 3)) * tscene.boxsize).astype(np.float32),
             vel=rng.normal(scale=300.0, size=(n, 3)).astype(np.float32),
             halo=np.zeros(n, np.int32),
             pid=np.arange(1, n + 1, dtype=np.uint32))
    jp, tp = _both_parts(d)
    want = np.asarray(jkin.apply_kinematics(jscene, jp).vel)
    got = tkin.apply_kinematics(tscene, tp).vel.numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    moved = got[:, 0] != d["vel"][:, 0]
    if orbit == "direct":
        assert not moved.any()   # stamped at setup (scene bulk_vel)
        assert tscene.halos[1].bulk_vel[0] == tscene.vel_merger[1]
    else:
        assert moved.all()


# ------------------------------------------------- the samplers' input

@pytest.fixture(scope="module")
def cool_positions():
    """Both packages' gas positions of the two-halo cool-core scene."""
    jscene, tscene = _scenes("cool_cores")
    jha, tha = _halo_arrays(jscene, tscene)
    jp = jpos.make_positions(jax.random.PRNGKey(5), jscene, jha)
    gen = torch.Generator().manual_seed(5)
    tp = tpos.make_positions(gen, tscene, tha)
    n_gas = tscene.npart_gas
    return (tscene, np.asarray(jp.pos)[:n_gas], np.asarray(jp.halo)[:n_gas],
            tp.pos[:n_gas].numpy(), tp.halo[:n_gas].numpy())


@pytest.mark.parametrize("halo", [0, 1])
def test_cool_core_gas_radii_match_jax(cool_positions, halo):
    """The gas sampler of each halo (halo-centred coordinates), KS on the
    radius, p > 1e-3."""
    scene, jpos_, jhalo, tpos_, thalo = cool_positions
    r_j = np.linalg.norm(jpos_[jhalo == halo], axis=1)
    r_t = np.linalg.norm(tpos_[thalo == halo], axis=1)
    assert len(r_t) == len(r_j) == scene.halos[halo].npart_gas
    assert stats.ks_2samp(r_t, r_j).pvalue > 1e-3


# ------------------------------------------- SLOW_SUBSTRUCTURE, sub_host

def test_slow_substructure_about_another_host_matches_jax():
    """The SLOW_SUBSTRUCTURE orbits with sub_host = 1 (the subhalos'
    distances taken from halo 1) on JAX's inputs."""
    jscene, tscene = _sub_scenes("sub_host_1")
    h0 = tscene.halos[0]
    kw = dict(mass_dm=h0.mass_dm, a_hernq=h0.a_hernq, G=tscene.units.G,
              mass_table=h0.mass_table, r_sample_gas=h0.r_sample_gas,
              has_gas=True)
    got = tvel.slow_substructure_bulk_velocities(
        tscene, build_distribution_function(**kw),
        np.random.default_rng(99))
    kw["mass_table"] = jscene.halos[0].mass_table
    ref = jvel.slow_substructure_bulk_velocities(
        jscene, jax_df(**kw), np.random.default_rng(99))
    np.testing.assert_allclose(np.array(got), np.array(ref), rtol=1e-10,
                               atol=0)
    assert all(np.linalg.norm(got[i]) > 0
               for i in range(tscene.sub_first, tscene.nhalos))
