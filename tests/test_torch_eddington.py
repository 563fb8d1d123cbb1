"""The Eddington integral of every halo's f(E) table in one call
(``ops/eddington.py``) and the velocity tables built on it
(``models/velocities.velocity_tables``), against the host's one-halo
NumPy integral (``models/eddington._exact_eddington_integral``) and the
tables it gives, on config 4's scene: 51 halos at 1e7 particles (the
scene alone, no particle is drawn) and 5 halos at 1e5 for the DM
velocities.

The file imports no JAX, so its card tests run on a machine without it
(``python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_eddington.py``); without a card they skip.
"""

import os

import numpy as np
import pytest
import torch

from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.models import eddington as edd
from toycluster_tpu_torch.models import positions as pos_mod
from toycluster_tpu_torch.models import velocities as vel
from toycluster_tpu_torch.models.substructure import setup_substructure
from toycluster_tpu_torch.ops import eddington as oped
from toycluster_tpu_torch.ops.interp import SplineTable
from toycluster_tpu_torch.particles import halo_arrays_from_scene
from toycluster_tpu_torch.scene import build_scene
from toycluster_tpu_torch.utils.logging import Spans

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(ROOT, "toycluster_tpu_torch", "data", "cluster.par")
# the benchmark's config 4 (h100_bench/configs/config4-sub-1e7.json)
CONFIG4 = dict(mass_ratio=1 / 3, substructure=True, seed=14041981)
DEVICES = ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)]


def _scene(ntotal):
    cfg = parse_par_file(PAR, ntotal=ntotal, **CONFIG4)
    return setup_substructure(build_scene(cfg), seed=cfg.seed + 7)


def _halo_kw(scene, h):
    return dict(mass_dm=h.mass_dm, a_hernq=h.a_hernq, G=scene.units.G,
                mass_table=h.mass_table, r_sample_gas=h.r_sample_gas,
                has_gas=h.npart_gas > 0)


@pytest.fixture(scope="module")
def scene():
    sc = _scene(10_000_000)
    assert sc.nhalos == 51
    return sc


@pytest.fixture(scope="module")
def inputs(scene):
    """Every halo's prepared inputs and its host integral."""
    inps = [edd.prepare_distribution_function(**_halo_kw(scene, h))
            for h in scene.halos]
    return inps, [edd._exact_eddington_integral(p.x, p.m2, p.E)
                  for p in inps]


@pytest.fixture
def dev(request):
    """The device of the test's parameter: the card, or a skip, decided
    inside the test, never at import."""
    name = request.param
    if name == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device(name)


def _stacked(inps, device):
    return [torch.as_tensor(np.stack([getattr(p, k) for p in inps]),
                            device=device) for k in ("x", "m2", "E")]


def _scale(p):
    """Per energy, the integral's terms summed in magnitude: the size its
    rounding scales with."""
    c1 = np.diff(p.m2) / np.diff(p.x)
    d = np.concatenate([c1[:1], np.diff(c1)])
    s = np.maximum(p.E[:, None] - p.x[None, :-1], 0.0)
    return (2.0 * abs(p.m2[0]) * np.sqrt(np.maximum(p.E - p.x[0], 0.0))
            + (4.0 / 3.0) * ((s * np.sqrt(s)) @ np.abs(d)))


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
def test_integral_matches_the_host_integral(dev, inputs):
    """Every halo's integral within 1e-12 of the host's, relative to the
    terms summed in magnitude, and ``terms`` the knots below each E."""
    inps, ref = inputs
    n0 = oped.eddington_integral.launches
    got, terms = oped.eddington_integral(*_stacked(inps, dev))
    assert oped.eddington_integral.launches == n0 + (dev.type == "cuda")
    assert got.dtype == torch.float64 and terms.dtype == torch.int32
    got, terms = got.cpu().numpy(), terms.cpu().numpy()
    for h, p in enumerate(inps):
        err = np.abs(got[h] - ref[h]) / _scale(p)
        assert err.max() <= 1e-12, (h, err.max())
        np.testing.assert_array_equal(
            terms[h], (p.x[None, :-1] < p.E[:, None]).sum(axis=1))
    # about half the (knot, energy) pairs lie below their energy
    assert 0.3 < terms.sum() / terms.size / (edd.NSAMPLE - 1) < 0.7


@pytest.mark.cuda
@pytest.mark.parametrize("dev", ["cuda"], indirect=True)
def test_kernel_reruns_are_bit_identical(dev, inputs):
    args = _stacked(inputs[0], dev)
    a, ta = oped.eddington_integral(*args)
    b, tb = oped.eddington_integral(*args)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and torch.equal(ta, tb)


@pytest.mark.cuda
@pytest.mark.parametrize("dev", ["cuda"], indirect=True)
def test_kernel_matches_the_plain_version(dev, inputs):
    """The card's integrals against the plain version's on the card,
    within the same bound; the knot counts equal."""
    args = _stacked(inputs[0], dev)
    got, terms = oped.eddington_integral(*args)
    ref, rterms = oped._eddington_integral_reference(*args)
    assert torch.equal(terms, rterms)
    scale = torch.as_tensor(np.stack([_scale(p) for p in inputs[0]]),
                            device=dev)
    assert float(((got - ref).abs() / scale).max()) <= 1e-12


@pytest.mark.parametrize("bad", ["dtype", "shape", "knots"])
def test_integral_refuses_what_it_does_not_take(bad):
    x = torch.linspace(0.0, 1.0, 8, dtype=torch.float64)[None]
    m2 = torch.zeros_like(x)
    E = torch.full((1, 4), 0.5, dtype=torch.float64)
    if bad == "dtype":
        E = E.float()
    elif bad == "shape":
        m2 = m2[:, :7].contiguous()
    else:
        x, m2 = x[:, :1].contiguous(), m2[:, :1].contiguous()
    with pytest.raises(ValueError):
        oped.eddington_integral(x, m2, E)


def _host_tables(scene, device):
    """The tables as each halo's host f(E) gives them
    (``build_distribution_function``), converted a halo at a time and
    stacked."""
    def t(x):
        return torch.as_tensor(np.asarray(x, np.float64),
                               dtype=torch.float32, device=device)

    rows = []
    for h in scene.halos:
        df = edd.build_distribution_function(**_halo_kw(scene, h))
        g = df.psi.gas
        if g is not None:
            psi_gas = SplineTable(t(g.spline.x), t(g.spline.y),
                                  t(g.spline.m2))
            psi_rmax, r_max = t(g.psi_rmax), t(g.r_max)
        else:
            z = t(np.zeros(edd.NTABLE))
            psi_gas = SplineTable(t(np.linspace(0.0, 1.0, edd.NTABLE)), z,
                                  z)
            psi_rmax, r_max = t(0.0), t(1.0)
        rows.append(vel.VelocityTables(
            fE=SplineTable(t(df.spline.x), t(df.spline.y), t(df.spline.m2)),
            psi_gas=psi_gas, has_gas=torch.tensor(g is not None,
                                                  device=device),
            psi_rmax=psi_rmax, r_max=r_max, a_hernq=t(h.a_hernq),
            mass_dm=t(h.mass_dm), G=t(scene.units.G)))

    def stack(*xs):
        if isinstance(xs[0], SplineTable):
            return SplineTable(*(torch.stack(p) for p in zip(*xs)))
        return torch.stack(xs)
    return vel.VelocityTables(*(stack(*f) for f in zip(*rows)))


def _fields(vt):
    for name, f in zip(vt._fields, vt):
        if isinstance(f, SplineTable):
            yield from ((f"{name}.{k}", p) for k, p in zip(f._fields, f))
        else:
            yield name, f


def _assert_tables_match(got, ref):
    """Every field equal, but f(E)'s spline values and second
    derivatives, which the integral's other order of summation may move
    by one float32 ulp; a second derivative at the natural end, zero up
    to float64 rounding, by one ulp of its row's largest."""
    for (name, a), (_, b) in zip(_fields(got), _fields(ref)):
        assert a.dtype == b.dtype and a.shape == b.shape, name
        a, b = a.cpu().numpy(), b.cpu().numpy()
        if name not in ("fE.y", "fE.m2"):
            np.testing.assert_array_equal(a, b, err_msg=name)
            continue
        ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
        ulp = np.maximum(ulp, np.spacing(np.abs(b).max(axis=1,
                                                       keepdims=True)))
        assert (np.abs(a - b) <= ulp).all(), name


@pytest.mark.parametrize("dev", DEVICES, indirect=True)
def test_stacked_tables_match_the_host_tables(dev, scene):
    sp = Spans()
    got = vel.velocity_tables(scene, dev, spans=sp)
    _assert_tables_match(got, _host_tables(scene, dev))
    spans = sp.take()
    assert [(s["name"], s.get("part")) for s in spans] == [
        ("velocity_fE", "prepare"), ("velocity_fE_integral", None),
        ("velocity_fE", "finish")]
    assert spans[1]["halos"] == 51 and spans[1]["terms"] > 0


@pytest.fixture(scope="module")
def cpu_tables(scene):
    return vel.velocity_tables(scene, "cpu")


@pytest.mark.parametrize("i", [0, 1, 50])
def test_one_halo_tables_are_its_row_of_the_stack(scene, cpu_tables, i):
    """``build_velocity_tables`` (the sharded stage's) is the one-halo
    case of the same function: halo i alone gives its row of the stack,
    to the bit."""
    one = vel.build_velocity_tables(scene, i, "cpu")
    row = vel.halo_tables(cpu_tables, i)
    for (name, a), (_, b) in zip(_fields(one), _fields(row)):
        assert a.shape == b.shape and torch.equal(a, b), name


def test_dm_velocities_match_the_per_halo_path(monkeypatch):
    """make_velocities on a small config-4 scene (5 halos): with the
    tables of one integral call, against the same draw with each halo's
    host tables stacked; the DM velocities within float32 rounding, the
    gas ones equal, every halo's count and finiteness unchanged."""
    scene = _scene(100_000)
    assert scene.nhalos == 5
    ha = halo_arrays_from_scene(scene, "cpu")

    def run():
        gen = torch.Generator().manual_seed(scene.config.seed)
        parts = pos_mod.make_positions(gen, scene, ha)
        return vel.make_velocities(gen, scene, ha, parts), parts

    new, parts = run()
    monkeypatch.setattr(vel, "velocity_tables",
                        lambda sc, device, spans=None: _host_tables(sc,
                                                                    device))
    old, _ = run()
    n_gas = scene.npart_gas
    assert torch.equal(new.vel[:n_gas], old.vel[:n_gas])
    a, b = new.vel[n_gas:], old.vel[n_gas:]
    assert torch.isfinite(a).all() and torch.isfinite(b).all()
    torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5 * float(
        b.abs().max()))
    halo = parts.halo[n_gas:].long()
    assert torch.equal(torch.bincount(halo, minlength=scene.nhalos),
                       torch.tensor([h.npart_dm for h in scene.halos]))
    # the DM moves: the speeds are the sampler's, not the fallback's zero
    assert float((a - ha.bulk_vel[halo]).norm(dim=1).median()) > 0
