"""The plain reference (``benchref``) on tiny cases, on the CPU: the
kernels' norm and derivative, the direct sums against an explicit loop,
the neighbour count on a lattice, the model density, the curl, and the
frozen scene against the program's own set-up.

    python3 -m pytest h100_bench/tests -q
"""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchref import scene as ref_scene  # noqa: E402
from benchref import sph as ref  # noqa: E402

F64 = torch.float64


@pytest.mark.parametrize("kind", ["wc6", "m4"])
def test_kernel_integrates_to_one_and_its_derivative(kind):
    h = torch.tensor(1.7, dtype=F64)
    r = torch.linspace(0, 1.7, 200_001, dtype=F64)
    w, dw = ref.kernel(kind, r, h)
    assert float(torch.trapezoid(4 * math.pi * r**2 * w, r)) == \
        pytest.approx(1.0, abs=1e-6)
    eps = 1e-6
    rr = torch.linspace(0.01, 1.69, 97, dtype=F64)
    fd = (ref.kernel(kind, rr + eps, h)[0]
          - ref.kernel(kind, rr - eps, h)[0]) / (2 * eps)
    assert torch.allclose(ref.kernel(kind, rr, h)[1], fd, rtol=1e-5,
                          atol=1e-8)


def _loop_density(pos, h, box, mpart, desnngb, kind):
    """The same sums by an explicit loop over pairs."""
    n = len(pos)
    rho, wk, vf = np.zeros(n), np.zeros(n), np.zeros(n)
    for i in range(n):
        sw = sdh = 0.0
        for j in range(n):
            d = pos[i] - pos[j]
            d -= box * np.round(d / box)
            r = float(np.sqrt((d * d).sum()))
            w, dw = (float(x) for x in ref.kernel(
                kind, torch.tensor(r, dtype=F64), torch.tensor(h[i],
                                                                dtype=F64)))
            sw += w
            sdh += 3.0 / h[i] * w + r / h[i] * dw
        rho[i] = mpart * sw
        wk[i] = 4.0 * math.pi / 3.0 * h[i] ** 3 * sw
        vf[i] = 1.0 / (1.0 - h[i] / (3.0 * rho[i]) * mpart * sdh)
        if kind == "wc6":
            rho[i] += float(ref.wc6_self_term(torch.tensor(h[i], dtype=F64),
                                              mpart, desnngb))
    return rho, wk, vf


@pytest.mark.parametrize("kind", ["wc6", "m4"])
def test_direct_sums_match_an_explicit_loop(kind):
    rng = np.random.default_rng(5)
    box = 10.0
    pos = rng.random((400, 3)) * box
    h = 3.0 + rng.random(400)
    q = slice(0, 12)
    rho, wk, vf = ref.density(torch.tensor(pos[q]), torch.tensor(h[q]),
                              torch.tensor(pos), box, 0.3, 295, kind,
                              chunk=17)
    want = _loop_density(pos, h, box, 0.3, 295, kind)
    for got, w in zip((rho, wk, vf), want):
        np.testing.assert_allclose(got.numpy(), w[q], rtol=1e-12)


def test_neighbour_count_on_a_lattice():
    """On a periodic cubic lattice of spacing 1, h with 4 pi / 3 h^3 =
    295 gives wkNgb = 295 to the lattice's discreteness."""
    n = 16
    g = torch.arange(n, dtype=F64)
    pos = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1).reshape(-1, 3)
    h = (295 / (4 * math.pi / 3)) ** (1 / 3)
    q = pos[:5] + 0.25
    _, wk, _ = ref.density(q, torch.full((5,), h, dtype=F64), pos, float(n),
                           1.0, 295, "wc6")
    assert torch.allclose(wk, torch.full_like(wk, 295.0), rtol=5e-3)


def test_model_density_is_the_largest_halo():
    halos = [dict(center=(0.0, 0.0, 0.0), rho0=2.0, rcore=1.0, rcut=50.0,
                  beta=0.54, cuspy=False),
             dict(center=(10.0, 0.0, 0.0), rho0=1.0, rcore=2.0, rcut=50.0,
                  beta=2 / 3, cuspy=False)]
    box = 100.0
    pos = torch.tensor([[50.0, 50.0, 50.0], [60.0, 50.0, 50.0],
                        [55.0, 50.0, 50.0]], dtype=F64)
    rho = ref.model_density(pos, halos, box)
    r10 = torch.tensor(10.0, dtype=F64)
    # each centre: its own halo's rho0 (the other's tail is lower)
    assert float(rho[0]) == pytest.approx(2.0, rel=1e-12)
    assert float(rho[1]) == pytest.approx(1.0, rel=1e-12)
    assert float(ref.halo_density(r10, halos[0])) < 1.0
    assert float(ref.halo_density(r10, halos[1])) < 2.0
    assert torch.equal(ref.model_density(pos, halos[:1], box),
                       ref.halo_density(torch.tensor([0.0, 10.0, 5.0],
                                                     dtype=F64), halos[0]))
    a = ref.vector_potential(pos, halos, box, 0.5)
    assert float(a[0]) == pytest.approx(1.0)
    assert float(a[1]) == pytest.approx(1.0)
    assert 0 < float(a[2]) < 1


def test_curl_of_a_constant_potential_vanishes_and_matches_a_loop():
    rng = np.random.default_rng(9)
    box = 8.0
    pos = torch.tensor(rng.random((80, 3)) * box)
    h = torch.full((80,), 2.0, dtype=F64)
    rho, _, vf = ref.density(pos, h, pos, box, 1.0, 295, "wc6")
    const = torch.full((80,), 3.0, dtype=F64)
    assert float(ref.curl(pos, h, rho, vf, const, pos, const, box, 1.0,
                          "wc6").abs().max()) == 0.0
    a = pos[:, 0] ** 2 / 10
    got = ref.curl(pos[:4], h[:4], rho[:4], vf[:4], a[:4], pos, a, box, 1.0,
                   "wc6", chunk=13)
    for i in range(4):
        b = torch.zeros(3, dtype=F64)
        for j in range(80):
            d = pos[i] - pos[j]
            d = d - box * torch.round(d / box)
            r = torch.linalg.vector_norm(d)
            if not 0 < r < h[i]:
                continue
            dw = ref.kernel("wc6", r, h[i])[1]
            da = (a[i] - a[j]).repeat(3)
            b += dw / r * torch.linalg.cross(da, d)
        b *= -1.0 * vf[i] / rho[i]
        assert torch.allclose(got[i], b, rtol=1e-10, atol=1e-14)


@pytest.mark.parametrize("preset", [
    dict(ntotal=10_000_000, mass_ratio=1.0, zero_e_orbit_frac=1.0,
         orbit="comet"),
    dict(ntotal=10_000_000, mass_ratio=1.0 / 3.0, substructure=True),
])
def test_frozen_scene_matches_the_program(preset):
    """The copy of the set-up builds the program's scene, subhalos and
    all, from the same par and seed."""
    from toycluster_tpu_torch.config import parse_par_file
    from toycluster_tpu_torch.models.substructure import setup_substructure
    from toycluster_tpu_torch.scene import build_scene
    par = HERE.parent / "toycluster_tpu_torch" / "data" / "cluster.par"
    seed = 2**31 + 11
    mine = ref_scene.build(par, {**preset, "seed": seed})
    cfg = parse_par_file(str(par), **preset, seed=seed)
    theirs = build_scene(cfg)
    if cfg.substructure:
        theirs = setup_substructure(theirs, seed=seed + 7)
    assert mine.nhalos == theirs.nhalos
    for k in ("boxsize", "mpart_gas", "npart_gas", "npart_dm", "sub_first"):
        assert getattr(mine, k) == getattr(theirs, k)
    for a, b in zip(mine.halos, theirs.halos):
        for k in ("d_com", "rho0", "rcore", "rcut", "beta", "mass_gas",
                  "have_cuspy", "npart_gas"):
            assert getattr(a, k) == getattr(b, k)


@pytest.mark.parametrize("name", ["config3-merger-1e7", "config4-sub-1e7"])
def test_frozen_scene_matches_the_jax_record(name, tmp_path):
    """The copy of the set-up against a second witness: the JAX
    package's host scene of the same configuration, recorded once on the
    CPU in ``fixtures/jax_scenes.json`` (box, particle masses and counts,
    every halo's centre, gas and DM profile, sampling radius and
    counts)."""
    import json
    from benchlib.main import par_text
    conf = json.loads((HERE / "configs" / f"{name}.json").read_text())
    want = json.loads((HERE / "tests" / "fixtures"
                       / "jax_scenes.json").read_text())[name]
    par = tmp_path / "run.par"
    par.write_text(par_text(conf["par"]))
    mine = ref_scene.build(par, conf["overrides"])
    for k in ("boxsize", "mpart_gas", "mpart_dm"):
        assert getattr(mine, k) == pytest.approx(want[k], rel=1e-12)
    for k in ("npart_gas", "npart_dm", "sub_first"):
        assert getattr(mine, k) == want[k]
    assert mine.units.G == pytest.approx(want["G"], rel=1e-12)
    assert len(mine.halos) == len(want["halos"])
    for h, w in zip(mine.halos, want["halos"]):
        assert list(h.d_com) == pytest.approx(w["d_com"], rel=1e-12,
                                              abs=1e-9)
        for k in ("rho0", "rcore", "rcut", "beta", "r_sample_gas",
                  "mass_dm", "a_hernq", "mass_gas"):
            assert getattr(h, k) == pytest.approx(w[k], rel=1e-12), k
        for k in ("have_cuspy", "is_stripped", "npart_gas", "npart_dm"):
            assert getattr(h, k) == w[k], k


def test_internal_energy_matches_the_closed_form_of_beta_two_thirds():
    """u(r) of an untapered beta = 2/3 gas in a Hernquist halo against
    Donnert+2016's closed form (temperature.c:51-83)."""
    from benchref import hydro
    rho0, rc, a, mdm, G, box = 3e-3, 40.0, 300.0, 8e4, 43007.1, 2000.0
    halo = dict(rho0=rho0, rcore=rc, rcut=1e12, beta=2.0 / 3.0, cuspy=False,
                r_sample_gas=1e12, mass_dm=mdm, a_hernq=a)
    rmax = box * math.sqrt(3.0)

    def f1(x):
        rc2, a2 = rc * rc, a * a
        res = ((a2 - rc2) * np.arctan(x / rc) - rc * (a2 + rc2) / (a + x)
               + a * rc * np.log((a + x) ** 2 / (rc2 + x * x)))
        return res * rc / (a2 + rc2) ** 2

    def f2(x):
        return np.arctan(x / rc) ** 2 / (2 * rc) + np.arctan(x / rc) / x

    r = np.geomspace(1.0, 2500.0, 40)
    want = (G / (hydro.GAMMA - 1.0) * (1.0 + (r / rc) ** 2)
            * (mdm * (f1(rmax) - f1(r))
               + 4.0 * math.pi * rho0 * rc ** 3 * (f2(rmax) - f2(r))))
    got = hydro.internal_energy(halo, r, boxsize=box, G=G,
                                no_rcut_in_t=False)
    np.testing.assert_allclose(got, want, rtol=2e-6)


def test_dm_mean_square_speed_matches_hernquist():
    """The Jeans <v^2>(r) of a Hernquist halo alone against Hernquist
    (1990) eq. 10, three times the radial dispersion."""
    from benchref import hydro
    m, a, G = 5e4, 250.0, 43007.1
    halo = dict(mass_dm=m, a_hernq=a, r_sample_gas=1.0, has_gas=False)
    # x up to 10: beyond, the closed form cancels in float64
    r = np.geomspace(0.5, 2500.0, 40)
    x = r / a
    sig2 = G * m / (12 * a) * (12 * x * (1 + x) ** 3 * np.log((1 + x) / x)
                               - x / (1 + x) * (25 + 52 * x + 42 * x * x
                                                + 12 * x ** 3))
    got = hydro.dm_mean_square_speed(halo, r, G=G)
    np.testing.assert_allclose(got, 3 * sig2, rtol=1e-5)


def test_gas_owner_is_the_densest_holding_halo():
    from benchref import hydro
    halos = [dict(center=(0.0, 0.0, 0.0), rho0=2.0, rcore=1.0, rcut=50.0,
                  beta=0.54, cuspy=False, r_sample_gas=20.0, stripped=False),
             dict(center=(10.0, 0.0, 0.0), rho0=1.0, rcore=2.0, rcut=50.0,
                  beta=2 / 3, cuspy=False, r_sample_gas=5.0, stripped=False),
             dict(center=(-10.0, 0.0, 0.0), rho0=9.0, rcore=2.0, rcut=50.0,
                  beta=2 / 3, cuspy=False, r_sample_gas=5.0, stripped=True)]
    box = 100.0
    pos = np.array([[50.0, 50, 50], [60.0, 50, 50], [40.0, 50, 50],
                    [50.0, 90, 50], [200.0, 50, 50]])
    owner, _, _, _ = hydro.gas_owner(pos, halos, box)
    # halo 0 at its centre; halo 1 at its centre; the stripped halo's
    # centre goes to halo 0; a point no halo holds, to halo 0; past the
    # box, -1
    assert owner.tolist() == [0, 1, 0, 0, -1]
