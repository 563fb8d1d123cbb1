"""The model density's wrapper (``ops/density_model.py``) on the CPU: its
plain version against the per-halo loop it replaced in
``sph.global_density_model``, bit for bit, over every branch; the packed
table against the plain version's own terms; its argument checks; and
the WVT loop handing it the halo subset, the static beta and its table.
The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
No JAX.
"""

import dataclasses
from functools import lru_cache

import numpy as np
import pytest
import torch

from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.models import wvt as twvt
from toycluster_tpu_torch.models.substructure import setup_substructure
from toycluster_tpu_torch.ops import cusp
from toycluster_tpu_torch.ops import density_model as dm
from toycluster_tpu_torch.particles import gas_density, halo_arrays_from_scene
from toycluster_tpu_torch.run_configs import PAR, PRESETS
from toycluster_tpu_torch.scene import build_scene

# the cool-core factors of chip_smoke.py's variant (Rho0_Fac, Rc_Fac)
COOL = (50.0, 40.0)
N = 20_000


@lru_cache(maxsize=None)
def _scene(preset):
    cfg = parse_par_file(str(PAR), **PRESETS[preset])
    scene = build_scene(cfg)
    if cfg.substructure:
        scene = setup_substructure(scene, seed=cfg.seed + 7)
    return scene


@lru_cache(maxsize=None)
def _config4():
    """Config 4's 51 halos (betas 0.54 and 2/3), every third one given a
    cool core."""
    scene = _scene(4)
    ha = halo_arrays_from_scene(scene, "cpu")
    cuspy = (torch.arange(ha.n_halos) % 3 == 0).to(torch.float32)
    return scene, dataclasses.replace(ha, have_cuspy=cuspy)


def _old_loop(pos_box, ha, boxsize, cool_core=None, beta=None, halos=None):
    """``sph.global_density_model`` as it was: a halo at a time."""
    boxhalf = boxsize / 2.0
    rho = torch.zeros_like(pos_box[..., 0])
    for j in dm.gas_halos(ha) if halos is None else halos:
        r = torch.linalg.vector_norm(pos_box - (ha.d_com[j] + boxhalf),
                                     dim=-1)
        rho = torch.maximum(rho, gas_density(r, ha, j, cool_core, beta=beta))
    return rho


@pytest.mark.parametrize("subset", [False, True])
@pytest.mark.parametrize("cool_core", [None, COOL])
@pytest.mark.parametrize("beta", [None, 2.0 / 3.0, 0.54])
def test_plain_path_equals_the_old_loop(beta, cool_core, subset):
    scene, ha = _config4()
    halos = dm.gas_halos(ha)[1::4] if subset else None
    pos = cusp.model_points(ha, scene.boxsize, N)
    want = _old_loop(pos, ha, scene.boxsize, cool_core, beta, halos)
    got = tsph.global_density_model(pos, ha, scene.boxsize, cool_core,
                                    beta=beta, halos=halos)
    assert (want > 0).all()
    assert torch.equal(got, want)
    table = dm.model_table(ha, scene.boxsize, halos or dm.gas_halos(ha),
                           cool_core, beta)
    assert torch.equal(dm.density_model(pos, ha, scene.boxsize, cool_core,
                                        beta=beta, halos=halos, table=table),
                       want)


@pytest.mark.parametrize("cool_core", [None, COOL])
@pytest.mark.parametrize("beta", [None, 2.0 / 3.0, 0.54])
def test_table_holds_the_plain_versions_terms(beta, cool_core):
    """Each column is the value the plain version computes from the same
    halo with the same PyTorch op."""
    scene, ha = _config4()
    halos = dm.gas_halos(ha)[::2]
    t = dm.model_table(ha, scene.boxsize, halos, cool_core, beta)
    assert t.tab.dtype == torch.float32
    assert t.tab.shape == (len(halos), len(dm.COLUMNS))
    assert t.recip == (beta == 2.0 / 3.0) and t.cool == (cool_core is not None)
    boxhalf = scene.boxsize / 2.0
    col = {name: t.tab[:, k] for k, name in enumerate(dm.COLUMNS)}
    for i, j in enumerate(halos):
        c = ha.d_com[j] + boxhalf
        assert torch.equal(torch.stack([col["cx"][i], col["cy"][i],
                                        col["cz"][i]]), c)
        for name in ("rcut", "rcore", "rho0"):
            assert torch.equal(col[name][i], getattr(ha, name)[j])
        if beta is None:
            assert torch.equal(col["expo"][i], -1.5 * ha.beta[j])
        elif not t.recip:
            # the Python float rounded to float32, as PyTorch's pow takes it
            assert col["expo"][i].item() == float(np.float32(-1.5 * beta))
        if cool_core is not None:
            assert torch.equal(col["cuspy"][i], ha.have_cuspy[j])
            assert torch.equal(col["rho_cc"][i], ha.rho0[j] * COOL[0])
            assert torch.equal(col["rc_cc"][i], ha.rcore[j] / COOL[1])


def _bad_calls():
    """(what, call) pairs that the wrapper refuses with a ValueError."""
    scene, ha = _config4()
    box = scene.boxsize
    pos = cusp.model_points(ha, box, 64)
    halos = dm.gas_halos(ha)
    other = dm.model_table(ha, box, halos[:3])
    meta = dataclasses.replace(ha, d_com=ha.d_com.to("meta"))
    return {
        "float64": lambda: dm.density_model(pos.double(), ha, box),
        "shape (n, 2)": lambda: dm.density_model(pos[:, :2].contiguous(),
                                                 ha, box),
        "shape (n,)": lambda: dm.density_model(pos[:, 0].contiguous(), ha,
                                               box),
        "strided": lambda: dm.density_model(pos[::2], ha, box),
        "device": lambda: dm.density_model(pos.to("meta"), ha, box),
        "other device": lambda: dm.density_model(pos.to("meta"), meta, box,
                                                 halos=halos),
        "table": lambda: dm.density_model(pos, ha, box, halos=halos,
                                          table=other),
    }


@pytest.mark.parametrize("what", ["float64", "shape (n, 2)", "shape (n,)",
                                  "strided", "device", "other device",
                                  "table"])
def test_wrapper_refuses_bad_arguments(what):
    with pytest.raises(ValueError):
        _bad_calls()[what]()


@pytest.mark.parametrize("preset,subset", [(3, False), (4, False),
                                           (4, True)])
def test_loop_hands_on_halos_beta_and_table(preset, subset, monkeypatch):
    """``_Loop.model_fields`` gives the wrapper the gas halos it read once
    (a subset where some halos hold no gas), the scene's static beta (0.54
    for config 3, None for config 4's mixed betas) and the table it built
    once, and its density is the old loop's."""
    scene = _scene(preset)
    ha = halo_arrays_from_scene(scene, "cpu")
    if subset:
        ha = dataclasses.replace(
            ha, mass_gas=torch.where(torch.arange(ha.n_halos) % 5 == 2,
                                     0.0, ha.mass_gas))
    L = twvt._Loop(scene, ha, N, "stream", torch.device("cpu"))
    want_halos = tuple(j for j in range(ha.n_halos)
                       if float(ha.mass_gas[j]) > 0)
    assert L.gas_halos == want_halos
    assert L.beta == tsph.uniform_beta(scene) == (0.54 if preset == 3
                                                  else None)
    seen = []

    def spy(*args, **kw):
        seen.append(kw)
        return dm.density_model(*args, **kw)
    monkeypatch.setattr(tsph, "density_model", spy)
    pos = cusp.model_points(ha, scene.boxsize, N)
    rho = L.model_fields(pos)[0]
    (kw,) = seen
    assert kw["halos"] == want_halos and kw["beta"] == L.beta
    assert kw["table"] is L.model_table
    assert L.model_table.key == (want_halos, L.cool_core, L.beta,
                                 L.boxsize)
    assert torch.equal(rho, _old_loop(pos, ha, scene.boxsize, L.cool_core,
                                      L.beta, want_halos))
