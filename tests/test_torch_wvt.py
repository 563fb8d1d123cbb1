"""The port's WVT loop and density solve against the JAX package's
stream engine (TOYCLUSTER_ENGINE=pallas, the Pallas kernel in interpret
mode, as tests/test_wvt.py:178-182 runs it), from the same initial
positions: the JAX make_positions at ntotal = 3000, M4 kernel.  Bounds
of tests/test_wvt.py:120-127: err_mean trajectory rtol 2e-2, periodic
position difference < 2e-3 box, rho rtol 2e-2 (pid-matched)."""

import os
from functools import partial

import jax
import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.models import positions as jpos
from toycluster_tpu.models import sph as jsph
from toycluster_tpu.models import wvt as jwvt
from toycluster_tpu.ops import pallas_pair
from toycluster_tpu.particles import halo_arrays_from_scene
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu_torch.from_reference import (halo_arrays_from_numpy,
                                                 particles_from_numpy)
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.models import wvt as twvt
from toycluster_tpu_torch.scene import build_scene
from toycluster_tpu_torch.config import parse_par_file

torch.set_num_threads(2)

PAR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "toycluster_tpu_torch", "data", "cluster.par")


@pytest.fixture(scope="module")
def start():
    over = dict(ntotal=3000, wvt_max_iter=3, sph_kernel="m4")
    jscene = jax_build_scene(jax_parse(PAR, **over))
    ha = halo_arrays_from_scene(jscene)
    parts = jpos.make_positions(jax.random.PRNGKey(5), jscene, ha)
    parts = jpos.shift_origin(parts, ha, jscene.boxsize)
    n_gas = parts.n_gas
    # real ids before the relaxation, so final states match by particle
    parts = parts._replace(pid=parts.pid.at[:n_gas].set(
        np.arange(1, n_gas + 1, dtype=np.uint32)))
    tscene = build_scene(parse_par_file(PAR, **over))
    tparts = particles_from_numpy(
        {k: np.asarray(v) for k, v in parts._asdict().items()})
    tha = halo_arrays_from_numpy(
        {k: np.asarray(v) for k, v in ha._asdict().items()})
    return jscene, ha, parts, tscene, tha, tparts


@pytest.fixture
def pallas_engine(monkeypatch):
    monkeypatch.setenv("TOYCLUSTER_ENGINE", "pallas")
    monkeypatch.setattr(
        pallas_pair, "stream_wvt_pallas",
        partial(pallas_pair.stream_wvt_pallas, interpret=True))


def _by_pid(pid, *arrays):
    order = np.argsort(np.asarray(pid))
    return [np.asarray(a)[order] for a in arrays]


def test_wvt_loop_matches_jax(start, pallas_engine):
    jscene, ha, parts, tscene, tha, tparts = start
    errs_j, errs_t = [], []

    def logger(errs):
        def log(stage, **kw):
            if stage == "wvt":
                errs.append(kw["err_mean"])
        return log

    ref = jwvt.regularise_sph_particles(jscene, ha, parts,
                                        log=logger(errs_j))
    got, _fresh = twvt.regularise_sph_particles(tscene, tha, tparts,
                                                log=logger(errs_t))
    assert len(errs_t) == len(errs_j) >= 3
    np.testing.assert_allclose(errs_t, errs_j, rtol=2e-2)
    n = ref.n_gas
    pj, rj = _by_pid(ref.pid[:n], ref.pos[:n], ref.rho)
    pt, rt = _by_pid(got.pid[:n].numpy(), got.pos[:n].numpy(),
                     got.rho.numpy())
    box = jscene.boxsize
    d = np.abs(pt - pj)
    d = np.minimum(d, box - d)
    assert d.max() < 2e-3 * box
    np.testing.assert_allclose(rt, rj, rtol=2e-2)
    # the DM half is untouched and ids stay a permutation
    np.testing.assert_array_equal(got.pos[n:].numpy(),
                                  np.asarray(ref.pos[n:]))
    assert sorted(got.pid.tolist()) == sorted(np.asarray(ref.pid).tolist())


def test_find_sph_quantities_matches_jax(start, pallas_engine):
    """The stand-alone density solve (sph.c:13-75): same sort, rho and
    hsml within the stream-kernel tolerance, and the neighbour
    contract."""
    jscene, ha, parts, tscene, tha, tparts = start
    ref = jsph.find_sph_quantities(jscene, ha, parts)
    jfrac = jsph.last_contract_frac
    got, state = tsph.find_sph_quantities(tscene, tha, tparts,
                                          return_state=True)
    n = ref.n_gas
    np.testing.assert_array_equal(got.pid[:n].numpy(),
                                  np.asarray(ref.pid[:n]))
    ok = (np.isclose(got.hsml.numpy(), np.asarray(ref.hsml), rtol=2e-3)
          & np.isclose(got.rho.numpy(), np.asarray(ref.rho), rtol=2e-3))
    assert ok.mean() > 0.98
    assert abs(tsph.last_contract_frac - jfrac) < 2e-3
    assert tsph.last_contract_frac > 0.99
    assert torch.equal(state.index.order, torch.arange(n))
