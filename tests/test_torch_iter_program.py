"""The WVT loop's iteration (``models/wvt.py``: ``_Loop.body`` and
``_Loop.iterate``), the counterpart of the JAX package's whole-iteration
program (``toycluster_tpu/models/wvt.py`` ``_get_iter_fn``), on the CPU.

The scene: the JAX make_positions at ntotal = 3,000 (1,500 gas), seed 5,
on both engines, WC6 (and M4 for the body).  The body with its
iteration index and margin as 0-d tensors against the iteration with
Python branches on them, to the bit; ``iterate`` (the Python margin and
index filled into the loop's 0-d scalars) against the body; outputs of
an earlier iteration that a later one leaves alone.

The pair kernels' plain versions are deterministic functions of their
inputs, so the tests memoise them on the bytes of every argument: a call
on bit-equal inputs returns the first call's outputs (and a call on
other inputs is computed)."""

import os
from functools import lru_cache, partial

import jax
import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.models import positions as jpos
from toycluster_tpu.particles import halo_arrays_from_scene
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu_torch import constants as const
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.from_reference import (halo_arrays_from_numpy,
                                                 particles_from_numpy)
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.models import wvt as twvt
from toycluster_tpu_torch.ops import blocks as tblk
from toycluster_tpu_torch.scene import build_scene

torch.set_num_threads(2)

PAR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "toycluster_tpu_torch", "data", "cluster.par")
SMALL = dict(ntotal=3000, sph_kernel="wc6")
ENGINES = ("stream", "classed")
CPU = torch.device("cpu")
F32 = torch.float32


@lru_cache(maxsize=None)
def _start():
    """(port halo arrays, port particles): the JAX start of the SMALL
    scene with pids 1..n_gas on the gas."""
    jscene = jax_build_scene(jax_parse(PAR, **SMALL))
    ha = halo_arrays_from_scene(jscene)
    parts = jpos.make_positions(jax.random.PRNGKey(5), jscene, ha)
    parts = jpos.shift_origin(parts, ha, jscene.boxsize)
    n_gas = parts.n_gas
    parts = parts._replace(pid=parts.pid.at[:n_gas].set(
        np.arange(1, n_gas + 1, dtype=np.uint32)))
    tparts = particles_from_numpy(
        {k: np.asarray(v) for k, v in parts._asdict().items()})
    tha = halo_arrays_from_numpy(
        {k: np.asarray(v) for k, v in ha._asdict().items()})
    return tha, tparts


def _port_scene(**more):
    return build_scene(parse_par_file(PAR, **{**SMALL, **more}))


# ------------------------------------------------------- memoised kernels

_MEMO: dict = {}


def _key(x):
    if torch.is_tensor(x):
        return (str(x.dtype), tuple(x.shape),
                x.detach().contiguous().numpy().tobytes())
    if isinstance(x, (tuple, list)):
        return tuple(_key(v) for v in x)
    return x


@pytest.fixture
def memo(monkeypatch):
    """The loop's pair kernels, memoised on their arguments' bytes."""
    for name in ("stream_wvt", "fused_wvt", "solve_density",
                 "wvt_displacement"):
        fn = getattr(twvt, name)

        def call(*args, _fn=fn, _name=name, **kw):
            k = (_name, _key(args), _key(sorted(kw.items())))
            if k not in _MEMO:
                _MEMO[k] = _fn(*args, **kw)
            return _MEMO[k]
        monkeypatch.setattr(twvt, name, call)


# ------------------------------------------------------------- the set-up

def _loop(engine, kernel="wc6"):
    tha, tparts = _start()
    return twvt._Loop(_port_scene(sph_kernel=kernel), tha, tparts.n_gas,
                      engine, CPU, lambda stage, **kw: None)


def _build(L, pos_gas):
    """A structure of ``pos_gas`` as the loop's first build makes it."""
    _, h0_model, h_box = L.model_fields(pos_gas)
    h_cap = torch.clamp(h0_model * tsph.CAP_FACTOR * 1.5, max=L.h_hard)
    build = (partial(tsph.build_neighbours, widths=L.widths)
             if L.engine == "stream" else tsph.build_neighbours_blocks)
    return build(pos_gas, h_cap, L.boxsize,
                 radius_sym_gas=h_box * L.boxsize * twvt.SYM_MARGIN)


@lru_cache(maxsize=None)
def _state(engine, kernel="wc6"):
    """(structure, loop arrays in its order): a warm h on half the lanes
    (the other half takes the cold margin), a predicted model density on
    those, a tenth of the lanes saturated, err_last 0 (so the step
    shrinks from it = 2 on)."""
    tha, tparts = _start()
    L = _loop(engine, kernel)
    n = tparts.n_gas
    state = _build(L, tparts.pos[:n].clone())
    pos_gas = state.index.pos[:n]
    rho_model, h0_model, _ = L.model_fields(pos_gas)
    rng = np.random.default_rng(0)
    warm = torch.from_numpy(rng.random(n) < 0.5)
    h_prev = torch.where(warm, h0_model * 1.1, torch.zeros_like(h0_model))
    rhom_prev = torch.where(warm, rho_model * 0.9, torch.zeros_like(h0_model))
    sat_mask = torch.from_numpy(rng.random(n) < 0.1)
    fac_gas = torch.full((n,), tsph.CAP_FACTOR, dtype=F32)
    step = torch.tensor(0.0085, dtype=F32)
    err_last = torch.tensor(0.0, dtype=F32)
    return state, (pos_gas, h_prev, rhom_prev, sat_mask, fac_gas, step,
                   err_last)


def _iterate(L, state, inputs, margin_w, it):
    pos_gas, h_prev, rhom_prev, sat_mask, fac_gas, step, err_last = inputs
    return L.iterate(state, pos_gas, h_prev, rhom_prev, sat_mask, margin_w,
                     fac_gas, step, err_last, it)


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------- the iteration with Python branches

def _python_iterate(L, state, pos_gas, h_prev, rhom_prev, sat_mask,
                    margin_w, fac_gas, step, err_last, it):
    """The iteration with the margin, the step shrink and the accept band
    chosen by Python branches on ``margin_w`` and ``it``."""
    n_gas = L.n_gas
    nb = state.index.n_blocks
    n_padded = nb * tblk.BLOCK

    def pad1(x):
        return tblk.pad_rows(x, n_padded)

    rho_model, h0_model, h_box = L.model_fields(pos_gas)
    h0 = torch.where(h_prev > 0, h_prev * twvt._warm_ratio(rho_model,
                                                           rhom_prev),
                     h0_model)
    valid = torch.arange(n_padded) < n_gas
    h0_s, hm_s = pad1(h0), pad1(h_box)
    hm_src = torch.where(valid, hm_s, torch.zeros_like(hm_s))
    h_cap_pad = state.h_cap
    if L.engine == "classed":
        cap_eff = h_cap_pad
        rho, hsml, vf, wk, done, delta = L.solve_classed(
            state, pad1(pos_gas), h0_s, cap_eff, hm_s, hm_src, valid)
    else:
        margin = torch.where(pad1(h_prev > 0),
                             torch.full_like(h0_s, margin_w),
                             torch.full_like(h0_s, twvt.BITS_MARGIN_COLD))
        cap_eff = torch.where(pad1(sat_mask), h_cap_pad,
                              torch.minimum(h_cap_pad, h0_s * margin))
        src, pos_t = tsph.source_blocks(pad1(pos_gas), hm_src)
        rho, hsml, vf, wk, done, delta = twvt.stream_wvt(
            src, state.cand.idx, state.cand.count, pos_t,
            h0_s.reshape(nb, tblk.BLOCK), cap_eff.reshape(nb, tblk.BLOCK),
            hm_s.reshape(nb, tblk.BLOCK), L.mpart, L.boxsize,
            kernel=L.kernel, desnngb=L.desnngb, do_disp=True)
    rho, hsml, vf, wk, done = (x.reshape(-1)
                               for x in (rho, hsml, vf, wk, done))
    delta = delta.reshape(-1, 3)
    growable = pad1(fac_gas < twvt.FAC_MAX * 0.999)
    saturated = (~done) | (hsml >= cap_eff * 0.999)
    still_growable = h_cap_pad < L.h_hard * 0.999
    n_sat_d = (valid & saturated & still_growable & growable).sum()
    err = torch.abs(rho[:n_gas] - rho_model) / rho_model
    drel = torch.where(valid, torch.linalg.vector_norm(delta, dim=1)
                       / torch.clamp(hm_s, min=1e-30), torch.zeros_like(hm_s))
    row_drel = drel.reshape(-1, tblk.BLOCK).amax(dim=1)
    n_contract = ((torch.abs(wk - L.desnngb) < const.NNGBDEV)
                  & valid).sum()
    err_mean = err.mean()
    err_diff = (err_last - err_mean) / err_mean
    step_new = (torch.where(err_diff < 0.01, step * 0.8, step)
                if it > 1 else step)
    pos_new = pos_gas + delta[:n_gas] * (step_new * L.boxsize)
    pos_new = pos_new - torch.floor(pos_new / L.boxsize) * L.boxsize
    band = (twvt._accept_band(n_gas, 0) if it < 3
            else twvt._accept_band(n_gas))
    accept = (n_sat_d > 0) & (n_sat_d <= band)
    fac_new = torch.where(
        accept & (hsml[:n_gas] >= h_cap_pad[:n_gas] * 0.999),
        torch.clamp(fac_gas * 1.6, max=twvt.FAC_MAX), fac_gas)
    scalars = torch.stack([x.to(torch.float64) for x in (
        err.max(), err_mean, n_sat_d, drel.max(),
        twvt.percentile(row_drel, 99.9), n_contract, step_new)])
    return dict(rho=rho[:n_gas], hsml=hsml[:n_gas], vf=vf[:n_gas],
                pos_new=pos_new, rho_model=rho_model, err_mean=err_mean,
                step_new=step_new, fac_new=fac_new,
                saturated=saturated[:n_gas], scalars=scalars)


@pytest.mark.parametrize("it", [0, 1, 2, 3, 5])
@pytest.mark.parametrize("margin_w", [1.02, 1.25])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("kernel", ["wc6", "m4"])
def test_body_with_device_scalars_equals_python_branches(memo, kernel,
                                                         engine, margin_w,
                                                         it):
    """``body`` with the index and the margin as 0-d tensors, against
    the Python branches, every output to the bit, with each SPH kernel;
    the step shrinks from it = 2 on."""
    state, inputs = _state(engine, kernel)
    pos_gas, h_prev, rhom_prev, sat_mask, fac_gas, step, err_last = inputs
    L = _loop(engine, kernel)
    assert L.kernel == kernel
    sels = L.selections(state) if engine == "classed" else None
    got = L.body(state, sels, pos_gas, h_prev, rhom_prev, sat_mask,
                 torch.tensor(margin_w, dtype=F32), fac_gas, step, err_last,
                 torch.tensor(it, dtype=torch.int32))
    ref = _python_iterate(L, state, pos_gas, h_prev, rhom_prev, sat_mask,
                          margin_w, fac_gas, step, err_last, it)
    _equal(got, ref)
    assert torch.equal(got["step_new"], step * 0.8 if it > 1 else step)


# ------------------------------------------------------------- the one path

@pytest.mark.parametrize("engine", ENGINES)
def test_first_run_eager_then_program_same_bits(memo, engine):
    """``iterate`` at a Python margin and index fills them into the
    loop's 0-d scalars and runs ``body`` on them: every output equal to
    ``body`` on the same scalars to the bit, in one ``wvt_step`` span of
    kind "eager"."""
    state, inputs = _state(engine)
    L = _loop(engine)
    got = _iterate(L, state, inputs, 1.02, 3)
    assert L.it_d.dtype == torch.int32 and int(L.it_d) == 3
    assert L.margin_d.dtype == F32
    assert float(L.margin_d) == float(np.float32(1.02))
    sels = L.selections(state) if engine == "classed" else None
    ref = L.body(state, sels, *inputs[:4], torch.tensor(1.02, dtype=F32),
                 *inputs[4:], torch.tensor(3, dtype=torch.int32))
    _equal(got, ref)
    assert [(s["name"], s["it"], s["kind"]) for s in L.spans.take()] == [
        ("wvt_step", 3, "eager")]


@pytest.mark.parametrize("engine", ENGINES)
def test_earlier_outputs_survive_a_later_run(memo, engine):
    """A later iteration (another index, so another step and move, with
    the loop's 0-d scalars filled anew) leaves an earlier one's outputs
    alone: none of them is a view of those scalars or of the inputs, as
    an iteration queued ahead (``speculate``) needs."""
    state, inputs = _state(engine)
    L = _loop(engine)
    first = _iterate(L, state, inputs, 1.02, 1)
    kept = {k: v.clone() for k, v in first.items()}
    later = _iterate(L, state, inputs, 1.25, 5)
    _equal(first, kept)
    held = {x.data_ptr() for x in inputs + (L.it_d, L.margin_d)}
    for k, v in first.items():
        assert v.data_ptr() not in held, k
    assert not torch.equal(first["step_new"], later["step_new"])
    assert not torch.equal(first["pos_new"], later["pos_new"])
