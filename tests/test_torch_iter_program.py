"""The WVT loop's iteration programs (``models/wvt.py``: ``_Loop.body``,
``_IterProgram``, ``_Loop.make_program``, ``_Loop.programs``), the
counterpart of the JAX package's whole-iteration program
(``toycluster_tpu/models/wvt.py`` ``_get_iter_fn``, ``_ITER_FN_CACHE``),
on the CPU, where a program runs the body on its static buffers.

The scene: the JAX make_positions at ntotal = 3,000 (1,500 gas), WC6,
seed 5, on both engines.  The body with its iteration index and margin
as 0-d tensors against the iteration with Python branches on them (the
loop before the programs), to the bit; outputs of an earlier run that a
later run leaves alone; when a program is made, reused and left alone;
the speculation window, which may not make one; and whole relaxations
with the programs on and off, equal to the bit.

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
    return build_scene(parse_par_file(PAR, **SMALL, **more))


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

def _loop(engine, log=None):
    tha, tparts = _start()
    return twvt._Loop(_port_scene(), tha, tparts.n_gas, engine, CPU,
                      log or (lambda stage, **kw: None))


def _build(L, pos_gas):
    """A structure of ``pos_gas`` as the loop's first build makes it."""
    _, h0_model, h_box = L.model_fields(pos_gas)
    h_cap = torch.clamp(h0_model * tsph.CAP_FACTOR * 1.5, max=L.h_hard)
    build = (partial(tsph.build_neighbours, widths=L.widths)
             if L.engine == "stream" else tsph.build_neighbours_blocks)
    return build(pos_gas, h_cap, L.boxsize,
                 radius_sym_gas=h_box * L.boxsize * twvt.SYM_MARGIN)


@lru_cache(maxsize=None)
def _state(engine):
    """(structure, loop arrays in its order): a warm h on half the lanes
    (the other half takes the cold margin), a predicted model density on
    those, a tenth of the lanes saturated, err_last 0 (so the step
    shrinks from it = 2 on)."""
    tha, tparts = _start()
    L = _loop(engine)
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


def _programs(L):
    return list(L.programs.values())


def _equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert torch.equal(a[k], b[k]), k


# ---------------------------------------- the iteration with Python branches

def _python_iterate(L, state, pos_gas, h_prev, rhom_prev, sat_mask,
                    margin_w, fac_gas, step, err_last, it):
    """The iteration as the loop ran it before the programs: the margin,
    the step shrink and the accept band chosen by Python branches on
    ``margin_w`` and ``it``."""
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
def test_body_with_device_scalars_equals_python_branches(memo, engine,
                                                         margin_w, it):
    """``body`` with the index and the margin as 0-d tensors, against
    the Python branches, every output to the bit; the step shrinks from
    it = 2 on."""
    state, inputs = _state(engine)
    pos_gas, h_prev, rhom_prev, sat_mask, fac_gas, step, err_last = inputs
    L = _loop(engine)
    sels = L.selections(state) if engine == "classed" else None
    got = L.body(state, sels, pos_gas, h_prev, rhom_prev, sat_mask,
                 torch.tensor(margin_w, dtype=F32), fac_gas, step, err_last,
                 torch.tensor(it, dtype=torch.int32))
    ref = _python_iterate(L, state, pos_gas, h_prev, rhom_prev, sat_mask,
                          margin_w, fac_gas, step, err_last, it)
    _equal(got, ref)
    assert torch.equal(got["step_new"], step * 0.8 if it > 1 else step)


# ------------------------------------------------- making and reusing them

@pytest.mark.parametrize("engine", ENGINES)
def test_first_run_eager_then_program_same_bits(memo, engine):
    """The first iteration of a shape runs eagerly and makes the program;
    the program's run on the same inputs gives the same bits, on its
    static buffers (the inputs and the dynamic scalars copied in)."""
    state, inputs = _state(engine)
    L = _loop(engine)
    eager = _iterate(L, state, inputs, 1.02, 3)
    assert (L.captured, L.replayed, L.eager) == (1, 0, 0)
    (prog,) = _programs(L)
    assert prog.graph is None       # the CPU runs the body on the buffers
    again = _iterate(L, state, inputs, 1.02, 3)
    assert (L.captured, L.replayed) == (1, 1)
    _equal(again, eager)
    for buf, x in zip(prog.inputs, inputs):
        assert torch.equal(buf, x) and buf is not x
    assert int(prog.it) == 3 and float(prog.margin) == float(np.float32(1.02))
    assert torch.equal(prog.lists[0], state.cand.idx)


@pytest.mark.parametrize("engine", ENGINES)
def test_earlier_outputs_survive_a_later_run(memo, engine):
    """Outputs are cloned out: a later run of the same program (another
    index, so another step and move) leaves an earlier run's alone."""
    state, inputs = _state(engine)
    L = _loop(engine)
    _iterate(L, state, inputs, 1.02, 1)
    first = _iterate(L, state, inputs, 1.02, 1)
    kept = {k: v.clone() for k, v in first.items()}
    later = _iterate(L, state, inputs, 1.02, 5)
    assert (L.captured, L.replayed) == (1, 2)
    _equal(first, kept)
    (prog,) = _programs(L)
    for k, v in first.items():
        assert v.data_ptr() not in {b.data_ptr() for b in prog.inputs}
    assert not torch.equal(first["step_new"], later["step_new"])
    assert not torch.equal(first["pos_new"], later["pos_new"])


@pytest.mark.parametrize("engine", ENGINES)
def test_index_and_margin_make_no_new_program(memo, engine):
    """Iterations at other indices and margins run the one program."""
    state, inputs = _state(engine)
    L = _loop(engine)
    for it, margin_w in ((0, 1.25), (1, 1.02), (2, 1.1), (3, 1.02)):
        _iterate(L, state, inputs, margin_w, it)
    assert (L.captured, L.replayed, L.eager) == (1, 3, 0)
    assert len(_programs(L)) == 1


def test_refresh_at_the_same_width_reuses_the_program(memo):
    """Stream engine: a list refresh at the same trimmed width runs the
    program (its lists copied in), a wider list makes a new one, with
    the same bits (the -1 padding is not read)."""
    state, inputs = _state("stream")
    L = _loop("stream")
    out = _iterate(L, state, inputs, 1.02, 0)
    pos2 = out["pos_new"]
    hm_w = (twvt._metric_hsml(out["rho_model"], L.mpart, L.desnngb)
            * L.boxsize * twvt.SYM_MARGIN)
    s2 = tsph.refresh_candidates(state, pos2, hm_w, L.boxsize,
                                 widths=L.widths)
    assert s2.max_cand == state.max_cand
    inputs2 = (pos2, out["hsml"], out["rho_model"]) + inputs[3:]
    ref = _iterate(L, s2, inputs2, 1.02, 1)
    assert (L.captured, L.replayed) == (1, 1)
    (prog,) = _programs(L)
    assert torch.equal(prog.lists[0], s2.cand.idx)
    assert torch.equal(prog.lists[1], s2.cand.count)
    idx = s2.cand.idx
    s3 = s2._replace(cand=s2.cand._replace(idx=torch.cat(
        [idx, torch.full_like(idx[:, :1], -1)], dim=1)))
    wide = _iterate(L, s3, inputs2, 1.02, 1)
    assert (L.captured, L.replayed) == (2, 1)
    assert len(_programs(L)) == 2
    _equal(wide, ref)


def test_new_classed_shape_makes_a_new_program(memo, monkeypatch):
    """Count-class engine: a rebuild with the same class shape runs the
    program, another class shape (a narrower first width) makes a new
    one; at most PROGRAMS_LIVE programs stay."""
    state, inputs = _state("classed")
    L = _loop("classed")
    _iterate(L, state, inputs, 1.02, 0)
    n = L.n_gas
    same = _build(L, inputs[0])
    assert L.program_key(same, L.selections(same)) == L.program_key(
        state, L.selections(state))
    _iterate(L, same, inputs, 1.02, 1)
    assert (L.captured, L.replayed) == (1, 1)
    monkeypatch.setattr(tsph, "MAX_CAND_START", 64)
    narrow = _build(L, inputs[0])
    assert narrow.max_cand == 64 and narrow.tail is None
    _iterate(L, narrow, inputs, 1.02, 2)
    assert (L.captured, L.replayed) == (2, 1)
    monkeypatch.setattr(tsph, "MAX_CAND_START", 32)
    narrower = _build(L, inputs[0])
    assert narrower.tail is None and n == inputs[0].shape[0]
    _iterate(L, narrower, inputs, 1.02, 3)
    assert L.captured == 3
    assert len(_programs(L)) == twvt.PROGRAMS_LIVE == 2


@pytest.mark.parametrize("rule", ["tail", "large", "off"])
def test_eager_rules(memo, monkeypatch, rule):
    """More than the engine's PROGRAM_MAX_GAS gas, or ITER_PROGRAMS off: the
    iteration runs eagerly, no program is made, and the rule is logged
    once.  "tail" is no rule: a count-class state with far-tail rows
    makes a program at its first iteration and replays it at the next,
    with the far-tail calls' launches counted apart."""
    engine = "classed" if rule == "tail" else "stream"
    if rule == "tail":
        monkeypatch.setattr(tsph, "MAX_CAND_START", 4)
        monkeypatch.setattr(tsph, "MAX_CAND_CAP", 4)
    if rule == "large":
        monkeypatch.setitem(twvt.PROGRAM_MAX_GAS, engine, 1000)
    if rule == "off":
        monkeypatch.setattr(twvt, "ITER_PROGRAMS", False)
    logs = []
    L = _loop(engine, log=lambda stage, **kw: logs.append((stage, kw)))
    _, inputs = _state(engine)
    state = _build(L, inputs[0])
    assert (state.tail is not None) == (rule == "tail")
    for it in (0, 1):
        _iterate(L, state, inputs, 1.02, it)
    if rule == "tail":
        assert (L.captured, L.replayed, L.eager) == (1, 1, 0)
        (prog,) = _programs(L)
        assert prog.state.tail is not None
        assert [s for s, _ in logs] == ["wvt_graph"]
        assert sum(L.sb_launches.values()) == 0   # no kernel on the CPU
        return
    assert (L.captured, L.replayed, L.eager) == (0, 0, 2)
    assert _programs(L) == []
    assert logs == [("wvt_eager", dict(it=0, rule=rule))]


@pytest.mark.parametrize("engine", ENGINES)
def test_capture_inside_the_window_raises(memo, engine):
    """``speculate`` may run a program but not make one: without a
    program of the shape it raises; once the iteration before made it,
    the queued iteration runs it."""
    state, inputs = _state(engine)
    L = _loop(engine)
    pos_gas, h_prev, rhom_prev, sat_mask, fac_gas, step, err_last = inputs
    prev = dict(pos_new=pos_gas, hsml=h_prev, rho_model=rhom_prev,
                fac_new=fac_gas, step_new=step, err_mean=err_last)
    sat_false = torch.zeros_like(sat_mask)
    with pytest.raises(RuntimeError, match="speculation window"):
        L.speculate(state, prev, 1.02, sat_false, 1)
    assert (L.captured, L.replayed, L.eager, L.in_window) == (0, 0, 0, False)
    out = _iterate(L, state, inputs, 1.02, 0)
    L.speculate(state, out, 1.02, sat_false, 1)
    assert (L.captured, L.replayed) == (1, 1)


# ---------------------------------------------- whole relaxations, on / off

@pytest.mark.parametrize("engine", ENGINES)
def test_programs_on_and_off_give_the_same_relaxation(memo, monkeypatch,
                                                      engine):
    """Three iterations (speculation on) with ITER_PROGRAMS on and off:
    the same wvt records and the same relaxed gas, bit for bit; with
    programs on the iterations after the first ran a program, with them
    off none, and each relaxation freed its programs."""
    tha, tparts = _start()
    loops, make = [], twvt._Loop.make_program

    def make_program(loop, *args):
        loops.append(loop)
        return make(loop, *args)
    monkeypatch.setattr(twvt._Loop, "make_program", make_program)
    runs = {}
    for on in (True, False):
        monkeypatch.setattr(twvt, "ITER_PROGRAMS", on)
        logs = []
        got, _ = twvt.regularise_sph_particles(
            _port_scene(wvt_max_iter=3), tha, tparts, engine=engine,
            log=lambda stage, **kw: logs.append((stage, kw)))
        runs[on] = (got, logs)
    assert loops and all(not loop.programs and not loop.sweeps.programs
                         for loop in loops)

    def records(logs, stage):
        return [kw for s, kw in logs if s == stage]
    assert records(runs[True][1], "wvt") == records(runs[False][1], "wvt")
    assert torch.equal(runs[True][0].pos, runs[False][0].pos)
    assert torch.equal(runs[True][0].hsml, runs[False][0].hsml)
    on = records(runs[True][1], "wvt_done")[0]
    off = records(runs[False][1], "wvt_done")[0]
    assert on["captured"] >= 1 and on["replayed"] >= 1 and on["eager"] == 0
    graphs = records(runs[True][1], "wvt_graph")
    assert len([g for g in graphs if g["kind"] == "iteration"]) \
        == on["captured"]
    # the builds' candidate sweeps made programs of their own
    assert any(g["kind"] == "sweep" for g in graphs)
    assert not records(runs[False][1], "wvt_graph")
    assert (off["captured"], off["replayed"]) == (0, 0)
    assert off["eager"] == on["captured"] + on["replayed"]
