"""The WVT loop's speculative dispatch against the JAX package's
(``toycluster_tpu/models/wvt.py``: the queued call :939-963, its
adoption :920-921, the drops :934, :995, :1095, the switch and size
limit :795-796), on the CPU.

The scene: the JAX make_positions at ntotal = 10,000 (5,000 gas), WC6,
seed 5, whose lists survive iterations 8-11 on both packages, and the
JAX loop on the Pallas stream kernel in interpret mode (as
tests/test_wvt.py:178-182 runs it).  With TOYCLUSTER_SPECULATE at 1 and
at 0 on both packages, every dispatch (the ones queued ahead included)
must carry the same iteration index, margin, step (fp32, bit for bit)
and saturation mask, and the stage log the same wvt and wvt_retry
records; err_mean and positions within the bounds of
tests/test_torch_wvt.py (err_mean rtol 2e-2, periodic position
difference < 2e-3 box, pid-matched)."""

import os
from functools import lru_cache, partial

import jax
import numpy as np
import pytest
import torch

from toycluster_tpu import parse_par_file as jax_parse
from toycluster_tpu.models import positions as jpos
from toycluster_tpu.models import wvt as jwvt
from toycluster_tpu.ops import pallas_pair
from toycluster_tpu.particles import halo_arrays_from_scene
from toycluster_tpu.scene import build_scene as jax_build_scene
from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.from_reference import (halo_arrays_from_numpy,
                                                 particles_from_numpy)
from toycluster_tpu_torch.models import sph as tsph
from toycluster_tpu_torch.models import wvt as twvt
from toycluster_tpu_torch.scene import build_scene

torch.set_num_threads(2)

PAR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "toycluster_tpu_torch", "data", "cluster.par")
BIG = dict(ntotal=10_000, sph_kernel="wc6")
SMALL = dict(ntotal=3000, sph_kernel="wc6")
# the speculating runs write a checkpoint at it = 9, while it = 10 is
# queued
CK_EVERY = 10


@lru_cache(maxsize=None)
def _start(ntotal):
    """(JAX scene, JAX halo arrays, JAX particles, port halo arrays, port
    particles): the JAX start at ``ntotal`` (BIG or SMALL) with pids
    1..n_gas on the gas."""
    over = BIG if ntotal == BIG["ntotal"] else SMALL
    jscene = jax_build_scene(jax_parse(PAR, **over))
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
    return jscene, ha, parts, tha, tparts


def _port_scene(over, **more):
    return build_scene(parse_par_file(PAR, **over, **more))


def _jax_dispatches(mp, calls):
    """Record (it, margin, step, err_last, any saturated lane) of every
    call of the JAX loop's iteration function."""
    orig = jwvt._get_iter_fn

    def get(*a, **k):
        fn = orig(*a, **k)

        def call(*args):
            calls.append((int(args[15]), float(args[5]), float(args[13]),
                          float(args[14]), bool(np.asarray(args[4]).any())))
            return fn(*args)
        return call
    mp.setattr(jwvt, "_get_iter_fn", get)


class _PortRecorder:
    """Record every ``iterate`` call of the port's loop as the JAX
    dispatches are recorded, and each ``speculate`` call's inputs, output
    and loop, in the order of the stage log's records (``events``)."""

    def __init__(self, mp, events):
        self.calls, self.spec = [], []
        orig_it, orig_spec = twvt._Loop.iterate, twvt._Loop.speculate

        def iterate(loop, state, pos_gas, h_prev, rhom_prev, sat_mask,
                    margin_w, fac_gas, step, err_last, it):
            self.calls.append((it, float(np.float32(margin_w)), float(step),
                               float(err_last), bool(sat_mask.any())))
            return orig_it(loop, state, pos_gas, h_prev, rhom_prev, sat_mask,
                           margin_w, fac_gas, step, err_last, it)

        def speculate(loop, state, out, margin_w, sat_false, it):
            res = orig_spec(loop, state, out, margin_w, sat_false, it)
            events.append(("speculate", dict(it=it)))
            self.spec.append((loop, state, out, margin_w, sat_false, it, res))
            return res
        mp.setattr(twvt._Loop, "iterate", iterate)
        mp.setattr(twvt._Loop, "speculate", speculate)


def _run_both(tmp, speculate):
    """Both loops on the BIG scene with TOYCLUSTER_SPECULATE=speculate,
    writing a checkpoint every CK_EVERY iterations."""
    jscene, ha, parts, tha, tparts = _start(BIG["ntotal"])
    res = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TOYCLUSTER_ENGINE", "pallas")
        mp.setenv("TOYCLUSTER_SPECULATE", str(speculate))
        mp.setattr(pallas_pair, "stream_wvt_pallas",
                   partial(pallas_pair.stream_wvt_pallas, interpret=True))
        jcalls, jlogs = [], []
        _jax_dispatches(mp, jcalls)
        ck_j = str(tmp / f"jax_ck{speculate}")
        ref = jwvt.regularise_sph_particles(
            jscene, ha, parts, log=lambda s, **k: jlogs.append((s, k)),
            checkpoint_path=ck_j, checkpoint_every=CK_EVERY)
        tlogs = []
        rec = _PortRecorder(mp, tlogs)
        ck_t = str(tmp / f"port_ck{speculate}")
        got, _ = twvt.regularise_sph_particles(
            _port_scene(BIG), tha, tparts,
            log=lambda s, **k: tlogs.append((s, k)),
            checkpoint_path=ck_t, checkpoint_every=CK_EVERY)
    res.update(jax=(ref, jcalls, jlogs, ck_j), port=(got, rec, tlogs, ck_t),
               box=jscene.boxsize)
    return res


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("speculate")
    return {s: _run_both(tmp, s) for s in (1, 0)}


def _records(logs, stage, keys=None):
    return [kw if keys is None else {k: kw[k] for k in keys}
            for s, kw in logs if s == stage]


def _adopted(events):
    """The ``speculate`` events whose queued iteration was adopted: those
    that no wvt_drop of their iteration follows before the next one."""
    out, open_ = [], None
    for i, (stage, kw) in enumerate(events):
        if stage == "speculate":
            if open_ is not None:
                out.append(open_)
            open_ = i
        elif stage == "wvt_drop":
            assert open_ is not None and events[open_][1]["it"] == kw["it"]
            open_ = None
    return out + ([] if open_ is None else [open_])


def _by_pid(pid, *arrays):
    order = np.argsort(np.asarray(pid))
    return [np.asarray(a)[order] for a in arrays]


def _periodic_max(a, b, box):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return np.minimum(d, box - d).max()


def test_iterations_were_queued_adopted_and_dropped(runs):
    """The speculating run queues iterations ahead, adopts >= 3 and drops
    the one a stop or a retry made useless; without speculation nothing
    is queued."""
    _, rec, logs, _ = runs[1]["port"]
    done = _records(logs, "wvt_done")[0]
    adopted = _adopted(logs)
    drops = _records(logs, "wvt_drop")
    assert done["adopted"] == len(adopted) >= 3
    assert done["speculated"] == len(rec.spec) == len(adopted) + len(drops)
    assert done["dropped"] == len(drops)
    assert {d["reason"] for d in drops} & {"retry", "stop"}
    _, rec0, logs0, _ = runs[0]["port"]
    done0 = _records(logs0, "wvt_done")[0]
    assert (done0["speculated"], done0["adopted"], done0["dropped"]) == (
        0, 0, 0)
    assert rec0.spec == [] and _records(logs0, "wvt_drop") == []


@pytest.mark.parametrize("speculate", [1, 0])
def test_dispatches_and_records_match_jax(runs, speculate):
    """Every dispatch in the same order with the same iteration index,
    margin, fp32 step and saturation mask (err_last within the err_mean
    bound); the same wvt (steps to the bit, margins) and wvt_retry
    records; the relaxed gas within the bounds of test_torch_wvt.py."""
    r = runs[speculate]
    ref, jcalls, jlogs, _ = r["jax"]
    got, rec, tlogs, _ = r["port"]
    assert len(rec.calls) == len(jcalls)
    for c_t, c_j in zip(rec.calls, jcalls):
        assert (c_t[0], c_t[1], c_t[2], c_t[4]) == (c_j[0], c_j[1], c_j[2],
                                                    c_j[4])
        np.testing.assert_allclose(c_t[3], c_j[3], rtol=2e-2)
    keys = ("it", "step", "margin")
    assert _records(tlogs, "wvt", keys) == _records(jlogs, "wvt", keys)
    np.testing.assert_allclose(
        [kw["err_mean"] for kw in _records(tlogs, "wvt")],
        [kw["err_mean"] for kw in _records(jlogs, "wvt")], rtol=2e-2)
    # the JAX loop logs a retry through the call that carries the
    # saturation mask and, where it rebuilds, the build's attempt and
    # saturated count
    keys = ("it", "attempt")
    assert _records(tlogs, "wvt_build", keys) == _records(jlogs, "wvt_build",
                                                          keys)
    retries = _records(tlogs, "wvt_retry")
    assert retries
    assert [r["it"] for r in retries] == [c[0] for c in jcalls if c[4]]
    assert ([(r["it"], r["attempt"] + 1, r["n_sat"]) for r in retries
             if r["rebuild"]]
            == [(b["it"], b["attempt"], b["n_sat"])
                for b in _records(jlogs, "wvt_build") if b["attempt"] > 0])
    n = ref.n_gas
    pj, rj = _by_pid(ref.pid[:n], ref.pos[:n], ref.rho)
    pt, rt = _by_pid(got.pid[:n].numpy(), got.pos[:n].numpy(),
                     got.rho.numpy())
    assert _periodic_max(pt, pj, r["box"]) < 2e-3 * r["box"]
    np.testing.assert_allclose(rt, rj, rtol=2e-2)


def test_adopted_results_equal_eager_iterations(runs):
    """Each adopted queued iteration, bit for bit, against ``iterate``
    called after the fact on the same inputs, with the step and err_last
    rebuilt from the host's values (the device carries them in fp32)."""
    _, rec, logs, _ = runs[1]["port"]
    adopted = _adopted(logs)
    spec_idx = [i for i, (s, _) in enumerate(logs) if s == "speculate"]
    assert len(adopted) >= 3
    for i in adopted:
        loop, state, out, margin_w, sat_false, it, res = rec.spec[
            spec_idx.index(i)]
        step = torch.tensor(float(out["step_new"]), dtype=torch.float32)
        err_last = torch.tensor(float(out["err_mean"]), dtype=torch.float32)
        assert torch.equal(step, out["step_new"])
        eager = loop.iterate(state, out["pos_new"].clone(),
                             out["hsml"].clone(), out["rho_model"].clone(),
                             sat_false, margin_w, out["fac_new"].clone(),
                             step, err_last, it)
        assert sorted(eager) == sorted(res)
        for k, v in eager.items():
            assert torch.equal(v, res[k]), (it, k)


def test_checkpoint_written_while_the_next_iteration_is_queued(runs):
    """The speculating run saves it = 9 after queuing it = 10: the file
    holds it = 9's adopted state (JAX :1081-1089): the JAX file's keys,
    it, step (fp32 to the bit) and err_last, the positions in the
    original order within 2e-3 box; each package resumes from its file
    at it = 10 with the saved step."""
    r = runs[1]
    _, _, jlogs, ck_j = r["jax"]
    _, _, tlogs, ck_t = r["port"]
    ck_rec = [i for i, (s, kw) in enumerate(tlogs)
              if s == "wvt_checkpoint" and kw["it"] == CK_EVERY - 1]
    assert len(ck_rec) == 1
    queued = [i for i, (s, kw) in enumerate(tlogs)
              if s == "speculate" and kw["it"] == CK_EVERY]
    assert queued and queued[-1] < ck_rec[0]
    assert queued[-1] in _adopted(tlogs)
    with np.load(ck_j) as cj, np.load(ck_t) as ct:
        assert sorted(cj.files) == sorted(ct.files)
        assert int(cj["it"]) == int(ct["it"]) == CK_EVERY - 1
        assert float(cj["step"]) == float(ct["step"])
        np.testing.assert_allclose(float(ct["err_last"]),
                                   float(cj["err_last"]), rtol=2e-2)
        assert (_periodic_max(cj["pos_gas"], ct["pos_gas"], r["box"])
                < 2e-3 * r["box"])
        step = float(ct["step"])
    saved = _records(tlogs, "wvt", ("it", "step"))
    assert {"it": CK_EVERY, "step": step} in saved

    _, ha, parts, tha, tparts = _start(BIG["ntotal"])
    logs_t, logs_j = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TOYCLUSTER_ENGINE", "pallas")
        mp.setattr(pallas_pair, "stream_wvt_pallas",
                   partial(pallas_pair.stream_wvt_pallas, interpret=True))
        jwvt.regularise_sph_particles(
            jax_build_scene(jax_parse(PAR, wvt_max_iter=CK_EVERY, **BIG)),
            ha, parts, log=lambda s, **k: logs_j.append((s, k)),
            checkpoint_path=ck_j)
    twvt.regularise_sph_particles(
        _port_scene(BIG, wvt_max_iter=CK_EVERY), tha, tparts,
        log=lambda s, **k: logs_t.append((s, k)), checkpoint_path=ck_t)
    assert (_records(logs_t, "wvt_resume") == _records(logs_j, "wvt_resume")
            == [dict(it=CK_EVERY, step=step)])
    wt, wj = _records(logs_t, "wvt"), _records(logs_j, "wvt")
    assert [w["it"] for w in wt] == [w["it"] for w in wj] == [CK_EVERY]
    np.testing.assert_allclose(wt[0]["err_mean"], wj[0]["err_mean"],
                               rtol=2e-2)


# ------------------------------------------------------------------------
# where nothing is queued

BLOCKED = dict(it=5, max_iter=64, its_since_build=3, drift_acc=0.05,
               sort_drift_acc=0.2, drift_inc_last=0.02, drift_budget=0.25,
               tail=None, err_diff_last=0.5, err_limit=0.01)


@pytest.mark.parametrize("change,reason", [
    ({}, None),
    (dict(it=64), "end"),
    (dict(its_since_build=twvt.REBUILD_EVERY - 1), "rebuild"),
    (dict(drift_acc=0.25 - 1.5 * 0.02 + 1e-6), "rebuild"),
    (dict(sort_drift_acc=twvt.SORT_DRIFT_BUDGET - 1.5 * 0.02 + 1e-6),
     "rebuild"),
    (dict(tail=(torch.zeros(1), torch.zeros(1, 1), torch.zeros(1))),
     "rebuild"),
    (dict(it=25, err_diff_last=0.0199), "stop"),
    (dict(it=24, err_diff_last=0.0199), None),
    (dict(it=25, err_diff_last=0.02), None),
])
def test_what_blocks_the_queued_iteration(change, reason):
    """The JAX loop's predict_rebuild (a scheduled rebuild, the drift and
    sort-drift budgets against 1.5x the last increment, far-tail rows)
    and predict_stop (it >= 25, err_diff under twice the limit)."""
    assert twvt.speculation_blocked(**{**BLOCKED, **change}) == reason


def test_switch_and_size_limit(monkeypatch):
    monkeypatch.delenv("TOYCLUSTER_SPECULATE", raising=False)
    assert twvt.speculation_enabled(twvt.SPECULATE_MAX_GAS)
    assert twvt.SPECULATE_MAX_GAS == 20_000_000
    assert not twvt.speculation_enabled(twvt.SPECULATE_MAX_GAS + 1)
    monkeypatch.setenv("TOYCLUSTER_SPECULATE", "0")
    assert not twvt.speculation_enabled(1000)


@pytest.fixture(scope="module")
def small():
    return _start(SMALL["ntotal"])


def _small_run(small, engine="stream", **over):
    *_, tha, tparts = small
    logs = []
    got, _ = twvt.regularise_sph_particles(
        _port_scene(SMALL, **over), tha, tparts, engine=engine,
        log=lambda s, **k: logs.append((s, k)))
    return got, logs


@pytest.mark.parametrize("case", ["none", "size", "rebuild", "tail"])
def test_nothing_queued_where_blocked(small, monkeypatch, case):
    """Two iterations on the 3,000-particle scene: it = 0 queues it = 1
    (dropped by the list refresh) on both engines; nothing is queued
    past the size limit, with a rebuild scheduled every iteration, or on
    the classed engine's far-tail scene (lists capped at 4 blocks); the
    trajectory is the one without speculation."""
    monkeypatch.setenv("TOYCLUSTER_SPECULATE", "1")
    engine = "classed" if case == "tail" else "stream"
    if case == "size":
        monkeypatch.setattr(twvt, "SPECULATE_MAX_GAS", 1000)
    if case == "rebuild":
        monkeypatch.setattr(twvt, "REBUILD_EVERY", 1)
    if case == "tail":
        monkeypatch.setattr(tsph, "MAX_CAND_START", 4)
        monkeypatch.setattr(tsph, "MAX_CAND_CAP", 4)
    got, logs = _small_run(small, engine, wvt_max_iter=1)
    done = _records(logs, "wvt_done")[0]
    if case == "tail":
        assert all(b["tail_rows"] > 0 for b in _records(logs, "wvt_build"))
    if case == "none":
        assert done["speculated"] == done["dropped"] == 1
        assert _records(logs, "wvt_drop") == [dict(it=1, at=1,
                                                   reason="refresh")]
        return
    assert (done["speculated"], done["adopted"], done["dropped"]) == (0, 0, 0)
    monkeypatch.setenv("TOYCLUSTER_SPECULATE", "0")
    ref, logs0 = _small_run(small, engine, wvt_max_iter=1)
    assert _records(logs, "wvt") == _records(logs0, "wvt")
    assert torch.equal(got.pos, ref.pos)


def test_classed_engine_speculates_to_the_same_bits(small, monkeypatch):
    """The classed engine solves against the build cap, so the margin of
    a queued call changes nothing: on and off give the same stage-log
    trajectory and the same relaxed gas, bit for bit, with iterations
    adopted on the way."""
    monkeypatch.setenv("TOYCLUSTER_SPECULATE", "1")
    got1, logs1 = _small_run(small, "classed")
    monkeypatch.setenv("TOYCLUSTER_SPECULATE", "0")
    got0, logs0 = _small_run(small, "classed")
    assert _records(logs1, "wvt_done")[0]["adopted"] >= 1
    assert _records(logs1, "wvt") == _records(logs0, "wvt")
    for k in ("pos", "rho", "hsml", "var_hsml_fac", "pid"):
        assert torch.equal(getattr(got1, k), getattr(got0, k)), k


def test_trace_reads_the_wvt_loop_span():
    """``make_ics`` marks the WVT loop's span for the trace tool, which
    reads it from the profiler's raw events and counts device time
    within it: busy_s is the union of the device ops' intervals, clipped
    to a span."""
    from toycluster_tpu_torch import trace
    from toycluster_tpu_torch.pipeline import make_ics
    iv = [(0, 2000), (1000, 3000), (5000, 9000)]
    assert trace.busy_s(iv) == pytest.approx(7e-6)
    assert trace.busy_s(iv, 1500, 6000) == pytest.approx(2.5e-6)
    assert trace.busy_s(iv, 3000, 5000) == 0.0
    cfg = parse_par_file(PAR, ntotal=2000, sph_kernel="m4", wvt_max_iter=1)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        make_ics(cfg, device="cpu", write=False, log=lambda *a, **k: None)
    ops, spans = trace.device_ops(prof)
    assert ops == [] and len(spans) == 1
    assert spans[0][1] > spans[0][0]
