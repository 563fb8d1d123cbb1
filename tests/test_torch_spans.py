"""The spans and the pair-work counter that the port's stage log
carries, on the CPU: one small ``make_ics`` per neighbour engine (the
config-4 scene, three halos) with a list recorder, and the span
collector and the records' receivers on their own.

The spans ride on the records that close their stage (``velocities``,
``wvt_done``); no record is added for them, and every ``seconds`` that a
record shares with a span is the span's."""

import json
import os
import time

import pytest
import torch

from toycluster_tpu_torch.config import parse_par_file
from toycluster_tpu_torch.models import wvt
from toycluster_tpu_torch.ops import blocks as blk
from toycluster_tpu_torch.pipeline import make_ics
from toycluster_tpu_torch.utils import logging as tlog

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAR = os.path.join(ROOT, "toycluster_tpu_torch", "data", "cluster.par")
ENGINES = ("stream", "classed")
# spans that no record is named after
SPAN_ONLY = ("wvt_loop", "wvt_iteration", "wvt_sweep", "wvt_capture",
             "wvt_step", "wvt_wait", "wvt_release", "velocity_table",
             "velocity_fE", "velocity_fE_integral", "velocity_cdf")
WVT_NAMES = {"wvt_loop", "wvt_iteration", "wvt_build", "wvt_refresh",
             "wvt_sweep", "wvt_capture", "wvt_step", "wvt_wait",
             "wvt_release"}
PAIRS = blk.BLOCK * blk.BLOCK


@pytest.fixture(scope="module", params=ENGINES)
def run(request):
    cfg = parse_par_file(PAR, ntotal=4000, sph_kernel="m4", wvt_max_iter=2,
                         mass_ratio=0.3333333, substructure=True)
    logs = []
    t0 = time.perf_counter()
    scene, parts = make_ics(
        cfg, device="cpu", engine=request.param, write=False,
        log=lambda stage, **kw: logs.append((stage, kw)))
    t1 = time.perf_counter()
    return dict(engine=request.param, scene=scene, n_gas=parts.n_gas,
                logs=logs, t0=t0, t1=t1, cfg=cfg)


def _one(run, stage):
    recs = [kw for st, kw in run["logs"] if st == stage]
    assert len(recs) == 1
    return recs[0]


def _spans(run, stage):
    return _one(run, stage)["spans"]


def test_velocities_and_wvt_done_carry_spans(run):
    vel = _spans(run, "velocities")
    loop = _spans(run, "wvt_done")
    assert {s["name"] for s in vel} == {"velocity_table", "velocity_fE",
                                        "velocity_fE_integral",
                                        "velocity_cdf"}
    assert {s["name"] for s in loop} >= {"wvt_loop", "wvt_iteration",
                                         "wvt_build", "wvt_sweep",
                                         "wvt_capture", "wvt_step",
                                         "wvt_wait", "wvt_release"}
    assert {s["name"] for s in loop} <= WVT_NAMES
    # the spans are plain JSON, as a log's receiver may keep them
    json.dumps(vel + loop)
    # no other record carries spans
    assert [st for st, kw in run["logs"] if "spans" in kw] == [
        "wvt_done", "velocities"]


@pytest.mark.parametrize("stage", ["velocities", "wvt_done"])
def test_every_span_lies_inside_its_parent_and_the_call(run, stage):
    spans = _spans(run, stage)
    eps = 1e-9
    for i, s in enumerate(spans):
        end = s["t0"] + s["seconds"]
        assert s["seconds"] >= 0
        assert run["t0"] - eps <= s["t0"] and end <= run["t1"] + eps
        p = s["parent"]
        assert -1 <= p < i
        if p >= 0:
            q = spans[p]
            assert q["t0"] - eps <= s["t0"]
            assert end <= q["t0"] + q["seconds"] + eps


def test_one_velocity_table_a_halo(run):
    """One ``velocity_table`` span over every halo's tables: the host
    prepare, the one integral call (its ``halos`` and the ``terms`` it
    summed), the host finish, then the speed CDFs."""
    spans = _spans(run, "velocities")
    n_halos = run["scene"].nhalos
    assert n_halos == 3
    tables = [s for s in spans if s["name"] == "velocity_table"]
    assert len(tables) == 1 and tables[0]["halos"] == n_halos
    assert spans[0] is tables[0] and tables[0]["parent"] == -1
    kids = [(s["name"], s.get("part")) for s in spans[1:]]
    assert kids == [("velocity_fE", "prepare"), ("velocity_fE_integral", None),
                    ("velocity_fE", "finish"), ("velocity_cdf", None)]
    assert all(s["parent"] == 0 for s in spans[1:])
    integral = spans[2]
    assert integral["halos"] == n_halos and integral["terms"] > 0


def test_the_wvt_spans_nest_as_the_loop_runs(run):
    spans = _spans(run, "wvt_done")
    done = _one(run, "wvt_done")
    name = [s["name"] for s in spans]
    assert name[0] == "wvt_loop" and name.count("wvt_loop") == 1
    assert spans[0]["seconds"] == done["seconds"]
    # the programs are freed after the loop's seconds, in a root of its own
    assert name[-1] == "wvt_release" and name.count("wvt_release") == 1
    assert spans[-1]["parent"] == -1
    assert spans[-1]["t0"] >= spans[0]["t0"] + spans[0]["seconds"]
    parent_of = {"wvt_iteration": {"wvt_loop"},
                 "wvt_build": {"wvt_iteration"},
                 "wvt_refresh": {"wvt_iteration"},
                 "wvt_step": {"wvt_iteration"},
                 "wvt_wait": {"wvt_iteration"},
                 "wvt_sweep": {"wvt_build", "wvt_refresh"},
                 "wvt_capture": {"wvt_sweep", "wvt_step"}}
    for s in spans[1:-1]:
        assert name[s["parent"]] in parent_of[s["name"]]
    its = [s["it"] for s in spans if s["name"] == "wvt_iteration"]
    assert its == list(range(len(its)))
    assert len(its) == done["iterations"]
    kinds = {s["name"]: set() for s in spans}
    for s in spans:
        kinds[s["name"]].add(s.get("kind"))
    assert kinds["wvt_step"] <= {"eager", "replay", "queued"}
    assert kinds["wvt_sweep"] <= {"eager", "replay", "capture"}
    assert kinds["wvt_capture"] == {"sweep", "iteration"}
    # a sweep's capture lies below a sweep of kind "capture"
    for s in spans:
        if s["name"] == "wvt_capture" and s["kind"] == "sweep":
            assert spans[s["parent"]]["kind"] == "capture"
    # the loop's programs are on: the speculated iteration is queued
    assert (done["speculated"] > 0) == ("queued" in kinds["wvt_step"])


def test_records_take_their_seconds_from_the_spans(run):
    spans = _spans(run, "wvt_done")
    for stage, match in (("wvt_build", None), ("wvt_refresh", None),
                         ("wvt_graph", "iteration"), ("wvt_graph", "sweep")):
        recs = [kw for st, kw in run["logs"] if st == stage
                and (match is None or kw["kind"] == match)]
        name = stage if match is None else "wvt_capture"
        got = [s for s in spans if s["name"] == name
               and (match is None or s["kind"] == match)]
        assert [r["seconds"] for r in recs] == [s["seconds"] for s in got]
        if stage != "wvt_graph":
            assert [r["it"] for r in recs] == [s["it"] for s in got]
    builds = [kw for st, kw in run["logs"] if st == "wvt_build"]
    assert builds and [b["attempt"] for b in builds] == [
        s["attempt"] for s in spans if s["name"] == "wvt_build"]


def test_builds_and_refreshes_carry_sweep_spills(run):
    """Each ``wvt_build`` and ``wvt_refresh`` record carries the rows its
    sweeps spilled from the sweep kernel's on-chip buffer; the plain
    sweep a CPU run takes spills none."""
    recs = [kw for st, kw in run["logs"]
            if st in ("wvt_build", "wvt_refresh")]
    assert recs and all(r["sweep_spills"] == 0 for r in recs)


def test_no_record_is_named_after_a_span_only_name(run):
    stages = {st for st, _ in run["logs"]}
    assert not stages & set(SPAN_ONLY)


def test_pairs_walked_counts_whole_blocks_of_the_needed_pairs(run):
    done = _one(run, "wvt_done")
    walked = done["pairs_walked"]
    assert isinstance(walked, int) and walked > 0
    assert walked % PAIRS == 0
    assert walked >= (run["n_gas"] * done["iterations"]
                      * run["cfg"].desnngb)


def test_the_loop_without_programs_counts_the_same_pairs(run, monkeypatch):
    """Iteration and sweep programs (run on their buffers here) add to
    the counter as the eager calls do: the same relaxation without them
    walks as many pairs, and its sweeps are all eager."""
    monkeypatch.setattr(wvt, "ITER_PROGRAMS", False)
    logs = []
    make_ics(run["cfg"], device="cpu", engine=run["engine"], write=False,
             log=lambda stage, **kw: logs.append((stage, kw)))
    done = [kw for st, kw in logs if st == "wvt_done"][0]
    assert done["pairs_walked"] == _one(run, "wvt_done")["pairs_walked"]
    kinds = {(s["name"], s.get("kind")) for s in done["spans"]}
    assert ("wvt_sweep", "eager") in kinds
    assert not {k for k in kinds if k[0] == "wvt_capture"}
    assert not [st for st, _ in logs if st == "wvt_graph"]


def test_offload_spans_only_where_the_loop_parks(run, monkeypatch):
    """Below the offload threshold the loop opens no ``wvt_offload`` or
    ``wvt_restore`` span; at or above it, one of each below the root,
    the park before the first iteration and the restore after the last,
    each with the gas ``rows`` and the ``host_bytes`` of pid (int64) and
    halo (int32) parked, over the seconds of its record."""
    parks = ("wvt_offload", "wvt_restore")
    assert not {s["name"] for s in _spans(run, "wvt_done")} & set(parks)
    monkeypatch.setenv("TOYCLUSTER_WVT_OFFLOAD_N", "1")
    logs = []
    cfg = parse_par_file(PAR, ntotal=2000, sph_kernel="m4", wvt_max_iter=1)
    scene, parts = make_ics(cfg, device="cpu", engine=run["engine"],
                            write=False,
                            log=lambda stage, **kw: logs.append((stage, kw)))
    spans = [kw for st, kw in logs if st == "wvt_done"][0]["spans"]
    name = [s["name"] for s in spans]
    assert [n for n in name if n in parks] == list(parks)
    iters = [i for i, n in enumerate(name) if n == "wvt_iteration"]
    off, back = name.index("wvt_offload"), name.index("wvt_restore")
    assert off < iters[0] and back > iters[-1]
    # the records keep their fields
    fields = {"wvt_offload": {"n_gas", "seconds", "host_gib"},
              "wvt_restore": {"seconds"}}
    for i in (off, back):
        s = spans[i]
        assert s["parent"] == 0
        assert s["rows"] == parts.n_gas
        assert s["host_bytes"] == parts.n_total * 12
        (rec,) = [kw for st, kw in logs if st == s["name"]]
        assert rec["seconds"] == s["seconds"]
        assert fields[s["name"]] <= set(rec)


def test_the_profile_dir_trace_shows_the_loop_spans(tmp_path):
    """``make_ics(profile_dir=)`` asks for the spans' ranges: its trace of
    the WVT loop holds them (and no second ``wvt_loop``)."""
    cfg = parse_par_file(PAR, ntotal=2000, sph_kernel="m4", wvt_max_iter=1)
    make_ics(cfg, device="cpu", write=False, profile_dir=str(tmp_path),
             log=tlog.silent_log)
    with open(tmp_path / "wvt_trace.json") as fh:
        names = [e.get("name") for e in json.load(fh)["traceEvents"]]
    for name in ("wvt_iteration", "wvt_build", "wvt_step", "wvt_wait"):
        assert name in names
    assert names.count("wvt_loop") == 1


# ------------------------------------------------ the collector on its own

def test_spans_nest_and_hand_over_once():
    sp = tlog.Spans()
    root = sp.open("a", profile=False, it=3)
    with sp.span("b", kind="x") as b:
        with sp.span("c"):
            pass
    assert sp.close(root) == root["seconds"]
    out = sp.take()
    assert [(s["name"], s["parent"]) for s in out] == [
        ("a", -1), ("b", 0), ("c", 1)]
    assert out[0]["it"] == 3 and b["kind"] == "x"
    assert sp.take() == []


def test_spans_refuse_a_close_out_of_order_and_a_take_while_open():
    sp = tlog.Spans()
    outer = sp.open("outer")
    sp.open("inner")
    with pytest.raises(RuntimeError):
        sp.close(outer)
    with pytest.raises(RuntimeError):
        sp.take()


def test_spans_open_profiler_ranges_only_where_asked():
    """A profiler sees a span only inside ``profiler_ranges`` and for a
    span opened with ``profile``; without a profiler no span opens one."""
    sp = tlog.Spans()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with sp.span("span_unasked"):
            torch.ones(4).sum()
        with tlog.profiler_ranges():
            with sp.span("span_in_range"):
                torch.ones(4).sum()
            with sp.span("span_no_range", profile=False):
                pass
        with sp.span("span_after"):
            pass
    names = {e.name for e in prof.events()}
    assert "span_in_range" in names
    assert not names & {"span_unasked", "span_no_range", "span_after"}
    with tlog.profiler_ranges(), sp.span("span_unprofiled") as rec:
        pass
    assert rec["seconds"] >= 0
    assert len(sp.take()) == 5


def test_records_keep_plain_fields_and_stage_log_sums_spans(capsys):
    rec = tlog.Records()
    spans = [{"name": "x", "parent": -1, "t0": 1.0, "seconds": 0.25},
             {"name": "x", "parent": -1, "t0": 2.0, "seconds": 0.5}]
    rec("stage_a", n=3, obj=object(), spans=spans, scene=None)
    assert len(rec) == 1 and rec[0]["stage"] == "stage_a"
    assert rec[0]["n"] == 3 and rec[0]["spans"] == spans
    assert "obj" not in rec[0] and "scene" not in rec[0]
    assert isinstance(rec[0]["t"], float)
    assert not capsys.readouterr().err
    tlog.stage_log("stage_b", spans=spans, n=1)
    err = capsys.readouterr().err
    assert "stage_b" in err and "'x': [2, 0.75]" in err
    assert "t0" not in err
    tlog.Records(echo=True)("stage_c", spans=spans)
    assert "'x': [2, 0.75]" in capsys.readouterr().err


def test_the_module_keeps_no_records_of_its_own():
    assert not hasattr(tlog, "METRICS")


# ------------------------------------------------ trace.py's span table

def test_the_trace_busy_index_reads_what_busy_s_reads():
    import random
    from toycluster_tpu_torch import trace
    rng = random.Random(7)
    iv = [(10, 20), (15, 30), (30, 40), (50, 50), (60, 90), (65, 70)]
    iv += [(a, a + rng.randrange(0, 30))
           for a in (rng.randrange(0, 400) for _ in range(200))]
    busy = trace.busy_index(iv)
    for lo, hi in [(0, 500), (12, 18), (20, 35), (40, 60), (30, 30)] + [
            (a, a + rng.randrange(0, 100))
            for a in (rng.randrange(-20, 450) for _ in range(300))]:
        assert busy(lo, hi) == pytest.approx(trace.busy_s(iv, lo, hi),
                                             abs=1e-15)


def test_the_trace_span_table_puts_idle_on_the_innermost_span():
    from toycluster_tpu_torch import trace
    # a 10 ns root with a 4 ns child at 2-6 (t0 in s, offset 0); ops
    # busy 0-3 and 5-7: root idle 5 ns, child idle 2 ns, root's own 3 ns
    spans = [{"name": "a", "parent": -1, "t0": 0.0, "seconds": 10e-9},
             {"name": "b", "parent": 0, "t0": 2e-9, "seconds": 4e-9}]
    table = trace.span_table(spans, trace.busy_index([(0, 3), (5, 7)]), 0.0)
    assert table["a"] == pytest.approx([1, 10e-9, 5e-9, 5e-9, 3e-9])
    assert table["b"] == pytest.approx([1, 4e-9, 2e-9, 2e-9, 2e-9])
