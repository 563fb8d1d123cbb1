"""The harness's arithmetic on the CPU: the window, the device-trace
union, the pair roofline's count, finding parts by name, and the import
check.  No card and no program run: the inputs are made by hand.

    python3 -m pytest h100_bench/tests -q
"""

import json
import shutil
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import devtrace, spec  # noqa: E402
from benchlib.main import forbidden_modules  # noqa: E402
from benchlib.window import IC, Run, run_window  # noqa: E402


def _ic(t0, t1, records, n_gas=1000, peak=0):
    return IC(t0=t0, t1=t1, records=records, peak_bytes=peak, n_gas=n_gas)


class _Clock:
    """A host clock that moves only when an IC runs."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_window_runs_whole_ics_until_its_length_has_passed():
    clock = _Clock()
    lengths = iter([4.0, 4.0, 4.0, 4.0, 4.0])

    def make_ic(rec):
        clock.t += next(lengths)
        rec("wvt_done", iterations=3, seconds=1.0)
        return 10, 0, "parts"

    ics, last = run_window(make_ic, 10.0, clock=clock)
    # ICs start at 0, 4 and 8 (< 10); the third ends at 12 and is kept
    assert len(ics) == 3 and last == "parts"
    assert [ic.seconds for ic in ics] == [4.0, 4.0, 4.0]


def test_window_always_runs_one_ic_and_stops_at_a_failure():
    clock = _Clock()
    calls = []

    def make_ic(rec):
        calls.append(1)
        clock.t += 1.0
        return None if len(calls) == 2 else (1, 0, "x")

    ics, _ = run_window(make_ic, 0.0, clock=clock)
    assert len(ics) == 1
    ics, _ = run_window(make_ic, 100.0, clock=clock)
    assert len(ics) == 0 and len(calls) == 2


def test_end_to_end_metrics_are_sums_over_sums():
    ics = [_ic(0.0, 5.0, [(1.0, "setup", {}),
                          (3.0, "wvt_done", {"iterations": 10,
                                             "seconds": 2.0})],
               n_gas=100, peak=3 * 2**30),
           _ic(5.0, 12.0, [(6.0, "setup", {}),
                           (10.0, "wvt_done", {"iterations": 30,
                                               "seconds": 4.0})],
               n_gas=100, peak=2 * 2**30)]
    run = Run(ics=ics, setup_s=7.5)
    assert spec.reader("ic_s")(run) == pytest.approx(6.0)
    # (100 x 10 + 100 x 30) / (2 + 4), not the mean of the two rates
    assert spec.reader("wvt_updates_per_s")(run) == pytest.approx(4000 / 6)
    assert spec.reader("peak_gib")(run) == pytest.approx(3.0)
    assert spec.reader("setup_s")(run) == 7.5
    assert spec.reader("wvt.iterations")(run) == pytest.approx(20.0)


def test_stage_time_is_the_gap_to_the_record_before():
    ic = _ic(10.0, 20.0, [(11.0, "setup", {}),
                          (12.5, "wvt_build", {"seconds": 0.5}),
                          (14.0, "wvt_refresh", {"seconds": 0.25}),
                          (15.0, "wvt_done", {"iterations": 2,
                                              "seconds": 2.0}),
                          (18.0, "velocities", {}),
                          (18.5, "wvt_graph", {"seconds": 0.1})])
    run = Run(ics=[ic], setup_s=1.0)
    assert ic.stage("setup")[0][0] == pytest.approx(1.0)
    assert spec.reader("stage_s.velocities")(run) == pytest.approx(3.0)
    assert spec.reader("stage_s.magnetic_field")(run) is None
    assert spec.reader("nbr.share")(run) == pytest.approx(37.5)
    assert spec.reader("nbr.s_per_call")(run) == pytest.approx(0.375)
    assert spec.reader("wvt.capture_s")(run) == pytest.approx(0.1)


@pytest.mark.parametrize("intervals, want", [
    ([], 0.0),
    ([(0, 10)], 10.0),
    ([(0, 10), (5, 15)], 15.0),          # overlap counted once
    ([(0, 10), (2, 3)], 10.0),           # nested
    ([(20, 30), (0, 10)], 20.0),         # unsorted, apart
    ([(0, 10), (10, 20)], 20.0),         # touching
])
def test_busy_union(intervals, want):
    assert devtrace.union_ns(intervals) == want


def test_trace_busy_idle_and_op_time_within_spans():
    ops = [("stream_wvt_kernel<1>", 100, 200), ("memcpy", 150, 250),
           ("stream_wvt_kernel<1>", 900, 1000), ("fused_wvt_kernel", 300, 400)]
    spans = {devtrace.WVT_SPAN: [(100, 500)], devtrace.IC_SPAN: [(0, 1000)]}
    tr = devtrace.Trace(ops=ops, spans=spans, offset=0.0)
    assert tr.busy_s(0, 1000) == pytest.approx(350e-9)
    assert tr.idle_share(devtrace.WVT_SPAN) == pytest.approx(1 - 250 / 400)
    assert tr.idle_share("absent") is None
    s, n = tr.op_seconds(("stream_wvt_kernel", "fused_wvt_kernel"),
                         devtrace.WVT_SPAN)
    assert n == 2 and s == pytest.approx(200e-9)
    s, n = tr.op_seconds(("stream_wvt_kernel",))
    assert n == 2 and s == pytest.approx(200e-9)


def test_breakdown_puts_each_gap_on_the_stage_that_followed():
    # host stamps t map to t * 1e9 + offset ns
    ics = [_ic(0.0, 1e-6, [(0.3e-6, "setup", {}), (0.6e-6, "wvt", {}),
                           (0.9e-6, "velocities", {})])]
    ops = [("k", 100, 350), ("k", 400, 650), ("k", 700, 950)]
    tr = devtrace.Trace(ops=ops, spans={devtrace.IC_SPAN: [(0, 1000)]},
                        offset=0.0)
    b = devtrace.breakdown(tr, ics)
    assert b["device_ops"] == [["k", pytest.approx(750e-9)]]
    gaps = dict((k, v) for k, v in b["idle_gaps"])
    # 0-100 before setup's stamp (300), 350-400 before the iteration's
    # (600), 650-700 before the velocities' (900), 950-1000 after the last
    assert gaps["setup"] == pytest.approx(100e-9)
    assert gaps["wvt iteration"] == pytest.approx(50e-9)
    assert gaps["velocities"] == pytest.approx(50e-9)
    assert gaps["between ICs"] == pytest.approx(50e-9)


def test_pair_roofline_counts_the_work_the_inputs_need():
    read = spec.reader("pairs_roofline")
    ics = [_ic(0.0, 1.0, [(0.5, "wvt_done", {"iterations": 10,
                                             "seconds": 0.4})],
               n_gas=1000)]
    # 1000 lanes x 10 iterations x 295 pairs x 56 operations = 1.652e8
    # operations: 2.4657e-6 s at 67 TFLOP/s; bytes 530,000 / 3.35 TB/s =
    # 1.58e-7 s; the pair kernels took 1e-4 s of device time
    ops = [("void stream_wvt_kernel(Args)", 0, 60_000),
           ("void fused_wvt_kernel(Args)", 60_000, 100_000),
           ("stream_curl_kernel", 100_000, 900_000)]
    run = Run(ics=ics, setup_s=1.0)
    run.facts = {"desnngb": 295, "kernel": "wc6"}
    run.trace = devtrace.Trace(ops=ops, spans={devtrace.WVT_SPAN:
                                               [(0, 1_000_000)]}, offset=0.0)
    want = 100.0 * (1000 * 10 * 295 * 56 / 67e12) / 1e-4
    assert read(run) == pytest.approx(want)
    assert read(run) < 100.0
    # no pair kernel in the spans: nothing to read
    run.trace = devtrace.Trace(ops=ops[2:], spans={devtrace.WVT_SPAN:
                                                   [(0, 1_000_000)]},
                               offset=0.0)
    assert read(run) is None
    run.trace = None
    assert read(run) is None


@pytest.mark.parametrize("modules, found", [
    (["jax"], ["jax"]),
    (["jax.numpy", "numpy"], ["jax"]),
    (["jaxlib.xla_client"], ["jaxlib"]),
    (["flax.linen"], ["flax"]),
    (["toycluster_tpu", "toycluster_tpu.ops.pallas_pair"], ["toycluster_tpu"]),
    (["toycluster_tpu_torch", "toycluster_tpu_torch.models.wvt"], []),
    (["jaxtyping", "jax_extras", "torch"], []),
])
def test_import_check_compares_whole_top_level_names(modules, found):
    assert forbidden_modules(modules) == found


def test_new_config_cell_and_metric_are_found_as_files(tmp_path):
    """A later change adds a configuration, a traffic mix, a cell and a
    per-layer metric by adding files and entries: no file changes."""
    root = tmp_path
    here = root / "h100_bench"
    shutil.copytree(HERE, here, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    conf = json.loads((HERE / "configs" / "config3-merger-1e7.json")
                      .read_text())
    conf = {**conf, "name": "config9-new",
            "overrides": {**conf["overrides"], "ntotal": 2_000_000}}
    (here / "configs" / "config9-new.json").write_text(json.dumps(conf))
    (here / "traffic" / "ic-new.json").write_text(json.dumps(
        {"engine": "classed", "warmup": {"ntotal": 100_000},
         "judge_lanes": 64}))
    (here / "limits" / "c9-new.json").write_text(json.dumps(
        {"count_gap": 0}))
    (here / "metrics" / "new.layer_metric.py").write_text(
        "def read(run):\n    return 42.0\n")
    bench["configs"].append({"name": "config9-new", "source": "x",
                             "file": "h100_bench/configs/config9-new.json",
                             "reduced": []})
    bench["workloads"].append({"name": "c9-new", "config": "config9-new",
                               "traffic": "ic-new", "chips": 1, "why": "x"})
    bench["per_layer"].append({"name": "new.layer_metric", "unit": "s",
                               "better": "lower", "source": "program_span",
                               "layer": "WVT loop", "moves": "ic_s",
                               "workloads": ["c9-new"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.cell("c9-new", 1, root=root, here=here)
    assert cell.config["overrides"]["ntotal"] == 2_000_000
    assert cell.traffic["engine"] == "classed"
    assert cell.limits == {"count_gap": 0}
    names = [m["name"] for m in cell.metrics]
    assert "new.layer_metric" in names and "idle.ic" in names
    assert spec.reader("new.layer_metric", here=here)(None) == 42.0
    # the old cells do not report the new metric
    old = spec.cell("c3-merger-1e7-stream", 1, root=root, here=here)
    assert "new.layer_metric" not in [m["name"] for m in old.metrics]
    e2e = spec.cell("c9-new", 0, root=root, here=here)
    assert [m["name"] for m in e2e.metrics] == [
        m["name"] for m in bench["end_to_end"] if "workloads" not in m]
    # an end-to-end metric with a list: only the cells it names
    listed = [m for m in bench["end_to_end"] if "workloads" in m]
    for m in listed:
        for w in bench["workloads"]:
            names = [x["name"] for x in spec.cell(w["name"], 0, root=root,
                                                  here=here).metrics]
            assert (m["name"] in names) == (w["name"] in m["workloads"])


def test_every_metric_of_the_benchmark_has_a_reader():
    bench = spec.benchmark()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(spec.reader(m["name"]))
    for w in bench["workloads"]:
        for trace in (0, 1):
            spec.cell(w["name"], trace)
