"""The readers of the program's spans and pair counter on the CPU, on
runs made by hand: the span arithmetic (what lies below a span, the
cut-out of wall and busy time), each reader's value, and the None each
returns where the records carry no spans.

    python3 -m pytest h100_bench/tests -q
"""

import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import devtrace, spans as bspans, spec  # noqa: E402
from benchlib.window import IC, Run  # noqa: E402

NEW = ("vel.table_s", "nbr.self_share", "nbr.idle", "wvt.step_idle",
       "pairs.yield")


def _span(name, parent, t0, seconds, **fields):
    return {"name": name, "parent": parent, "t0": t0, "seconds": seconds,
            **fields}


# one WVT loop on the host clock (s): 0-10, two iterations; the first
# builds (1-4, with a sweep 2-3.5 that captures 2.5-3.5), then steps
# (4-6, with an iteration capture 5-5.5) and waits (6-6.5); the second
# refreshes (6.5-7) and steps (7-9.5)
LOOP = [
    _span("wvt_loop", -1, 0.0, 10.0),                       # 0
    _span("wvt_iteration", 0, 0.5, 6.0, it=0),              # 1
    _span("wvt_build", 1, 1.0, 3.0, it=0, attempt=0),       # 2
    _span("wvt_sweep", 2, 2.0, 1.5, kind="capture"),        # 3
    _span("wvt_capture", 3, 2.5, 1.0, kind="sweep"),        # 4
    _span("wvt_step", 1, 4.0, 2.0, it=0, kind="eager"),     # 5
    _span("wvt_capture", 5, 5.0, 0.5, kind="iteration"),    # 6
    _span("wvt_wait", 1, 6.0, 0.5, it=0),                   # 7
    _span("wvt_iteration", 0, 6.5, 3.5, it=1),              # 8
    _span("wvt_refresh", 8, 6.5, 0.5, it=1),                # 9
    _span("wvt_step", 8, 7.0, 2.5, it=1, kind="replay"),    # 10
]
VEL = [_span("velocity_table", -1, 12.0, 0.75, halo=0),
       _span("velocity_fE", 0, 12.0, 0.5),
       _span("velocity_cdf", 0, 12.5, 0.25),
       _span("velocity_table", -1, 12.75, 0.25, halo=1)]


def _run(loop=LOOP, vel=VEL, pairs=16384 * 1000, ops=(), n_ics=1):
    done = {"iterations": 2, "seconds": 10.0}
    if loop is not None:
        done["spans"] = loop
    if pairs is not None:
        done["pairs_walked"] = pairs
    velf = {} if vel is None else {"spans": vel}
    ics = [IC(t0=0.0, t1=14.0, records=[(10.0, "wvt_done", done),
                                         (13.0, "velocities", velf)],
              peak_bytes=0, n_gas=100) for _ in range(n_ics)]
    run = Run(ics=ics, setup_s=1.0, facts={"desnngb": 50, "kernel": "m4"})
    # the trace's clock: host seconds x 1e9 (offset 0)
    run.trace = devtrace.Trace(ops=list(ops), spans={}, offset=0.0)
    return run


def _ns(a, b):
    return (a * 1e9, b * 1e9)


def test_below_takes_the_topmost_named_spans():
    assert bspans.below(LOOP, 0, ("wvt_capture",)) == [4, 6]
    assert bspans.below(LOOP, 1, ("wvt_build", "wvt_capture")) == [2, 6]
    assert bspans.below(LOOP, 2, ("wvt_capture",)) == [4]
    assert bspans.below(LOOP, 8, ("wvt_capture",)) == []
    assert bspans.self_seconds(LOOP, 2, ("wvt_capture",)) == 2.0


def test_wall_and_busy_with_children_cut_out():
    # busy 1.5-3.0 (1.5 s, 0.5 s of it inside the capture 2.5-3.5)
    run = _run(ops=[("k", *_ns(1.5, 3.0))])
    wall, busy = bspans.wall_busy(run.trace, bspans.Busy(run.trace), LOOP, 2,
                                  ("wvt_capture",))
    assert wall == pytest.approx(2.0)
    assert busy == pytest.approx(1.0)


def test_the_busy_index_reads_what_the_trace_reads():
    """``Busy`` against ``devtrace.Trace.busy_s`` on overlapping,
    nested, touching and empty ops, at windows inside, across and
    outside them."""
    import random
    rng = random.Random(5)
    ops = [("k", 10, 20), ("k", 15, 30), ("k", 30, 40), ("k", 50, 50),
           ("k", 60, 90), ("k", 65, 70), ("k", 100, 101)]
    ops += [("k", a, a + rng.randrange(0, 30))
            for a in (rng.randrange(0, 400) for _ in range(200))]
    tr = devtrace.Trace(ops=ops, spans={}, offset=0.0)
    busy = bspans.Busy(tr)
    windows = [(0, 500), (12, 18), (20, 35), (40, 60), (95, 99), (101, 200),
               (30, 30), (500, 600)]
    windows += [(a, a + rng.randrange(0, 100))
                for a in (rng.randrange(-20, 450) for _ in range(300))]
    for lo, hi in windows:
        assert busy.busy_s(lo, hi) == pytest.approx(tr.busy_s(lo, hi),
                                                     abs=1e-15)


def test_velocity_tables_are_seconds_an_ic():
    assert spec.reader("vel.table_s")(_run()) == pytest.approx(1.0)
    assert spec.reader("vel.table_s")(_run(n_ics=2)) == pytest.approx(1.0)


def test_neighbour_self_share_cuts_out_the_sweep_captures():
    # builds and refreshes 3.0 + 0.5 s, less the capture 1.0 s, over 10 s
    assert spec.reader("nbr.self_share")(_run()) == pytest.approx(25.0)


def test_neighbour_idle_over_builds_and_refreshes():
    # build less capture: 1-2.5 and 3.5-4 (2.0 s wall); refresh 6.5-7
    # (0.5 s); busy: 1.0-2.0 and 6.5-6.75 (the op inside the capture is
    # cut out with it)
    ops = [("k", *_ns(1.0, 2.0)), ("k", *_ns(2.6, 3.4)),
           ("k", *_ns(6.5, 6.75))]
    got = spec.reader("nbr.idle")(_run(ops=ops))
    assert got == pytest.approx(100.0 * (1.0 - 1.25 / 2.5))


def test_step_idle_cuts_out_builds_refreshes_and_captures():
    # iteration 0: 0.5-6.5 less the build 1-4 and the capture 5-5.5:
    # 2.5 s; iteration 1: 6.5-10 less the refresh 6.5-7: 3.0 s.  Busy
    # 4.0-5.0 (1.0), 5.0-5.5 cut, 7.0-9.0 (2.0), 1.0-4.0 cut
    ops = [("k", *_ns(1.0, 4.0)), ("k", *_ns(4.0, 5.5)),
           ("k", *_ns(7.0, 9.0))]
    got = spec.reader("wvt.step_idle")(_run(ops=ops))
    assert got == pytest.approx(100.0 * (1.0 - 3.0 / 5.5))


def test_pair_yield_is_the_needed_over_the_walked_pairs():
    # 100 gas x 2 iterations x 50 over 16,384,000 walked, two ICs summed
    for n in (1, 2):
        got = spec.reader("pairs.yield")(_run(n_ics=n))
        assert got == pytest.approx(100.0 * 100 * 2 * 50 / 16_384_000)


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_or_counter_reads_none(name):
    """A run of a program whose records carry neither spans nor
    ``pairs_walked`` (the parent of this benchmark's spans) reports
    nothing, and an untraced run no device-trace metric."""
    assert spec.reader(name)(_run(loop=None, vel=None, pairs=None)) is None
    run = _run()
    run.trace = None
    if name in ("nbr.idle", "wvt.step_idle"):
        assert spec.reader(name)(run) is None
    else:
        assert spec.reader(name)(run) is not None


def test_the_new_entries_of_the_benchmark_name_reader_files():
    bench = spec.benchmark()
    entries = {m["name"]: m for m in bench["per_layer"]}
    layers = {m["layer"] for m in bench["per_layer"] if m["name"] not in NEW}
    for name in NEW:
        assert (HERE / "metrics" / f"{name}.py").is_file()
        assert callable(spec.reader(name))
        # an existing layer, reported by every cell
        assert entries[name]["layer"] in layers
        assert "workloads" not in entries[name]
        for w in bench["workloads"]:
            assert name in {m["name"] for m in
                            spec.cell(w["name"], 1).metrics}
