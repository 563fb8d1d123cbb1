"""Config 5 (``configs/config5-three-1e8.json``) on the CPU: the frozen
reference scene against the JAX package's scene of the same
configuration, recorded once in ``fixtures/jax_scene_config5.json``; the
reader of ``wvt.offload_s`` on span lists made by hand; and the judge
on a small config-5 IC that the program makes, under the cell's own
limits for the numbers that do not depend on the size.

    python3 -m pytest h100_bench/tests -q
"""

import dataclasses
import json
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import spec  # noqa: E402
from benchlib.controls import run_mode  # noqa: E402
from benchlib.main import par_text  # noqa: E402
from benchlib.window import IC, Run  # noqa: E402
from benchref import scene as ref_scene  # noqa: E402

CELL = "c5-three-1e8-stream"
NAME = "config5-three-1e8"
SEED = 2**31 + 19


def _conf():
    return json.loads((HERE / "configs" / f"{NAME}.json").read_text())


def test_frozen_scene_matches_the_jax_record(tmp_path):
    """Box, particle masses and counts, and every halo's centre,
    profiles, sampling radius and counts as the JAX package's scene of
    config 5; the third subhalo first after the two clusters, at the
    par's SubFirstPos with its mass (1e13 Msun) and the par's SubFirstVel
    as its kick."""
    conf = _conf()
    want = json.loads((HERE / "tests" / "fixtures"
                       / "jax_scene_config5.json").read_text())[NAME]
    par = tmp_path / "run.par"
    par.write_text(par_text(conf["par"]))
    mine = ref_scene.build(par, conf["overrides"])
    for k in ("boxsize", "mpart_gas", "mpart_dm"):
        assert getattr(mine, k) == pytest.approx(want[k], rel=1e-12)
    for k in ("npart_gas", "npart_dm", "sub_first"):
        assert getattr(mine, k) == want[k]
    assert mine.npart_gas + mine.npart_dm == conf["overrides"]["ntotal"]
    assert mine.units.G == pytest.approx(want["G"], rel=1e-12)
    assert len(mine.halos) == len(want["halos"]) == 72
    for h, w in zip(mine.halos, want["halos"]):
        assert list(h.d_com) == pytest.approx(w["d_com"], rel=1e-12,
                                              abs=1e-9)
        assert list(h.bulk_vel) == pytest.approx(w["bulk_vel"], rel=1e-12,
                                                 abs=1e-9)
        for k in ("rho0", "rcore", "rcut", "beta", "r_sample_gas",
                  "mass_dm", "a_hernq", "mass_gas"):
            assert getattr(h, k) == pytest.approx(w[k], rel=1e-12), k
        for k in ("have_cuspy", "is_stripped", "npart_gas", "npart_dm"):
            assert getattr(h, k) == w[k], k
    third = mine.halos[mine.sub_first]
    assert mine.sub_first == 2
    assert tuple(third.d_com) == (300.0, 200.0, 0.0)
    assert tuple(third.bulk_vel) == (-500.0, 100.0, 0.0)
    assert third.mass_dm == conf["overrides"]["sub_first_mass"]
    assert third.npart_gas > 0 and third.npart_dm > 0


def _span(name, parent, t0, seconds, **fields):
    return {"name": name, "parent": parent, "t0": t0, "seconds": seconds,
            **fields}


def _run(*span_lists):
    ics = [IC(t0=0.0, t1=100.0, records=[(90.0, "wvt_done", {
        "iterations": 27, "seconds": 80.0,
        **({"spans": spans} if spans is not None else {})})],
        peak_bytes=0, n_gas=50) for spans in span_lists]
    return Run(ics=ics, setup_s=1.0)


def test_offload_reader_sums_both_spans_an_ic():
    read = spec.reader("wvt.offload_s")
    parked = [_span("wvt_loop", -1, 0.0, 80.0),
              _span("wvt_offload", 0, 0.5, 0.25, rows=50, host_bytes=1200),
              _span("wvt_iteration", 0, 1.0, 70.0, it=0),
              _span("wvt_restore", 0, 79.0, 0.5, rows=50, host_bytes=1200)]
    plain = [_span("wvt_loop", -1, 0.0, 80.0),
             _span("wvt_iteration", 0, 1.0, 70.0, it=0)]
    assert read(_run(parked)) == pytest.approx(0.75)
    assert read(_run(parked, parked)) == pytest.approx(0.75)
    # over the window's ICs, one that parked nothing counted
    assert read(_run(parked, plain)) == pytest.approx(0.375)
    # nothing parked, or a program whose records carry no spans
    assert read(_run(plain)) is None
    assert read(_run(None)) is None


def test_offload_metric_is_the_new_cells_alone():
    names = [m["name"] for m in spec.cell(CELL, 1).metrics]
    assert "wvt.offload_s" in names
    for w in spec.benchmark()["workloads"]:
        if w["name"] != CELL:
            assert "wvt.offload_s" not in [
                m["name"] for m in spec.cell(w["name"], 1).metrics]


# 8,000 particles (4,000 gas), M4: the smallest size of this scene at
# which the program's own neighbour contract holds (99.9% of the lanes
# within 0.05 of DESNNGB; at 4,000 the loop accepts the capped h of up to
# 32 lanes, 1.6% of 2,000, and holds 95.5%).  The judge reads every gas
# lane, so that ngb_miss is the share of the set and not of a sample.
SMALL = {"ntotal": 8000, "sph_kernel": "m4", "wvt_max_iter": 8}


@pytest.fixture(scope="module")
def small_cell():
    import torch
    torch.set_num_threads(4)
    cell = spec.cell(CELL, 0)
    return dataclasses.replace(
        cell, config={**cell.config, "overrides": {
            **cell.config["overrides"], **SMALL}},
        traffic={**cell.traffic, "warmup": {"ntotal": 2000,
                                            "wvt_max_iter": 1},
                 "judge_lanes": SMALL["ntotal"], "judge_vbin": 250})


def test_judge_on_a_small_config5_ic(small_cell):
    """The cell's own limits on the numbers that do not depend on the
    size (the counts, the density sums, the neighbour counts, the
    temperatures); the relaxation, the field and the DM velocities are
    judged at full size only."""
    r = run_mode("sound", small_cell, SEED, 0.0, "cpu", time.perf_counter())
    checks = r["checks"]
    print({k: v["value"] for k, v in checks.items()})
    assert r["attempted"] == 1 and r["failed"] == 0
    for k in ("count_gap", "rho_rel", "ngb_miss", "u_rel"):
        assert checks[k]["value"] <= checks[k]["limit"], (k, checks[k])
    assert checks["count_gap"]["value"] == 0
