"""Whole runs of the harness, past its look for a card, with the timed
path sound, under the precision control, and with each fault the cells
can have planted (``benchlib/controls.py``): the judge has to pass the
first and fail the rest.

The CPU cases run the program's plain kernels on a 4,000-particle merger
(M4, 8 WVT iterations), where the relaxation has moved the density only
a little: the limits there sit between that size's readings.  The
``cuda`` cases run config 3 at 1e6 particles on the card:

    python3 -m pytest h100_bench/tests -q -m cuda --noconftest
"""

import dataclasses
import sys
import time
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(HERE), str(HERE.parent)]

from benchlib import spec  # noqa: E402
from benchlib.controls import run_mode  # noqa: E402

SEED = 2**31 + 101

# at the CPU's size, limits between the sound run's readings (rho_rel
# 5.3e-6, ngb_miss 0.0020, relax_mad 0.076, relax_err 0.072, bfld_rel
# 8.5e-4, bfld_norm 2.1e-4, u_rel 4.5e-7, vdisp_rel 0.045 with bins of
# 250) and those of the control (rho_rel 0.013, ngb_miss 0.85, bfld_rel
# 0.075, u_rel 0.0058, vdisp_rel 1.0) and the faults (frozen: relax_mad
# 0.30, relax_err 0.37; half: rho_rel 325; altered: ngb_miss 1.0; fast:
# vdisp_rel 0.24; bnorm: bfld_norm 0.42, count_gap 18)
CPU_LIMITS = {"count_gap": 0, "rho_rel": 1e-4, "ngb_miss": 0.01,
              "relax_mad": 0.2, "relax_err": 0.2, "bfld_rel": 0.02,
              "bfld_norm": 0.05, "u_rel": 1e-3, "vdisp_rel": 0.12}
MODES = [("sound", True), ("precision", False), ("frozen", False),
         ("half", False), ("altered", False), ("fast", False),
         ("bnorm", False)]


def _cell(overrides, limits, warm):
    cell = spec.cell("c3-merger-1e7-stream", 0)
    return dataclasses.replace(
        cell, config={**cell.config, "overrides": {
            **cell.config["overrides"], **overrides}},
        traffic={**cell.traffic, "warmup": warm, "judge_lanes": 512,
                 "judge_vbin": 250},
        limits=limits)


@pytest.fixture(scope="module")
def cpu_cell():
    import torch
    torch.set_num_threads(4)
    return _cell({"ntotal": 4000, "sph_kernel": "m4", "wvt_max_iter": 8},
                 CPU_LIMITS, {"ntotal": 2000, "wvt_max_iter": 1})


@pytest.mark.parametrize("mode, correct", MODES)
def test_judge_on_the_cpu(cpu_cell, mode, correct):
    r = run_mode(mode, cpu_cell, SEED, 0.0, "cpu", time.perf_counter())
    print(mode, {k: v["value"] for k, v in r["checks"].items()})
    assert r["attempted"] == 1 and r["failed"] == 0
    assert r["correct"] is correct, r["checks"]


@pytest.fixture(scope="module")
def card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


# config 3 at 1e6 on the card, limits between the sound run's readings
# (rho_rel 3.6e-7, ngb_miss 0, relax_mad 0.024, relax_err 0.036,
# bfld_rel 6.1e-5, bfld_norm 8.6e-7, u_rel 6.2e-7, vdisp_rel 0.013 with
# bins of 20,000) and those of the control (rho_rel 0.014, ngb_miss 0.97,
# bfld_rel 0.065, bfld_norm 7.3e-5, u_rel 0.0053, vdisp_rel 1.0) and the
# faults (frozen: relax_mad 0.17, relax_err 0.18; half: rho_rel 2547;
# altered: ngb_miss 1.0; fast: vdisp_rel 0.23; bnorm: bfld_norm 0.42)
CARD_LIMITS = {"count_gap": 0, "rho_rel": 1e-4, "ngb_miss": 0.001,
               "relax_mad": 0.1, "relax_err": 0.1, "bfld_rel": 0.01,
               "bfld_norm": 1e-5, "u_rel": 2e-4, "vdisp_rel": 0.05}


@pytest.mark.cuda
@pytest.mark.parametrize("mode, correct", MODES)
def test_judge_on_the_card(card, mode, correct):
    cell = _cell({"ntotal": 1_000_000}, CARD_LIMITS, {"ntotal": 200_000})
    cell = dataclasses.replace(cell, traffic={**cell.traffic,
                                              "judge_lanes": 1024,
                                              "judge_vbin": 20_000})
    r = run_mode(mode, cell, SEED, 0.0, card, time.perf_counter())
    print(mode, {k: v["value"] for k, v in r["checks"].items()})
    assert r["attempted"] == 1 and r["failed"] == 0
    assert r["correct"] is correct, r["checks"]
