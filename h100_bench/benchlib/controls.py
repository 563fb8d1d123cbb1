"""The control and the planted faults that the judge has to catch.

None of this runs in a benchmark run.  ``control.py`` runs them on the
card at a cell's own size (the readings that set the limits), and the
tests run them at a test's size.

* ``precision``: the precision control.  The configuration states float32
  (the program's particle fields and sums); the reference takes the
  program's place at the sampled lanes computed in bfloat16
  (``judge.judge(control=)``).
* ``frozen``: a fault planted in the program's timed path, a WVT
  iteration that returns the positions it was given (its state
  unchanged).
* faults in the set that ``make_ics`` hands back, where it is produced:
  ``half``, the density of every second gas lane left out and filled
  with the mean over the rest; ``altered``, every gas smoothing length
  altered by 1%; ``fast``, every DM velocity about its halo's mean
  altered by 10%; ``bnorm``, the field normalised without its sqrt(3).

The control and the faults of the handed-back set judge the same IC as
the sound run (``run_modes``); ``frozen`` needs an IC of its own.
"""

from __future__ import annotations

import contextlib
import functools
import math

from . import judge as judge_mod

MODES = ("sound", "precision", "frozen", "half", "altered", "fast", "bnorm")
SHARED = ("sound", "precision", "half", "altered", "fast", "bnorm")


def fault(mode, out):
    """The handed-back set ``out`` (host tensors, gas first) with the
    fault ``mode`` applied."""
    out = dict(out)
    n_gas = out["rho"].shape[0]
    if mode == "half":
        rho = out["rho"].clone()
        rho[1::2] = rho[0::2].mean()
        out["rho"] = rho
    elif mode == "altered":
        out["hsml"] = out["hsml"] * 1.01
    elif mode == "fast":
        vel = out["vel"].clone()
        halo = out["halo"][n_gas:].long()
        dm = vel[n_gas:]
        for j in halo.unique().tolist():
            at = halo == j
            mean = dm[at].mean(0)
            dm[at] = mean + 1.1 * (dm[at] - mean)
        out["vel"] = vel
    elif mode == "bnorm":
        out["bfld"] = out["bfld"] * math.sqrt(3.0)
    elif mode not in ("sound", "precision"):
        raise ValueError(f"{mode!r} is not a fault of the handed-back set")
    return out


@contextlib.contextmanager
def frozen_loop():
    """Every WVT iteration, queued ahead or not, hands on the positions
    it was given."""
    from toycluster_tpu_torch.models import wvt
    iterate, speculate = wvt._Loop.iterate, wvt._Loop.speculate

    @functools.wraps(iterate)
    def frozen_iterate(self, state, pos_gas, *args, **kw):
        out = iterate(self, state, pos_gas, *args, **kw)
        return {**out, "pos_new": pos_gas}

    @functools.wraps(speculate)
    def frozen_speculate(self, state, out, *args, **kw):
        nxt = speculate(self, state, out, *args, **kw)
        return {**nxt, "pos_new": out["pos_new"]}

    wvt._Loop.iterate, wvt._Loop.speculate = frozen_iterate, frozen_speculate
    try:
        yield
    finally:
        wvt._Loop.iterate, wvt._Loop.speculate = iterate, speculate


def run_modes(modes, cell, seed, seconds, device, t_start):
    """``main.run_cell`` of ``cell`` once, with the IC's set judged under
    each of ``modes`` (all of ``SHARED``, or ``frozen`` alone); returns
    {mode: result}."""
    from .main import run_cell
    from .judge import verdict
    import torch
    modes = list(modes)
    if modes == ["frozen"]:
        with frozen_loop():
            return {"frozen": run_cell(cell, seed, seconds, 0, device,
                                       t_start)}
    bad = [m for m in modes if m not in SHARED]
    if bad or not modes:
        raise ValueError(f"modes {modes!r}: one of {MODES} at a time, or "
                         f"any of {SHARED} together")
    values = {}

    def judge_all(out, facts, seed, lanes, device, **kw):
        for m in modes:
            control = torch.bfloat16 if m == "precision" else None
            values[m] = judge_mod.judge(fault(m, out), facts, seed, lanes,
                                        device, control=control, **kw)
        return values[modes[0]]

    first = run_cell(cell, seed, seconds, 0, device, t_start,
                     judge_fn=judge_all)
    results = {}
    for m in modes:
        ok, checks = verdict(values.get(m, {}), cell.limits)
        results[m] = {**first, "checks": checks,
                      "correct": bool(ok and first["failed"] == 0
                                      and first["attempted"] > 0)}
    return results


def run_mode(mode, cell, seed, seconds, device, t_start):
    """``main.run_cell`` of ``cell`` with the control or fault ``mode``
    in place; returns its result."""
    if mode not in MODES:
        raise ValueError(f"unknown mode {mode!r}")
    return run_modes([mode], cell, seed, seconds, device, t_start)[mode]
