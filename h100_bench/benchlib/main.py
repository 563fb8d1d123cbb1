"""One run of one cell: set-up, the measured window, the judge, the
result line.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

Set-up (``setup_s``, from the first line of ``run.py`` to the window's
start): importing torch and the program, loading or building its
kernels, and one warm-up IC of the cell's own configuration and engine at
the traffic's ``warmup`` overrides.  The window then makes
ICs of the cell at full size, back to back (``window.run_window``); with
``--trace 1`` under ``torch.profiler``.  Every IC is the
configuration's whole job: its ``Config.seed`` fixes the scene, subhalos
and all, and draws the particles, so that every run does the same work
and the WVT loop stops by its own rule, after as many iterations in
every run.  The run's seed draws the lanes that the judge samples.
After it, the last IC's particle set is copied to the host, the program's
state is freed, and the judge compares it with the reference.  The last
lines of standard error list each compared number beside its limit; the
last line of standard output is the result's JSON object.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time
import traceback

from . import spec
from .window import Run, run_window

FORBIDDEN = ("jax", "jaxlib", "flax", "toycluster_tpu")
FIELDS = ("pos", "vel", "u", "rho", "hsml", "bfld", "halo")


def forbidden_modules(modules=None):
    """Top-level names in ``sys.modules`` (the part before the first dot,
    compared whole) that a run must not load."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(FORBIDDEN))


def par_text(tags):
    """A par file of the ``tags`` {tag: value} (one tag a line)."""
    return "".join(f"{k} {v}\n" for k, v in tags.items())


def parse_args(argv):
    p = argparse.ArgumentParser(prog="h100_bench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def _say(msg):
    print(msg, file=sys.stderr, flush=True)


class Program:
    """The system under test: ``make_ics`` of ``toycluster_tpu_torch`` on
    one device."""

    def __init__(self, device):
        import torch
        from toycluster_tpu_torch.config import parse_par_file
        from toycluster_tpu_torch.pipeline import make_ics
        self.torch = torch
        self.device = device
        self.cuda = device.startswith("cuda")
        self.parse = parse_par_file
        self.make_ics = make_ics

    def sync(self):
        if self.cuda:
            self.torch.cuda.synchronize()

    def ic(self, par, overrides, engine, log, span=None):
        """One IC; returns (n_gas, allocator peak bytes, particles).  The
        configuration's own ``Config.seed`` draws its scene (the
        substructure draws from it) and its particles."""
        cfg = self.parse(par, **overrides)
        ctx = (self.torch.profiler.record_function(span) if span
               else contextlib.nullcontext())
        with ctx:
            if span:
                log.span_start = time.perf_counter()
            _, parts = self.make_ics(cfg, device=self.device, engine=engine,
                                     write=False, log=log)
            self.sync()
        peak = (self.torch.cuda.max_memory_allocated() if self.cuda else 0)
        return parts.n_gas, peak, parts

    def device_info(self, count, peak):
        kind = self.torch.cuda.get_device_name(0) if self.cuda else "cpu"
        return dict(platform="gpu" if self.cuda else "cpu", kind=kind,
                    count=count, memory_peak_bytes=peak)


def run_cell(cell, seed, seconds, trace, device, t_start, judge_fn=None):
    """A whole run of ``cell``; returns the result dict (its last key,
    ``checks``, holds each compared number beside its limit)."""
    from .devtrace import IC_SPAN, Trace, breakdown, events
    from .judge import judge, scene_facts, verdict
    from .window import Recorder
    import torch
    from benchref import scene as ref_scene

    prog = Program(device)
    engine = cell.traffic["engine"]
    overrides = dict(cell.config["overrides"])
    with tempfile.TemporaryDirectory() as tmp:
        par = os.path.join(tmp, f"{cell.config_name}.par")
        with open(par, "w") as fd:
            fd.write(par_text(cell.config["par"]))

        warm = {**overrides, **cell.traffic.get("warmup", {})}
        t = time.perf_counter()
        prog.ic(par, warm, engine, Recorder())
        _say(f"warm-up IC: {time.perf_counter() - t:.3f} s")

        prof = None
        if trace:
            from torch.profiler import ProfilerActivity, profile
            acts = [ProfilerActivity.CPU]
            if prog.cuda:
                acts.append(ProfilerActivity.CUDA)
            prof = profile(activities=acts)
        failures = []

        def make_ic(rec):
            try:
                return prog.ic(par, overrides, engine, rec,
                               span=IC_SPAN if trace else None)
            except Exception:   # the run reports the failed IC
                failures.append(traceback.format_exc())
                _say(failures[-1])
                return None

        t_window = time.perf_counter()
        setup_s = t_window - t_start
        with (prof if prof is not None else contextlib.nullcontext()):
            ics, last = run_window(make_ic, seconds)
        window_s = time.perf_counter() - t_window
        _say(f"window: {len(ics)} ICs in {window_s:.3f} s")
        for ic in ics:
            done = [f for _, f in ic.stage("wvt_done")]
            stamps = [ic.t0] + [t for t, _, _ in ic.records]
            gaps = sorted(((b - a, st) for a, b, (_, st, _) in
                           zip(stamps, stamps[1:], ic.records)),
                          reverse=True)[:2]
            _say(f"IC {ic.seconds:.3f} s: " + " ".join(
                f"{k}={done[0][k]!r}" for k in ("iterations", "seconds",
                                                "captured", "replayed")
                if done and k in done[0])
                + " longest: " + ", ".join(f"{st} {g:.3f}" for g, st in gaps))

        out = None
        if last is not None:
            out = {k: getattr(last, k).detach().cpu() for k in FIELDS}
        del last
        if prog.cuda:
            torch.cuda.empty_cache()

        run = Run(ics=ics, setup_s=setup_s,
                  facts=scene_facts(ref_scene.build(par, overrides)))
        if prof is not None:
            ops, spans = events(prof)
            offset = (spans[IC_SPAN][0][0] - ics[0].span_start * 1e9
                      if ics and spans.get(IC_SPAN) else 0.0)
            run.trace = Trace(ops=ops, spans=spans, offset=offset)
        values = {}
        if out is not None:
            t = time.perf_counter()
            values = (judge_fn or judge)(
                out, run.facts, seed, int(cell.traffic["judge_lanes"]),
                device, vbin=int(cell.traffic["judge_vbin"]))
            _say(f"judge: {time.perf_counter() - t:.3f} s")

    metrics = {}
    for m in cell.metrics:
        v = spec.reader(m["name"])(run) if ics else None
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    correct, checks = verdict(values, cell.limits)
    dev = prog.device_info(cell.chips,
                           max((ic.peak_bytes for ic in ics), default=0))
    result = {"correct": bool(correct and not failures and ics),
              "attempted": len(ics) + len(failures),
              "failed": len(failures), "metrics": metrics, "device": dev}
    if run.trace is not None and run.trace.spans.get(IC_SPAN):
        lo, hi = run.trace.spans[IC_SPAN][0][0], run.trace.spans[IC_SPAN][-1][1]
        dev["busy_s"] = run.trace.busy_s(lo, hi)
        dev["window_s"] = (hi - lo) * 1e-9
        result["breakdown"] = breakdown(run.trace, ics)
    result["checks"] = checks
    return result


def main(argv, t_start):
    args = parse_args(argv)
    cell = spec.cell(args.workload, args.trace)
    import torch
    if not torch.cuda.is_available():
        _say("no CUDA device: the benchmark runs on the card only")
        return 2
    if torch.cuda.device_count() < cell.chips:
        _say(f"{args.workload} needs {cell.chips} devices, "
             f"{torch.cuda.device_count()} found")
        return 2
    result = run_cell(cell, args.seed, args.seconds, args.trace, "cuda",
                      t_start)
    found = forbidden_modules()
    if found:
        _say(f"modules that the run must not load: {', '.join(found)}")
        return 3
    for name, c in result["checks"].items():
        _say(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0
