"""Finding a cell's parts by name.

``BENCHMARK.json`` at the root of the checkout names the cells
(``workloads``), their configurations and traffic, and the metrics.
Everything that belongs to one of them is a file of its own under the
benchmark's folder, found by that name:

* ``configs/<config>.json``  (the configuration's ``file``): the par's
  tags and values (``par``), the preset's ``Config`` overrides
  (``overrides``), the source, ``assumed`` and ``reduced``;
* ``traffic/<traffic>.json``: the job a cell repeats (the neighbour
  engine, the warm-up size, the gas lanes the judge samples and the
  fewest DM particles of a bin of its velocity check);
* ``limits/<cell>.json``: the limit of each number the judge compares;
* ``metrics/<metric>.py``: the reader of one metric, ``read(run)``.

A new configuration, cell or metric is a new file and a new entry in
``BENCHMARK.json``; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: dict
    metrics: list       # BENCHMARK.json metric entries this cell reports


def load_json(path):
    with open(path) as fd:
        return json.load(fd)


def benchmark(root=ROOT):
    return load_json(Path(root) / "BENCHMARK.json")


def _listed(metric, cell_name, default):
    """Whether ``cell_name`` reports ``metric``: by its ``workloads``
    list where it has one; else ``default`` (every cell reports an
    unlisted end-to-end metric, and an unlisted per-layer metric where it
    reports the end-to-end metric that it moves)."""
    listed = metric.get("workloads")
    return default if listed is None else cell_name in listed


def cell(name, trace, root=ROOT, here=HERE):
    """The cell ``name`` of the benchmark, with the metrics it reports
    in a run with ``trace`` (the end-to-end ones without, the per-layer
    ones with)."""
    bench = benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _listed(m, name, True)]
    names = {m["name"] for m in e2e}
    metrics = ([m for m in bench["per_layer"]
                if _listed(m, name, m["moves"] in names)]
               if trace else e2e)
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=entry["config"],
                config=load_json(Path(root) / conf["file"]),
                traffic_name=entry["traffic"],
                traffic=load_json(here / "traffic" / f"{entry['traffic']}.json"),
                limits=load_json(here / "limits" / f"{name}.json"),
                metrics=metrics)


def reader(metric_name, here=HERE):
    """The ``read`` function of ``metrics/<metric_name>.py``."""
    path = here / "metrics" / f"{metric_name}.py"
    spec = importlib.util.spec_from_file_location(
        "h100_bench_metric_" + metric_name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
