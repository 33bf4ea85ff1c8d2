"""Where the benchmark finds a cell's parts, by the names in BENCHMARK.json:

* a cell: the ``workloads`` entry of that name;
* its configuration: the ``file`` of its ``configs`` entry (a JSON object:
  the HMM input under ``hmm``, the types, the prep and the material box);
* its traffic: ``hmm_bench/traffic/<traffic>.json``;
* a per-layer metric: ``hmm_bench/metrics/<name>.py``, whose ``read(ctx)``
  returns the number or None.

Adding any of them is adding files and entries; nothing here names one.
"""
from __future__ import annotations

import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: str) -> dict:
    return _load_json(os.path.join(root, "BENCHMARK.json"))


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(root: str, bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return _load_json(os.path.join(root, c["file"]))
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = HERE) -> dict:
    return _load_json(os.path.join(bench_dir, "traffic", f"{name}.json"))


def metric_reader(name: str, bench_dir: str = HERE):
    """The ``read`` function of ``metrics/<name>.py``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"hmm_bench_metric_{len(name)}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def metrics_of(bench: dict, cell_name: str, kind: str) -> list:
    """The ``end_to_end`` or ``per_layer`` entries that this cell reports."""
    return [m for m in bench[kind] if cell_name in m.get("workloads", [cell_name])]
