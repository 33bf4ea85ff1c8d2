"""The benchmark finds every part of a cell by name, and picks up parts
added as files with no edit to the harness."""
from __future__ import annotations

import json
import os
import shutil

from _tiny import ROOT

from hmm_bench import registry


def _bench():
    return registry.benchmark(ROOT)


def test_every_cell_resolves_by_name():
    bench = _bench()
    assert bench["workloads"]
    for w in bench["workloads"]:
        cell = registry.cell(bench, w["name"])
        conf = registry.config(ROOT, bench, cell["config"])
        assert {"source", "reduced", "assumed", "hmm", "dtype", "md_dtype"} <= set(conf)
        traffic = registry.traffic(cell["traffic"])
        assert traffic["segment_steps"] >= 1 and traffic["prefix_steps"] >= 1
        for m in registry.metrics_of(bench, w["name"], "per_layer"):
            assert callable(registry.metric_reader(m["name"]))
        names = {m["name"] for m in registry.metrics_of(bench, w["name"], "end_to_end")}
        assert {"macro_step_s", "macro_step_p95_s", "setup_s"} <= names


def test_config_entries_match_their_files():
    bench = _bench()
    for c in bench["configs"]:
        conf = registry.config(ROOT, bench, c["name"])
        assert conf["name"] == c["name"]
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]


def test_added_files_are_picked_up_without_edits(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(os.path.join(ROOT, "hmm_bench"), root / "hmm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = _bench()
    conf = json.loads((root / "hmm_bench/configs/g0_dogbone.json").read_text())
    conf["name"] = "g0_two_replicas"
    conf["hmm"]["molecular dynamics material"]["number of replicas"] = 2
    (root / "hmm_bench/configs/g0_two_replicas.json").write_text(json.dumps(conf))
    (root / "hmm_bench/traffic/onset.json").write_text(json.dumps(
        {"name": "onset", "why": "steps 1-4", "prefix_steps": 1, "segment_steps": 4}))
    (root / "hmm_bench/metrics/steps_read.py").write_text(
        "def read(ctx):\n    return ctx.get('steps')\n")
    bench["configs"].append({"name": "g0_two_replicas", "source": "s",
                             "file": "hmm_bench/configs/g0_two_replicas.json",
                             "reduced": [], "why": "w"})
    bench["workloads"].append({"name": "g0_onset", "config": "g0_two_replicas",
                               "traffic": "onset", "chips": 1, "why": "w"})
    bench["per_layer"].append({"name": "steps_read", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "MD jobs",
                               "moves": "macro_step_s", "workloads": ["g0_onset"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    b = registry.benchmark(str(root))
    cell = registry.cell(b, "g0_onset")
    c = registry.config(str(root), b, cell["config"])
    assert c["hmm"]["molecular dynamics material"]["number of replicas"] == 2
    t = registry.traffic(cell["traffic"], bench_dir=str(root / "hmm_bench"))
    assert t["prefix_steps"] == 1
    names = [m["name"] for m in registry.metrics_of(b, "g0_onset", "per_layer")]
    assert names == ["steps_read"]
    assert registry.metric_reader("steps_read", bench_dir=str(root / "hmm_bench"))(
        {"steps": 8}) == 8
    # the cells that were there keep their metrics and do not take the new one
    assert "steps_read" not in [m["name"] for m in registry.metrics_of(b, "g0_steady",
                                                                         "per_layer")]


def test_readers_return_nothing_without_readings():
    bench = _bench()
    for m in bench["per_layer"]:
        assert registry.metric_reader(m["name"])({}) is None
