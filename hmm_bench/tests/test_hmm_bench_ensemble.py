"""The four-card replica ensemble cell (``g0_ensemble4_4chip``): its
configuration and traffic resolve by name, its reader of the NCCL kernels'
device time, and a two-rank gloo run of the harness on a tiny two-replica
variant of the configuration that ends ``correct`` against the reference."""
from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from _tiny import ROOT

from hmm_bench import registry
from hmm_bench.launcher import free_port

CELL = "g0_ensemble4_4chip"


def _bench():
    return registry.benchmark(ROOT)


def test_cell_resolves_and_takes_a_card_per_rank():
    bench = _bench()
    cell = registry.cell(bench, CELL)
    conf = registry.config(ROOT, bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])
    assert cell["chips"] == traffic["ranks"] == 4
    assert conf["hmm"]["molecular dynamics material"]["number of replicas"] == 4
    assert (traffic["prefix_steps"], traffic["segment_steps"]) == (4, 4)
    names = [m["name"] for m in registry.metrics_of(bench, CELL, "per_layer")]
    assert names == ["collective_ms"]
    # every other key is g0_dogbone's
    g0 = registry.config(ROOT, bench, "g0_dogbone")
    conf["hmm"]["molecular dynamics material"]["number of replicas"] = 1
    assert conf["hmm"] == g0["hmm"]
    assert {k: conf[k] for k in ("dtype", "md_dtype", "prep", "reduced")} == \
        {k: g0[k] for k in ("dtype", "md_dtype", "prep", "reduced")}


def test_collective_ms_reads_the_nccl_kernels():
    read = registry.metric_reader("collective_ms")
    ops = [["_anonymous_namespace_::k1_run_kernel", 0.4],
           ["ncclDevKernel_AllGather_RING_LL_ncclDevKernelArgsStorage_4096", 0.016],
           ["void_at::native::vectorized_elementwise_kernel", 0.001],
           ["ncclKernel_Broadcast_RING_LL_Sum_int8_t", 0.0004],
           ["NCCLDEVKERNEL_FUTURE_NAME", 0.0006]]
    assert read({"device_ops": ops, "steps": 8}) == pytest.approx(1e3 * 0.017 / 8)
    assert read({"device_ops": ops[:1] + ops[2:3], "steps": 8}) is None
    assert read({"device_ops": ops, "steps": 0}) is None
    assert read({}) is None


CHILD = """
import json, sys, torch
sys.path[:0] = [%(root)r, %(tests)r]
torch.set_num_threads(1)
from _tiny import tiny_conf
from hmm_bench import registry, run as R
conf = tiny_conf("g0_ensemble4")
conf["hmm"]["molecular dynamics material"]["number of replicas"] = 2
traffic = dict(registry.traffic("steady4"), ranks=2)
res = R.run_cell(conf, traffic, %(seed)d, 0.2, False, torch.device("cpu"), [], [])
if "correct" in res:
    print("RESULT " + json.dumps({"correct": res["correct"], "count": res["device"]["count"],
                                  "checked": res["checked"], "attempted": res["attempted"]}))
"""


def test_two_rank_gloo_run_of_a_two_replica_variant_is_correct():
    code = CHILD % dict(root=ROOT, tests=os.path.join(ROOT, "hmm_bench", "tests"),
                        seed=2**31 + 2026)
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=ROOT, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              env=dict(env, RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                                       OMP_NUM_THREADS="1"))
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=600))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert [p.returncode for p in procs] == [0, 0], [e[-3000:] for _, e in outs]
    lines = [ln for ln in outs[0][0].splitlines() if ln.startswith("RESULT ")]
    assert len(lines) == 1 and not any(ln.startswith("RESULT ") for ln in
                                       outs[1][0].splitlines())
    res = json.loads(lines[0][len("RESULT "):])
    assert res["count"] == 2 and res["attempted"] >= 1
    assert res["correct"] is True, res["checked"]
    assert res["checked"]["qp_selection"][0] == 0
