"""The program window (``hmm_bench/program_window.py``): its readers on
synthetic readings, and the window itself on the CPU tiny cell, where the
port's tracer counts the host syncs and MD job-steps that the benchmark
also counts from the outside."""
from __future__ import annotations

import pytest
import torch

from _tiny import tiny_conf, traffic

from hmm_bench import program_window as PW
from hmm_bench import run as R


def test_readers_per_step():
    ctx = dict(prog_steps=4, prog_idle_fe_s=0.004, prog_idle_cluster_s=0.008,
               prog_idle_md_s=0.02, prog_md_device_s=0.2, prog_sync_s=0.001,
               prog_counters={"host_syncs": 12, "md.job_steps": 4 * 70000})
    assert PW.read(ctx) == pytest.approx({
        "fe_idle_ms": 1.0, "cluster_idle_ms": 2.0, "md_idle_ms": 5.0, "md_device_ms": 50.0,
        "host_syncs": 3.0, "sync_wait_ms": 0.25, "md_job_steps": 70000.0})


@pytest.mark.parametrize("ctx", [{}, {"prog_steps": 0}])
def test_readers_return_nothing_without_a_window(ctx):
    assert PW.read(ctx) == {m: None for m in PW.METRICS}


def test_interval_overlap():
    a = PW._union([[0, 4], [2, 6], [10, 12]])
    assert a == [[0, 6], [10, 12]]
    assert PW._overlap(a, [[5, 11]]) == 2
    assert PW._overlap(a, [[-3, 20]]) == 8
    assert PW._overlap([], a) == 0


@pytest.fixture(scope="module")
def g0_cell():
    cell, _, _ = R.setup_cell(tiny_conf("g0_dogbone"), traffic(), 2**31 + 4321,
                              torch.device("cpu"))
    return cell


def test_program_window_on_the_tiny_cell(g0_cell):
    from scema_tpu_torch.utils import trace

    ctx = PW.program_window(g0_cell, segments=1)
    assert not trace.enabled()
    n = g0_cell.seg
    assert ctx["prog_steps"] == len(ctx["prog_step_s"]) == n
    got = PW.read(ctx)
    # the points where the host waits, every step: the reduction's pick, the
    # job list and its count, has_result's scatter, 3 copies of the Voigt
    # weights, 4 of the MD runs' dt and T
    assert got["host_syncs"] == 11
    assert ctx["prog_counters"]["host_syncs.cluster.reduce"] == n
    work = R.md_work(g0_cell, ctx["prog_last"], 1)
    assert got["md_job_steps"] * n == work["strain_steps"] + work["sample_steps"]
    # no kernel runs on the CPU: the layers' spans hold all the "idle" time
    for k in ("fe_idle_ms", "cluster_idle_ms", "md_idle_ms", "sync_wait_ms"):
        assert got[k] > 0, k
    assert got["md_device_ms"] is None
    # between the steps: the clock's own lines
    assert 0 <= ctx["prog_idle_outside_steps_s"] < 0.05 * ctx["prog_window_s"]


def test_program_window_leaves_the_steps_unchanged(g0_cell):
    ctx = PW.program_window(g0_cell, segments=1)
    c, c2, out = ctx["prog_last"][g0_cell.seg - 1]
    for i, c_in, c_out, o in g0_cell.segment():
        pass
    for a, b in zip(torch.utils._pytree.tree_leaves((c2, out)),
                    torch.utils._pytree.tree_leaves((c_out, o))):
        assert not torch.is_tensor(a) or torch.equal(a, b)


def test_program_window_without_a_tracer(g0_cell, monkeypatch):
    monkeypatch.setattr(PW, "_tracer", lambda: None)
    assert PW.program_window(g0_cell, segments=1) == {}
