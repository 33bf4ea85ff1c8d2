"""The harness on the CPU at a tiny size (the port's plain kernel versions,
float64): it agrees with its reference, its result line has the fixed
keys, each fault planted under the timed path turns ``correct`` false, the
control (the reference in bfloat16) fails the limits, and no module of JAX
or the JAX package is loaded."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from _tiny import ROOT, tiny_conf, traffic

from hmm_bench import registry
from hmm_bench import run as R
from hmm_bench.reference import check as CK

FIELDS = ("pos", "vel", "h", "vxi")


def _metrics(kind):
    return registry.metrics_of(registry.benchmark(ROOT), "g0_steady", kind)


@pytest.fixture(scope="module")
def g0_cell():
    cell, fp0, setup_s = R.setup_cell(tiny_conf("g0_dogbone"), traffic(), 2**31 + 12345,
                                      torch.device("cpu"))
    return cell, fp0, setup_s


def _measure(cell_fp, trace=False, control=False, seconds=0.2):
    cell, fp0, setup_s = cell_fp
    return R.measure(cell, fp0, setup_s, seconds, trace, _metrics("per_layer"),
                     _metrics("end_to_end"), control=control)


def test_harness_agrees_with_reference(g0_cell):
    res = _measure(g0_cell)
    assert res["correct"], res["checked"]
    for k, (v, lim) in res["checked"].items():
        assert v <= lim, (k, v, lim)
    assert res["checked"]["fe_strain"][0] < 1e-9
    assert res["checked"]["md_stress"][0] < 1e-9
    line = R.result_line(res)
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[-1] == "checked"
    assert set(line["metrics"]) == {"macro_step_s", "macro_step_p95_s", "setup_s"}
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    json.dumps(line)


def test_traced_line_has_per_layer_metrics(g0_cell):
    res = _measure(g0_cell, trace=True)
    assert res["correct"], res["checked"]
    line = R.result_line(res)
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU no kernel runs: the roofline share has nothing to read
    assert {"fe_cluster_ms", "md_update_ms", "md_launches",
            "device_idle_share"} <= set(line["metrics"])
    assert "md_roofline" not in line["metrics"]


def _patched_md(fault):
    """strain_and_homogenize as the coupled step calls it, with ``fault``."""
    import scema_tpu_torch.hmm.md_coupling as MC
    from scema_tpu_torch.md import engine as E

    real = MC.strain_and_homogenize

    def run(sys_, st, dl, params, active=None):
        n = st.pos.shape[0]
        if fault == "half":  # the second half left out, its stress the mean of the rest
            k = max(1, n // 2)
            sub = E.MDState(*(getattr(st, f)[:k] for f in FIELDS))
            out, sig = real(sys_, sub, dl[:k], params,
                            None if active is None else active[:k])
            fill = sig.mean(0, keepdim=True).expand((n - k,) + sig.shape[1:])
            return (E.MDState(*(torch.cat([getattr(out, f), getattr(st, f)[k:]])
                                for f in FIELDS)), torch.cat([sig, fill]))
        out, sig = real(sys_, st, dl, params, active)
        sig = sig.clone()
        sig[0] = sig[0] * 1.5  # one answer altered where it is produced
        return out, sig

    return MC, real, run


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_each_fault_turns_correct_false(g0_cell, fault):
    cell = g0_cell[0]
    if fault == "unchanged":  # a step that returns its state unchanged
        real = cell.hmm.step
        object.__setattr__(cell.hmm, "step", lambda c: (c, real(c)[1]))
        try:
            res = _measure(g0_cell)
        finally:
            object.__delattr__(cell.hmm, "step")
    else:
        MC, real, run = _patched_md(fault)
        MC.strain_and_homogenize = run
        try:
            res = _measure(g0_cell)
        finally:
            MC.strain_and_homogenize = real
    assert not res["correct"], res["checked"]


def test_control_fails_the_limits(g0_cell):
    res = _measure(g0_cell, control=True)
    assert res["correct"]
    ctrl, over = res["control"], res["control_over"]
    assert "carry_unchanged" not in ctrl
    for k in ("fe_strain", "fe_disp", "md_box", "md_stress"):
        assert ctrl[k] > CK.LIMITS[k], (k, ctrl[k], CK.LIMITS[k])
        assert k in over
    assert CK.over_limit({k: v for k, (v, _) in res["checked"].items()}) == {}


def test_no_jax_module_after_a_run():
    code = (
        "import sys, torch; sys.path.insert(0, %r); sys.path.insert(0, %r)\n"
        "from _tiny import tiny_conf, traffic\n"
        "from hmm_bench import run as R\n"
        "res = R.run_cell(tiny_conf('si_sw_dogbone'), traffic(), 5, 0.05, False,\n"
        "                 torch.device('cpu'), [], [])\n"
        "print('FORBIDDEN', R.forbidden_modules(), res['correct'])\n"
    ) % (ROOT, os.path.join(ROOT, "hmm_bench", "tests"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         cwd=ROOT, env=env, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "FORBIDDEN [] True" in out.stdout


def _cli(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "-m", "hmm_bench.run", "--workload", "g0_steady",
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, cwd=cwd, env=env, timeout=300)


def test_cli_without_a_card_prints_no_result():
    out = _cli(ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_cli_in_a_bare_directory_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    shutil.copytree(os.path.join(ROOT, "hmm_bench"), tmp_path / "hmm_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _cli(tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.requires_cuda
def test_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the cell runs the port's CUDA kernels")
    out = subprocess.run([sys.executable, "-m", "hmm_bench.run", "--workload", "si_sw_steady",
                          "--seed", "3", "--seconds", "2", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    line = json.loads(out.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checked"]
