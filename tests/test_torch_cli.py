"""The port's command line and its independence from JAX."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from scema_tpu_torch import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture()
def empty_cfg(tmp_path):
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps({}))
    return str(p)


def test_run_cpu_hooke_two_steps(empty_cfg, capsys):
    """The verify-skill milestone: max displacement = steps * 0.002 * 0.08."""
    assert cli.main(["run", empty_cfg, "--cpu", "--hooke", "--steps", "2"]) == 0
    out = capsys.readouterr().out
    assert "Timestep 2 at time 1e-06" in out
    assert "flagged qps 144" in out  # the top-cell layer at step 1
    line = next(l for l in out.splitlines() if l.startswith("Max displacement"))
    assert np.isclose(float(line.split()[2]), 2 * 0.002 * 0.08, rtol=1e-9)


def test_run_without_cpu_needs_cuda(empty_cfg, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the run would proceed")
    assert cli.main(["run", empty_cfg, "--quick-prep", "--steps", "1"]) != 0
    assert "no CUDA device" in capsys.readouterr().err


def test_run_without_quick_prep_names_the_roadmap_item(empty_cfg, monkeypatch):
    """``run`` without ``--quick-prep`` builds with the staged NPT prep (the
    JAX CLI's default), with it the quick prep; the build is stubbed so the
    check stays cheap."""
    from scema_tpu_torch.hmm import md_coupling

    seen = []

    class Built(Exception):
        pass

    def stub(cfg, **kw):
        seen.append(kw["staged"])
        raise Built

    monkeypatch.setattr(md_coupling, "build_md_hmm", stub)
    for flags, staged in (([], True), (["--quick-prep"], False)):
        with pytest.raises(Built):
            cli.main(["run", empty_cfg, "--cpu", "--steps", "1", *flags])
        assert seen[-1] is staged


def test_port_never_imports_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import scema_tpu_torch\n"
        "for m in pkgutil.walk_packages(scema_tpu_torch.__path__, 'scema_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax' or k.startswith('jax.')\n"
        "             or k == 'scema_tpu' or k.startswith('scema_tpu.'))\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
