"""The port's command line beyond ``run``'s main path, on the CPU: mirrors
of tests/test_cli_handshake.py (init-material -> run, strain-md ->
analyse-md) and of tests/test_output_checkpoint.py::test_cli_fault_recovery,
plus the refusals: a kernel error is never retried, ``--surrogate`` with
no Keras file raises, and no subcommand runs on the CPU unasked.

The configs are the JAX tests' (a 1x1x2-cell dogbone, SW silicon at
0.01 K, 20 sampling steps), with 64-atom boxes where the JAX tests take
216, and for init-material -> run an MD timestep of 2 fs where they take
0.002 (1000x fewer deform steps per job), so that each test stays within
seconds on one core.  The strain-md ->
analyse-md agreement is the JAX test's: 1e-3 relative between the npz and
the text-dump formats (the dump keeps 10 significant digits)."""
import json
import os
import re

import numpy as np
import pytest
import torch

from scema_tpu import cli as jax_cli

from scema_tpu_torch import cli
from scema_tpu_torch.ops import _build

from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _write_config(path, nano_dir, out_dir, nsteps=2, md_dt=0.002):
    """tests/test_cli_handshake.py's reference-format JSON (``md_dt`` its
    MD timestep in fs)."""
    cfg = {
        "problem type": {"class": "dogbone", "strain rate": 0.002},
        "scale-bridging": {"stress computation method": 0,
                           "approximate md with hookes law": 0, "use pjm scheduler": 0},
        "continuum time": {"timestep length": 5e-07, "start timestep": 1,
                           "end timestep": nsteps},
        "continuum mesh": {"fe degree": 1, "quadrature formula": 2,
                           "input": {"style": "cuboid", "x length": 0.03,
                                     "y length": 0.03, "z length": 0.08,
                                     "x cells": 1, "y cells": 1, "z cells": 2}},
        "model precision": {"md": {"min quadrature strain norm": 1e-10},
                            "clustering": {"spline points": 10, "min steps": 500,
                                           "diff threshold": 1e-06}},
        "molecular dynamics material": {"number of replicas": 1, "list of materials": ["g0"],
                                        "distribution": {"style": "uniform",
                                                         "proportions": [1.0]}},
        "molecular dynamics parameters": {"temperature": 0.01, "timestep length": md_dt,
                                          "strain rate": 1.0e-3,
                                          "number of sampling steps": 20,
                                          "force field": "sw"},
        "output data": {"checkpoint frequency": 0, "visualisation output frequency": 0,
                        "analytics output frequency": 0,
                        "loaded boundary force output frequency": 0,
                        "homogenization output frequency": 0},
        "directory structure": {"nanoscale input": nano_dir, "macroscale output": out_dir,
                                "nanoscale output": out_dir},
    }
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _hooke_config(tmp_path, every_step=False):
    """tests/test_output_checkpoint.py::test_cli_fault_recovery's; with
    ``every_step`` each output and checkpoint is due at every step."""
    cfg = {
        "problem type": {"class": "dogbone", "strain rate": 0.002},
        "scale-bridging": {"stress computation method": 0,
                           "approximate md with hookes law": 1},
        "continuum time": {"timestep length": 5e-07, "start timestep": 1,
                           "end timestep": 4},
        "continuum mesh": {"fe degree": 1, "quadrature formula": 2,
                           "input": {"style": "cuboid", "x length": 0.03, "y length": 0.03,
                                     "z length": 0.08, "x cells": 1, "y cells": 1,
                                     "z cells": 2}},
    }
    if every_step:
        cfg["output data"] = {k: 1 for k in (
            "checkpoint frequency", "visualisation output frequency",
            "analytics output frequency", "loaded boundary force output frequency",
            "homogenization output frequency")}
    p = tmp_path / "inputs.json"
    p.write_text(json.dumps(cfg))
    return str(p)


@pytest.fixture()
def small_sw_boxes(monkeypatch):
    """`run` builds the 64-atom SW box (2^3 cells) with a short prep."""
    from scema_tpu_torch.hmm import md_coupling
    from scema_tpu_torch.md import material as M

    real = md_coupling.build_md_hmm

    def build(cfg, **kw):
        return real(cfg, spec=M.MaterialSpec(name="g0", force_field="sw", n_cells=2),
                    equil_steps=20, minimize_steps=50, **kw)

    monkeypatch.setattr(md_coupling, "build_md_hmm", build)


def test_init_material_then_run_honours_the_init_files(tmp_path, monkeypatch,
                                                       small_sw_boxes, capsys):
    nano = str(tmp_path / "nanoscale_input")
    cfg_path = _write_config(str(tmp_path / "inputs.json"), nano, str(tmp_path / "out"),
                             md_dt=2.0)
    assert cli.main(["init-material", cfg_path, "--cpu", "--cells", "2", "--quick-prep",
                     "--minimize-steps", "50", "--equil-steps", "20",
                     "--outdir", nano]) == 0
    out = capsys.readouterr().out
    assert re.search(r"g0_1: L=\S+ A  rho=\S+ kg/m3  C11=\S+ GPa", out), out
    assert f"g0: wrote averaged init.g0.stiff / .density to {nano}" in out
    for suffix in (".length", ".stress", ".stiff"):
        assert os.path.exists(f"{nano}/init.g0_1{suffix}"), suffix
    assert os.path.exists(f"{nano}/init.g0.stiff") and os.path.exists(f"{nano}/init.g0.density")

    from scema_tpu_torch.bridging.replica_data import load_replica_metadata
    from scema_tpu_torch.md import material as M

    mr = load_replica_metadata(nano, ["g0"], 1)[0][0]
    assert mr.length is not None and mr.stress is not None and mr.stiff is not None
    # spy: with init.* files present the run must not re-measure
    calls = []
    real_measure = M.measure
    monkeypatch.setattr(M, "measure",
                        lambda *a, **k: calls.append(1) or real_measure(*a, **k))
    assert cli.main(["run", cfg_path, "--cpu", "--quick-prep", "--steps", "2"]) == 0
    assert calls == [], "run re-measured despite init.* files"
    # control: an empty nanoscale_input measures on the device
    cfg2 = _write_config(str(tmp_path / "inputs2.json"), str(tmp_path / "empty_nano"),
                         str(tmp_path / "out2"), md_dt=2.0)
    assert cli.main(["run", cfg2, "--cpu", "--quick-prep", "--steps", "2"]) == 0
    assert len(calls) > 0
    assert "Max displacement: 0.00032" in capsys.readouterr().out


def test_strain_md_to_analyse_md_roundtrip(tmp_path, capsys):
    cfg_path = _write_config(str(tmp_path / "inputs.json"), str(tmp_path / "nano"),
                             str(tmp_path / "out"))
    npz = str(tmp_path / "micro.npz")
    dump = str(tmp_path / "last.1.g0_1.dump")
    assert cli.main(["strain-md", cfg_path, "--cpu", "--cells", "2",
                     "--minimize-steps", "50", "--equil-steps", "20",
                     "--strain", "0.002,0,0,0,0,0", "--save-state", npz, "--dump", dump]) == 0
    out = capsys.readouterr().out
    assert "stress (Pa, Voigt xx yy zz xy xz yz):" in out
    assert f"microstate saved to {npz}" in out and f"microstate dump written to {dump}" in out

    def analyse(state_path):
        assert cli.main(["analyse-md", cfg_path, state_path, "--cpu", "--cells", "2"]) == 0
        text = capsys.readouterr().out
        m = re.search(r"re-homogenized stress.*\n([-+0-9.e ]+)", text)
        assert m, text
        return np.array([float(x) for x in m.group(1).split()])

    sig_npz, sig_dump = analyse(npz), analyse(dump)
    assert sig_npz.shape == (6,) and np.all(np.isfinite(sig_npz))
    assert np.all(np.isfinite(sig_dump))
    np.testing.assert_allclose(sig_dump, sig_npz, rtol=1e-3, atol=abs(sig_npz).max() * 1e-3)
    # a wrong-geometry dump is refused with exit code 2
    assert cli.main(["analyse-md", cfg_path, dump, "--cpu", "--cells", "3"]) == 2
    assert "match --cells" in capsys.readouterr().err


def test_dump_columns_equal_jax(tmp_path):
    """analyse-md reads the dump strain-md writes: the port's custom_scaled
    writer and reader against the JAX package's, byte for byte and value
    for value."""
    from scema_tpu.md import data_io as JD

    from scema_tpu_torch.md import data_io as TD

    rng = np.random.default_rng(6)
    h = np.array([[11.0, 0.7, -0.3], [0.0, 12.0, 0.4], [0.0, 0.0, 13.0]])
    pos = rng.uniform(0, 10, (40, 3))
    vel = rng.standard_normal((40, 3)) * 1e-3
    types = rng.integers(0, 3, 40)
    for mod, name in ((JD, "jax.dump"), (TD, "port.dump")):
        mod.write_lammpstrj(str(tmp_path / name), pos, h, types=types, vel=vel,
                            style="custom_scaled")
    assert (tmp_path / "jax.dump").read_bytes() == (tmp_path / "port.dump").read_bytes()
    a, b = JD.read_lammps_dump(str(tmp_path / "jax.dump")), \
        TD.read_lammps_dump(str(tmp_path / "jax.dump"))
    for k in ("pos", "vel", "h", "types"):
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
    np.testing.assert_allclose(b["pos"], pos, rtol=1e-8, atol=1e-8)


def test_outdir_restarts_profile_and_similarity(tmp_path, capsys):
    cfg = _hooke_config(tmp_path, every_step=True)
    out, sim, prof = tmp_path / "out", tmp_path / "sim.npz", tmp_path / "prof"
    assert cli.main(["run", cfg, "--hooke", "--cpu", "--steps", "3", "--outdir", str(out),
                     "--dump-similarity", str(sim), "--profile", str(prof)]) == 0
    text = capsys.readouterr().out
    step3 = re.search(r"Timestep 3 .*reaction \S+", text).group(0)
    assert f"Profiler trace written to {prof / 'trace.json'}" in text
    assert json.loads((prof / "trace.json").read_text())["traceEvents"]
    with np.load(sim) as f:
        assert f["dist"].shape == (16, 16) and float(f["threshold"]) == 1e-6
    for ts in (1, 2, 3):
        assert (out / f"checkpoint-{ts:06d}.npz").exists()
        assert (out / f"solution-{ts:06d}.vtu").exists()
    # a restart into the same outdir: step 3 again; the CSV drops the rows
    # after the restored step, while the collection, as the JAX package's
    # (scema_tpu/fem/output.py:196-206 keeps every entry it re-reads),
    # lists step 3 twice
    assert cli.main(["run", cfg, "--hooke", "--cpu", "--steps", "1", "--outdir", str(out),
                     "--restart", str(out / "checkpoint-000002.npz")]) == 0
    text = capsys.readouterr().out
    assert f"Restarted from {out / 'checkpoint-000002.npz'} at timestep 2" in text
    assert re.search(r"Timestep 3 .*reaction \S+", text).group(0) == step3
    lbc = (out / "loaded_boundary_force.csv").read_text().splitlines()
    assert [r.split(",")[0] for r in lbc[1:]] == ["1", "2", "3"]
    assert (out / "solution.pvd").read_text().count("solution-000003.pvtu") == 2
    # the reference-format restart resumes at the step its time gives
    assert cli.main(["run", cfg, "--hooke", "--cpu", "--steps", "1",
                     "--restart-reference", str(out / "restart")]) == 0
    text = capsys.readouterr().out
    assert "at time 1.5e-06 (timestep 3)" in text and "Timestep 4 at time 2e-06" in text
    assert "Max displacement: 0.00064" in text


def test_fault_mid_run_rolls_back(tmp_path, monkeypatch, capsys):
    from scema_tpu_torch.hmm import problem

    real_step = problem.HMMProblem.step
    calls = {"n": 0}

    def faulty(self, state):
        calls["n"] += 1
        if calls["n"] == 3:  # fail once mid-run
            raise RuntimeError("injected device fault")
        return real_step(self, state)

    monkeypatch.setattr(problem.HMMProblem, "step", faulty)
    assert cli.main(["run", _hooke_config(tmp_path), "--hooke", "--cpu", "--steps", "4"]) == 0
    outerr = capsys.readouterr()
    assert "injected device fault" in outerr.err and "rolling back" in outerr.err
    # 4 steps of the 1x1x2 dogbone: 4 * 0.002 * 0.08 = 0.64 mm
    assert "Max displacement: 0.00064" in outerr.out
    assert calls["n"] == 5


@pytest.mark.parametrize("fault", ["launch", "build", "cuda"])
def test_kernel_errors_are_never_retried(tmp_path, monkeypatch, capsys, fault):
    from scema_tpu_torch.hmm import problem

    def failing(self, state):
        if fault == "launch":
            _build.check(1, "pairwise_l2_f32")
        if fault == "build":
            raise _build.KernelError("nvcc failed on ['pairwise_l2.cu']")
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    monkeypatch.setattr(problem.HMMProblem, "step", failing)
    with pytest.raises(RuntimeError):
        cli.main(["run", _hooke_config(tmp_path), "--hooke", "--cpu", "--steps", "2"])
    assert "rolling back" not in capsys.readouterr().err


def test_surrogate_names_its_roadmap_item(tmp_path):
    # --surrogate runs stress method 2 since ROADMAP item 8 landed
    # (tests/test_torch_surrogate.py); a missing Keras file raises
    with pytest.raises(FileNotFoundError):
        cli.main(["run", _hooke_config(tmp_path), "--cpu", "--surrogate",
                  str(tmp_path / "model.bin")])


@pytest.mark.parametrize("cmd", ["run", "init-material", "strain-md", "analyse-md"])
def test_subcommands_need_cuda_without_cpu(tmp_path, monkeypatch, capsys, cmd):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = [cmd, _hooke_config(tmp_path)] + (["state.npz"] if cmd == "analyse-md" else [])
    assert cli.main(argv) == 2
    assert "no CUDA device" in capsys.readouterr().err


def _flags(main, cmd, capsys) -> set:
    with pytest.raises(SystemExit):
        main([cmd, "--help"])
    return set(re.findall(r"(--[a-z][a-z-]+)", capsys.readouterr().out))


@pytest.mark.parametrize("cmd", ["run", "init-material", "strain-md", "analyse-md"])
def test_every_jax_flag_is_accepted(cmd, capsys):
    want = _flags(jax_cli.main, cmd, capsys)
    assert want and want <= _flags(cli.main, cmd, capsys)
