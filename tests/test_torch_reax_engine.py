"""The ReaxFF path of the port beyond its fields, on the CPU, on the
synthetic H/C/N/O parameter file of tests/torch_file_util.py in a
``lammps_scripts_reax`` directory:

* ``material.equilibrate`` (FIRE 5 steps, i.e. one 10-step chunk, then
  JAX's Maxwell draw; no NVT) against the JAX package's, which starts FIRE
  from the force field's ``fire_dt0`` (0.05 fs, not the generic 0.5);
* ``run_strain`` (20 steps: two neighbor chunks, with shear) and then
  ``sample_stress`` (10 steps) with the QEq warm start, on 4 jobs of the
  32-atom all-atom PE melt (4 x C2 at 0.25 g/cm^3) with their own
  perturbations, strains and JAX's Maxwell velocities, against JAX's
  vmapped XLA engine, float64: positions 1e-8 A, velocities and pressures
  1e-8 relative (only the summation order differs);
* the warm-start pattern itself: one cold CG solve per chunk, warm ones
  after it;
* a port-only coupled macro-step (test_reax.py:294-327's dogbone, float32,
  with reference-format replica data in place of the measurement, which
  the init-material test runs): finite displacements and stresses, MD
  jobs run, route "unfused: reax";
* the CLI: ``run``, ``init-material``, ``strain-md`` and ``analyse-md`` on
  a reax config (its scripts directory selects ReaxFF and the ffield).  The
  config cannot size the box, so these tests shrink the spec
  ``md_spec_kwargs`` gives to a 16-atom melt (2 x C2); ``run`` reads
  replica data as above.

The whole slice against the JAX package's ``build_md_hmm`` + ``step`` is
marked slow: JAX's side alone takes minutes (its compile of the coupled
step through the reax graph).
"""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import homogenization as JH
from scema_tpu.md import material as JM

from scema_tpu_torch import cli, interop
from scema_tpu_torch import config as TC
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.hmm import md_coupling as TMC
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import homogenization as TH
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md.forcefields import reax as TR

import torch_file_util as fu
from torch_port_util import fixed_replica_data, np64, one_torch_thread, rel_err  # noqa: F401

MELT = dict(n_chains=4, chain_length=2, pe_density=0.25, validate=False)
T, DT = 300.0, 0.25
EPS = np.array([[1e-3, 0.0, -5e-4, 0.0, 0.0, 0.0], [-8e-4, 6e-4, 0.0, 1e-3, 0.0, 0.0],
                [0.0, 0.0, 2e-3, 0.0, -5e-4, 0.0], [5e-4, 5e-4, 5e-4, 0.0, 0.0, 1e-3]])

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def scripts(tmp_path_factory):
    """A lammps_scripts_reax directory holding the synthetic ffield."""
    d = tmp_path_factory.mktemp("reax") / "lammps_scripts_reax"
    d.mkdir()
    fu.write_ffield(d / "ffield.reax.synthetic")
    return str(d)


def _spec(mod, scripts, **kw):
    return mod.MaterialSpec(name="rx", force_field="reax", **MELT,
                            reax_ffield=os.path.join(scripts, "ffield.reax.synthetic"), **kw)


@pytest.fixture(scope="module")
def runs(scripts):
    """JAX's equilibrate, then 4 perturbed jobs through its vmapped
    run_strain (20 steps) and sample_stress (10 steps)."""
    jsys, jst = JM.build_system(_spec(JM, scripts))
    params = JH.MDParams(temperature=T, dt=DT, strain_rate=1e-4, nsteps_sample=10)
    jeq = JM.equilibrate(jsys, jst, params, jax.random.PRNGKey(11), minimize_steps=5,
                         equil_steps=0)
    vel0 = JE.maxwell_velocities(jsys, jax.random.PRNGKey(11), T)
    rng = np.random.default_rng(5)
    pos = np.asarray(jeq.pos)[None] + 0.02 * rng.standard_normal((4,) + jeq.pos.shape)
    vel = np.stack([np.asarray(JE.maxwell_velocities(jsys, jax.random.PRNGKey(20 + j), T))
                    for j in range(4)])
    jobs = JE.MDState(pos=jnp.asarray(pos), vel=jnp.asarray(vel),
                      h=jnp.broadcast_to(jeq.h, (4, 3, 3)), vxi=jnp.zeros((4, 3)))
    strained = jax.jit(jax.vmap(lambda s, e: JE.run_strain(jsys, s, e, jnp.asarray(20), T, DT)))(
        jobs, jnp.asarray(EPS))
    sampled, press = jax.jit(jax.vmap(lambda s: JE.sample_stress(jsys, s, 10, T, DT)))(strained)
    return dict(sys=jsys, st=jst, eq=jeq, vel0=vel0, jobs=jobs, strained=strained, sampled=sampled,
                press=np.asarray(press), params=params)


@pytest.fixture(scope="module")
def port(scripts):
    sys_, st = TM.build_system(_spec(TM, scripts), device="cpu")
    assert isinstance(sys_.ff, TR.ReaxFFList) and sys_.route == "unfused: reax"
    return sys_, st


def test_equilibrate_matches_jax(runs, port):
    """FIRE from the force field's fire_dt0 (0.05 fs), then the Maxwell
    draw, as JAX's equilibrate; with 0.5 fs the positions would differ."""
    sys_, st = port
    assert np.array_equal(np64(st.pos), np.asarray(runs["st"].pos))
    p = TH.MDParams(**dataclasses.asdict(runs["params"]))
    out = TM.equilibrate(sys_, st, p, minimize_steps=5, equil_steps=0,
                         velocities=torch.as_tensor(np.asarray(runs["vel0"])))
    ref = runs["eq"]
    assert np.abs(np64(out.pos) - np.asarray(ref.pos)).max() < 1e-9
    assert np.array_equal(np64(out.vel), np.asarray(ref.vel))
    moved = np.abs(np.asarray(ref.pos) - np.asarray(runs["st"].pos)).max()
    assert 1e-3 < moved
    fast = TE.minimize_fire(sys_, st, n_steps=5, dt0=0.5)
    assert np.abs(np64(fast.pos) - np.asarray(ref.pos)).max() > 1e-3


def test_run_strain_warm_matches_jax(runs, port):
    sys_, _ = port
    assert TE._qeq_warm_enabled(sys_)
    out = TE.run_strain(sys_, interop.md_state(runs["jobs"]), torch.as_tensor(EPS), 20, T, DT)
    ref = runs["strained"]
    assert np.abs(np64(out.pos) - np.asarray(ref.pos)).max() < 1e-8
    assert rel_err(np64(out.vel), np.asarray(ref.vel)) < 1e-8
    assert rel_err(np64(out.vxi), np.asarray(ref.vxi)) < 1e-8
    assert np.abs(np64(out.h) - np.asarray(ref.h)).max() < 1e-12
    assert np.abs(np.asarray(ref.pos) - np.asarray(runs["jobs"].pos)).max() > 1e-2


def test_sample_stress_warm_matches_jax(runs, port):
    sys_, _ = port
    st, press = TE.sample_stress(sys_, interop.md_state(runs["strained"]), 10, T, DT)
    assert rel_err(np64(press), runs["press"]) < 1e-8
    assert np.abs(np64(st.pos) - np.asarray(runs["sampled"].pos)).max() < 1e-8
    assert np.isfinite(runs["press"]).all() and len(set(np.round(runs["press"][:, 0], 3))) == 4


def test_warm_start_pattern(runs, port, monkeypatch):
    """One cold solve (qeq_iters trips) per chunk, then a warm solve per
    step seeded by the step before; the FIRE and NPT loops stay cold."""
    sys_, _ = port
    calls = []
    solve = TR.ReaxFFList._solve_qeq

    def spy(self, shield, idx, guess=None):
        calls.append(guess is None)
        return solve(self, shield, idx, guess=guess)

    monkeypatch.setattr(TR.ReaxFFList, "_solve_qeq", spy)
    jobs = interop.md_state(runs["jobs"])
    TE.run_strain(sys_, jobs, torch.as_tensor(EPS), 20, T, DT)
    assert calls == ([True] + [False] * 10) * 2
    calls.clear()
    TE.sample_stress(sys_, jobs, 10, T, DT)
    assert calls == [True] + [False] * 10
    calls.clear()
    TE.minimize_fire(sys_, jobs, n_steps=10, dt0=0.05)
    assert calls == [True] * 10
    cold = dataclasses.replace(sys_, ff=dataclasses.replace(sys_.ff, qeq_warm=False))
    assert not TE._qeq_warm_enabled(cold)


def _hmm_cfg(cls, dtype="float32"):
    """test_reax.py:294-327's config: a 1x1x2-cell dogbone, one replica,
    10 K, 0.1 fs MD steps, strain rate 1e-2, 5 sampling steps."""
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=2),
        bridging=cfg.bridging.__class__(stress_method=0, approx_md_with_hookes_law=False),
        material=cfg.material.__class__(number_of_replicas=1, materials=("rx",),
                                        proportions=(1.0,)),
        md=cfg.md.__class__(temperature=10.0, timestep_length=0.1, strain_rate=1.0e-2,
                            nsteps_sample=5, force_field="reax"),
        dtype=dtype, md_dtype=dtype)


def _init_files(nano_dir):
    """Reference-format init.rx_1.* replica data (box lengths, a residual
    stress, an isotropic stiffness), so that the coupled step's build
    skips the measurement (held to JAX in test_sample_stress_warm_matches_jax
    and run by the init-material test)."""
    C = np.zeros((6, 6))
    C[:3, :3] = 2.0e9
    C[range(3), range(3)] = 6.0e9
    C[range(3, 6), range(3, 6)] = 2.0e9
    TM.write_init_files(str(nano_dir), "rx", 1, TM.InitData(
        length=np.full(3, 9.27), stress=np.array([1e6, 1e6, 0.0, 0.0, 0.0, 0.0]), stiff=C,
        density=250.0))


def test_coupled_step_on_cpu(scripts, tmp_path, capsys):
    _init_files(tmp_path)
    cfg = _hmm_cfg(TCfg)
    cfg = cfg.replace(dirs=dataclasses.replace(cfg.dirs, nanoscale_input=str(tmp_path)))
    hmm = TMC.build_md_hmm(cfg, spec=_spec(TM, scripts), equil_steps=0, minimize_steps=5,
                           device="cpu")
    assert "route unfused: reax" in capsys.readouterr().out
    carry, out = hmm.step(hmm.init_state())
    fe = carry[0]
    assert int(out.n_jobs) > 0 and hmm.backend.sys.route == "unfused: reax"
    assert torch.isfinite(fe.u).all() and torch.isfinite(fe.qp.new_stress).all()
    assert float(fe.qp.new_stress.abs().max()) > 0.0


def _small_box(monkeypatch):
    """The config's reax spec sized to half the melt above: 2 x C2, 16
    atoms."""
    def kw(cfg, _orig=TC.md_spec_kwargs):
        return {**_orig(cfg), **MELT, "n_chains": 2}

    monkeypatch.setattr(TC, "md_spec_kwargs", kw)
    monkeypatch.setattr(TMC, "md_spec_kwargs", kw)


def _write_cfg(path, scripts, out_dir):
    """A reference-format config whose scripts directory selects ReaxFF."""
    cfg = {
        "continuum time": {"timestep length": 5e-07, "start timestep": 1, "end timestep": 1},
        "continuum mesh": {"input": {"style": "cuboid", "x length": 0.03, "y length": 0.03,
                                     "z length": 0.08, "x cells": 1, "y cells": 1,
                                     "z cells": 2}},
        "molecular dynamics material": {"number of replicas": 1, "list of materials": ["rx"],
                                        "distribution": {"style": "uniform",
                                                         "proportions": [1.0]}},
        "molecular dynamics parameters": {"temperature": 10.0, "timestep length": 0.1,
                                          "strain rate": 1.0e-2,
                                          "number of sampling steps": 5,
                                          "scripts directory": scripts},
        "directory structure": {"nanoscale input": out_dir, "macroscale output": out_dir,
                                "nanoscale output": out_dir},
    }
    with open(path, "w") as f:
        json.dump(cfg, f)


def test_cli_run_reax_config(scripts, tmp_path, monkeypatch, capsys):
    _small_box(monkeypatch)
    _init_files(tmp_path)
    cfg = tmp_path / "cfg.json"
    _write_cfg(cfg, scripts, str(tmp_path))
    loaded = TC.load_config(str(cfg))
    assert loaded.md.force_field == "reax"
    assert TC.md_spec_kwargs(loaded)["reax_ffield"].endswith("ffield.reax.synthetic")
    rc = cli.main(["run", str(cfg), "--cpu", "--quick-prep", "--steps", "1"])
    out = capsys.readouterr().out
    assert rc == 0, out
    assert "route unfused: reax" in out and "md jobs 0" not in out
    assert "Max displacement: 0.00016 m" in out


def test_cli_md_subcommands_reax_config(scripts, tmp_path, monkeypatch, capsys):
    """init-material, strain-md and analyse-md on the reax config."""
    _small_box(monkeypatch)
    cfg = tmp_path / "cfg.json"
    _write_cfg(cfg, scripts, str(tmp_path))
    few = ["--cpu", "--minimize-steps", "5", "--equil-steps", "0"]
    assert cli.main(["init-material", str(cfg), "--quick-prep", *few]) == 0
    assert os.path.exists(tmp_path / "init.rx_1.stiff")
    state = str(tmp_path / "m.npz")
    assert cli.main(["strain-md", str(cfg), "--save-state", state, *few]) == 0
    assert cli.main(["analyse-md", str(cfg), state, "--cpu"]) == 0
    out = capsys.readouterr().out
    stress = [float(x) for x in out.strip().splitlines()[-1].split()]
    assert len(stress) == 6 and np.isfinite(stress).all()


@pytest.mark.slow
def test_coupled_step_matches_jax(scripts, monkeypatch):
    """The whole slice against the JAX package: build_md_hmm + one step of
    the dogbone above in float64, the port handed JAX's prepared replica
    (FIRE 5 steps and its Maxwell draw) and replica data (fixed, as in
    tests/test_torch_hmm_*.py) and its material draw; u and the stresses
    within 1e-8 relative.  Slow: JAX's build and step compile the reax
    graph for minutes."""
    from scema_tpu.config import HMMConfig as JCfg
    from scema_tpu.hmm import md_coupling as JMC
    from scema_tpu.hmm.problem import assign_materials

    fixed_replica_data(monkeypatch, JMC)
    jcfg = _hmm_cfg(JCfg, "float64")
    jh = JMC.build_md_hmm(jcfg, spec=_spec(JM, scripts), equil_steps=0, minimize_steps=5)
    be = jh.backend
    data = [interop.init_data(JM.InitData(
        length=be.ensemble.init_length[0, r], stress=be.ensemble.init_stress[0, r],
        stiff=be.ensemble.init_stiff[0, r], density=be.ensemble.rho[0, r]))
        for r in range(be.n_repl)]
    th = TMC.build_md_hmm(_hmm_cfg(TCfg, "float64"), spec=_spec(TM, scripts), device="cpu",
                          prepared=[(interop.md_state(be.initial_md_state), data)],
                          material=interop.materials(assign_materials(jcfg, jh.geom,
                                                                      jh.base.dtype)))
    (jfe, (jm,)), jo = jax.jit(jh.step)(jh.init_state())
    (tfe, (tm,)), to = th.step(th.init_state())
    assert int(to.n_jobs) == int(jo.n_jobs) > 0
    assert rel_err(np64(tfe.u), np.asarray(jfe.u)) < 1e-8
    assert rel_err(np64(tfe.qp.new_stress), np.asarray(jfe.qp.new_stress)) < 1e-8
    assert rel_err(np64(to.md_stress_repl), np.asarray(jo.md_stress_repl)) < 1e-8
    assert np.abs(np64(tm.pos) - np.asarray(jm.pos)).max() < 1e-8


@pytest.mark.slow
def test_measure_matches_jax(runs, port):
    """``material.measure`` (10 sampling steps, then the 12-box cold
    stiffness probe: FIRE 60 from dt0 0.2 per box) against the JAX
    package's on the equilibrated melt.  The residual stress and the
    probe's arithmetic agree to rounding: stress 1e-8 relative, and the
    probe with 20 FIRE steps 1e-10.  Over 60 FIRE steps (dt growing to 4
    fs on the reactive boxes) the probe amplifies the packages' different
    summation orders: measured 5.3e-13 and 3.1e-13 after 20 and 40 steps
    from the equilibrated state, 3.8e-7 after 60 from the sampled one (the
    port's own stiffness moves by 2.6e-9 when its state moves by 1e-14 A),
    so the full probe is held at 1e-5.  On the synthetic field
    the stiffness is not positive definite in either package, which is
    what makes chip_smoke.py phase 28's explicit FE step grow after its
    first step.  Slow: JAX compiles the sampling and the vmapped probe
    through the reax graph (minutes)."""
    sys_, _ = port
    params = TH.MDParams(**dataclasses.asdict(runs["params"]))
    jd = JM.measure(runs["sys"], runs["eq"], runs["params"])
    td = TM.measure(sys_, interop.md_state(runs["eq"]), params)
    assert rel_err(td.stress, jd.stress) < 1e-8
    assert rel_err(td.stiff, jd.stiff) < 1e-5
    assert td.density == pytest.approx(jd.density, rel=1e-12)
    assert np.allclose(td.length, jd.length, rtol=1e-12)
    assert np.linalg.eigvalsh(0.5 * (jd.stiff + jd.stiff.T)).min() < 0.0
    jC = jax.jit(lambda s: JH.stiffness_probe(runs["sys"], s, runs["params"],
                                              relax_steps=20))(runs["eq"])
    tC = TH.stiffness_probe(sys_, interop.md_state(runs["eq"]), params, relax_steps=20)
    assert rel_err(np64(tC), np.asarray(jC)) < 1e-10
