"""The slice end to end on the CPU: the MD-coupled macro-step of the port
against ``scema_tpu.hmm.md_coupling.build_md_hmm``, float64, on a
1x1x2-cell dogbone (16 qps) with the small united-atom melt at every qp.

JAX prepares the material (FIRE + NVT, stress sampling, stiffness probe)
and draws the material assignment; both go into the port through
``scema_tpu_torch.interop``, so the two packages start from the same
microstates and ensemble.  The MD strain rate is raised to 1e-3/fs so
every job's deform run is 10 steps — one XLA neighbor chunk, the regime in
which the XLA engine and the fused kernel integrate the same force history
(see tests/test_torch_md_fused.py).  Tolerance 1e-8 relative on the FE
fields and stresses, 1e-8 A on the microstates (measured in float64 on a CPU:
~2e-15 relative on the stresses, ~4e-14 A on the positions — only the
summation order differs)."""
import jax
import numpy as np
import pytest
import torch

from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.hmm.md_coupling import build_md_hmm as j_build_md_hmm
from scema_tpu.hmm.problem import assign_materials
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.hmm.md_coupling import build_md_hmm as t_build_md_hmm
from scema_tpu_torch.md import material as TM

from torch_port_util import np64, rel_err

SMALL = dict(name="g0", force_field="opls", n_chains=8, chain_length=6,
             opls_lj_cutoff=5.0, opls_coul_cutoff=5.0, validate=False)
N_STEPS = 3


def _cfg(cls):
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        md=cfg.md.__class__(temperature=300.0, timestep_length=2.0,
                            strain_rate=1.0e-3, nsteps_sample=20),
        md_dtype="float64")


@pytest.fixture(scope="module")
def runs():
    jcfg = _cfg(JCfg)
    jh = j_build_md_hmm(jcfg, spec=JM.MaterialSpec(**SMALL, use_fused=False),
                        equil_steps=10, minimize_steps=20)
    be = jh.backend
    ens = be.ensemble
    data = [TM.InitData(length=np.asarray(ens.init_length[0, r]),
                        stress=np.asarray(ens.init_stress[0, r]),
                        stiff=np.asarray(ens.init_stiff[0, r]),
                        density=float(ens.rho[0, r]))
            for r in range(be.n_repl)]
    mat = assign_materials(jcfg, jh.geom, jh.base.dtype)
    th = t_build_md_hmm(_cfg(TCfg), spec=TM.MaterialSpec(**SMALL), device="cpu",
                        prepared=[(interop.md_state(be.initial_md_state), data)],
                        material=interop.materials(mat))
    jc, tc = jh.init_state(), th.init_state()
    step = jax.jit(jh.step)
    outs = []
    for _ in range(N_STEPS):
        jc, jo = step(jc)
        tc, to = th.step(tc)
        outs.append((jo, to))
    return jh, th, jc, tc, outs, step


def test_injected_ensemble_matches(runs):
    jh, th = runs[0], runs[1]
    for f in ("rotam", "init_length", "init_stress", "init_stiff", "rho"):
        assert rel_err(np64(getattr(th.backend.ensemble, f)),
                       np.asarray(getattr(jh.backend.ensemble, f))) < 1e-15
    assert rel_err(np64(th.base.ops.mass_diag), np.asarray(jh.base.ops.mass_diag)) < 1e-12


def test_macro_steps_match_jax(runs):
    _, _, jc, tc, outs, _ = runs
    (jfe, (jm,)), (tfe, (tm,)) = jc, tc
    for jo, to in outs:
        assert int(to.n_flagged) == int(jo.n_flagged)
        assert int(to.n_jobs) == int(jo.n_jobs) > 0
        assert np.array_equal(to.md_ran.numpy(), np.asarray(jo.md_ran))
        assert rel_err(np64(to.md_stress_repl), np.asarray(jo.md_stress_repl)) < 1e-8
        assert abs(float(to.residual1) - float(jo.residual1)) <= 1e-8 * abs(float(jo.residual1))
    assert rel_err(np64(tfe.u), np.asarray(jfe.u)) < 1e-8
    assert rel_err(np64(tfe.qp.new_stress), np.asarray(jfe.qp.new_stress)) < 1e-8
    assert np.abs(np64(tm.pos) - np.asarray(jm.pos)).max() < 1e-8
    assert np.abs(np64(tm.h) - np.asarray(jm.h)).max() < 1e-10
    assert rel_err(np64(tm.vxi), np.asarray(jm.vxi)) < 1e-8
    assert np.array_equal(tm.has_run.numpy(), np.asarray(jm.has_run))
    # documented milestone: max displacement = steps * strain rate * Lz
    u = np64(tfe.u).reshape(-1, 3)
    assert np.isclose(np.abs(u).max(), N_STEPS * 0.002 * 0.08, rtol=1e-9)


def test_injected_microstates_step_like_jax(runs):
    """A JAX carry (FE state + microstates) handed to the port mid-run
    steps like the JAX package."""
    _, th, jc, _, _, step = runs
    tc = (interop.fe_state(jc[0]), (interop.micro_states(jc[1][0]),))
    (jfe, (jm,)), _ = step(jc)
    (tfe, (tm,)), _ = th.step(tc)
    assert rel_err(np64(tfe.qp.new_stress), np.asarray(jfe.qp.new_stress)) < 1e-8
    assert np.abs(np64(tm.pos) - np.asarray(jm.pos)).max() < 1e-8


def test_entry_points_need_cuda_unless_cpu_is_asked():
    """Without a device the entry points take the current CUDA device; on
    a machine without one they raise instead of running on the CPU."""
    import torch

    from scema_tpu_torch.hmm.problem import build_hooke_hmm

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would run on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        t_build_md_hmm(TCfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_hooke_hmm(TCfg())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TM.build_system(TM.MaterialSpec(**SMALL))
    assert TM.build_system(TM.MaterialSpec(**SMALL), device="cpu")[1].pos.device.type == "cpu"
