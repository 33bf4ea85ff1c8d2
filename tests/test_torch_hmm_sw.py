"""The Stillinger-Weber slice end to end on the CPU: the MD-coupled
macro-step of the port against ``scema_tpu.hmm.md_coupling.build_md_hmm``,
float64, on a 1x1x2-cell dogbone (16 qps) with the 64-atom diamond-Si SW
box (n_cells = 2) at every qp — the port on K5's plain version, JAX on its
XLA engine.

JAX prepares the material (FIRE + NVT, stress sampling, stiffness probe)
and draws the material assignment; both go into the port through
``scema_tpu_torch.interop``.  The MD strain rate is raised to 1e-3/fs so
every job's deform run is 10 steps — one XLA neighbor chunk, the regime in
which the XLA engine and the fused kernel integrate the same force history
(ROADMAP section 3).  Tolerances as in tests/test_torch_hmm_md.py: 1e-8
relative on the FE fields and stresses, 1e-8 A on the microstates (only
the summation order differs).  After 2 steps the documented milestone
holds: max displacement 0.32 mm."""
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

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

SPEC = dict(name="sic", force_field="sw", n_cells=2)
N_STEPS = 3


pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _cfg(cls):
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        md=cfg.md.__class__(temperature=300.0, timestep_length=2.0, strain_rate=1.0e-3,
                            nsteps_sample=20, force_field="sw"),
        md_dtype="float64")


@pytest.fixture(scope="module")
def runs():
    jcfg = _cfg(JCfg)
    jh = j_build_md_hmm(jcfg, spec=JM.MaterialSpec(**SPEC, use_fused=False),
                        equil_steps=10, minimize_steps=20)
    be = jh.backend
    data = [interop.init_data(JM.InitData(
        length=be.ensemble.init_length[0, r], stress=be.ensemble.init_stress[0, r],
        stiff=be.ensemble.init_stiff[0, r], density=be.ensemble.rho[0, r]))
        for r in range(be.n_repl)]
    mat = assign_materials(jcfg, jh.geom, jh.base.dtype)
    th = t_build_md_hmm(_cfg(TCfg), spec=TM.MaterialSpec(**SPEC), device="cpu",
                        prepared=[(interop.md_state(be.initial_md_state), data)],
                        material=interop.materials(mat))
    assert th.backend.sys.fused.spec.kernel == "K5" and th.backend.sys.n_atoms == 64
    jc, tc = jh.init_state(), th.init_state()
    step = jax.jit(jh.step)
    outs = []
    for _ in range(N_STEPS):
        jc, jo = step(jc)
        tc, to = th.step(tc)
        outs.append((jo, to, np64(tc[0].u)))
    return jh, th, jc, tc, outs


def test_macro_steps_match_jax(runs):
    _, _, jc, tc, outs = runs
    (jfe, (jm,)), (tfe, (tm,)) = jc, tc
    for jo, to, _ in outs:
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


def test_milestone_after_two_steps(runs):
    """The reference example's milestone: 0.32 mm after 2 steps (steps x
    strain rate 0.002 x Lz 0.08 m)."""
    u2 = runs[4][1][2].reshape(-1, 3)
    assert np.isclose(np.abs(u2).max(), 2 * 0.002 * 0.08, rtol=1e-9)
