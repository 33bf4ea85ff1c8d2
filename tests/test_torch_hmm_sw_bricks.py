"""The SW slice above K5's gate end to end on the CPU: the MD-coupled
macro-step of the port on the unfused engine — the brick route
(``use_pallas_bricks``: K6c/K6d's plain versions) and the list route
(autograd of ``SW.energy``, ``use_fused=False``) — against
``scema_tpu.hmm.md_coupling.build_md_hmm`` on its XLA engine
(``use_fused=False``), float64, on a 1x1x2-cell dogbone (16 qps) with the
64-atom diamond-Si box at every qp.  The mirror of test_torch_hmm_sw.py,
whose port side runs K5.

JAX prepares the material and draws the material assignment; both go into
the port through ``scema_tpu_torch.interop``.  Tolerances as in
test_torch_hmm_sw.py: 1e-8 relative on the FE fields and stresses, 1e-8 A
on the microstates (only the summation order differs).  After 2 steps the
milestone holds: max displacement 0.32 mm."""
import jax
import numpy as np
import pytest
import torch  # noqa: F401

from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.hmm.md_coupling import build_md_hmm as j_build_md_hmm
from scema_tpu.hmm.problem import assign_materials
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.hmm.md_coupling import build_md_hmm as t_build_md_hmm
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.ops import sw_bricks as SWB

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

SPEC = dict(name="sic", force_field="sw", n_cells=2)
ROUTES = {"bricks": dict(use_pallas_bricks=True), "list": dict(use_fused=False)}
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
def jax_run():
    jcfg = _cfg(JCfg)
    jh = j_build_md_hmm(jcfg, spec=JM.MaterialSpec(**SPEC, use_fused=False),
                        equil_steps=10, minimize_steps=20)
    be = jh.backend
    assert be.sys.fused is None
    data = [interop.init_data(JM.InitData(
        length=be.ensemble.init_length[0, r], stress=be.ensemble.init_stress[0, r],
        stiff=be.ensemble.init_stiff[0, r], density=be.ensemble.rho[0, r]))
        for r in range(be.n_repl)]
    mat = assign_materials(jcfg, jh.geom, jh.base.dtype)
    jc = jh.init_state()
    step = jax.jit(jh.step)
    outs = []
    for _ in range(N_STEPS):
        jc, jo = step(jc)
        outs.append(jo)
    return jh, data, mat, jc, outs


@pytest.fixture(scope="module", params=list(ROUTES))
def runs(request, jax_run):
    jh, data, mat, jc, jouts = jax_run
    th = t_build_md_hmm(_cfg(TCfg), spec=TM.MaterialSpec(**SPEC, **ROUTES[request.param]),
                        device="cpu",
                        prepared=[(interop.md_state(jh.backend.initial_md_state), data)],
                        material=interop.materials(mat))
    sys_ = th.backend.sys
    assert sys_.fused is None and sys_.n_atoms == 64
    assert isinstance(sys_.ff, SWB.SWBricksFF) == (request.param == "bricks")
    tc = th.init_state()
    outs = []
    for jo in jouts:
        tc, to = th.step(tc)
        outs.append((jo, to, np64(tc[0].u)))
    return jc, tc, outs


def test_macro_steps_match_jax(runs):
    jc, tc, outs = runs
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
    """0.32 mm after 2 steps (steps x strain rate 0.002 x Lz 0.08 m)."""
    u2 = runs[2][1][2].reshape(-1, 3)
    assert np.isclose(np.abs(u2).max(), 2 * 0.002 * 0.08, rtol=1e-9)
