"""The charged slice end to end on the CPU: 2 MD-coupled macro-steps of a
1x1x2-cell dogbone (16 qps) with the small charged all-atom PE fixture of
tests/test_allatom_fused.py at every flagged qp, the port against
``scema_tpu.hmm.md_coupling.build_md_hmm``, float64.

JAX prepares the material on its XLA engine and draws the material
assignment; both go into the port through ``scema_tpu_torch.interop``.
The MD strain rate is raised to 1e-3/fs so every deform run is 10 steps.
``cut`` (coul/cut): the XLA engine's 10-step neighbor chunks and the
kernel integrate the same force history — 1e-8 relative on the FE fields
and stresses, 1e-8 A on the microstates (measured ~4e-13 and 2e-12 A).
``ewald``: the port freezes the k-space remainder per step
(kspace_every = 1) and the XLA engine rebuilds every step (exact Ewald) —
1e-3 relative on the stresses and displacements, 5e-3 A on the
microstates (measured 6e-5, 1e-4 and 7e-4 A: the remainder's one-step lag
in the second half-kick and the erfc polynomial)."""
import jax
import numpy as np
import pytest

from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.hmm.md_coupling import build_md_hmm as j_build_md_hmm
from scema_tpu.hmm.problem import assign_materials
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.hmm.md_coupling import build_md_hmm as t_build_md_hmm
from scema_tpu_torch.md import material as TM

from torch_port_util import np64, rel_err

PE = dict(name="g0", force_field="opls", allatom=True, n_chains=4, chain_length=4,
          pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False)
N_STEPS = 2


def _cfg(cls):
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        md=cfg.md.__class__(temperature=300.0, timestep_length=1.0,
                            strain_rate=1.0e-3, nsteps_sample=20),
        md_dtype="float64")


@pytest.fixture(scope="module", params=["cut", "ewald"])
def runs(request):
    ewald = request.param == "ewald"
    jcfg = _cfg(JCfg)
    jh = j_build_md_hmm(jcfg, spec=JM.MaterialSpec(**PE, use_ewald=ewald, use_fused=False,
                                                   rebuild_every=1 if ewald else 10),
                        equil_steps=10, minimize_steps=20)
    be = jh.backend
    ens = be.ensemble
    data = [TM.InitData(length=np.asarray(ens.init_length[0, r]),
                        stress=np.asarray(ens.init_stress[0, r]),
                        stiff=np.asarray(ens.init_stiff[0, r]),
                        density=float(ens.rho[0, r]))
            for r in range(be.n_repl)]
    mat = assign_materials(jcfg, jh.geom, jh.base.dtype)
    th = t_build_md_hmm(_cfg(TCfg), spec=TM.MaterialSpec(**PE, use_ewald=ewald, kspace_every=1),
                        device="cpu",
                        prepared=[(interop.md_state(be.initial_md_state), data)],
                        material=interop.materials(mat))
    jc, tc = jh.init_state(), th.init_state()
    step = jax.jit(jh.step)
    outs = []
    for _ in range(N_STEPS):
        jc, jo = step(jc)
        tc, to = th.step(tc)
        outs.append((jo, to))
    return request.param, jc, tc, outs


def test_charged_macro_steps_match_jax(runs):
    case, jc, tc, outs = runs
    (jfe, (jm,)), (tfe, (tm,)) = jc, tc
    rel, pos = (1e-3, 5e-3) if case == "ewald" else (1e-8, 1e-8)
    for jo, to in outs:
        assert int(to.n_flagged) == int(jo.n_flagged)
        assert int(to.n_jobs) == int(jo.n_jobs) > 0
        assert np.array_equal(to.md_ran.numpy(), np.asarray(jo.md_ran))
        assert rel_err(np64(to.md_stress_repl), np.asarray(jo.md_stress_repl)) < rel
    assert rel_err(np64(tfe.u), np.asarray(jfe.u)) < rel
    assert rel_err(np64(tfe.qp.new_stress), np.asarray(jfe.qp.new_stress)) < rel
    assert np.abs(np64(tm.pos) - np.asarray(jm.pos)).max() < pos
    assert np.array_equal(tm.has_run.numpy(), np.asarray(jm.has_run))
    # documented milestone: max displacement = steps * strain rate * Lz
    u = np64(tfe.u).reshape(-1, 3)
    assert np.isclose(np.abs(u).max(), N_STEPS * 0.002 * 0.08, rtol=1e-9)
