"""The list path in the coupled step on the CPU: one MD-coupled macro-step
of a 1x1x2-cell dogbone (16 qps) at a capacity of 4 MD jobs, with the small
charged all-atom PE fixture of tests/test_torch_hmm_allatom.py on the
gather-list path (``force_list_kernel``) at every flagged qp — the port
against ``scema_tpu.hmm.md_coupling.build_md_hmm``, float64.

JAX prepares the material on its XLA engine and draws the material
assignment; both go into the port through ``scema_tpu_torch.interop``.
The MD strain rate is raised to 1e-3/fs so every deform run is 10 steps;
coul/cut, so the XLA engine's 10-step neighbor chunks and the port's
10-step list rebuilds integrate the same force history: 1e-8 relative on
the FE fields and stresses, 1e-8 A on the microstates.  The port runs only
the jobs it packs; the reference also runs its padding slots and discards
them, so the comparison is over the jobs that ran."""
import jax
import numpy as np

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
          pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False,
          use_ewald=False, force_list_kernel=True)


def _cfg(cls):
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        md=cfg.md.__class__(temperature=300.0, timestep_length=1.0,
                            strain_rate=1.0e-3, nsteps_sample=20),
        resources=cfg.resources.__class__(**{**cfg.resources.__dict__, "max_md_jobs": 4}),
        md_dtype="float64")


def test_list_macro_step_matches_jax():
    jcfg = _cfg(JCfg)
    jh = j_build_md_hmm(jcfg, spec=JM.MaterialSpec(**PE, use_fused=False, rebuild_every=10),
                        equil_steps=10, minimize_steps=20)
    be = jh.backend
    ens = be.ensemble
    data = [TM.InitData(length=np.asarray(ens.init_length[0, r]),
                        stress=np.asarray(ens.init_stress[0, r]),
                        stiff=np.asarray(ens.init_stiff[0, r]), density=float(ens.rho[0, r]))
            for r in range(be.n_repl)]
    mat = assign_materials(jcfg, jh.geom, jh.base.dtype)
    th = t_build_md_hmm(_cfg(TCfg), spec=TM.MaterialSpec(**PE), device="cpu",
                        prepared=[(interop.md_state(be.initial_md_state), data)],
                        material=interop.materials(mat))
    assert th.backend.sys.fused.spec.kernel == "K4" and th.backend.max_jobs == 4
    (jfe, (jm,)), jo = jax.jit(jh.step)(jh.init_state())
    (tfe, (tm,)), to = th.step(th.init_state())
    assert int(to.n_flagged) == int(jo.n_flagged) > 4
    assert int(to.n_jobs) == int(jo.n_jobs) == 4
    ran = np.asarray(jo.md_ran)
    assert np.array_equal(to.md_ran.numpy(), ran)
    assert rel_err(np64(to.md_stress_repl)[ran], np.asarray(jo.md_stress_repl)[ran]) < 1e-8
    assert rel_err(np64(tfe.u), np.asarray(jfe.u)) < 1e-8
    assert rel_err(np64(tfe.qp.new_stress), np.asarray(jfe.qp.new_stress)) < 1e-8
    assert np.array_equal(tm.has_run.numpy(), np.asarray(jm.has_run))
    assert np.abs(np64(tm.pos) - np.asarray(jm.pos)).max() < 1e-8
    u = np64(tfe.u).reshape(-1, 3)
    assert np.isclose(np.abs(u).max(), 0.002 * 0.08, rtol=1e-9)
