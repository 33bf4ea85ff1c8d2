"""Per-material specs: ``build_md_hmm(cfg, specs=[...])`` of the port
against the JAX package's (md_coupling.py:407-423), float64 on the CPU.

Two materials with different SW boxes, the 64-atom diamond-Si box (2^3
cells) and a 96-atom one (2 x 2 x 3 cells), on a 1x1x2-cell dogbone (16
qps) whose seed gives each cell another material.  JAX prepares the
replicas (its measure fixed by ``torch_port_util.fixed_replica_data``) on
its XLA engine, the port takes JAX's states, replica data and material
draw and runs K5's plain version; the MD strain rate is raised so that
every deform run is one 10-step neighbor chunk, as in
tests/test_torch_hmm_sw.py.  Three coupled steps (the second material's
qps run MD from step 3): the FE fields and stresses
to 1e-8 relative, the microstates to 1e-8 A (the summation order
differs).  JAX's initial FE state gives every qp the first material's
stiffness and density (``HMMProblem.init_state`` averages
``backends[0].ensemble`` and clamps the material index into it); the
port gives each qp its own material's, and so does the JAX state the step
is compared from, made from both materials' replica data."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from scema_tpu.bridging import bridge as JB
from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.hmm import md_coupling as JMC
from scema_tpu.hmm.problem import assign_materials
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.hmm import md_coupling as TMC
from scema_tpu_torch.md import material as TM

from torch_port_util import fixed_replica_data, np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_STEPS = 3  # the strain wave reaches the second material's cell at step 3
BOXES = (dict(name="sia", force_field="sw", n_cells=2),
         dict(name="sib", force_field="sw", n_cells_xyz=(2, 2, 3)))


def _cfg(cls):
    cfg = cls()
    return cfg.replace(
        seed=3,  # cell 0 takes material 1, cell 1 material 0
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        md=cfg.md.__class__(temperature=300.0, timestep_length=2.0, strain_rate=1.0e-3,
                            nsteps_sample=20, force_field="sw"),
        material=dataclasses.replace(cfg.material, materials=("sia", "sib"),
                                     proportions=(0.5, 0.5)),
        md_dtype="float64")


@pytest.fixture(scope="module")
def runs():
    mp = pytest.MonkeyPatch()
    fixed_replica_data(mp, JMC)
    try:
        jcfg = _cfg(JCfg)
        jh = JMC.build_md_hmm(jcfg, specs=[JM.MaterialSpec(**b, use_fused=False)
                                           for b in BOXES], equil_steps=10, minimize_steps=20)
    finally:
        mp.undo()
    prepared = []
    for be in jh.backends:
        data = [interop.init_data(JM.InitData(
            length=be.ensemble.init_length[0, r], stress=be.ensemble.init_stress[0, r],
            stiff=be.ensemble.init_stiff[0, r], density=be.ensemble.rho[0, r]))
            for r in range(be.n_repl)]
        prepared.append((interop.md_state(be.initial_md_state), data))
    mat = assign_materials(jcfg, jh.geom, jh.base.dtype)
    th = TMC.build_md_hmm(_cfg(TCfg), specs=[TM.MaterialSpec(**b) for b in BOXES],
                          device="cpu", prepared=prepared, material=interop.materials(mat))
    # JAX's initial FE state from both materials' replica data (its own
    # init_state averages the first material's ensemble alone)
    jens = JB.ReplicaEnsemble(*(jnp.concatenate([getattr(be.ensemble, f) for be in jh.backends])
                                for f in JB.ReplicaEnsemble._fields))
    jfix = dataclasses.replace(jh, base=dataclasses.replace(jh.base, ensemble=jens))
    jc, tc, step = jfix.init_state(), th.init_state(), jax.jit(jfix.step)
    for _ in range(N_STEPS):
        (jc, jo), (tc, to) = step(jc), th.step(tc)
    return jh, th, mat, (jc, jo), (tc, to)


def test_each_material_takes_its_own_box(runs):
    jh, th, mat, _, _ = runs
    mat = np.asarray(mat)
    assert sorted(set(mat.tolist())) == [0, 1]
    # each qp's initial stiffness is its own material's; JAX's init_state
    # clamps material 1 into material 0's data (a reference fault)
    own = np.asarray(JB.average_replica_data(jh.backends[1].ensemble)[0][0])
    first = np.asarray(JB.average_replica_data(jh.backends[0].ensemble)[0][0])
    q = int(np.flatnonzero(mat == 1)[0])
    assert np.abs(np64(th.init_state()[0].qp.stiff[q]) - own).max() <= 1e-6 * np.abs(own).max()
    assert np.array_equal(np.asarray(jh.init_state()[0].qp.stiff[q]), first)
    assert [be.sys.n_atoms for be in th.backends] == [be.sys.n_atoms for be in jh.backends] \
        == [64, 96]
    assert [be.sys.route for be in th.backends] == ["K5", "K5"]


def test_coupled_step_matches_jax(runs):
    _, _, _, (jc, jo), (tc, to) = runs
    assert int(to.n_jobs) == int(jo.n_jobs) > 0
    assert np.array_equal(to.md_ran.numpy(), np.asarray(jo.md_ran))
    assert rel_err(np64(to.md_stress_repl), np.asarray(jo.md_stress_repl)) < 1e-8
    assert rel_err(np64(tc[0].u), np.asarray(jc[0].u)) < 1e-8
    assert rel_err(np64(tc[0].qp.new_stress), np.asarray(jc[0].qp.new_stress)) < 1e-8
    for tm, jm in zip(tc[1], jc[1], strict=True):
        assert tm.has_run.any()  # both materials ran MD
        assert np.abs(np64(tm.pos) - np.asarray(jm.pos)).max() < 1e-8
        assert np.array_equal(tm.has_run.numpy(), np.asarray(jm.has_run))


def test_specs_count_must_match_the_materials():
    with pytest.raises(ValueError, match="1 specs for the config's 2 materials"):
        TMC.build_md_hmm(_cfg(TCfg), specs=[TM.MaterialSpec(**BOXES[0])], device="cpu")
