"""The drop-weight and compact-tension problems and the FE solvers of the
port against the JAX package, float64 on the CPU.

Inputs are built in the repository: the drop-weight plate (0.08 x 0.08 x
0.02 m, 6 x 6 x 2 cells, a 0.04 m weight driven at 1e8 m/s^2 for 3 steps:
chip_smoke.py phase 24's configuration), and a compact-tension specimen
(calculi_B 0.01 m) written as a GMSH file by tests/torch_file_util.py, an
O-grid about the pin hole so that the loaded ring, y = 0 and z = 0 all hold
nodes.  Checks, each with its tolerance:

* both packages read the GMSH file to the same nodes and cells (the port's
  Python parser against JAX's reader), exactly;
* for the dogbone, the drop-weight (class "dropweight" and "drop weight")
  and the compact tension ("compact" and "compact tension"): the fixed and
  loaded masks, and ``bc_inc_velocity(t)`` / ``constrained_mask(t)`` for t
  = 1 ... steps to accelerate + 1, exactly; an unknown class raises
  ValueError in both;
* 10 Hooke-mode macro-steps of the drop-weight and the compact tension: u
  within 1e-12 relative (both sum the same terms, in another order);
* the drop-weight with real MD on a 2 x 2 x 1-cell plate, the 64-atom SW
  box at the flagged qps (at most 8 MD jobs a step, taken round-robin;
  the port on K5's plain version, JAX on its XLA engine, JAX's prepared
  states and material draw injected through ``interop``; JAX measures no
  replica, ``torch_port_util.fixed_replica_data``), 2 macro-steps:
  stresses within 1e-8 relative (the regime of tests/test_torch_hmm_sw.py);
* a mirror of tests/test_solver.py: the consistent mass's row sums are the
  lumped diagonal (1e-12), and CG, GMRES, BiCGStab and the direct solve
  each give JAX's solution on the same seeded system within 1e-9.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.config import config_from_dict as j_config
from scema_tpu.fem import assembly as JA
from scema_tpu.fem import mesh as JMesh
from scema_tpu.fem import problem_types as JP
from scema_tpu.fem import shapes as JS
from scema_tpu.fem import solver as JSOL
from scema_tpu.hmm import md_coupling as JMC
from scema_tpu.hmm.md_coupling import build_md_hmm as j_build_md_hmm
from scema_tpu.hmm.problem import assign_materials
from scema_tpu.hmm.problem import build_hooke_hmm as j_build_hooke
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.config import config_from_dict as t_config
from scema_tpu_torch.fem import assembly as TA
from scema_tpu_torch.fem import mesh as TMesh
from scema_tpu_torch.fem import problem_types as TP
from scema_tpu_torch.fem import shapes as TS
from scema_tpu_torch.fem import solver as TSOL
from scema_tpu_torch.hmm.md_coupling import build_md_hmm as t_build_md_hmm
from scema_tpu_torch.hmm.problem import build_hooke_hmm as t_build_hooke
from scema_tpu_torch.md import material as TM

from torch_file_util import write_ct_msh
from torch_port_util import fixed_replica_data, np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

N_ACC = 3
DROPWEIGHT = {"problem type": {"class": "dropweight", "diameter": 0.04, "acceleration": 1.0e8,
                               "steps to accelerate": N_ACC},
              "continuum mesh": {"input": {"style": "cuboid", "x length": 0.08,
                                           "y length": 0.08, "z length": 0.02, "x cells": 6,
                                           "y cells": 6, "z cells": 2}}}
CALCULI_B = 0.01
# a displacement of 0.002 x W per step at the pin: the dogbone's strain scale
CT_VELOCITY = 0.002 * 2.0 * CALCULI_B
HOOKE = {"scale-bridging": {"approximate md with hookes law": 1}}


@pytest.fixture(scope="module")
def ct_msh(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ct") / "ct.msh")
    assert write_ct_msh(path, CALCULI_B) == 72
    return path


def _ct(path):
    return {"problem type": {"class": "compact", "velocity": CT_VELOCITY},
            "continuum mesh": {"input": {"style": "file3D", "filename": path,
                                         "calculi_B": CALCULI_B}}}


def _with_class(d: dict, cls: str) -> dict:
    return {**d, "problem type": {**d["problem type"], "class": cls}}


def test_gmsh_file_reads_as_in_jax(ct_msh):
    j, t = JMesh.read_msh(ct_msh), TMesh.read_msh(ct_msh)
    assert t.n_cells == 72 and t.n_nodes == 156  # the unused node dropped
    assert np.array_equal(t.nodes, j.nodes) and np.array_equal(t.cells, j.cells)
    g = TS.precompute_geometry(t.nodes, t.cells, 2, dtype=torch.float64, device="cpu")
    assert float(g.jxw.min()) > 0.0  # every hex right-handed


@pytest.mark.parametrize("which, cls", [("dogbone", "dogbone"), ("drop", "dropweight"),
                                        ("drop", "drop weight"), ("ct", "compact"),
                                        ("ct", "compact tension")])
def test_boundary_conditions_match_jax(ct_msh, which, cls):
    d = {"dogbone": {}, "drop": DROPWEIGHT, "ct": _ct(ct_msh)}[which]
    if which != "dogbone":
        d = _with_class(d, cls)
    jp = JP.make_problem(j_config(d))
    tp = TP.make_problem(t_config(d), device="cpu")
    assert np.array_equal(tp.mesh.nodes, jp.mesh.nodes)
    assert np.array_equal(tp.mesh.cells, jp.mesh.cells)
    fixed, loaded = tp.fixed_mask.numpy(), tp.loaded_mask.numpy()
    assert np.array_equal(fixed, np.asarray(jp.fixed_mask))
    assert np.array_equal(loaded, np.asarray(jp.loaded_mask))
    assert fixed.any() and loaded.any()
    if which == "ct":  # the three sets of compact_tension.h
        assert fixed[1::3].any() and fixed[2::3].any() and loaded[1::3].any()
    for t in range(1, N_ACC + 2):
        assert np.array_equal(tp.bc_inc_velocity(t).numpy(),
                              np.asarray(jp.bc_inc_velocity(jnp.asarray(t))))
        assert np.array_equal(tp.constrained_mask(t).numpy(),
                              np.asarray(jp.constrained_mask(jnp.asarray(t))))
    if which == "drop":  # the weight is driven, and pinned, only while it accelerates
        assert bool(tp.bc_inc_velocity(N_ACC).any()) and not tp.bc_inc_velocity(N_ACC + 1).any()
        assert not torch.equal(tp.constrained_mask(N_ACC), tp.constrained_mask(N_ACC + 1))


def test_unknown_class_raises():
    d = {"problem type": {"class": "three-point bend"}}
    with pytest.raises(ValueError, match="unknown problem type"):
        JP.make_problem(j_config(d))
    with pytest.raises(ValueError, match="unknown problem type"):
        TP.make_problem(t_config(d), device="cpu")


@pytest.mark.parametrize("which", ["drop", "ct"])
def test_hooke_steps_match_jax(ct_msh, which):
    """(The dogbone's Hooke steps: tests/test_torch_fem.py.)"""
    d = {**{"drop": DROPWEIGHT, "ct": _ct(ct_msh)}[which], **HOOKE}
    jh, th = j_build_hooke(j_config(d)), t_build_hooke(t_config(d), device="cpu")
    js, ts = jh.init_state(), th.init_state()
    step = jax.jit(jh.step)
    for _ in range(10):
        js, jo = step(js)
        ts, to = th.step(ts)
        assert int(to.n_flagged) == int(jo.n_flagged)
        assert abs(float(to.reaction_force) - float(jo.reaction_force)) <= \
            1e-12 * abs(float(jo.reaction_force))
    assert float(ts.u.abs().max()) > 0.0
    assert rel_err(ts.u.numpy(), np.asarray(js.u)) < 1e-12
    assert rel_err(ts.qp.new_stress.numpy(), np.asarray(js.qp.new_stress)) < 1e-12


def _md_drop(config):
    cfg = config({**DROPWEIGHT, "continuum mesh": {"input": {
        **DROPWEIGHT["continuum mesh"]["input"], "x cells": 2, "y cells": 2, "z cells": 1}},
        "computational resources": {"maximum md jobs": 8}})
    return cfg.replace(md=cfg.md.__class__(temperature=300.0, timestep_length=2.0,
                                           strain_rate=1.0e-3, nsteps_sample=20,
                                           force_field="sw"),
                       md_dtype="float64")


def test_dropweight_real_md_matches_jax(monkeypatch):
    spec = dict(name="sic", force_field="sw", n_cells=2)
    fixed_replica_data(monkeypatch, JMC)
    jcfg = _md_drop(j_config)
    jh = j_build_md_hmm(jcfg, spec=JM.MaterialSpec(**spec, use_fused=False), equil_steps=10,
                        minimize_steps=20)
    be = jh.backend
    data = [interop.init_data(JM.InitData(
        length=be.ensemble.init_length[0, r], stress=be.ensemble.init_stress[0, r],
        stiff=be.ensemble.init_stiff[0, r], density=be.ensemble.rho[0, r]))
        for r in range(be.n_repl)]
    mat = assign_materials(jcfg, jh.geom, jh.base.dtype)
    th = t_build_md_hmm(_md_drop(t_config), spec=TM.MaterialSpec(**spec), device="cpu",
                        prepared=[(interop.md_state(be.initial_md_state), data)],
                        material=interop.materials(mat))
    assert th.backend.sys.route == "K5" and th.geom.n_qp_total == 32
    jc, tc = jh.init_state(), th.init_state()
    step = jax.jit(jh.step)
    for _ in range(2):
        jc, jo = step(jc)
        tc, to = th.step(tc)
        assert int(to.n_flagged) == int(jo.n_flagged) > 0
        assert int(to.n_jobs) == int(jo.n_jobs) > 0
        assert rel_err(np64(to.md_stress_repl), np.asarray(jo.md_stress_repl)) < 1e-8
        assert abs(float(to.reaction_force) - float(jo.reaction_force)) <= \
            1e-8 * abs(float(jo.reaction_force))
    assert rel_err(np64(tc[0].qp.new_stress), np.asarray(jc[0].qp.new_stress)) < 1e-8
    assert rel_err(np64(tc[0].u), np.asarray(jc[0].u)) < 1e-8


def _consistent_system(seed: int):
    """tests/test_solver.py's system in both packages (2 x 2 x 3 cells,
    rho 1200, ~10% of the dofs constrained, a seeded x_true)."""
    m = TMesh.build_cuboid(1.0, 1.0, 1.5, 2, 2, 3)
    jg = JS.precompute_geometry(m.nodes, m.cells, 2)
    tg = TS.precompute_geometry(m.nodes, m.cells, 2, dtype=torch.float64, device="cpu")
    n = tg.n_nodes * 3
    rng = np.random.default_rng(seed)
    constrained = rng.random(n) < 0.1
    x_true = np.where(constrained, 0.0, rng.standard_normal(n))
    rho = np.full(tg.n_qp_total, 1200.0)
    jcm = JSOL.consistent_cell_mass(jg, jnp.asarray(rho))
    tcm = TSOL.consistent_cell_mass(tg, torch.as_tensor(rho))
    jmv = lambda v: JSOL.consistent_mass_matvec(jg, jcm, v)  # noqa: E731
    tmv = lambda v: TSOL.consistent_mass_matvec(tg, tcm, v)  # noqa: E731
    jb = jnp.where(jnp.asarray(constrained), 0.0, jmv(jnp.asarray(x_true)))
    j = (jmv, jb, JA.lumped_mass_diag(jg, jnp.asarray(rho)), jnp.asarray(constrained))
    t = (tmv, torch.as_tensor(np.asarray(jb)), TA.lumped_mass_diag(tg, torch.as_tensor(rho)),
         torch.as_tensor(constrained))
    return j, t, jcm, tcm, x_true, n


def test_consistent_mass_row_sums_equal_lumped():
    m = TMesh.build_cuboid(1.0, 1.0, 1.0, 2, 2, 2)
    g = TS.precompute_geometry(m.nodes, m.cells, 2, dtype=torch.float64, device="cpu")
    rho = torch.full((g.n_qp_total,), 950.0, dtype=torch.float64)
    cm = TSOL.consistent_cell_mass(g, rho)
    row_sums = TSOL.consistent_mass_matvec(g, cm, torch.ones(g.n_nodes * 3, dtype=torch.float64))
    lumped = TA.lumped_mass_diag(g, rho)
    assert rel_err(row_sums, lumped) < 1e-12
    assert abs(float(row_sums.reshape(-1, 3)[:, 0].sum()) - 950.0) < 1e-12 * 950.0


@pytest.mark.parametrize("solver", ["cg", "gmres", "bicgstab", "direct"])
def test_solvers_match_jax(solver):
    (jmv, jb, jd, jc), (tmv, tb, td, tc), jcm, tcm, x_true, n = _consistent_system(1)
    assert rel_err(tcm, np.asarray(jcm)) < 1e-13
    kw = dict(tol=1e-12, maxiter=500)
    if solver == "direct":
        xj, xt = JSOL.direct_solve(jmv, n, jb, jc), TSOL.direct_solve(tmv, n, tb, tc)
    else:
        name = f"{solver}_solve"
        xj = getattr(JSOL, name)(jmv, jb, jd, jc, **kw)
        xt = getattr(TSOL, name)(tmv, tb, td, tc, **kw)
    xt = xt.numpy()
    assert np.linalg.norm(xt - x_true) / np.linalg.norm(x_true) < 1e-7
    assert np.abs(xt - np.asarray(xj)).max() < 1e-9
    assert not xt[tc.numpy()].any()  # the constrained dofs pinned
