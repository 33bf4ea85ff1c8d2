"""Macroscale explicit-dynamics FE problem: the step lifecycle.

Torch twin of ``scema_tpu/fem/fe_problem.py`` (reference: FEProblem's
beginstep/solve/check/endstep, FE_problem.h; driven by
HMMProblem::do_timestep at dealammps.cc:418-474).  One macro timestep is:

    state = begin_step(ops, state)                    # BCs into inc_v
    state, out = solve(ops, state)                    # explicit solve +
                                                      #   strain update + flags
    upd = <MD / Hooke on out.update_strain_cg>        # bridging layer
    state, res = apply_stress_update(ops, state, upd) # check()
    state = end_step(ops, state)                      # v += inc_v, u += inc_u
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import torch

from ..utils import tensors as T
from . import assembly
from .problem_types import Problem
from .shapes import FEGeometry
from .state import FEState, QPState


@dataclass(frozen=True)
class FEOps:
    """Static pieces of the FE problem."""

    geom: FEGeometry
    problem: Problem
    dt: float
    stress_method: int  # 0 MD | 1 tangent Hooke | 2 surrogate
    hooke_mode: bool  # approximate md with hookes law
    min_strain_norm: float
    mass_diag: torch.Tensor  # (n_dofs,) lumped mass


def make_ops(geom: FEGeometry, problem: Problem, qp: QPState, dt: float,
             stress_method: int, hooke_mode: bool, min_strain_norm: float) -> FEOps:
    return FEOps(geom=geom, problem=problem, dt=dt, stress_method=stress_method,
                 hooke_mode=hooke_mode, min_strain_norm=min_strain_norm,
                 mass_diag=assembly.lumped_mass_diag(geom, qp.rho))


def begin_step(ops: FEOps, state: FEState) -> FEState:
    """Advance the timestep counter and impose BC incremental velocities
    (dealammps.cc:424-439; FE_problem.h:2400-2410, 715-729)."""
    ts = state.timestep + 1
    return state.replace(
        timestep=ts,
        time=state.time + ops.dt,
        inc_u=torch.zeros_like(state.u),
        inc_v=ops.problem.bc_inc_velocity(ts).to(state.v.dtype),
    )


class SolveOutputs(NamedTuple):
    residual: torch.Tensor  # () rhs l2 norm after BCs
    flags: torch.Tensor  # (n_qp,) bool — to_be_updated_with_md
    update_strain_cg: torch.Tensor  # (n_qp, 6) upd_strain in common ground
    material: torch.Tensor  # (n_qp,) int64
    most_recent_id: torch.Tensor  # (n_qp,) int64


def solve(ops: FEOps, state: FEState) -> tuple[FEState, SolveOutputs]:
    """One explicit 'Newton' iteration (FEProblem::solve, FE_problem.h:2414-2449)."""
    qp = state.qp
    constrained = ops.problem.constrained_mask(state.timestep)
    rhs = assembly.assemble_rhs(ops.geom, qp.new_stress, qp.rho, ops.dt, constrained)
    residual = torch.linalg.vector_norm(rhs)
    dv = assembly.solve_explicit(rhs, ops.mass_diag, constrained)

    # update_incremental_variables (FE_problem.h:1021-1037)
    nud = ops.dt * (state.v + state.inc_v + dv) - state.inc_u
    inc_v = state.inc_v + dv
    inc_u = state.inc_u + nud

    # update_strain_quadrature_point_history (FE_problem.h:1042-1106)
    newton_strain = assembly.qp_strains(ops.geom, nud)
    new_strain = qp.new_strain + newton_strain
    upd_strain = qp.upd_strain + newton_strain

    # sticky MD-trigger flag (FE_problem.h:1114-1161)
    if ops.stress_method == 0:
        flags = qp.to_be_updated | (T.voigt_norm(upd_strain) >= ops.min_strain_norm)
    else:
        flags = torch.zeros_like(qp.to_be_updated)

    # strain-history append of the total strain (FE_problem.h:1091-1103);
    # past capacity each append overwrites the last slot (saturation)
    hist = state.hist
    n_qp = new_strain.shape[0]
    idx = min(hist.count, hist.buffer.shape[1] - 1)
    buffer = hist.buffer.clone()
    buffer[:, idx, :] = new_strain
    hist = hist.replace(
        buffer=buffer,
        count=hist.count + 1,
        id_to_get_results_from=torch.arange(n_qp, device=new_strain.device),
        most_recent_id=hist.id_to_get_results_from,
    )

    new_qp = qp.replace(old_strain=qp.new_strain, old_stress=qp.new_stress,
                        newton_strain=newton_strain, new_strain=new_strain,
                        upd_strain=upd_strain, to_be_updated=flags)
    # write_md_updates_list (FE_problem.h:1296-1373): common-ground frame
    update_strain_cg = T.rotate_voigt(upd_strain, new_qp.rotam)
    state = state.replace(qp=new_qp, hist=hist, inc_u=inc_u, inc_v=inc_v)
    return state, SolveOutputs(residual=residual, flags=flags,
                               update_strain_cg=update_strain_cg,
                               material=new_qp.material,
                               most_recent_id=hist.most_recent_id)


def apply_stress_update(ops: FEOps, state: FEState, flags: torch.Tensor,
                        update_stress_cg: torch.Tensor, id_to_get: torch.Tensor,
                        surrogate_fn=None) -> tuple[FEState, torch.Tensor]:
    """FEProblem::check + update_stress_quadrature_point_history
    (FE_problem.h:2452-2477, 1631-1752).  Stress method 2 takes every qp's
    new stress from ``surrogate_fn(old_strain, new_strain, old_stress)``
    (``bridging.surrogate.Surrogate.as_update_fn``).  Returns the
    post-update residual."""
    qp = state.qp
    gathered = update_stress_cg[id_to_get]
    loc = T.rotate_voigt(gathered, qp.rotam.transpose(-1, -2))
    tangent = qp.new_stress + T.sym_contract_c66(qp.stiff, qp.newton_strain)
    if ops.stress_method == 0:
        md_stress = loc + qp.old_stress if ops.hooke_mode else loc
        new_stress = torch.where(flags[:, None], md_stress, tangent)
        upd_strain = torch.where(flags[:, None], torch.zeros_like(qp.upd_strain),
                                 qp.upd_strain)
    elif ops.stress_method == 1:
        new_stress = tangent
        upd_strain = qp.upd_strain
    elif ops.stress_method == 2:
        if surrogate_fn is None:
            raise ValueError("stress_method=2 requires a surrogate_fn")
        new_stress = surrogate_fn(qp.old_strain, qp.new_strain, qp.old_stress)
        upd_strain = qp.upd_strain
    else:
        raise ValueError(f"unknown stress computation method {ops.stress_method}")
    state = state.replace(qp=qp.replace(new_stress=new_stress, upd_strain=upd_strain))
    constrained = ops.problem.constrained_mask(state.timestep)
    rhs = assembly.assemble_rhs(ops.geom, new_stress, qp.rho, ops.dt, constrained)
    return state, torch.linalg.vector_norm(rhs)


def end_step(ops: FEOps, state: FEState) -> FEState:
    """FEProblem::endstep (FE_problem.h:2483-2502): accumulate totals."""
    return state.replace(u=state.u + state.inc_u, v=state.v + state.inc_v)
