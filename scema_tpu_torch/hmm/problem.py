"""Top-level HMM coupler: the FE + bridging macro timestep.

Torch twin of ``scema_tpu/hmm/problem.py`` (reference: HMMProblem,
dealammps.cc:101-537).  The per-timestep sequence (do_timestep,
dealammps.cc:418-474; the Newton loop runs exactly once) is

    begin_step -> solve -> [clustering dedup] -> md_update -> check -> end_step
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple

import torch

from ..bridging import bridge
from ..config import HMMConfig
from ..fem import assembly
from ..fem import fe_problem as FE
from ..fem import shapes
from ..fem.problem_types import Problem, make_problem
from ..fem.state import FEState, init_fe_state, init_history, init_qp_state
from ..utils import tensors as T
from ..utils.device import resolve


def clustering_mapping(state: FEState, flags: torch.Tensor, min_steps: int,
                       n_points: int, threshold: float, layout=assembly.WHOLE):
    """Strain-history similarity dedup: which qp sources each qp's stress
    (history_analysis, FE_problem.h:1166-1291).  Active only after
    ``min steps`` timesteps (FE_problem.h:1277).  As in the JAX version the
    splines, the distance matrix (K2) and the graph reduction run on every
    step and the result is selected afterwards.  ``flags`` covers every
    qp; the history is gathered from the rows ``layout`` holds."""
    from ..clustering.reduction import reduce_graph
    from ..clustering.similarity import similarity_adjacency
    from ..clustering.spline import splinify_histories

    n_qp = flags.shape[0]
    identity = torch.arange(n_qp, device=flags.device)
    splines = splinify_histories(layout.full_qps(state.hist.buffer), state.hist.count,
                                 n_points)
    adj = similarity_adjacency(splines, flags, threshold)
    on = state.timestep > min_steps
    mapping, saturated = reduce_graph(adj & on, return_saturated=True)
    return (mapping if on else identity), saturated


class StepOutputs(NamedTuple):
    residual0: torch.Tensor  # rhs norm before the stress update
    residual1: torch.Tensor  # rhs norm after the stress update
    n_flagged: torch.Tensor  # number of qps flagged for MD
    n_jobs: torch.Tensor  # number of qps running MD (after dedup)
    reaction_force: torch.Tensor  # loaded-boundary reaction
    md_ran: torch.Tensor | None = None  # (n_qp,) bool — MD executed this step
    md_strain_cg: torch.Tensor | None = None  # (n_qp, 6) job strains
    md_stress_repl: torch.Tensor | None = None  # (n_qp, n_repl, 6)
    cluster_saturated: torch.Tensor | None = None


# md_update_fn(eps_cg (n_qp,6), material (n_qp,), jobs_mask (n_qp,),
# most_recent_id (n_qp,)) -> dense update_stress_cg (n_qp, 6)
MDUpdateFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor],
                      torch.Tensor]


@dataclass(frozen=True)
class HMMProblem:
    cfg: HMMConfig
    problem: Problem
    geom: shapes.FEGeometry
    ops: FE.FEOps
    ensemble: bridge.ReplicaEnsemble
    md_update_fn: MDUpdateFn | None
    dtype: torch.dtype
    material: torch.Tensor  # (n_qp,) per-qp material index
    surrogate_fn: object = None  # stress method 2 (bridging/surrogate.py)

    @property
    def device(self) -> torch.device:
        return self.material.device

    def init_state(self) -> FEState:
        cfg = self.cfg
        n_qp = self.geom.n_qp_total
        stiff_cg, rho = bridge.average_replica_data(self.ensemble)
        qp = init_qp_state(n_qp, self.material, rho, stiff_cg, dtype=self.dtype)
        capacity = cfg.time.end_timestep - cfg.time.start_timestep + 2
        hist = init_history(n_qp, capacity, dtype=self.dtype, device=self.device)
        return init_fe_state(self.geom.n_nodes, qp, hist, cfg.time.start_timestep,
                             dtype=self.dtype)

    def step(self, state: FEState) -> tuple[FEState, StepOutputs]:
        """One macro timestep, over the rows ``ops.layout`` holds."""
        ops = self.ops
        state = FE.begin_step(ops, state)
        state, out = FE.solve(ops, state)
        p = self.cfg.precision
        id_to_get, saturated = clustering_mapping(
            state, out.flags, p.clustering_min_steps, p.spline_points,
            p.clustering_diff_threshold, ops.layout)
        state = state.replace(hist=state.hist.replace(
            id_to_get_results_from=ops.layout.own(id_to_get)))
        jobs = bridge.job_mask(out.flags, id_to_get)
        if ops.stress_method == 0:
            update_stress_cg = self.md_update_fn(
                out.update_strain_cg, out.material, jobs, out.most_recent_id)
        else:
            update_stress_cg = torch.zeros_like(out.update_strain_cg)
        state, res1 = FE.apply_stress_update(ops, state, out.flags, update_stress_cg,
                                             id_to_get, surrogate_fn=self.surrogate_fn)
        rf = assembly.reaction_force(self.geom, state.qp.new_stress, state.qp.rho,
                                     self.problem.loaded_mask, ops.layout)
        state = FE.end_step(ops, state)
        return state, StepOutputs(
            residual0=out.residual, residual1=res1,
            n_flagged=out.flags.sum(), n_jobs=jobs.sum(),
            reaction_force=rf, cluster_saturated=saturated)


def assign_materials(cfg: HMMConfig, geom: shapes.FEGeometry,
                     generator: torch.Generator | None = None,
                     device=None) -> torch.Tensor:
    """Random per-cell material from proportions, repeated per qp
    (CellData::generate_nanostructure_uniform, FE.h:177-210).  Draws come
    from a ``torch.Generator`` seeded with ``cfg.seed``; they are not the
    JAX package's draws, so tests inject JAX's assignment instead."""
    props = torch.tensor(cfg.material.proportions, dtype=torch.float64)
    if abs(float(props.sum()) - 1.0) > 1e-4:
        raise ValueError("Material proportions must sum to 1")
    if generator is None:
        generator = torch.Generator().manual_seed(cfg.seed)
    r = torch.rand(geom.n_cells, generator=generator, dtype=torch.float64)
    cell_mat = torch.sum(r[:, None] >= torch.cumsum(props, 0)[None, :], dim=1)
    return torch.repeat_interleave(cell_mat, geom.n_qp_per_cell).to(device)


def build_hooke_hmm(cfg: HMMConfig, ensemble: bridge.ReplicaEnsemble | None = None,
                    device=None, material: torch.Tensor | None = None,
                    surrogate_fn=None, device_mesh=None) -> HMMProblem:
    """HMMProblem with the Hooke's-law fake-MD backend (the reference's
    "approximate md with hookes law" debug mode), or with stress method 2
    the surrogate ``surrogate_fn`` (``Surrogate.as_update_fn``; its tensors
    on ``device``).  ``material`` overrides the per-qp material draw.
    ``device`` None means the current CUDA device (an error without one);
    ``device="cpu"`` asks for the CPU.  With ``device_mesh`` (a mesh of
    ``parallel.mesh_utils``) each rank computes the update of its block of
    qps and the blocks are all-gathered (``shard_md_update``,
    problem.py:202-205)."""
    device = resolve(device)
    dtype = getattr(torch, cfg.dtype)
    problem = make_problem(cfg, dtype, device)
    geom = shapes.precompute_geometry(problem.mesh.nodes, problem.mesh.cells,
                                      cfg.mesh.quadrature_formula, dtype=dtype,
                                      device=device)
    if ensemble is None:
        stiff = T.isotropic_c66(3.0e9, 0.35, dtype=dtype, device=device)
        ensemble = bridge.uniform_ensemble(len(cfg.material.materials),
                                           cfg.material.number_of_replicas,
                                           stiff, 1200.0, dtype)

    def md_update_fn(eps_cg, material_, jobs, most_recent_id):
        upd = bridge.hooke_update_stress(ensemble, eps_cg, material_)
        return torch.where(jobs[:, None], upd, torch.zeros_like(upd))

    if device_mesh is not None:
        from ..parallel.mesh_utils import shard_md_update

        md_update_fn = shard_md_update(md_update_fn, device_mesh)
    if material is None:
        material = assign_materials(cfg, geom, device=device)
    material = material.to(device=device, dtype=torch.int64)
    stiff_cg, rho = bridge.average_replica_data(ensemble)
    qp = init_qp_state(geom.n_qp_total, material, rho, stiff_cg, dtype=dtype)
    ops = FE.make_ops(geom, problem, qp, cfg.time.timestep_length,
                      cfg.bridging.stress_method,
                      cfg.bridging.approx_md_with_hookes_law,
                      cfg.precision.min_quadrature_strain_norm)
    return HMMProblem(cfg=cfg, problem=problem, geom=geom, ops=ops,
                      ensemble=ensemble, md_update_fn=md_update_fn, dtype=dtype,
                      material=material, surrogate_fn=surrogate_fn)
