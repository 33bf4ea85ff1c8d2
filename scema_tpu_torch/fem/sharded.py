"""P2: node- and qp-sharded FE state over a process mesh.

Torch twin of ``scema_tpu/fem/sharded.py``.  The base posture replicates
the FE nodal arrays on every rank, as the reference's
``parallel::shared::Triangulation`` does (a full mesh per rank).  Here the
persistent state is spread instead:

- nodal leaves (``u``, ``v``, ``inc_u``, ``inc_v``; the lumped-mass
  diagonal is sliced from the ops) keep their dof block on each rank,
- qp leaves (every ``QPState`` field, the history ``buffer``,
  ``id_to_get_results_from`` and ``most_recent_id``) keep their qp block
  (qp = cell * n_q + q, a cell decomposition like the reference's subdomain
  ownership, FE_problem.h:104-109),

each only where its leading axis divides by the mesh size; any other leaf
stays replicated (JAX ``_spec_for``, sharded.py:45-56).

The JAX version pins the state's sharding and lets GSPMD partition the
step, inserting the all-gather of displacements (the "ghost exchange")
and the reduce-scatter of force contributions (the "owned-node
accumulation").  Torch has no GSPMD, so the FE layer takes a layout
(``assembly.Layout``) that says which rows a process holds and joins the
processes' rows; :class:`RankLayout` is one rank's, and
:func:`make_sharded_step` is ``hmm.step`` over ops bound to it.  Each rank
assembles the force contributions of its own qps into a full nodal vector
(a qp block that splits a cell takes the cell with the other rank's qps
at zero), one ``reduce_scatter`` sums them onto the owning ranks, the
diagonal solve and the incremental update run on owned dofs, and one
``all_gather`` of the displacement increment feeds the strain update of
the rank's qps.  The phases that need every qp gather their inputs, as
GSPMD would: the clustering matrix and the greedy reduction (the history
buffer, the flags), the job mask, and the MD or Hooke update (the
strains, materials and most-recent ids); the stress update reads the
rank's rows of their outputs.  Norms and the reaction force are
``all_reduce`` sums.

The sharded step sums in another order than the unsharded one, so the two
agree to roundoff (1e-9 relative in stress over multi-step runs), not bit
for bit; over a mesh of one rank every collective is an identity and the
state's arithmetic is the unsharded step's (the residual norms sum their
squares in another order).

Usage::

    mesh = make_mesh()                       # after init_process_group
    hmm = build_hooke_hmm(cfg)
    step = make_sharded_step(hmm, mesh)      # drop-in for hmm.step
    state = shard_fe_state(hmm.init_state(), mesh)
    state, out = step(state)
    full = gather_fe_state(state, mesh, hmm)
"""
from __future__ import annotations

import dataclasses
from dataclasses import fields

import torch

from ..parallel import mesh_utils as MU
from .assembly import Layout
from .state import FEState, QPState

_NODAL = ("u", "v", "inc_u", "inc_v")
_HIST = ("buffer", "id_to_get_results_from", "most_recent_id")


@dataclasses.dataclass(frozen=True)
class RankLayout(Layout):
    """One rank's rows of the dof and qp axes: a contiguous block of each
    axis whose length divides by the mesh size, the whole axis of one that
    does not (JAX ``_spec_for``, sharded.py:45-56)."""

    group: object
    world: int
    rank: int
    n_dofs: int
    n_qp: int

    def rows(self, n: int) -> tuple[int, int]:
        if n % self.world:
            return 0, n
        b = n // self.world
        return self.rank * b, (self.rank + 1) * b

    def own(self, x: torch.Tensor) -> torch.Tensor:
        lo, hi = self.rows(x.shape[0])
        return x[lo:hi]

    def _full(self, x: torch.Tensor, n: int) -> torch.Tensor:
        return MU.all_gather(x, self.group) if n % self.world == 0 else x

    def full_dofs(self, x: torch.Tensor) -> torch.Tensor:
        return self._full(x, self.n_dofs)

    def full_qps(self, x: torch.Tensor) -> torch.Tensor:
        return self._full(x, self.n_qp)

    def assemble(self, part: torch.Tensor) -> torch.Tensor:
        if self.n_qp % self.world:  # every rank assembled every qp
            return self.own(part)
        if self.n_dofs % self.world:
            return MU.all_reduce(part, self.group)
        return MU.reduce_scatter(part, self.group)

    def total(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.n_qp % self.world else MU.all_reduce(x, self.group)

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        sq = torch.sum(v * v)
        return torch.sqrt(MU.all_reduce(sq, self.group) if self.n_dofs % self.world == 0
                          else sq)


def rank_layout(mesh, geom, axis: str = "md") -> RankLayout:
    """This rank's layout of the FE mesh ``geom`` over ``mesh``."""
    r = MU.mesh_rank(mesh, axis)
    if r is None:
        raise ValueError("this rank is outside the mesh; an FE state has no block here")
    return RankLayout(group=MU.mesh_group(mesh, axis), world=MU.mesh_size(mesh, axis), rank=r,
                      n_dofs=3 * geom.n_nodes, n_qp=geom.n_qp_total)


def _map_state(state: FEState, nodal, qp) -> FEState:
    """``state`` with ``nodal`` applied to the nodal leaves and ``qp`` to
    the qp leaves."""
    qs = state.qp.replace(**{f.name: qp(getattr(state.qp, f.name)) for f in fields(QPState)})
    hist = state.hist.replace(**{k: qp(getattr(state.hist, k)) for k in _HIST})
    return state.replace(qp=qs, hist=hist, **{k: nodal(getattr(state, k)) for k in _NODAL})


def shard_fe_state(state: FEState, mesh, axis: str = "md") -> FEState:
    """This rank's block of every nodal and qp leaf of a full (replicated)
    state, cloned so the full arrays can be freed (a rank outside the mesh
    keeps the state whole)."""
    w, r = MU.mesh_size(mesh, axis), MU.mesh_rank(mesh, axis)
    if r is None:
        return state

    def cut(x):
        n = x.shape[0]
        return x[r * (n // w):(r + 1) * (n // w)].clone() if n % w == 0 else x

    return _map_state(state, cut, cut)


def gather_fe_state(state: FEState, mesh, hmm, axis: str = "md") -> FEState:
    """The full state from every rank's blocks (for tests and writers)."""
    lay = rank_layout(mesh, hmm.geom, axis)
    return _map_state(state, lay.full_dofs, lay.full_qps)


def fe_state_bytes(state: FEState) -> int:
    """Bytes of the state's tensor leaves on this rank."""
    total = 0

    def add(x):
        nonlocal total
        total += x.numel() * x.element_size()
        return x

    _map_state(state, add, add)
    return total


def make_sharded_step(hmm, mesh, axis: str = "md"):
    """``hmm.step`` over a state from :func:`shard_fe_state`: the same
    macro-step with its FE ops bound to this rank's :class:`RankLayout`.
    ``hmm`` is an ``HMMProblem`` (the Hooke or surrogate backend, its
    ``md_update_fn`` unsharded or already wrapped by
    ``mesh_utils.shard_md_update``)."""
    lay = rank_layout(mesh, hmm.geom, axis)
    ops = dataclasses.replace(hmm.ops, layout=lay, mass_diag=lay.own(hmm.ops.mass_diag))
    return dataclasses.replace(hmm, ops=ops).step
