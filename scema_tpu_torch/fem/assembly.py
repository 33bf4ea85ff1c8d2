"""Matrix-free explicit-dynamics FE kernels (gather -> einsum -> scatter).

Torch twin of ``scema_tpu/fem/assembly.py``.  The reference assembles
``M dv = dt * (f_ext - f_int)`` with a lumped diagonal mass
(FE_problem.h:732-914); here that is a gather of cell dofs, one einsum per
quadrature sum, and a scatter-add back onto the nodes.

The JAX version scatters with ``jax.ops.segment_sum``; here it is
``index_add_``.  On a CUDA tensor ``index_add_`` sums with atomics in an
order that changes from run to run, so nodal sums differ between runs by a
few float32 ulps of the largest contribution (relative ~1e-7 on the
dogbone); on the CPU the order is fixed and the sums are bit-reproducible.

Every function that sums over qps takes a :class:`Layout`: which rows of
the dof and qp axes this process holds, and the collectives that join the
processes' rows.  The default, :data:`WHOLE`, holds every row and its
collectives are identities, so the arithmetic is the unsharded one;
``fem.sharded`` gives one rank of a process mesh its own layout.
"""
from __future__ import annotations

import torch

from ..utils import tensors as T
from .shapes import FEGeometry

GRAVITY = 9.81  # m/s^2 — BodyForce magnitude (FE.h:143-147), along -z


class Layout:
    """The whole mesh in one process: every row of the dof and qp axes is
    held here and each collective is the identity."""

    def rows(self, n: int) -> tuple[int, int]:
        """(first, end) of the rows held here of an axis of length n."""
        return 0, n

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """The rows held here of a full nodal or qp array."""
        return x

    def full_dofs(self, x: torch.Tensor) -> torch.Tensor:
        """The full nodal array from every process's rows."""
        return x

    def full_qps(self, x: torch.Tensor) -> torch.Tensor:
        """The full qp array from every process's rows."""
        return x

    def assemble(self, part: torch.Tensor) -> torch.Tensor:
        """The held rows of the sum over processes of each one's nodal
        contributions (n_dofs,) from the qps it holds."""
        return part

    def total(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over processes of each one's share of a qp sum."""
        return x

    def norm(self, v: torch.Tensor) -> torch.Tensor:
        """The l2 norm of a nodal vector from the rows held here."""
        return torch.linalg.vector_norm(v)


WHOLE = Layout()


def gather_cell_dofs(geom: FEGeometry, nodal: torch.Tensor) -> torch.Tensor:
    """(n_dofs,) -> (n_cells, 8, 3) per-cell nodal values."""
    return nodal.reshape(geom.n_nodes, 3)[geom.cells]


def _cell_block(geom: FEGeometry, layout: Layout) -> tuple[int, int]:
    """(first, end) of the cells that hold the qps held here."""
    q0, q1 = layout.rows(geom.n_qp_total)
    nq = geom.n_qp_per_cell
    return q0 // nq, -(-q1 // nq)


def _by_cell(geom: FEGeometry, layout: Layout, x: torch.Tensor) -> torch.Tensor:
    """Per-qp rows held here (m, ...) laid out by the cells of
    :func:`_cell_block` (cells, n_q, ...), zero at the qps of a shared cell
    that another process holds."""
    nq = geom.n_qp_per_cell
    q0, q1 = layout.rows(geom.n_qp_total)
    c0, c1 = _cell_block(geom, layout)
    lo, hi = q0 - c0 * nq, c1 * nq - q1
    if lo or hi:
        x = torch.cat([x.new_zeros((lo,) + x.shape[1:]), x, x.new_zeros((hi,) + x.shape[1:])])
    return x.reshape((c1 - c0, nq) + x.shape[1:])


def _scatter_nodes(geom: FEGeometry, vals: torch.Tensor, c0: int = 0) -> torch.Tensor:
    """(cells, 8, ...) of the cells from c0 on -> (n_nodes, ...) sum over
    every cell touching a node."""
    flat = vals.reshape((-1,) + vals.shape[2:])
    out = torch.zeros((geom.n_nodes,) + vals.shape[2:], dtype=vals.dtype,
                      device=vals.device)
    return out.index_add_(0, geom.cells[c0:c0 + vals.shape[0]].reshape(-1), flat)


def scatter_add_cell_dofs(geom: FEGeometry, cell_vals: torch.Tensor) -> torch.Tensor:
    """(n_cells, 8, 3) -> (n_dofs,)."""
    return _scatter_nodes(geom, cell_vals).reshape(-1)


def qp_gradients(geom: FEGeometry, nodal: torch.Tensor, c0: int = 0,
                 c1: int | None = None) -> torch.Tensor:
    """Displacement gradient d u_i / d x_j at the qps of cells c0:c1 (all
    by default): (cells, n_qp, 3, 3)."""
    cell_u = nodal.reshape(geom.n_nodes, 3)[geom.cells[c0:c1]]
    return torch.einsum("cvi,cqvj->cqij", cell_u, geom.grads[c0:c1])


def qp_strains(geom: FEGeometry, nodal: torch.Tensor, layout: Layout = WHOLE) -> torch.Tensor:
    """Voigt strain (m, 6) at the qps held here (every qp by default) from
    the full nodal vector."""
    q0, q1 = layout.rows(geom.n_qp_total)
    c0, c1 = _cell_block(geom, layout)
    eps = T.strain_from_grad(qp_gradients(geom, nodal, c0, c1))
    lo = q0 - c0 * geom.n_qp_per_cell
    return T.sym_to_voigt(eps).reshape(-1, 6)[lo:lo + q1 - q0]


def _nodal_mass_weights(geom: FEGeometry, rho_qp: torch.Tensor,
                        layout: Layout = WHOLE) -> torch.Tensor:
    """sum_q rho phi_v JxW per node (row-sum lumping, FE_problem.h:776-800)
    over the qps held here."""
    c0, c1 = _cell_block(geom, layout)
    rho = _by_cell(geom, layout, rho_qp)
    contrib = torch.einsum("cq,qv,cq->cv", rho, geom.shapes, geom.jxw[c0:c1])
    return _scatter_nodes(geom, contrib, c0)


def lumped_mass_diag(geom: FEGeometry, rho_qp: torch.Tensor) -> torch.Tensor:
    """Diagonal mass (n_dofs,), identical for the 3 components of a node."""
    return torch.repeat_interleave(_nodal_mass_weights(geom, rho_qp), 3)


def internal_force(geom: FEGeometry, stress_voigt: torch.Tensor,
                   layout: Layout = WHOLE) -> torch.Tensor:
    """f_int (n_dofs,) = sum_q sigma : eps(phi) JxW  (FE_problem.h:817-827)
    over the qps held here."""
    c0, c1 = _cell_block(geom, layout)
    sig = T.voigt_to_sym(_by_cell(geom, layout, stress_voigt))
    cell_f = torch.einsum("cqij,cqvj,cq->cvi", sig, geom.grads[c0:c1], geom.jxw[c0:c1])
    return _scatter_nodes(geom, cell_f, c0).reshape(-1)


def external_force(geom: FEGeometry, rho_qp: torch.Tensor,
                   layout: Layout = WHOLE) -> torch.Tensor:
    """Gravity body force f_ext (n_dofs,)  (FE_problem.h:802-816) over the
    qps held here."""
    f_node = _nodal_mass_weights(geom, rho_qp, layout)
    f = torch.zeros((geom.n_nodes, 3), dtype=rho_qp.dtype, device=rho_qp.device)
    f[:, 2] = -GRAVITY * f_node
    return f.reshape(-1)


def assemble_rhs(geom: FEGeometry, stress_voigt: torch.Tensor, rho_qp: torch.Tensor,
                 dt: float, constrained: torch.Tensor, layout: Layout = WHOLE) -> torch.Tensor:
    """rhs = dt * (f_ext - f_int) with constrained rows zeroed, on the dof
    rows held here (``constrained`` those rows)."""
    rhs = layout.assemble(dt * (external_force(geom, rho_qp, layout)
                                - internal_force(geom, stress_voigt, layout)))
    return torch.where(constrained, torch.zeros_like(rhs), rhs)


def solve_explicit(rhs: torch.Tensor, mass_diag: torch.Tensor,
                   constrained: torch.Tensor) -> torch.Tensor:
    """Diagonal solve M dv = rhs (the reference's CG, FE_problem.h:882-914)."""
    dv = rhs / mass_diag
    return torch.where(constrained, torch.zeros_like(dv), dv)


def reaction_force(geom: FEGeometry, stress_voigt: torch.Tensor, rho_qp: torch.Tensor,
                   loaded_mask: torch.Tensor, layout: Layout = WHOLE) -> torch.Tensor:
    """Sum of nodal internal-minus-external force over loaded dofs
    (FE_problem.h:1801-1858, 1941-1980)."""
    f = internal_force(geom, stress_voigt, layout) - external_force(geom, rho_qp, layout)
    return layout.total(torch.sum(torch.where(loaded_mask, f, torch.zeros_like(f))))
