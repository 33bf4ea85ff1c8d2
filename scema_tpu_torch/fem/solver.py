"""Matrix-free linear solvers for the velocity update.

Torch twin of ``scema_tpu/fem/solver.py``.  The reference assembles the
mass matrix in PETSc and offers CG / GMRES / BiCGStab / MUMPS
(FE_problem.h:882-1017), but its matrix is lumped (diagonal), so the FE step
solves it directly (``assembly.solve_explicit``) and nothing in the step
calls this module.  For the consistent mass (the reference's commented-out
``cell_mass(i,j)`` path, FE_problem.h:797) it gives the matrix-free
operator and Jacobi-preconditioned solvers written out in torch (torch has
no counterpart of ``jax.scipy.sparse.linalg``), each stopping, as the JAX
package's do, once the residual norm ||b - A x|| is at most ``tol * ||b||``
or after ``maxiter`` iterations.  Constrained dofs are identity equations
with a zero right-hand side: the operator masks its input and output
(apply_boundary_values, FE_problem.h:862-914), and the solution is zero
there.  The iterations run on the host, one scalar read per step.
"""
from __future__ import annotations

import numpy as np
import torch

from . import assembly
from .shapes import FEGeometry


def consistent_cell_mass(geom: FEGeometry, rho_qp: torch.Tensor) -> torch.Tensor:
    """(n_cells, 8, 8) consistent mass blocks: M_ij = sum_q rho phi_i phi_j JxW."""
    rho = rho_qp.reshape(geom.n_cells, geom.n_qp_per_cell)
    return torch.einsum("cq,qi,qj,cq->cij", rho, geom.shapes, geom.shapes, geom.jxw)


def consistent_mass_matvec(geom: FEGeometry, cell_mass: torch.Tensor,
                           v: torch.Tensor) -> torch.Tensor:
    """y = M v, matrix-free (gather -> block product -> ``index_add_``)."""
    vc = assembly.gather_cell_dofs(geom, v)  # (c, 8, 3)
    return assembly.scatter_add_cell_dofs(geom, torch.einsum("cij,cjd->cid", cell_mass, vc))


def _pinned(matvec, constrained: torch.Tensor):
    """The operator with the constrained dofs as identity equations."""
    def op(x):
        x = torch.where(constrained, torch.zeros_like(x), x)
        return torch.where(constrained, x, matvec(x))

    return op


def _setup(matvec, b, diag, constrained):
    """(pinned operator, masked rhs, Jacobi inverse diagonal)."""
    b = torch.where(constrained, torch.zeros_like(b), b)
    minv = torch.where(constrained, torch.ones_like(diag), 1.0 / diag)
    return _pinned(matvec, constrained), b, minv


def _norm(x: torch.Tensor) -> float:
    return float(torch.linalg.vector_norm(x))


def cg_solve(matvec, b: torch.Tensor, diag: torch.Tensor, constrained: torch.Tensor,
             tol: float = 1.0e-10, maxiter: int = 200) -> torch.Tensor:
    """Jacobi-preconditioned CG with the constrained dofs pinned to zero
    (apply_boundary_values + PETSc CG, FE_problem.h:862-914), the
    recurrences of ``jax.scipy.sparse.linalg.cg`` from x = 0."""
    op, b, minv = _setup(matvec, b, diag, constrained)
    stop = tol * _norm(b)
    x = torch.zeros_like(b)
    r = b.clone()
    z = minv * r
    p = z
    gamma = torch.dot(r, z)
    for _ in range(maxiter):
        if _norm(r) <= stop:
            break
        Ap = op(p)
        alpha = gamma / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = minv * r
        gamma_new = torch.dot(r, z)
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
    return torch.where(constrained, torch.zeros_like(x), x)


def gmres_solve(matvec, b: torch.Tensor, diag: torch.Tensor, constrained: torch.Tensor,
                tol: float = 1.0e-10, maxiter: int = 200, restart: int = 30) -> torch.Tensor:
    """Jacobi-preconditioned restarted GMRES — the reference's
    ``solve_linear_problem_GMRES`` (FE_problem.h:918-950), matrix-free:
    right preconditioning (A M^-1 y = b, x = M^-1 y), so the Arnoldi
    least-squares residual is the true residual; Givens rotations on the
    host; at most ``maxiter`` restart cycles of ``restart`` steps."""
    op, b, minv = _setup(matvec, b, diag, constrained)
    stop = tol * _norm(b)
    x = torch.zeros_like(b)
    m = max(1, min(restart, b.shape[0]))
    for _ in range(maxiter):
        r = b - op(x)
        beta = _norm(r)
        if beta <= stop:
            break
        V = [r / beta]
        H = np.zeros((m + 1, m))
        cs, sn = np.zeros(m), np.zeros(m)
        g = np.zeros(m + 1)
        g[0] = beta
        k = 0
        for j in range(m):
            w = op(minv * V[j])
            for i in range(j + 1):  # modified Gram-Schmidt
                H[i, j] = float(torch.dot(w, V[i]))
                w = w - H[i, j] * V[i]
            hnext = _norm(w)
            H[j + 1, j] = hnext
            for i in range(j):  # the earlier rotations on the new column
                H[i, j], H[i + 1, j] = (cs[i] * H[i, j] + sn[i] * H[i + 1, j],
                                        -sn[i] * H[i, j] + cs[i] * H[i + 1, j])
            den = np.hypot(H[j, j], H[j + 1, j])
            cs[j], sn[j] = H[j, j] / den, H[j + 1, j] / den
            H[j, j], H[j + 1, j] = den, 0.0
            g[j + 1], g[j] = -sn[j] * g[j], cs[j] * g[j]
            k = j + 1
            # converged, or a lucky breakdown (the Krylov space is invariant)
            if abs(g[j + 1]) <= stop or hnext == 0.0:
                break
            V.append(w / hnext)
        y = np.linalg.solve(np.triu(H[:k, :k]), g[:k])
        x = x + minv * sum(float(y[i]) * V[i] for i in range(k))
    return torch.where(constrained, torch.zeros_like(x), x)


def bicgstab_solve(matvec, b: torch.Tensor, diag: torch.Tensor, constrained: torch.Tensor,
                   tol: float = 1.0e-10, maxiter: int = 200) -> torch.Tensor:
    """Jacobi-preconditioned BiCGStab — the reference's
    ``solve_linear_problem_BiCGStab`` (FE_problem.h:954-991; its BoomerAMG
    preconditioner becomes Jacobi, as in the JAX package), the recurrences
    of ``jax.scipy.sparse.linalg.bicgstab`` from x = 0, stopping early
    where the half-step residual s already meets the tolerance."""
    op, b, minv = _setup(matvec, b, diag, constrained)
    stop = tol * _norm(b)
    x = torch.zeros_like(b)
    r = b.clone()
    rhat = r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    alpha = omega = rho = one
    p = q = r
    for _ in range(maxiter):
        if _norm(r) <= stop:
            break
        rho_new = torch.dot(rhat, r)
        if float(rho_new) == 0.0:  # breakdown
            break
        p = r + (rho_new / rho * alpha / omega) * (p - omega * q)
        phat = minv * p
        q = op(phat)
        alpha = rho_new / torch.dot(rhat, q)
        s = r - alpha * q
        if _norm(s) <= stop:
            x = x + alpha * phat
            r = s
            break
        shat = minv * s
        t = op(shat)
        omega = torch.dot(t, s) / torch.dot(t, t)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        if float(omega) == 0.0 or float(alpha) == 0.0:
            break
    return torch.where(constrained, torch.zeros_like(x), x)


def direct_solve(matvec, n_dofs: int, b: torch.Tensor,
                 constrained: torch.Tensor) -> torch.Tensor:
    """Dense direct solve — the reference's MUMPS path
    (``solve_linear_problem_direct``, FE_problem.h:995-1017): the pinned
    operator materialised column by column, the constrained equations made
    x_i = 0 on the diagonal (their columns are zero under the mask), then
    ``torch.linalg.solve``.  For small meshes only, as MUMPS on one rank."""
    op = _pinned(matvec, constrained)
    eye = torch.eye(n_dofs, dtype=b.dtype, device=b.device)
    A = torch.stack([op(eye[:, i]) for i in range(n_dofs)], dim=1)
    A = A + torch.diag(constrained.to(b.dtype))
    b = torch.where(constrained, torch.zeros_like(b), b)
    x = torch.linalg.solve(A, b)
    return torch.where(constrained, torch.zeros_like(x), x)
