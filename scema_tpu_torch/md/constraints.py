"""SHAKE/RATTLE bond-length constraints.

Torch twin of ``scema_tpu/md/constraints.py`` (reference physics: ``fix
shake 0.001 20 1000 m 1.0``, in.strain.lammps — bonds to hydrogens held
rigid so a 2 fs timestep is stable).  Kernel K3 applies the constraints
inside its run (Jacobi sweeps over static partner offsets,
``ops/md_fused.py``); the host MD loops (the unfused engine, the NPT loops
and Berendsen on every engine) apply them here.

Jacobi-style parallel SHAKE, as in the JAX package: each sweep computes
the Lagrange correction of every constraint from the current positions
along its pre-drift direction and applies all of them, under-relaxed, with
one ``index_add`` per bond end over the atom axis (the JAX package's
segment sum); a fixed sweep count (20, the reference's) keeps the work
static.  RATTLE removes the relative velocity along each constrained bond
the same way (10 sweeps).  Every function broadcasts over leading batch
dimensions of the positions (..., N, 3) and boxes (..., 3, 3).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import box as B


class Constraints(NamedTuple):
    idx: np.ndarray  # (nc, 2) int atom pairs
    d0: np.ndarray  # (nc,) target lengths
    mask: np.ndarray  # (nc,) bool (padding rows False)


def from_bonds(bonds, lengths) -> Constraints:
    bonds = np.asarray(bonds, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.float64)
    return Constraints(idx=bonds, d0=lengths, mask=np.ones((bonds.shape[0],), dtype=bool))


def on_device(cons: Constraints, device, dtype=torch.float64) -> Constraints:
    """The set as tensors on ``device`` (the host loops' copy, made once)."""
    return Constraints(idx=torch.as_tensor(np.asarray(cons.idx), dtype=torch.int64,
                                           device=device),
                       d0=torch.as_tensor(np.asarray(cons.d0), dtype=dtype, device=device),
                       mask=torch.as_tensor(np.asarray(cons.mask), device=device))


def _rows(cons: Constraints, like: torch.Tensor):
    """(i, j, d0, mask) of the set on ``like``'s device and dtype (no copy
    for a set already there)."""
    idx = torch.as_tensor(cons.idx, dtype=torch.int64, device=like.device)
    return (idx[:, 0], idx[:, 1], torch.as_tensor(cons.d0, device=like.device).to(like.dtype),
            torch.as_tensor(cons.mask, device=like.device))


def _min_image(h: torch.Tensor):
    """The minimum image of h (..., 3, 3), its inverse taken once:
    dr (..., P, 3) -> dr (..., P, 3) (``box.min_image_disp``)."""
    hinv_t = B.inv_h(h).transpose(-1, -2)
    h_t = h.transpose(-1, -2)

    def mi(dr):
        ds = dr @ hinv_t
        return (ds - torch.round(ds)) @ h_t

    return mi


def shake_positions(cons: Constraints, pos_old: torch.Tensor, pos_new: torch.Tensor,
                    h: torch.Tensor, inv_mass: torch.Tensor, n_iters: int = 20,
                    relax: float = 0.8) -> torch.Tensor:
    """Project updated positions pos_new (..., N, 3) back onto the
    constraint manifold (constraints.py:35-65): each sweep corrects every
    bond along its direction at pos_old, the minimum image taken in the
    boxes h (..., 3, 3); ``inv_mass`` (N,) is 1/m in any consistent unit."""
    if len(cons.idx) == 0:
        return pos_new
    i, j, d0, mask = _rows(cons, pos_new)
    mi = _min_image(h)
    r_old = mi(pos_old[..., j, :] - pos_old[..., i, :])  # reference directions
    inv_mass = inv_mass.to(pos_new.dtype)
    wi, wj = inv_mass[i][:, None], inv_mass[j][:, None]
    w = inv_mass[i] + inv_mass[j]
    d0sq = d0 * d0
    zero = torch.zeros((), dtype=pos_new.dtype, device=pos_new.device)
    # the sweeps accumulate their small corrections apart from the
    # positions and add them once: in float32 a position of tens of A
    # would round every sweep's correction
    dr_new = pos_new[..., j, :] - pos_new[..., i, :]
    acc = torch.zeros_like(pos_new)
    for _ in range(n_iters):
        r_new = mi(dr_new + (acc[..., j, :] - acc[..., i, :]))
        diff = torch.sum(r_new * r_new, -1) - d0sq
        denom = 2.0 * torch.sum(r_new * r_old, -1) * w + 1e-30
        g = torch.where(mask, relax * diff / denom, zero)
        corr = g[..., None] * r_old  # (..., nc, 3)
        acc.index_add_(-2, i, corr * wi).index_add_(-2, j, -corr * wj)
    return pos_new + acc


def rattle_velocities(cons: Constraints, pos: torch.Tensor, vel: torch.Tensor,
                      h: torch.Tensor, inv_mass: torch.Tensor, n_iters: int = 10,
                      relax: float = 0.8) -> torch.Tensor:
    """Remove the relative-velocity components of vel (..., N, 3) along
    the constrained bonds at pos (constraints.py:68-95)."""
    if len(cons.idx) == 0:
        return vel
    i, j, _, mask = _rows(cons, vel)
    r = _min_image(h)(pos[..., j, :] - pos[..., i, :])
    r2 = torch.sum(r * r, -1)
    inv_mass = inv_mass.to(vel.dtype)
    wi, wj = inv_mass[i][:, None], inv_mass[j][:, None]
    w = inv_mass[i] + inv_mass[j]
    zero = torch.zeros((), dtype=vel.dtype, device=vel.device)
    for _ in range(n_iters):
        dv = vel[..., j, :] - vel[..., i, :]
        k = torch.where(mask, relax * torch.sum(dv * r, -1) / (r2 * w + 1e-30), zero)
        corr = k[..., None] * r
        dvel = torch.zeros_like(vel).index_add_(-2, i, corr * wi)
        vel = vel + dvel.index_add_(-2, j, -corr * wj)
    return vel
