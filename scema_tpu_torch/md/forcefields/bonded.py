"""Bonded energies: harmonic bonds and angles, OPLS dihedrals, harmonic
impropers over a fixed topology.

Torch twin of ``scema_tpu/md/forcefields/bonded.py:56-126`` (reference
physics, lammps_scripts_opls/in.set.lammps):

  bond_style harmonic      E = K (r - r0)^2
  angle_style harmonic     E = K (theta - theta0)^2
  dihedral_style opls      E = 0.5 K1 (1+cos phi) + 0.5 K2 (1-cos 2phi)
                             + 0.5 K3 (1+cos 3phi) + 0.5 K4 (1-cos 4phi)
  improper_style harmonic  E = K (chi - chi0)^2

Energies only, over the numpy topology rows of ``opls.OPLS`` (types < 0
mark padding), with the JAX package's clips and ``1e-30`` guards; the
unfused engine takes forces and virials by autograd.  Positions carry any
leading batch shape (..., N, 3), boxes (..., 3, 3); each term returns (...).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import box as B


def _rows(idx: np.ndarray, types: np.ndarray, dev):
    return (torch.as_tensor(np.asarray(idx, dtype=np.int64), device=dev),
            torch.as_tensor(np.asarray(types, dtype=np.int64), device=dev))


def _masked_sum(e: torch.Tensor, types: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.where(types >= 0, e, torch.zeros_like(e)), -1)


def _zero(pos):
    return torch.zeros(pos.shape[:-2], dtype=pos.dtype, device=pos.device)


def bond_energy(pos, h, bonds, bond_type, k, r0) -> torch.Tensor:
    if len(bonds) == 0:
        return _zero(pos)
    b, ty = _rows(bonds, bond_type, pos.device)
    dr = B.min_image_disp(h, pos[..., b[:, 1], :] - pos[..., b[:, 0], :])
    r = torch.sqrt(torch.sum(dr * dr, -1) + 1e-30)
    t = torch.clamp(ty, 0, k.shape[0] - 1)
    return _masked_sum(k[t] * (r - r0[t]) ** 2, ty)


def angle_energy(pos, h, angles, angle_type, k, theta0) -> torch.Tensor:
    if len(angles) == 0:
        return _zero(pos)
    a, ty = _rows(angles, angle_type, pos.device)
    r1 = B.min_image_disp(h, pos[..., a[:, 0], :] - pos[..., a[:, 1], :])
    r2 = B.min_image_disp(h, pos[..., a[:, 2], :] - pos[..., a[:, 1], :])
    c = torch.sum(r1 * r2, -1) / torch.sqrt(
        torch.sum(r1 * r1, -1) * torch.sum(r2 * r2, -1) + 1e-30)
    theta = torch.arccos(torch.clamp(c, -1.0 + 1e-12, 1.0 - 1e-12))
    t = torch.clamp(ty, 0, k.shape[0] - 1)
    return _masked_sum(k[t] * (theta - theta0[t]) ** 2, ty)


def dihedral_angle(pos, h, quads: torch.Tensor) -> torch.Tensor:
    """Signed dihedral angle phi of (n, 4) atom quadruples: (..., n)."""
    p = [pos[..., quads[:, m], :] for m in range(4)]
    b1 = B.min_image_disp(h, p[1] - p[0])
    b2 = B.min_image_disp(h, p[2] - p[1])
    b3 = B.min_image_disp(h, p[3] - p[2])
    n1 = torch.linalg.cross(b1, b2, dim=-1)
    n2 = torch.linalg.cross(b2, b3, dim=-1)
    m1 = torch.linalg.cross(n1, b2 / torch.linalg.vector_norm(b2, dim=-1, keepdim=True),
                            dim=-1)
    return torch.atan2(torch.sum(m1 * n2, -1), torch.sum(n1 * n2, -1))


def dihedral_energy(pos, h, dihedrals, dihedral_type, K) -> torch.Tensor:
    if len(dihedrals) == 0:
        return _zero(pos)
    d, ty = _rows(dihedrals, dihedral_type, pos.device)
    phi = dihedral_angle(pos, h, d)
    Kt = K[torch.clamp(ty, 0, K.shape[0] - 1)]
    e = 0.5 * (Kt[:, 0] * (1.0 + torch.cos(phi)) + Kt[:, 1] * (1.0 - torch.cos(2.0 * phi))
               + Kt[:, 2] * (1.0 + torch.cos(3.0 * phi)) + Kt[:, 3] * (1.0 - torch.cos(4.0 * phi)))
    return _masked_sum(e, ty)


def improper_energy(pos, h, impropers, improper_type, k, chi0) -> torch.Tensor:
    if len(impropers) == 0:
        return _zero(pos)
    d, ty = _rows(impropers, improper_type, pos.device)
    chi = dihedral_angle(pos, h, d)
    t = torch.clamp(ty, 0, k.shape[0] - 1)
    return _masked_sum(k[t] * (chi - chi0[t]) ** 2, ty)


def bonded_energy(pos, h, ff) -> torch.Tensor:
    """The four terms of the topology and coefficients held by ``ff``
    (``opls.OPLS``)."""
    return (bond_energy(pos, h, ff.bonds, ff.bond_type, ff.bond_k, ff.bond_r0)
            + angle_energy(pos, h, ff.angles, ff.angle_type, ff.angle_k, ff.angle_theta0)
            + dihedral_energy(pos, h, ff.dihedrals, ff.dihedral_type, ff.dihedral_k)
            + improper_energy(pos, h, ff.impropers, ff.improper_type, ff.improper_k,
                              ff.improper_chi0))
