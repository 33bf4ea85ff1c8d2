"""Ewald electrostatics: the splitting parameter, the k-vector set and the
dense reciprocal sum.

Torch twin of the parts of ``scema_tpu/md/forcefields/coulomb.py`` that the
fused charged path reads (reference physics: ``pair_style lj/cut/coul/long
12.0 9.0`` + ``kspace_style pppm 0.0001``, in.set.lammps).  The real-space
sum runs inside kernel K3 (``ops/md_fused.py``); here live the k-space
energy, batched over a leading job axis with each job's own box, and the
self energy, and the plain cutoff Coulomb energy over a neighbor list
(:func:`coulomb_cut_energy`, the unfused engine's route).
``data_io.to_opls`` picks this dense sum below 2048 atoms and
PME (``pme.py``) above, as the JAX package does.

Real units: qqr2e = 332.06371 converts q_i q_j / r (e^2/A) to kcal/mol.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import box as B
from .. import neighbor as NB

QQR2E_REAL = 332.06371


def ewald_alpha(accuracy: float, cutoff: float) -> float:
    """LAMMPS-style splitting parameter estimate: erfc(a*rc)/rc ~ accuracy."""
    return float((1.35 - 0.15 * np.log(accuracy)) / cutoff)


def kvector_grid(kmax: tuple[int, int, int]) -> np.ndarray:
    """Integer reciprocal-lattice triples with the +half-space convention
    (k and -k counted once, k = 0 excluded)."""
    kx, ky, kz = kmax
    out = []
    for nx in range(0, kx + 1):
        for ny in range(-ky, ky + 1):
            for nz in range(-kz, kz + 1):
                if nx == 0 and (ny < 0 or (ny == 0 and nz <= 0)):
                    continue
                out.append((nx, ny, nz))
    return np.asarray(out, dtype=np.float64)


@dataclass(frozen=True)
class Ewald:
    """Ewald summation with a static k-vector set."""

    charges: torch.Tensor  # (N,)
    cutoff: float
    alpha: float
    kvecs: torch.Tensor  # (n_k, 3) integer triples
    qqr2e: float = QQR2E_REAL

    @staticmethod
    def create(charges, cutoff: float, h0, accuracy: float = 1.0e-4,
               dtype=torch.float64, device=None) -> "Ewald":
        alpha = ewald_alpha(accuracy, cutoff)
        h0 = np.asarray(h0, dtype=float)
        L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]])
        # kmax per dim: exp(-(pi*k/(alpha*L))^2) < accuracy
        km = np.ceil(alpha * L / np.pi * np.sqrt(-np.log(accuracy))).astype(int)
        kvecs = kvector_grid((int(km[0]), int(km[1]), int(km[2])))
        return Ewald(charges=torch.as_tensor(np.asarray(charges, dtype=np.float64),
                                             dtype=dtype, device=device),
                     cutoff=cutoff, alpha=alpha,
                     kvecs=torch.as_tensor(kvecs, dtype=dtype, device=device))

    def reciprocal_energy(self, pos: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """Structure-factor sum over the static k-set: pos (..., N, 3) and
        h (..., 3, 3) -> energy (...)."""
        k_cart = 2.0 * math.pi * (self.kvecs @ B.inv_h(h))  # (..., n_k, 3)
        k2 = torch.sum(k_cart * k_cart, -1)
        phase = pos @ k_cart.transpose(-1, -2)  # (..., N, n_k)
        q = self.charges.to(pos.dtype)[:, None]
        s_re = torch.sum(q * torch.cos(phase), -2)
        s_im = torch.sum(q * torch.sin(phase), -2)
        s2 = s_re * s_re + s_im * s_im
        pref = torch.exp(-k2 / (4.0 * self.alpha ** 2)) / torch.where(
            k2 > 0, k2, torch.ones_like(k2))
        # E = (2 pi / V) sum_{all k != 0} pref |S|^2; the half-space k-set
        # counts each +/-k pair once, hence the factor 2
        return self.qqr2e * (2.0 * math.pi / B.volume(h)) * 2.0 * torch.sum(pref * s2, -1)

    def self_energy(self) -> torch.Tensor:
        return -self.qqr2e * self.alpha / math.sqrt(math.pi) * torch.sum(self.charges ** 2)


def coulomb_cut_energy(charges, pos, h, nbr, cutoff: float, weights=None,
                       qqr2e: float = QQR2E_REAL) -> torch.Tensor:
    """Plain truncated Coulomb (coul/cut, coulomb.py:120) of positions pos
    (..., N, 3) in boxes h (..., 3, 3) over the full list ``nbr``, halved:
    energies (...)."""
    dr = NB.neighbor_disp(pos, h, nbr)
    r2 = torch.sum(dr * dr, -1)
    mask = nbr.mask & (r2 < cutoff ** 2)
    r = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
    qq = charges[:, None] * charges[nbr.idx]
    e = qqr2e * qq / r
    if weights is not None:
        e = e * weights
    return 0.5 * torch.sum(torch.where(mask, e, torch.zeros_like(e)), (-1, -2))
