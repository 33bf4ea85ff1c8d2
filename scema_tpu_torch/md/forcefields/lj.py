"""Lennard-Jones (cut) pair potential with per-type parameters.

Torch twin of ``scema_tpu/md/forcefields/lj.py`` (reference physics: the LJ
part of ``pair_style lj/cut/coul/long``, no energy shift at the cutoff).
:meth:`LJ.energy` is the unfused engine's route (autograd forces and
virial over a full neighbor list); kernel K1 runs the same function over
all pairs from the dense planes ``ops.md_fused.make_runner`` builds from
``epsilon``/``sigma``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import neighbor as NB


@dataclass(frozen=True)
class LJ:
    epsilon: torch.Tensor  # (ntypes, ntypes)
    sigma: torch.Tensor  # (ntypes, ntypes)
    cutoff: float
    types: torch.Tensor  # (N,) int64 atom types

    def energy(self, pos: torch.Tensor, h: torch.Tensor, nbr: NB.NeighborList) -> torch.Tensor:
        """Energies (...) of positions pos (..., N, 3) in boxes h (..., 3, 3)
        over the full list ``nbr`` (each pair in both rows, halved);
        r^2 is clamped at 0.25 (overlapping beads would overflow
        (sig/r)^12 in float32)."""
        dr = NB.neighbor_disp(pos, h, nbr)
        r2 = torch.sum(dr * dr, -1)
        mask = nbr.mask & (r2 < self.cutoff ** 2)
        r2 = torch.clamp(torch.where(mask, r2, torch.ones_like(r2)), min=0.25)
        ti = self.types[:, None]
        tj = self.types[nbr.idx]
        sig = self.sigma[ti, tj]
        s2 = sig * sig / r2
        s6 = s2 * s2 * s2
        e = 4.0 * self.epsilon[ti, tj] * (s6 * s6 - s6)
        return 0.5 * torch.sum(torch.where(mask, e, torch.zeros_like(e)), (-1, -2))


def single_type(epsilon: float, sigma: float, cutoff: float, n_atoms: int,
                dtype=torch.float64, device=None) -> LJ:
    return LJ(epsilon=torch.full((1, 1), epsilon, dtype=dtype, device=device),
              sigma=torch.full((1, 1), sigma, dtype=dtype, device=device), cutoff=cutoff,
              types=torch.zeros((n_atoms,), dtype=torch.int64, device=device))
