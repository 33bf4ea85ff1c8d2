"""OPLS-style force-field parameters and topology for the fused MD path.

Torch twin of the parameter side of ``scema_tpu/md/forcefields/opls.py``:
LJ tables (geometric mixing), the bonded topology and coefficients, and the
special-bonds exclusion lists (reference: lammps_scripts_opls/in.set.lammps,
``special_bonds`` at the LAMMPS default lj/coul 0 0 0: 1-2, 1-3 and 1-4
pairs fully excluded) and, for charged systems with ``kspace``, the Ewald
or PME object.  The fused path takes forces and virials from kernels K1,
K3 and K4 (``ops/md_fused.py``) and the smooth k-space remainder from
``material.build_kspace_split``; :meth:`OPLS.energy` (opls.py:77-147) is
the unfused engine's route (``MaterialSpec.use_fused=False``), autograd
over a neighbor list, with plain cutoff Coulomb only.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from .. import neighbor as NB
from . import bonded as BD
from .coulomb import coulomb_cut_energy


def build_exclusions(n_atoms: int, bonds: np.ndarray,
                     max_per_atom: int = 16) -> np.ndarray:
    """Per-atom (1-2, 1-3, 1-4) partner lists from the bond graph:
    (N, 3, max_per_atom) int32, padded with -1 (opls.py:27-53)."""
    adj: list[set[int]] = [set() for _ in range(n_atoms)]
    for a, b in np.asarray(bonds):
        adj[int(a)].add(int(b))
        adj[int(b)].add(int(a))
    excl = np.full((n_atoms, 3, max_per_atom), -1, dtype=np.int32)
    for i in range(n_atoms):
        one2 = adj[i]
        one3 = set()
        for j in one2:
            one3 |= adj[j]
        one3 -= one2 | {i}
        one4 = set()
        for j in one3:
            one4 |= adj[j]
        one4 -= one3 | one2 | {i}
        for order, s in enumerate((one2, one3, one4)):
            lst = sorted(s)[:max_per_atom]
            excl[i, order, :len(lst)] = lst
    return excl


def mix_geometric(eps_diag: torch.Tensor, sig_diag: torch.Tensor):
    """OPLS geometric mixing for both epsilon and sigma."""
    return (torch.sqrt(eps_diag[:, None] * eps_diag[None, :]),
            torch.sqrt(sig_diag[:, None] * sig_diag[None, :]))


@dataclass(frozen=True)
class OPLS:
    """OPLS parameter tables over a fixed topology (host-side topology as
    numpy, parameters as tensors)."""

    types: torch.Tensor  # (N,) int64
    charges: torch.Tensor  # (N,)
    lj_epsilon: torch.Tensor  # (ntypes, ntypes) pre-mixed
    lj_sigma: torch.Tensor
    lj_cutoff: float
    coul_cutoff: float
    bonds: np.ndarray  # (nb, 2)
    bond_type: np.ndarray
    angles: np.ndarray  # (na, 3)
    angle_type: np.ndarray
    dihedrals: np.ndarray  # (nd, 4)
    dihedral_type: np.ndarray
    impropers: np.ndarray  # (ni, 4)
    bond_k: torch.Tensor
    bond_r0: torch.Tensor
    angle_k: torch.Tensor
    angle_theta0: torch.Tensor  # radians
    dihedral_k: torch.Tensor  # (ndt, 4) K1..K4
    excl: np.ndarray  # (N, 3, max_excl) int32, -1 padded
    special_lj: tuple = (0.0, 0.0, 0.0)  # 1-2, 1-3, 1-4 weights
    special_coul: tuple = (0.0, 0.0, 0.0)
    ewald: object = None  # coulomb.Ewald or pme.PME; None = coul/cut
    improper_type: np.ndarray = field(default_factory=lambda: np.zeros((0,), np.int64))
    improper_k: torch.Tensor = field(default_factory=lambda: torch.zeros(1, dtype=torch.float64))
    improper_chi0: torch.Tensor = field(  # radians
        default_factory=lambda: torch.zeros(1, dtype=torch.float64))

    @property
    def n_atoms(self) -> int:
        return int(self.types.shape[0])

    @property
    def cutoff(self) -> float:
        return max(self.lj_cutoff, self.coul_cutoff)

    def pair_weights(self, special=None) -> np.ndarray:
        """Dense (N, N) special-bonds weights, zero on the diagonal."""
        special = self.special_lj if special is None else special
        n = self.n_atoms
        W = np.ones((n, n))
        rows = np.arange(n)[:, None]
        for order in range(3):
            partners = self.excl[:, order, :]
            hit = partners >= 0
            W[np.broadcast_to(rows, partners.shape)[hit], partners[hit]] = special[order]
        np.fill_diagonal(W, 0.0)
        return W

    def _pair_weights(self, nbr: NB.NeighborList, special) -> torch.Tensor:
        """(..., N, K) special-bonds weights of the list entries
        (opls.py:82-91)."""
        partners = torch.as_tensor(self.excl, dtype=torch.int64, device=nbr.idx.device)
        w = torch.ones(nbr.idx.shape, dtype=self.charges.dtype, device=nbr.idx.device)
        for order in range(3):
            hit = torch.any(nbr.idx[..., None] == partners[:, order, None, :], -1)
            w = torch.where(hit & (partners.shape[2] > 0), special[order], w)
        return w

    def energy(self, pos: torch.Tensor, h: torch.Tensor, nbr: NB.NeighborList) -> torch.Tensor:
        """Energies (...) of positions pos (..., N, 3) in boxes h (..., 3, 3)
        over the full list ``nbr``: LJ with the special-bond weights (r^2
        clamped at 0.25), cutoff Coulomb and the bonded terms.  The Ewald
        branch raises NotImplementedError (ROADMAP item 5)."""
        if self.ewald is not None:
            raise NotImplementedError(
                "OPLS.energy: the Ewald/PME Coulomb branch is not ported (ROADMAP item 5); "
                "charged Ewald systems run the fused kernels K3/K4")
        dr = NB.neighbor_disp(pos, h, nbr)
        r2 = torch.sum(dr * dr, -1)
        lj_mask = nbr.mask & (r2 < self.lj_cutoff ** 2)
        r2s = torch.clamp(torch.where(lj_mask, r2, torch.ones_like(r2)), min=0.25)
        ti = self.types[:, None]
        tj = self.types[nbr.idx]
        sig = self.lj_sigma[ti, tj]
        s2 = sig * sig / r2s
        s6 = s2 * s2 * s2
        wlj = self._pair_weights(nbr, self.special_lj)
        e = wlj * 4.0 * self.lj_epsilon[ti, tj] * (s6 * s6 - s6)
        e_lj = 0.5 * torch.sum(torch.where(lj_mask, e, torch.zeros_like(e)), (-1, -2))
        wq = self._pair_weights(nbr, self.special_coul)
        e_q = coulomb_cut_energy(self.charges, pos, h, nbr, self.coul_cutoff, weights=wq)
        return e_lj + e_q + BD.bonded_energy(pos, h, self)
