"""OPLS-style force-field parameters and topology for the fused MD path.

Torch twin of the parameter side of ``scema_tpu/md/forcefields/opls.py``:
LJ tables (geometric mixing), the bonded topology and coefficients, and the
special-bonds exclusion lists (reference: lammps_scripts_opls/in.set.lammps,
``special_bonds`` at the LAMMPS default lj/coul 0 0 0: 1-2, 1-3 and 1-4
pairs fully excluded) and, for charged systems with ``kspace``, the Ewald
or PME object.  No pair energy function lives here: the ported path takes
forces and virials from kernels K1 and K3 (``ops/md_fused.py``) and the
smooth k-space remainder from ``material.build_kspace_split``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


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
