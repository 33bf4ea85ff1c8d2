"""SHAKE/RATTLE bond-length constraints: the constraint set.

Torch twin of the container of ``scema_tpu/md/constraints.py`` (reference
physics: ``fix shake 0.001 20 1000 m 1.0``, in.strain.lammps — bonds to
hydrogens held rigid).  The port applies the constraints inside kernel K3
(Jacobi sweeps over static partner offsets, ``ops/md_fused.py``), so only
the set itself lives here.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Constraints(NamedTuple):
    idx: np.ndarray  # (nc, 2) int atom pairs
    d0: np.ndarray  # (nc,) target lengths
    mask: np.ndarray  # (nc,) bool (padding rows False)


def from_bonds(bonds, lengths) -> Constraints:
    bonds = np.asarray(bonds, dtype=np.int64)
    lengths = np.asarray(lengths, dtype=np.float64)
    return Constraints(idx=bonds, d0=lengths, mask=np.ones((bonds.shape[0],), dtype=bool))
