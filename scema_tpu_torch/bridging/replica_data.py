"""Per-replica nanostructure metadata + equilibration-data loading.

Torch-side twin of ``scema_tpu/bridging/replica_data.py``
(reference: STMDSync::load_replica_generation_data, stmd_sync.h:280-359,
and load_replica_equilibration_data, :361-489).  Each piece is optional per
replica: a missing ``<mat>_<n>.json`` falls back to the identity
orientation, and missing ``init.<mat>_<n>.*`` files fall back to measuring
the prepared box on the device.  Seeding microstates from LAMMPS binary
restarts (``init.<mat>_<n>.bin``) is not ported yet: where such a file
exists the JAX package starts the replica from it (and sizes an SW lattice
to match), so the port raises rather than equilibrate another microstate.
"""
from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..utils import io_tensors as io
from ..utils import tensors as T


@dataclass
class ReplicaMeta:
    """One replica's nanostructure + equilibration data (ReplicaData,
    stmd_sync.h:41-51)."""

    rotam: np.ndarray  # (3, 3) replica frame -> common ground
    rho: Optional[float] = None  # kg/m^3 from relative_density * 1000
    length: Optional[np.ndarray] = None  # (3,)
    stress: Optional[np.ndarray] = None  # (6,) Voigt, Pa
    stiff: Optional[np.ndarray] = None  # (6, 6) Pa


def _rotation_from_json(pt: dict, cg_vector) -> np.ndarray:
    """stmd_sync.h:338-359: single-flake replicas rotate normal -> cg."""
    nv = pt.get("normal_vector") or {}
    if int(pt.get("Nsheets", 0)) == 1 and "1" in nv:
        v = nv["1"]
        nvec = np.array([float(v["x"]), float(v["y"]), float(v["z"])])
        cg = np.asarray(cg_vector, dtype=float)
        R = T.compute_rotation_tensor(torch.as_tensor(nvec / np.linalg.norm(nvec)),
                                      torch.as_tensor(cg / np.linalg.norm(cg)))
        return R.numpy()
    return np.eye(3)


def load_replica_metadata(nano_dir: str, materials, n_repl: int,
                          cg_vector=(1.0, 0.0, 0.0)) -> list[list[ReplicaMeta]]:
    """[(material)][(replica)] metadata; silent identity fallbacks.  Raises
    NotImplementedError where an ``init.<mat>_<n>.bin`` LAMMPS restart
    exists (replica_data.py:93-102 reads it; ``md/lammps_restart.py`` is
    not ported, ROADMAP queue 1)."""
    out = []
    for mat in materials:
        rows = []
        for r in range(n_repl):
            meta = ReplicaMeta(rotam=np.eye(3))
            jpath = os.path.join(nano_dir, f"{mat}_{r + 1}.json")
            if os.path.exists(jpath):
                with open(jpath) as f:
                    pt = json.load(f)
                meta.rotam = _rotation_from_json(pt, cg_vector)
                if "relative_density" in pt:
                    meta.rho = float(pt["relative_density"]) * 1000.0
            base = os.path.join(nano_dir, f"init.{mat}_{r + 1}")
            if os.path.exists(base + ".length"):
                meta.length = io.read_vector(base + ".length")
            if os.path.exists(base + ".stress"):
                sym = io.read_sym2(base + ".stress")
                meta.stress = np.array([sym[0, 0], sym[1, 1], sym[2, 2],
                                        sym[0, 1], sym[0, 2], sym[1, 2]])
            if os.path.exists(base + ".stiff"):
                c4 = io.read_sym4(base + ".stiff")
                meta.stiff = T.rank4_to_c66(torch.as_tensor(c4)).numpy()
            if os.path.exists(base + ".bin"):
                raise NotImplementedError(
                    f"{base}.bin: seeding a replica from a LAMMPS binary restart "
                    "(md/lammps_restart.py) is not ported (ROADMAP queue 1); remove the "
                    "file to equilibrate the replica on the device instead")
            rows.append(meta)
        out.append(rows)
    return out
