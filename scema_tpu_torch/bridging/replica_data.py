"""Per-replica nanostructure metadata + equilibration-data loading.

Torch-side twin of ``scema_tpu/bridging/replica_data.py``
(reference: STMDSync::load_replica_generation_data, stmd_sync.h:280-359,
and load_replica_equilibration_data, :361-489).  Each piece is optional per
replica: a missing ``<mat>_<n>.json`` falls back to the identity
orientation, and missing ``init.<mat>_<n>.*`` files fall back to measuring
the prepared box on the device.  A LAMMPS binary restart
(``init.<mat>_<n>.bin``) is read by ``md/lammps_restart.py`` into
``ReplicaMeta.micro``; ``hmm.md_coupling.build_md_hmm`` then starts that
replica from it, as the reference's ``read_restart`` does
(stmd_problem.h:185-207), instead of preparing it on the device.  A file
that does not parse is skipped with a warning.
"""
from __future__ import annotations

import json
import os
import warnings
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
    micro: object = None  # lammps_restart.LammpsRestart (init.*.bin)


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
    """[(material)][(replica)] metadata; silent identity fallbacks, and a
    warning for an ``init.<mat>_<n>.bin`` that does not parse
    (replica_data.py:93-101)."""
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
                from ..md import lammps_restart as LRS

                try:
                    meta.micro = LRS.read_restart(base + ".bin")
                except ValueError as e:
                    warnings.warn(f"skipping unreadable LAMMPS restart {base}.bin: {e}")
            rows.append(meta)
        out.append(rows)
    return out
