"""Reference-format macroscale restart IO (lcts.* files).

Torch twin of ``scema_tpu/fem/reference_restart.py``: the file formats are
numpy, as there; the state bridge restores into the port's ``FEState``.

The reference checkpoints the macroscale as (FE_problem.h:2278-2335):

* ``lcts.solution.bin`` / ``lcts.velocity.bin`` — rank-0 deal.II
  ``Vector<double>::block_write``: the vector size in ASCII decimal,
  then ``"\\n["``, then the raw little-endian float64 payload, then
  ``"]"``.
* ``lcts.pr_<p>.lhistory.bin`` — per-processor CSV lines
  ``time,cell,qpoint,material,upd_strain(6),new_stress(6)`` with the
  upper-triangular tensor components in (00,01,02,11,12,22) order at 16
  significant digits.

and restores them by block_read + recomputing total strains from the
displacement gradients (FE_problem.h:540-712).  This module reads and
writes those exact formats so a run can resume from reference-produced
state (and vice versa).

DoF numbering: deal.II enumerates Q1 vector dofs first-seen while
traversing cells in creation order, with ``dim`` consecutive components
per vertex (FESystem node ordering).  ``dealii_dof_node_order`` replays
that traversal over our cell connectivity — for ``subdivided_hyper_
rectangle`` grids both the cell order (x fastest) and the in-cell vertex
order (GeometryInfo<3>: x, then y, then z) match this package's
``build_cuboid``, so the permutation is exact for cuboid problems and
best-effort for imported meshes.
"""
from __future__ import annotations

import glob
import os
import re

import numpy as np
import torch


# ---------------------------------------------------------------- block IO

def read_dealii_vector(path: str) -> np.ndarray:
    """Parse a deal.II Vector<double>::block_write file."""
    with open(path, "rb") as f:
        raw = f.read()
    m = re.match(rb"\s*(\d+)\n\[", raw)
    if m is None:
        raise ValueError(f"{path}: not a deal.II block_write vector")
    n = int(m.group(1))
    start = m.end()
    payload = raw[start : start + 8 * n]
    if len(payload) != 8 * n or raw[start + 8 * n : start + 8 * n + 1] != b"]":
        raise ValueError(f"{path}: truncated block_write payload (n={n})")
    return np.frombuffer(payload, dtype="<f8").copy()


def write_dealii_vector(path: str, v: np.ndarray) -> None:
    """Emit a deal.II Vector<double>::block_read-compatible file."""
    v = np.ascontiguousarray(np.asarray(v, dtype="<f8").ravel())
    with open(path, "wb") as f:
        f.write(f"{v.size}\n[".encode())
        f.write(v.tobytes())
        f.write(b"]")


# ------------------------------------------------------------ DoF ordering

def dealii_dof_node_order(cells: np.ndarray, n_nodes: int) -> np.ndarray:
    """First-seen vertex enumeration over the cell traversal.

    Returns ``order`` with ``order[dealii_vertex_dof] = our_node_id``;
    the displacement vector entry for (our node n, component c) lives at
    deal.II index ``inv[n]*3 + c`` where ``inv`` is the inverse
    permutation.
    """
    order = np.empty(n_nodes, dtype=np.int64)
    seen = np.zeros(n_nodes, dtype=bool)
    k = 0
    for cell in np.asarray(cells):
        for v in cell:
            if not seen[v]:
                seen[v] = True
                order[k] = v
                k += 1
    if k != n_nodes:
        raise ValueError("mesh has nodes unreachable from cells")
    return order


def _scatter_dofs(vec_dealii: np.ndarray, order: np.ndarray) -> np.ndarray:
    """(3*n_nodes,) deal.II-ordered vector -> our node-major dof vector."""
    n = order.size
    out = np.empty(3 * n)
    out.reshape(n, 3)[order] = vec_dealii.reshape(n, 3)
    return out


def _gather_dofs(vec_ours: np.ndarray, order: np.ndarray) -> np.ndarray:
    n = order.size
    return vec_ours.reshape(n, 3)[order].reshape(-1)


# -------------------------------------------------------------- lhistory IO

_TRIU = [(0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2)]
# our Voigt order [xx yy zz xy xz yz] as positions in the triu list
_TRIU_TO_VOIGT = [0, 3, 5, 1, 2, 4]


def _triu6_to_voigt(row6: np.ndarray) -> np.ndarray:
    return row6[..., _TRIU_TO_VOIGT]


def _voigt_to_triu6(v: np.ndarray) -> np.ndarray:
    out = np.empty_like(v)
    out[..., _TRIU_TO_VOIGT] = v
    return out


def read_lhistory(restart_dir: str, n_cells: int, n_qp_per_cell: int):
    """Merge every ``lcts.pr_*.lhistory.bin`` in a restart directory.

    Returns (time, upd_strain (n_qp,6), new_stress (n_qp,6)) in our Voigt
    order, qp id = cell * n_qp_per_cell + q (FE_problem.h:485 convention).
    Missing qps stay zero (the reference leaves them default too).
    """
    n_qp = n_cells * n_qp_per_cell
    upd = np.zeros((n_qp, 6))
    sig = np.zeros((n_qp, 6))
    t = 0.0
    paths = sorted(glob.glob(os.path.join(restart_dir, "lcts.pr_*.lhistory.bin")))
    for p in paths:
        with open(p, "r") as f:
            for line in f:
                parts = line.strip().split(",")
                if len(parts) < 16:
                    continue
                t = float(parts[0])
                cell = int(parts[1])
                q = int(parts[2])
                if cell >= n_cells or q >= n_qp_per_cell:
                    continue
                qp = cell * n_qp_per_cell + q
                u6 = np.array([float(x) for x in parts[4:10]])
                s6 = np.array([float(x) for x in parts[10:16]])
                upd[qp] = _triu6_to_voigt(u6)
                sig[qp] = _triu6_to_voigt(s6)
    return t, upd, sig


def write_lhistory(path: str, time: float, material: np.ndarray,
                   upd_strain: np.ndarray, new_stress: np.ndarray,
                   n_qp_per_cell: int) -> None:
    """Single-proc lcts.pr_0.lhistory.bin in the reference layout."""
    upd_t = _voigt_to_triu6(np.asarray(upd_strain))
    sig_t = _voigt_to_triu6(np.asarray(new_stress))
    n_qp = upd_t.shape[0]
    with open(path, "w") as f:
        for qp in range(n_qp):
            cell, q = divmod(qp, n_qp_per_cell)
            vals = [f"{x:.16g}" for x in np.concatenate([upd_t[qp], sig_t[qp]])]
            f.write(f"{time},{cell},{q},{int(material[qp])}," + ",".join(vals)
                    + "\n")


# ----------------------------------------------------------- state bridge

def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


def save_reference_checkpoint(outdir: str, state, mesh) -> None:
    """Write lcts.solution.bin / lcts.velocity.bin / lcts.pr_0.lhistory.bin
    exactly as FEProblem::checkpoint does (FE_problem.h:2278-2335)."""
    os.makedirs(outdir, exist_ok=True)
    order = dealii_dof_node_order(mesh.cells, mesh.n_nodes)
    write_dealii_vector(os.path.join(outdir, "lcts.solution.bin"),
                        _gather_dofs(_np(state.u), order))
    write_dealii_vector(os.path.join(outdir, "lcts.velocity.bin"),
                        _gather_dofs(_np(state.v), order))
    qp = state.qp
    n_qp_per_cell = qp.new_stress.shape[0] // mesh.n_cells
    write_lhistory(os.path.join(outdir, "lcts.pr_0.lhistory.bin"),
                   float(state.time), _np(qp.material),
                   _np(qp.upd_strain), _np(qp.new_stress),
                   n_qp_per_cell)


def load_reference_restart(restart_dir: str, state, geom, mesh):
    """Restore a reference-produced macroscale restart into an FEState.

    Mirrors FEProblem::restart (FE_problem.h:540-712): block_read the
    displacement and velocity vectors, recompute total strains from the
    displacement gradients, and splice upd_strain + new_stress from the
    per-proc lhistory files.  History splines / timestep counters are NOT
    in the reference files (the reference restarts those from the config),
    so they keep their current values; ``time`` comes back as a Python
    float, as the port's FEState holds it.
    """
    from . import assembly

    # The serial first-seen DoF replay below is exact only for restarts
    # produced by a single-rank reference run: parallel::shared::
    # Triangulation renumbers DoFs subdomain-wise under >1 MPI rank, so a
    # multi-rank lcts.solution.bin would load size-correct but scrambled.
    procs = glob.glob(os.path.join(restart_dir, "lcts.pr_*.lhistory.bin"))
    if len(procs) > 1:
        raise ValueError(
            f"{restart_dir}: {len(procs)} per-proc lhistory files — this "
            "restart was written by a multi-rank reference run, whose "
            "subdomain-wise DoF numbering is not reproduced here; "
            "--restart-reference supports single-rank reference restarts "
            "only (re-run the reference with mpirun -np 1, or restart from "
            "this package's own npz checkpoints)"
        )

    order = dealii_dof_node_order(mesh.cells, mesh.n_nodes)
    like = state.u

    def tensor(a):
        return torch.as_tensor(a).to(dtype=like.dtype, device=like.device)

    sol = os.path.join(restart_dir, "lcts.solution.bin")
    if os.path.exists(sol):
        u = _scatter_dofs(read_dealii_vector(sol), order)
        if u.size != state.u.numel():
            raise ValueError(
                f"{sol}: {u.size} dofs, expected {state.u.numel()} — mesh mismatch"
            )
        u = tensor(u)
        state = state.replace(u=u, qp=state.qp.replace(
            new_strain=assembly.qp_strains(geom, u)))

    vel = os.path.join(restart_dir, "lcts.velocity.bin")
    if os.path.exists(vel):
        state = state.replace(v=tensor(_scatter_dofs(read_dealii_vector(vel), order)))

    n_qp_per_cell = state.qp.new_stress.shape[0] // mesh.n_cells
    if procs:
        t, upd, sig = read_lhistory(restart_dir, mesh.n_cells, n_qp_per_cell)
        state = state.replace(
            time=float(t),
            qp=state.qp.replace(upd_strain=tensor(upd), new_stress=tensor(sig),
                                old_stress=tensor(sig)),
        )
    return state
