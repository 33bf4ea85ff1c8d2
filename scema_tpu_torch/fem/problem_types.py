"""Problem geometries and boundary conditions: dogbone / dropweight / compact.

Torch twin of ``scema_tpu/fem/problem_types.py`` (reference:
FE_problem_type.h:28-111, dogbone.h, drop_weight.h, compact_tension.h).
DOF numbering is ``node * 3 + component``.  Each problem holds its fixed
and loaded masks and two functions of the timestep, evaluated afresh at
every call: ``bc_inc_velocity(t)``, the incremental velocity imposed at the
start of step t, and ``constrained_mask(t)``, the dofs the solve pins.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from ..config import HMMConfig
from .mesh import HexMesh, build_cuboid, read_msh, reposition_for_dogbone


def _min_edge(mesh: HexMesh) -> float:
    """Minimum vertex distance within cells (cell->minimum_vertex_distance)."""
    xyz = mesh.nodes[mesh.cells]
    d = np.linalg.norm(xyz[:, :, None, :] - xyz[:, None, :, :], axis=-1)
    d = np.where(d == 0.0, np.inf, d)
    return float(d.min())


@dataclass(frozen=True)
class Problem:
    mesh: HexMesh
    fixed_mask: torch.Tensor  # (n_dofs,) bool
    loaded_mask: torch.Tensor  # (n_dofs,) bool
    bc_inc_velocity: Callable  # (timestep) -> (n_dofs,) tensor
    constrained_mask: Callable  # (timestep) -> (n_dofs,) bool

    @property
    def n_dofs(self) -> int:
        return self.mesh.n_nodes * 3


def _masks(n_dofs: int, fixed_dofs, loaded_dofs, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(fixed, loaded) (n_dofs,) bool masks of two dof lists."""
    fixed = np.zeros(n_dofs, dtype=bool)
    loaded = np.zeros(n_dofs, dtype=bool)
    fixed[np.asarray(fixed_dofs, dtype=int)] = True
    loaded[np.asarray(loaded_dofs, dtype=int)] = True
    return torch.as_tensor(fixed, device=device), torch.as_tensor(loaded, device=device)


def _on_loaded(loaded_mask: torch.Tensor, value: float, dtype) -> torch.Tensor:
    """``value`` on the loaded dofs, 0 elsewhere."""
    return torch.where(loaded_mask, torch.tensor(value, dtype=dtype, device=loaded_mask.device),
                       torch.zeros((), dtype=dtype, device=loaded_mask.device))


def make_dogbone(cfg: HMMConfig, dtype=torch.float64, device=None) -> Problem:
    """Uniaxial-stretch dogbone (dogbone.h): base (z=0) fully fixed; top
    fixed in x,y and pulled in z with ``strain_rate * Lz / dt`` imposed as
    the incremental velocity at timestep 1 only (dogbone.h:128-162)."""
    m = cfg.mesh
    if m.style == "cuboid":
        mesh = build_cuboid(m.x_length, m.y_length, m.z_length,
                            m.x_cells, m.y_cells, m.z_cells)
    elif "2" in m.style:
        from .mesh import extrude_quads_to_hexes, read_msh_quads

        nodes2d, quads = read_msh_quads(m.mesh_file)
        mesh = reposition_for_dogbone(
            extrude_quads_to_hexes(nodes2d, quads, m.extrude_length, m.extrude_points))
    else:
        mesh = reposition_for_dogbone(read_msh(m.mesh_file))
    zmax = mesh.limits(2)[1]
    delta = _min_edge(mesh) / 10.0
    z = mesh.nodes[:, 2]
    base_nodes = np.where(np.abs(z) < delta)[0]
    top_nodes = np.where(np.abs(z - zmax) < delta)[0]

    n_dofs = mesh.n_nodes * 3
    fixed_mask, loaded_mask = _masks(
        n_dofs, [3 * n + c for n in base_nodes for c in range(3)]
        + [3 * n + c for n in top_nodes for c in (0, 1)], [3 * n + 2 for n in top_nodes], device)
    both = fixed_mask | loaded_mask
    pulled = _on_loaded(loaded_mask, cfg.problem.strain_rate * zmax / cfg.time.timestep_length,
                        dtype)
    still = torch.zeros(n_dofs, dtype=dtype, device=device)

    def bc_inc_velocity(timestep: int) -> torch.Tensor:
        return pulled if timestep == 1 else still

    def constrained_mask(timestep: int) -> torch.Tensor:
        return both

    return Problem(mesh, fixed_mask, loaded_mask, bc_inc_velocity, constrained_mask)


def make_dropweight(cfg: HMMConfig, dtype=torch.float64, device=None) -> Problem:
    """Drop-weight impact (drop_weight.h; problem_types.py:104-143): a
    cuboid centred on (0, 0) with its top face at z = 0; the nodes within
    the weight's diameter are driven down by ``-acceleration * dt`` for the
    first ``steps to accelerate`` steps, and pinned only in those steps;
    the four side faces are fully fixed."""
    m = cfg.mesh
    mesh = build_cuboid(m.x_length, m.y_length, m.z_length, m.x_cells, m.y_cells,
                        m.z_cells).shifted((-m.x_length / 2.0, -m.y_length / 2.0, -m.z_length))
    delta = _min_edge(mesh) / 10.0
    x, y = mesh.nodes[:, 0], mesh.nodes[:, 1]
    loaded_nodes = np.where(np.sqrt(x * x + y * y) < cfg.problem.diameter / 2.0)[0]
    edge_nodes = np.where((np.abs(x - m.x_length / 2) < delta) | (np.abs(x + m.x_length / 2) < delta)
                          | (np.abs(y - m.y_length / 2) < delta)
                          | (np.abs(y + m.y_length / 2) < delta))[0]
    n_dofs = mesh.n_nodes * 3
    fixed_mask, loaded_mask = _masks(n_dofs, [3 * n + c for n in edge_nodes for c in range(3)],
                                     [3 * n + 2 for n in loaded_nodes], device)
    n_acc = cfg.problem.steps_to_accelerate
    driven = _on_loaded(loaded_mask, -cfg.problem.acceleration * cfg.time.timestep_length, dtype)
    still = torch.zeros(n_dofs, dtype=dtype, device=device)
    both = fixed_mask | loaded_mask

    def bc_inc_velocity(timestep: int) -> torch.Tensor:
        return driven if timestep <= n_acc else still

    def constrained_mask(timestep: int) -> torch.Tensor:
        return both if timestep <= n_acc else fixed_mask

    return Problem(mesh, fixed_mask, loaded_mask, bc_inc_velocity, constrained_mask)


def make_compact_tension(cfg: HMMConfig, dtype=torch.float64, device=None) -> Problem:
    """Compact-tension specimen (compact_tension.h; problem_types.py:
    145-179) on a GMSH hex mesh: the y = 0 plane fixed in y, the z = 0
    plane fixed in z, the upper half of the pin-hole ring (radius dd / 2
    about (W, s / 2), W = 2 calculi_B) pulled in y at ``velocity`` / dt,
    imposed at timestep 1."""
    m = cfg.mesh
    mesh = read_msh(m.mesh_file)
    delta = _min_edge(mesh) / 10.0
    x, y, z = mesh.nodes[:, 0], mesh.nodes[:, 1], mesh.nodes[:, 2]
    ww = 2.0 * m.calculi_B
    ss, dd = 0.55 * ww, 0.25 * ww
    cx, cy = ww, ss / 2.0
    dist = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    loaded_nodes = np.where((np.abs(dist - dd / 2.0) < delta) & (y > cy))[0]
    n_dofs = mesh.n_nodes * 3
    fixed_mask, loaded_mask = _masks(
        n_dofs, [3 * n + 1 for n in np.where(np.abs(y) < delta)[0]]
        + [3 * n + 2 for n in np.where(np.abs(z) < delta)[0]],
        [3 * n + 1 for n in loaded_nodes], device)
    both = fixed_mask | loaded_mask
    pulled = _on_loaded(loaded_mask, cfg.problem.velocity / cfg.time.timestep_length, dtype)
    still = torch.zeros(n_dofs, dtype=dtype, device=device)

    def bc_inc_velocity(timestep: int) -> torch.Tensor:
        return pulled if timestep == 1 else still

    def constrained_mask(timestep: int) -> torch.Tensor:
        return both

    return Problem(mesh, fixed_mask, loaded_mask, bc_inc_velocity, constrained_mask)


def make_problem(cfg: HMMConfig, dtype=torch.float64, device=None) -> Problem:
    """Dispatch on 'problem type.class' (FE_problem.h:120-166)."""
    cls = cfg.problem.cls
    if cls == "dogbone":
        return make_dogbone(cfg, dtype, device)
    if cls in ("dropweight", "drop weight"):
        return make_dropweight(cfg, dtype, device)
    if cls in ("compact", "compact tension"):
        return make_compact_tension(cfg, dtype, device)
    raise ValueError(f"unknown problem type class: {cls!r}")
