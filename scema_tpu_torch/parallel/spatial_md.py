"""P4: spatial decomposition of ONE large SW box over a process mesh.

Torch twin of ``scema_tpu/parallel/spatial_md.py``.  The reference runs
each big MD job spatially decomposed over its batch communicator
(stmd_problem.h:156, 284: LAMMPS's own domain decomposition over MPI).  The
JAX version shards the x-plane axis of a cell grid over the mesh: each
device owns a slab of planes, the stencil's x+-1 neighbours at a slab edge
arrive by a ring ``ppermute`` halo exchange, the energy is a ``psum``, and
forces come from ``jax.grad`` through the ``shard_map``.

Here the box's positions stay replicated on every rank, as the JAX runner
keeps "the state replicated" (spatial_md.py:237-253), and each rank
evaluates the per-centre terms of ``SW.energy`` only for the centres whose
x-cell plane lies in its slab: the two-body sum is halved per row and the
three-body sum is a sum of per-centre moments, so the energy splits
exactly by centre.  Autograd gives the rank's share of the forces on all
atoms (its centres' neighbours included) and of the virial, and one
``all_reduce`` sums the shares: what JAX's ``psum`` plus the gradient
through its ``ppermute`` amount to.  JAX's ring halo becomes a read of the
rank's own copy of the neighbours' positions.  The pairs come from the
engine's neighbor list (``neighbor.build``, the cell build on these
boxes), rebuilt once per ``rebuild_every`` chunk as on the unsharded list
route, and the rank keeps the rows of its centres; the slab of an atom is
fixed by that binning for the chunk, which the affine deform remap
(fractional coordinates held) keeps valid, as in JAX's
``run_strain_sharded``.  The JAX slab grid's moment math
(``md/grid.py``) is not ported; the SW list route's energy is.

:class:`SpatialRunner` plugs into the unfused engine through
``MDSystem.spatial``: the engine's neighbor build, force and force +
energy + virial calls go to it, so the strain, sampling, FIRE, NPT and
stiffness loops run sharded with the engine's own chunking (a job of zero
steps stays untouched, where JAX's loop runs at least ``rebuild_every``
steps).  Every running job of a call is sharded the same way: the slab
owner of a centre is per job, the collective is one per force call for
the whole batch.  A rank outside the runner's mesh evaluates the whole box
alone.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..md import box as B
from ..md import engine as E
from ..md import neighbor as NB
from . import mesh_utils as MU


@dataclass(frozen=True)
class ShardedGridSpec:
    """The x-plane count of JAX's sharded cell grid (spatial_md.py:34-48):
    ``cells[0]``, the planes the slabs split, a multiple of the shards.
    JAX's slot capacity and in-plane permutations serve its slot grid,
    which the port does not build (the module docstring)."""

    cells: tuple  # (c1, c2, c3)
    r_list: float


def derive_sharded_grid(n_atoms: int, h0: np.ndarray, cutoff: float,
                        skin: float = 0.5, n_shards: int = 1,
                        margin: float = 1.15) -> ShardedGridSpec:
    """Like grid.derive_grid but with c1 forced to a multiple of n_shards
    (spatial_md.py:51-89).  ``n_atoms`` is kept for JAX's signature."""
    r = cutoff + skin
    h0 = np.asarray(h0, dtype=float)
    L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]], dtype=float)
    nc = np.maximum(3, np.floor(L / (margin * r)).astype(int))
    c1 = int(nc[0]) // n_shards * n_shards
    if c1 < max(n_shards, 3):
        # c1 < 3 would alias the x-1 and x+1 stencil relations (pairs
        # double-counted); < n_shards cannot be slab-sharded at all
        raise ValueError(
            f"box too small to shard: {nc[0]} x-cells, need >= "
            f"max({n_shards}, 3)")
    return ShardedGridSpec(cells=(c1, int(nc[1]), int(nc[2])), r_list=r)


class SlabList(NamedTuple):
    """A rank's share of a batch's neighbor lists: the rows of its centres
    (``centres`` (B, M) atom ids, the list rows (B, M, K) with padded rows
    masked out), or the whole lists with ``centres`` None."""

    nbr: NB.NeighborList
    centres: torch.Tensor | None


def slab_of(sg: ShardedGridSpec, n_slabs: int, pos: torch.Tensor,
            h: torch.Tensor) -> torch.Tensor:
    """Each atom's slab (..., N): its x-cell plane of the c1 planes
    (fractional binning, floor and clip, as the JAX package's ``bin_atoms``),
    planes split
    into ``n_slabs`` contiguous runs."""
    c1 = sg.cells[0]
    s = B.to_fractional(h, pos)[..., 0]
    s = s - torch.floor(s)
    plane = torch.clamp((s * c1).long(), 0, c1 - 1)
    return plane * n_slabs // c1


@dataclass(frozen=True)
class SpatialRunner:
    """MDSystem plug-in: the unfused engine's SW force calls, x-slab
    sharded over the ranks of ``mesh`` (a one-axis mesh of
    ``parallel.mesh_utils``, None for one process without a group)."""

    sg: ShardedGridSpec
    mesh: object = None
    axis: str = "md"

    def _place(self):
        """(slab index, slabs, group): this rank's slab, or (None, 1, None)
        where it evaluates the whole box."""
        if self.mesh is None:
            return None, 1, None
        r = MU.mesh_rank(self.mesh, self.axis)
        if r is None:
            return None, 1, None
        return r, MU.mesh_size(self.mesh, self.axis), MU.mesh_group(self.mesh, self.axis)

    def build(self, nspec: NB.NeighborSpec, pos: torch.Tensor, h: torch.Tensor) -> SlabList:
        """The batch's lists (``neighbor.build``) cut to this rank's centres."""
        nbr = NB.build(nspec, pos, h)
        r, k, _ = self._place()
        if r is None or k == 1:
            return SlabList(nbr, None)
        own = slab_of(self.sg, k, pos, h) == r  # (B, N)
        counts = own.sum(-1)
        m = max(int(counts.max()), 1)
        order = torch.argsort((~own).to(torch.int8), dim=-1, stable=True)
        centres = order[..., :m]  # the rank's atoms first, in index order
        valid = torch.arange(m, device=pos.device) < counts[..., None]
        rows = centres[..., None].expand(centres.shape + (nbr.idx.shape[-1],))
        idx = torch.gather(nbr.idx, -2, rows)
        mask = torch.gather(nbr.mask, -2, rows) & valid[..., None]
        return SlabList(NB.NeighborList(idx=idx, mask=mask), centres)

    def _sum(self, x: torch.Tensor) -> torch.Tensor:
        _, _, group = self._place()
        return x if group is None else MU.all_reduce(x, group)

    def forces(self, sw, pos: torch.Tensor, h: torch.Tensor, slab: SlabList) -> torch.Tensor:
        """Forces (B, N, 3): -grad of the rank's share of the energy,
        summed over the ranks."""
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            (g,) = torch.autograd.grad(sw.energy(p, h, slab.nbr, centres=slab.centres).sum(), p)
        return self._sum(-g)

    def forces_energy_virial(self, sw, pos: torch.Tensor, h: torch.Tensor, slab: SlabList):
        """(F (B, N, 3), E (B,), W (B, 6)) as ``engine.forces_energy_virial``
        computes them, from the rank's share, in one ``all_reduce``."""
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            eps = torch.zeros(pos.shape[:-2] + (3, 3), dtype=pos.dtype, device=pos.device,
                              requires_grad=True)
            F = torch.eye(3, dtype=pos.dtype, device=pos.device) + eps
            energy = sw.energy(p @ F.transpose(-1, -2), F @ h, slab.nbr, centres=slab.centres)
            gp, ge = torch.autograd.grad(energy.sum(), (p, eps))
        W = E._voigt(-0.5 * (ge + ge.transpose(-1, -2)))
        bsz, n = pos.shape[0], pos.shape[-2]
        packed = self._sum(torch.cat([-gp.reshape(bsz, 3 * n), energy.detach()[:, None], W], 1))
        return (packed[:, :3 * n].reshape(bsz, n, 3), packed[:, 3 * n],
                packed[:, 3 * n + 1:])
