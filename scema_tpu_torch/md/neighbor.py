"""Neighbor lists of fixed width for the gather-list kernel K4.

Torch twin of ``scema_tpu/md/neighbor.py`` with a leading job axis: a
*full* list (each pair in both rows) of width K, ``idx (..., N, K)`` with
``mask (..., N, K)``, dead slots self-padded.  K4 reads it through its
packed channels; the unfused engine's SW list route hands it to
``SW.energy``.  The setup-time diagnostics
(``derive_spec``, ``required_k``, ``max_in_range``,
``max_cell_occupancy``) are numpy, as in the JAX package.

Three builds give the same pairs: the dense O(N^2) search
(:func:`build_dense`), and two cell-binned ones on ``spec.cells``, which
bin atoms into cells of edge >= r_list by a sort on the cell id and take
the candidates from the 27 surrounding cells, ``spec.cell_capacity`` atoms
each (atoms beyond it drop out of the cell table): the gather form
(:func:`build_cells`, one row per atom) and the structured form
(:func:`build_cells_structured`, one row per cell slot, the JAX package's
choice on the TPU).  :func:`build` takes the dense build where
``derive_spec`` found fewer than 3 cells along an axis or the box is at
most ``n2_threshold`` atoms, else the gather form, the faster of the two
cell builds on the card.  Every build runs in
job slices that bound its candidate tensors (:func:`jobs_per_slice`).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import box as B

# candidate elements (jobs x rows x candidates per row) per slice of a build
_SLICE_ELEMS = 1 << 27
# the 27 cells around a cell (and itself), in the JAX package's order
_CELL_OFFSETS = np.array([[i, j, k] for i in (-1, 0, 1) for j in (-1, 0, 1)
                          for k in (-1, 0, 1)], dtype=np.int64)


class NeighborList(NamedTuple):
    idx: torch.Tensor  # (..., N, K) int64 neighbor indices (self-padded when invalid)
    mask: torch.Tensor  # (..., N, K) bool


@dataclass(frozen=True)
class NeighborSpec:
    """Static neighbor-list configuration."""

    cutoff: float  # interaction cutoff
    skin: float = 2.0
    k_max: int = 64  # neighbor-list width
    n2_threshold: int = 1024  # below this, use the dense N^2 path
    cells: tuple[int, int, int] = (0, 0, 0)  # 0 = dense
    cell_capacity: int = 32

    @property
    def r_list(self) -> float:
        return self.cutoff + self.skin


def derive_spec(n_atoms: int, h0: np.ndarray, cutoff: float, skin: float = 2.0,
                k_max: int = 64) -> NeighborSpec:
    """Static cell grid from the initial box (20% margin for shrinkage
    under deformation); the dense path when fewer than 3 cells fit."""
    r = cutoff + skin
    h0 = np.asarray(h0, dtype=float)
    L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]], dtype=float)
    nc = np.maximum(1, np.floor(L / (1.2 * r)).astype(int))
    if (nc < 3).any():
        return NeighborSpec(cutoff=cutoff, skin=skin, k_max=k_max, n2_threshold=n_atoms)
    density = n_atoms / float(np.prod(L))
    cap = int(np.ceil(density * np.prod(L / np.maximum(nc, 1)) * 2.0)) + 4
    return NeighborSpec(cutoff=cutoff, skin=skin, k_max=k_max,
                        cells=(int(nc[0]), int(nc[1]), int(nc[2])), cell_capacity=cap)


def required_k(n_atoms: int, h0: np.ndarray, r_list: float, margin: float = 1.3,
               pad: int = 8) -> int:
    """Uniform-density estimate of the list width that holds every
    candidate within ``r_list`` (a list narrower than the true coordination
    silently drops pairs)."""
    vol = abs(float(np.linalg.det(np.asarray(h0, dtype=float))))
    k = int(np.ceil(n_atoms / vol * (4.0 / 3.0) * np.pi * r_list ** 3 * margin)) + pad
    return max(1, min(k, n_atoms - 1))


def max_in_range(pos, h, r: float, chunk: int = 1024) -> int:
    """The exact largest per-atom neighbor count within ``r`` (minimum
    image), numpy, chunked — setup time only."""
    pos = np.asarray(pos, dtype=float)
    h = np.asarray(h, dtype=float)
    ih = np.linalg.inv(h)
    worst = 0
    for i0 in range(0, pos.shape[0], chunk):
        ds = (pos[i0:i0 + chunk, None, :] - pos[None, :, :]) @ ih.T
        ds -= np.round(ds)
        dr = ds @ h.T
        cnt = (np.einsum("ijk,ijk->ij", dr, dr) < r * r).sum(axis=1) - 1  # minus self
        worst = max(worst, int(cnt.max()))
    return worst


def max_cell_occupancy(spec: NeighborSpec, pos, h) -> int:
    """The fullest cell's atom count under ``spec.cells`` (0 for the dense
    path)."""
    if spec.cells == (0, 0, 0):
        return 0
    pos = np.asarray(pos, dtype=float)
    nc = np.asarray(spec.cells)
    s = pos @ np.linalg.inv(np.asarray(h, dtype=float)).T
    s -= np.floor(s)
    cxyz = np.clip((s * nc).astype(int), 0, nc - 1)
    cid = (cxyz[:, 0] * nc[1] + cxyz[:, 1]) * nc[2] + cxyz[:, 2]
    return int(np.bincount(cid).max())


def _topk_compact(dr2: torch.Tensor, cand_idx: torch.Tensor, valid: torch.Tensor, k: int,
                  r2_cut: float) -> NeighborList:
    """Keep the k nearest valid candidates per row (``torch.topk`` on the
    negated distances; ties may fall in another order than ``lax.top_k``'s,
    so lists compare as per-row sets)."""
    big = torch.full((), 1e30, dtype=dr2.dtype, device=dr2.device)
    keyed = torch.where(valid & (dr2 < r2_cut), dr2, big)
    neg_d, order = torch.topk(-keyed, k, dim=-1)
    idx = torch.gather(cand_idx, -1, order)
    mask = -neg_d < big
    self_idx = torch.arange(dr2.shape[-2], device=dr2.device)[:, None]
    return NeighborList(idx=torch.where(mask, idx, self_idx), mask=mask)


def _min_image_r2(h: torch.Tensor, dr: list) -> torch.Tensor:
    """|d|^2 of the minimum image of the displacements dr (three (Bf, ...)
    components) in boxes h (Bf, 3, 3): box.min_image_disp's arithmetic
    (ds = inv_h dr, rounded, back through h) without an (..., 3) tensor.
    Empties the list dr, so that its planes are freed before the second
    pass."""
    tail = (1,) * (dr[0].dim() - 1)
    ih = B.inv_h(h)

    def c(m, a, b):
        return m[:, a, b].reshape((-1,) + tail)

    ds = [c(ih, a, 0) * dr[0] + c(ih, a, 1) * dr[1] + c(ih, a, 2) * dr[2] for a in range(3)]
    dr.clear()
    ds = [x - torch.round(x) for x in ds]
    r2 = torch.zeros_like(ds[0])
    for a in range(3):
        d = c(h, a, 0) * ds[0] + c(h, a, 1) * ds[1] + c(h, a, 2) * ds[2]
        r2 += d * d
    return r2


def _dense_block(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor) -> NeighborList:
    n = pos.shape[-2]
    # r_j - r_i per component
    dr2 = _min_image_r2(h, [pos[:, None, :, a] - pos[:, :, None, a] for a in range(3)])
    cand = torch.arange(n, device=pos.device).expand(pos.shape[:-2] + (n, n))
    valid = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    return _topk_compact(dr2, cand, valid, min(spec.k_max, n - 1), spec.r_list ** 2)


def _bin(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor):
    """Each atom's cell (fractional binning on the fixed ``spec.cells``
    grid, floor and clip) of pos (Bf, N, 3) in boxes h (Bf, 3, 3): the cell
    coordinates (Bf, N, 3), then from a stable sort by cell id the sorted
    ids, the order and each sorted atom's rank within its cell, (Bf, N)
    each."""
    n = pos.shape[1]
    nc = torch.tensor(spec.cells, device=pos.device)
    s = B.to_fractional(h, pos)
    s = s - torch.floor(s)
    cxyz = torch.minimum((s * nc).long(), nc - 1).clamp_min(0)
    cid = (cxyz[..., 0] * nc[1] + cxyz[..., 1]) * nc[2] + cxyz[..., 2]
    order = torch.argsort(cid, dim=-1, stable=True)
    cid_sorted = torch.gather(cid, -1, order)
    first = torch.searchsorted(cid_sorted, cid_sorted, side="left")
    return cxyz, cid_sorted, order, torch.arange(n, device=pos.device) - first


def _table(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor, slot) -> tuple:
    """The (Bf, C * cap) cell table of pos (Bf, N, 3): entry ``slot(cell,
    rank)`` holds the atom of that rank in that cell, N where none; an atom
    ranked at or beyond ``cell_capacity`` is dropped, not clipped onto the
    last slot (JAX's ``mode="drop"``).  Also returns the cell coordinates."""
    Bf, n = pos.shape[:2]
    C = spec.cells[0] * spec.cells[1] * spec.cells[2]
    cxyz, cid_sorted, order, rank = _bin(spec, pos, h)
    table = torch.full((Bf, C * spec.cell_capacity), n, dtype=torch.int64, device=pos.device)
    keep = rank < spec.cell_capacity
    jobs = torch.arange(Bf, device=pos.device)[:, None].expand(Bf, n)
    table[jobs[keep], slot(cid_sorted, rank)[keep]] = order[keep]
    return table, cxyz


def _cells_block(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor) -> NeighborList:
    """neighbor.py:342-375 on a slice of jobs: each atom's row takes the
    occupants of its 27 surrounding cells (periodic wrap) as candidates."""
    Bf, n = pos.shape[:2]
    cap = spec.cell_capacity
    _, ncy, ncz = spec.cells
    occ, cxyz = _table(spec, pos, h, lambda cid, rank: cid * cap + rank)
    nc = torch.tensor(spec.cells, device=pos.device)
    nxyz = torch.remainder(cxyz[:, :, None, :] + torch.as_tensor(_CELL_OFFSETS,
                                                                  device=pos.device), nc)
    ncell = (nxyz[..., 0] * ncy + nxyz[..., 1]) * ncz + nxyz[..., 2]  # (Bf, N, 27)
    slots = (ncell[..., None] * cap + torch.arange(cap, device=pos.device)).reshape(Bf, -1)
    cand = torch.gather(occ, 1, slots)  # (Bf, N * 27 * cap)
    pos_pad = torch.cat([pos, torch.zeros_like(pos[:, :1])], 1)
    dr2 = _min_image_r2(h, [(torch.gather(pos_pad[..., a], 1, cand).reshape(Bf, n, -1)
                             - pos[..., a, None]) for a in range(3)])
    cand = cand.reshape(Bf, n, -1)
    valid = (cand < n) & (cand != torch.arange(n, device=pos.device)[:, None])
    return _topk_compact(dr2, cand, valid, spec.k_max, spec.r_list ** 2)


def _structured_block(spec: NeighborSpec, pos: torch.Tensor,
                      h: torch.Tensor) -> NeighborList:
    """neighbor.py:255-339 on a slice of jobs: the atoms in a (cap, C) slot
    grid, each of the 27 neighbor relations a fixed permutation of the
    cells, distances on (cap_i, cap_j, C) blocks, one row per slot, then the
    slot rows scattered back to atom order."""
    Bf, n = pos.shape[:2]
    ncx, ncy, ncz = spec.cells
    C, cap = ncx * ncy * ncz, spec.cell_capacity
    dev = pos.device
    grid, _ = _table(spec, pos, h, lambda cid, rank: rank * C + cid)
    pos_pad = torch.cat([pos, torch.zeros_like(pos[:, :1])], 1)
    pg = [torch.gather(pos_pad[..., a], 1, grid).reshape(Bf, cap, C) for a in range(3)]
    grid = grid.reshape(Bf, cap, C)
    occ = grid < n
    cells = np.arange(C)
    iz, iy, ix = cells % ncz, (cells // ncz) % ncy, cells // (ncy * ncz)
    not_self = ~torch.eye(cap, dtype=torch.bool, device=dev)[:, :, None]
    d2_blocks, id_blocks = [], []
    for dx, dy, dz in _CELL_OFFSETS:
        perm = torch.as_tensor((((ix + dx) % ncx) * ncy + (iy + dy) % ncy) * ncz
                               + (iz + dz) % ncz, device=dev)
        r2 = _min_image_r2(h, [p[..., perm][:, None, :, :] - p[:, :, None, :] for p in pg])
        valid = occ[:, :, None, :] & occ[..., perm][:, None, :, :]
        if (dx, dy, dz) == (0, 0, 0):
            valid = valid & not_self
        d2_blocks.append(torch.where(valid, r2, torch.full((), 1e30, dtype=r2.dtype,
                                                           device=dev)))
        id_blocks.append(grid[..., perm][:, None].expand(Bf, cap, cap, C))
    # (Bf, cap_i, 27 cap, C) -> per-slot rows (Bf, cap * C, 27 cap)
    d2 = torch.cat(d2_blocks, 2).permute(0, 1, 3, 2).reshape(Bf, cap * C, 27 * cap)
    ids = torch.cat(id_blocks, 2).permute(0, 1, 3, 2).reshape(Bf, cap * C, 27 * cap)
    nl = _topk_compact(d2, ids, d2 < spec.r_list ** 2, spec.k_max, spec.r_list ** 2)
    slot_atom = grid.reshape(Bf, cap * C)
    live = slot_atom < n
    jobs = torch.arange(Bf, device=dev)[:, None].expand(Bf, cap * C)
    idx = torch.arange(n, device=dev)[:, None].expand(Bf, n, spec.k_max).clone()
    mask = torch.zeros((Bf, n, spec.k_max), dtype=torch.bool, device=dev)
    idx[jobs[live], slot_atom[live]] = nl.idx[live]
    mask[jobs[live], slot_atom[live]] = nl.mask[live]
    return NeighborList(idx=torch.where(mask, idx, torch.arange(n, device=dev)[:, None]),
                        mask=mask)


def _candidates(spec: NeighborSpec, n_atoms: int, form: str) -> int:
    """Candidate elements per job of one build form: N^2 (dense), N x 27 x
    cap (gather) or (cap x C) slots x 27 cap (structured)."""
    if form == "dense":
        return n_atoms * n_atoms
    rows = n_atoms if form == "gather" else spec.cell_capacity * int(np.prod(spec.cells))
    return rows * 27 * spec.cell_capacity


def _form(spec: NeighborSpec, n_atoms: int) -> str:
    return "dense" if n_atoms <= spec.n2_threshold or spec.cells == (0, 0, 0) else "gather"


def _jobs(spec: NeighborSpec, n_atoms: int, form: str) -> int:
    return max(1, _SLICE_ELEMS // _candidates(spec, n_atoms, form))


def jobs_per_slice(spec: NeighborSpec, n_atoms: int) -> int:
    """Jobs per slice of :func:`build` (bounds its candidate tensors: 8
    jobs of the dense build at N = 4096, 43 of the gather cell build on
    the 4096-atom Si box's (7, 7, 7) cells of capacity 28)."""
    return _jobs(spec, n_atoms, _form(spec, n_atoms))


def _sliced(block, form: str, spec: NeighborSpec, pos: torch.Tensor,
            h: torch.Tensor) -> NeighborList:
    """``block`` over pos (..., N, 3) in boxes h (..., 3, 3), in slices of
    jobs that bound its candidate tensors -> lists (..., N, K)."""
    n = pos.shape[-2]
    bs = pos.shape[:-2]
    pf, hf = pos.reshape(-1, n, 3), h.expand(bs + (3, 3)).reshape(-1, 3, 3)
    step = _jobs(spec, n, form)
    parts = [block(spec, pf[s:s + step], hf[s:s + step]) for s in range(0, pf.shape[0], step)]
    k = parts[0].idx.shape[-1]
    return NeighborList(idx=torch.cat([p.idx for p in parts]).reshape(bs + (n, k)),
                        mask=torch.cat([p.mask for p in parts]).reshape(bs + (n, k)))


def build_dense(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor) -> NeighborList:
    """O(N^2) masked neighbor search: pos (..., N, 3), h (..., 3, 3) ->
    lists (..., N, min(k_max, N - 1))."""
    return _sliced(_dense_block, "dense", spec, pos, h)


def build_cells(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor) -> NeighborList:
    """Cell-binned neighbor search, the gather form (neighbor.py:342-375):
    pos (..., N, 3), h (..., 3, 3) -> lists (..., N, k_max).  An atom
    dropped from a full cell keeps its own row but is no one's
    candidate."""
    return _sliced(_cells_block, "gather", spec, pos, h)


def build_cells_structured(spec: NeighborSpec, pos: torch.Tensor,
                           h: torch.Tensor) -> NeighborList:
    """Cell-binned neighbor search, the structured form (neighbor.py:
    255-339): pos (..., N, 3), h (..., 3, 3) -> lists (..., N, k_max).  An
    atom dropped from a full cell has no row (an empty list) and is no
    one's candidate.  (The JAX form clips the rank, so a dropped atom's
    write races the last slot's occupant; on the CPU it erases it.)"""
    return _sliced(_structured_block, "structured", spec, pos, h)


def build(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor) -> NeighborList:
    """The dense build where the box has at most ``n2_threshold`` atoms or
    no cell grid, else the gather cell build (neighbor.py:378-381, where
    the JAX package takes the structured form, a TPU layout without
    gathers).  The gather form is the faster on the card: on 128 strained
    4096-atom Si boxes (cells (7, 7, 7), capacity 28) it takes 97.9-99.3 ms
    per build against the structured form's 369.6-418.0 and the dense
    build's 386.7-388.6 (chip_smoke.py phase 13 in turns, two runs; NVIDIA
    H100 80GB HBM3, 700 W)."""
    if _form(spec, pos.shape[-2]) == "dense":
        return build_dense(spec, pos, h)
    return build_cells(spec, pos, h)


def neighbor_disp(pos: torch.Tensor, h: torch.Tensor, nbr: NeighborList) -> torch.Tensor:
    """Min-image displacement r_j - r_i for every list entry: pos (..., N,
    3), h (..., 3, 3) -> (..., N, K, 3) (neighbor.py:389)."""
    lead, (n, k) = nbr.idx.shape[:-2], nbr.idx.shape[-2:]
    flat = nbr.idx.reshape(lead + (n * k, 1)).expand(lead + (n * k, 3))
    nb = torch.gather(pos.expand(lead + pos.shape[-2:]), -2, flat).reshape(lead + (n, k, 3))
    return B.min_image_disp(h[..., None, :, :], nb - pos[..., :, None, :])
