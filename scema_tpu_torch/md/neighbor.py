"""Neighbor lists of fixed width for the gather-list kernel K4.

Torch twin of ``scema_tpu/md/neighbor.py`` with a leading job axis: a
*full* list (each pair in both rows) of width K, ``idx (..., N, K)`` with
``mask (..., N, K)``, dead slots self-padded.  K4 reads it through its
packed channels; the unfused engine's SW list route hands it to
``SW.energy``.  The setup-time diagnostics
(``derive_spec``, ``required_k``, ``max_in_range``,
``max_cell_occupancy``) are numpy, as in the JAX package.

Only the dense O(N^2) build is ported.  Every box the port runs takes it:
``derive_spec`` falls back to the dense path when fewer than 3 cells of
edge 1.2 r_list fit along an axis, which holds below ~47 A at the charged
material's r_list = 13 A.  The cell-binned builds (``build_cells``,
``build_cells_structured``) are not ported yet; :func:`build` raises for a
spec that asks for cells.  SW boxes take the dense build at every size
(``material._build_sw`` clears the cells of their spec): it gives the same
pairs as the cell build.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from . import box as B

# (jobs x N x N) candidate-plane elements per slice of the dense build
_DENSE_ELEMS = 1 << 27


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


def _dense_block(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor) -> NeighborList:
    n = pos.shape[-2]
    ih = B.inv_h(h)
    # r_j - r_i per component, then the minimum image of box.min_image_disp
    # (ds = inv_h dr, rounded, back through h) without an (..., N, N, 3)
    # tensor
    dr = [pos[..., None, :, a] - pos[..., :, None, a] for a in range(3)]
    ds = [ih[..., a, 0, None, None] * dr[0] + ih[..., a, 1, None, None] * dr[1]
          + ih[..., a, 2, None, None] * dr[2] for a in range(3)]
    del dr
    ds = [x - torch.round(x) for x in ds]
    dr2 = torch.zeros_like(ds[0])
    for a in range(3):
        d = (h[..., a, 0, None, None] * ds[0] + h[..., a, 1, None, None] * ds[1]
             + h[..., a, 2, None, None] * ds[2])
        dr2 += d * d
    del ds
    cand = torch.arange(n, device=pos.device).expand(pos.shape[:-2] + (n, n))
    valid = ~torch.eye(n, dtype=torch.bool, device=pos.device)
    return _topk_compact(dr2, cand, valid, min(spec.k_max, n - 1), spec.r_list ** 2)


def jobs_per_slice(n_atoms: int) -> int:
    """Jobs per slice of a batched dense build (bounds its (jobs, N, N)
    candidate planes: 26 jobs at N = 2240)."""
    return max(1, _DENSE_ELEMS // (n_atoms * n_atoms))


def build_dense(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor) -> NeighborList:
    """O(N^2) masked neighbor search: pos (..., N, 3), h (..., 3, 3) ->
    lists (..., N, min(k_max, N - 1)).  A batch of jobs is built in slices
    that bound the (jobs, N, N) candidate planes."""
    n = pos.shape[-2]
    bs = pos.shape[:-2]
    if not bs:
        return _dense_block(spec, pos, h)
    pf, hf = pos.reshape(-1, n, 3), h.expand(bs + (3, 3)).reshape(-1, 3, 3)
    step = jobs_per_slice(n)
    parts = [_dense_block(spec, pf[s:s + step], hf[s:s + step])
             for s in range(0, pf.shape[0], step)]
    k = parts[0].idx.shape[-1]
    return NeighborList(idx=torch.cat([p.idx for p in parts]).reshape(bs + (n, k)),
                        mask=torch.cat([p.mask for p in parts]).reshape(bs + (n, k)))


def build(spec: NeighborSpec, pos: torch.Tensor, h: torch.Tensor) -> NeighborList:
    if pos.shape[-2] <= spec.n2_threshold or spec.cells == (0, 0, 0):
        return build_dense(spec, pos, h)
    raise NotImplementedError(
        f"neighbor.build: the cell-binned list (cells {spec.cells}) is not ported "
        "(build_cells / build_cells_structured, ROADMAP queue 1)")


def neighbor_disp(pos: torch.Tensor, h: torch.Tensor, nbr: NeighborList) -> torch.Tensor:
    """Min-image displacement r_j - r_i for every list entry: pos (..., N,
    3), h (..., 3, 3) -> (..., N, K, 3) (neighbor.py:389)."""
    lead, (n, k) = nbr.idx.shape[:-2], nbr.idx.shape[-2:]
    flat = nbr.idx.reshape(lead + (n * k, 1)).expand(lead + (n * k, 3))
    nb = torch.gather(pos.expand(lead + pos.shape[-2:]), -2, flat).reshape(lead + (n, k, 3))
    return B.min_image_disp(h[..., None, :, :], nb - pos[..., :, None, :])
