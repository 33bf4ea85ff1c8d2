"""Triclinic simulation box: h-matrix algebra, minimum image, deformation.

Torch twin of ``scema_tpu/md/box.py``.  LAMMPS box convention: edge
vectors a = (lx,0,0), b = (xy,ly,0), c = (xz,yz,lz) form the upper-triangular
column matrix

    h = [[lx, xy, xz],
         [0,  ly, yz],
         [0,  0,  lz]]

``fix deform ... remap x`` holds fractional coordinates fixed:
``r' = h_new h_old^-1 r``.  Every function broadcasts over leading batch
dimensions of ``h`` (..., 3, 3) and ``eps`` (..., 6).
"""
from __future__ import annotations

import torch


def h_from_lengths_tilts(lengths: torch.Tensor, tilts: torch.Tensor) -> torch.Tensor:
    """(..., 3) lengths + (..., 3) [xy, xz, yz] -> (..., 3, 3) h-matrix."""
    z = torch.zeros_like(lengths[..., 0])
    lx, ly, lz = lengths.unbind(-1)
    xy, xz, yz = tilts.unbind(-1)
    return torch.stack([torch.stack([lx, xy, xz], -1),
                        torch.stack([z, ly, yz], -1),
                        torch.stack([z, z, lz], -1)], -2)


def lengths_tilts(h: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.stack([h[..., 0, 0], h[..., 1, 1], h[..., 2, 2]], -1),
            torch.stack([h[..., 0, 1], h[..., 0, 2], h[..., 1, 2]], -1))


def volume(h: torch.Tensor) -> torch.Tensor:
    return h[..., 0, 0] * h[..., 1, 1] * h[..., 2, 2]


def inv_h(h: torch.Tensor) -> torch.Tensor:
    """General inverse (the strain-derivative virial deforms h by arbitrary
    3x3 factors, so no upper-triangular shortcut)."""
    return torch.linalg.inv(h)


def to_fractional(h: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """pos (..., N, 3) -> fractional coordinates for h (..., 3, 3)."""
    return pos @ inv_h(h).transpose(-1, -2)


def min_image_disp(h: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement vectors dr (..., P, 3) for h (..., 3, 3)."""
    ds = dr @ inv_h(h).transpose(-1, -2)
    ds = ds - torch.round(ds)
    return ds @ h.transpose(-1, -2)


def remap_affine(h_old: torch.Tensor, h_new: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """fix-deform 'remap x': hold fractional coords fixed under box change."""
    return pos @ (torch.linalg.inv(h_old).transpose(-1, -2) @ h_new.transpose(-1, -2))


def deform_path(h0: torch.Tensor, eps_eff: torch.Tensor, frac) -> torch.Tensor:
    """Box at fraction ``frac`` of a fix-deform run toward strain eps_eff:
    diagonals scale lengths ``L_i(f) = L_i0 (1 + f eps_ii)``; shears change
    tilts by ``f * eps_ij * L_assoc0`` (xy->ly, xz->lz, yz->lz)."""
    L0, t0 = lengths_tilts(h0)
    if torch.is_tensor(frac) and frac.dim() > 0:
        frac = frac[..., None]
    L = L0 * (1.0 + frac * eps_eff[..., :3])
    assoc = torch.stack([L0[..., 1], L0[..., 2], L0[..., 2]], -1)
    tilts = t0 + frac * eps_eff[..., 3:] * assoc
    return h_from_lengths_tilts(L, tilts)
