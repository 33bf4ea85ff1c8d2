"""K2: pairwise L2 distances between strain-history splines.

The port of ``scema_tpu/ops/pairwise_pallas.py`` (``_dist_kernel``, launched
by ``pairwise_l2_pallas``).  :func:`pairwise_l2` launches the hand-written
CUDA kernel ``csrc/pairwise_l2.cu`` (the Hopper redesign: upper-triangle
tile pairs of 64 or, where those would not fill the card, 32 rows, each
tile written with its mirror) on a CUDA tensor and counts
the launch in ``pairwise_l2.launches``; on a CPU tensor it computes the
same function with :func:`pairwise_l2_plain`.  Any other device raises.
:func:`_first` launches the first design (a block per tile of the full
square) for the checks only, counted in ``_first.launches``; both designs
give the same bits.
"""
from __future__ import annotations

import torch

from . import _build


def pairwise_l2_plain(x: torch.Tensor, block: int = 256) -> torch.Tensor:
    """(n, d) -> (n, n) L2 distances by direct differencing, ``block`` rows
    at a time (compare_L2_norm semantics, strain2spline.h:469-487)."""
    rows = []
    for i in range(0, x.shape[0], block):
        diff = x[i:i + block, None, :] - x[None, :, :]
        rows.append(torch.sqrt(torch.sum(diff * diff, dim=-1)))
    return torch.cat(rows, dim=0) if rows else x.new_zeros((0, 0))


def _launch(x: torch.Tensor, symbol: str, counted, *extra) -> torch.Tensor:
    """Launch ``symbol`` on x and add one to ``counted.launches``; ``extra``
    are its integer arguments after d (K2's tile edge: 0 lets the kernel
    choose, 32 or 64 for the checks)."""
    if x.dtype != torch.float32:
        raise TypeError(f"pairwise_l2 kernel takes float32, got {x.dtype}")
    n, d = x.shape
    out = torch.empty((n, n), dtype=torch.float32, device=x.device)
    if n == 0:
        return out
    x = x.contiguous()
    rc = getattr(_build.library(), symbol)(x.data_ptr(), out.data_ptr(), n, d, *extra,
                                           _build.stream_handle(x.device))
    _build.check(rc, symbol)
    counted.launches += 1
    return out


def pairwise_l2(x: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, n) L2 distance matrix: K2 on CUDA (the kernel picks its
    tile edge from n and the card's SMs), the plain version on the CPU."""
    if x.dim() != 2:
        raise ValueError(f"pairwise_l2 expects (n, d), got {tuple(x.shape)}")
    if x.device.type == "cpu":
        return pairwise_l2_plain(x)
    if x.device.type != "cuda":
        raise ValueError(f"pairwise_l2: unsupported device {x.device}")
    return _launch(x, "pairwise_l2_f32", pairwise_l2, 0)


def _first(x: torch.Tensor) -> torch.Tensor:
    """K2's first design on a CUDA tensor (the checks' A/B only)."""
    if x.dim() != 2 or x.device.type != "cuda":
        raise ValueError(f"_first takes an (n, d) CUDA tensor, got {tuple(x.shape)} "
                         f"on {x.device}")
    return _launch(x, "pairwise_l2_first_f32", _first)


pairwise_l2.launches = 0
_first.launches = 0
