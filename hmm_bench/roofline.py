"""The yardstick of the kernels' share of their roofline.

Frozen copies, from ``chip_smoke.py`` at commit ce23eb3, of the published
H100 peaks, the operation counts per pair and ``bound``,
``pair_fractions``, ``pair_flops``, ``sw_live_pairs`` and ``sw_flops``;
``min_image_disp`` is ``scema_tpu_torch/md/box.py``'s at the same commit.
The CPU tests hold each equal to its original on small shapes.
"""
from __future__ import annotations

import torch

# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
# floating-point operations the pair function needs per unordered pair
# i < j: triclinic minimum image + r^2 for every pair, the LJ force scalar
# inside the LJ cutoff, the damped erfc Coulomb scalar inside the Coulomb
# cutoff, and, inside either, applying the pair force to both atoms and,
# when the virial is sampled, its six products
FLOP_GEOM, FLOP_LJ, FLOP_EWALD, FLOP_APPLY, FLOP_VIRIAL = 26, 8, 24, 9, 12
# per live unordered SW pair, beside the geometry of every pair; with
# sampling, both ordered pairs' virial
FLOP_SW, FLOP_SW_VIRIAL = 184, 24


def min_image_disp(h: torch.Tensor, dr: torch.Tensor) -> torch.Tensor:
    """Minimum-image displacement vectors dr (..., P, 3) for h (..., 3, 3)."""
    ds = dr @ torch.linalg.inv(h).transpose(-1, -2)
    ds = ds - torch.round(ds)
    return ds @ h.transpose(-1, -2)


def bound(bytes_, flops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the float32 rate."""
    t_b, t_f = bytes_ / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def pair_fractions(pos, h, cut2, coul_cut2=0.0, skip=None):
    """Fractions of the pairs i != j of the boxes pos (B, N, 3) inside each
    cutoff, with the kernel's minimum image; the pairs of the (N, N) bool
    mask ``skip`` (the excluded partners) count as outside."""
    fl = fq = 0.0
    for b in range(pos.shape[0]):
        d = min_image_disp(h[b], pos[b][None, :, :] - pos[b][:, None, :])
        r2 = (d * d).sum(-1)
        r2.fill_diagonal_(float("inf"))
        if skip is not None:
            r2[skip] = float("inf")
        pairs = r2.shape[0] * (r2.shape[0] - 1)
        fl += float((r2 < cut2).double().sum()) / pairs
        fq += float((r2 < coul_cut2).double().sum()) / pairs
    n = pos.shape[0]
    return fl / n, fq / n


def pair_flops(n_atoms, jobs_steps, f_lj, f_q=0.0, virial=False):
    """Operations of ``jobs_steps`` pair-force evaluations of one box over
    its N(N-1)/2 unordered pairs (the Coulomb cutoff lies inside the LJ
    one, so max(f_lj, f_q) of the pairs carry a force)."""
    per = (FLOP_GEOM + FLOP_LJ * f_lj + FLOP_EWALD * f_q
           + (FLOP_APPLY + FLOP_VIRIAL * virial) * max(f_lj, f_q))
    return n_atoms * (n_atoms - 1) / 2.0 * jobs_steps * per


def sw_live_pairs(pos, h, rc2):
    """Unordered pairs per box inside K5's mask (r2 < rc2, r2 > 1e-8) of
    boxes pos (B, N, 3) in h (B, 3, 3), averaged over the boxes, in
    float64 — the pairs the SW function needs arithmetic for."""
    tot = 0.0
    for b in range(pos.shape[0]):
        p = pos[b].double()
        d = min_image_disp(h[b].double(), p[None, :, :] - p[:, None, :])
        r2 = (d * d).sum(-1)
        tot += float(((r2 < rc2) & (r2 > 1e-8)).sum()) / 2.0
    return tot / pos.shape[0]


def sw_flops(n_atoms, jobs_steps, live, virial=False):
    """Operations of ``jobs_steps`` SW force calls on one box: the geometry
    of its N(N-1)/2 unordered pairs, and the SW arithmetic on its ``live``
    ones."""
    return jobs_steps * (n_atoms * (n_atoms - 1) / 2.0 * FLOP_GEOM
                         + live * (FLOP_SW + FLOP_SW_VIRIAL * virial))


def md_work(kind: str, n_atoms: int, strain_steps: int, sample_steps: int, live: float,
            skip=None) -> float:
    """Operations of a step's MD work: every job's strained steps without
    the virial and its sampling steps with it; ``live`` is the LJ pair
    fraction (chain boxes) or the live pairs per box (SW)."""
    if kind == "sw":
        return (sw_flops(n_atoms, strain_steps, live)
                + sw_flops(n_atoms, sample_steps, live, virial=True))
    return (pair_flops(n_atoms, strain_steps, live)
            + pair_flops(n_atoms, sample_steps, live, virial=True))
