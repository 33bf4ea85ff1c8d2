"""Stillinger-Weber three-body potential (single element).

Torch twin of ``scema_tpu/md/forcefields/sw.py``: the reference's
``pair_style sw`` with Si.sw (the streched_polyhedron example's force field,
examples/.../lammps_scripts_sisw/in.set.lammps).  Functional form
(Stillinger & Weber, PRB 31, 5262 (1985)):

  E = sum_{i<j} phi2(r_ij) + sum_i sum_{j<k} phi3(r_ij, r_ik, theta_jik)
  phi2(r) = A eps (B (sig/r)^p - (sig/r)^q) exp(sig / (r - a sig))
  phi3    = lam eps (cos th - cos0)^2 exp(gam sig/(r_ij - a sig))
                                      exp(gam sig/(r_ik - a sig))

both cut at r = a*sig.  :meth:`SW.energy` is the moment form over a full
neighbor list: the unfused engine's list route takes its forces and
virial by autograd (SW boxes above K5's gate without the brick kernels).
Kernel K5 (``ops/md_fused.py``) computes the same function over all pairs,
and K6c/K6d (``ops/sw_bricks.py``) over brick tiles, with hand-derived
forces; the tests hold their plain versions to autograd of this energy.

As in the JAX package and the reference, the .sw file's metal-unit numbers
are read under ``units real`` verbatim.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from .. import box as B


@dataclass(frozen=True)
class SW:
    epsilon: float
    sigma: float
    a: float
    lam: float
    gamma: float
    costheta0: float
    A: float
    B: float
    p: float
    q: float

    @property
    def cutoff(self) -> float:
        return self.a * self.sigma

    def energy(self, pos: torch.Tensor, h: torch.Tensor, nbr) -> torch.Tensor:
        """Total energy of positions pos (..., N, 3) in boxes h (..., 3, 3)
        over the full neighbor list ``nbr`` (idx, mask (..., N, K); each
        pair in both rows), minimum image by fractional rounding.  Returns
        (...) energies; differentiable in pos and h.

        The three-body double sum collapses to per-atom moments because
        (cos - c0)^2 is quadratic in cos(theta_jik) = u_j . u_k:
        sum_{j!=k} g_j g_k (u_j.u_k)^2 = Tr[Q^2] - sum g_j^2, and likewise
        for |m|^2 and s^2, with m = sum g_j u_j, Q = sum g_j u_j u_j^T,
        s = sum g_j."""
        lead, (n, k) = nbr.idx.shape[:-2], nbr.idx.shape[-2:]
        flat = nbr.idx.reshape(lead + (n * k, 1)).expand(lead + (n * k, 3))
        nb = torch.gather(pos, -2, flat).reshape(lead + (n, k, 3))
        dr = B.min_image_disp(h[..., None, :, :], nb - pos[..., :, None, :])  # (..., N, K, 3)
        r2 = torch.sum(dr * dr, -1)
        rc = self.cutoff
        mask = nbr.mask & (r2 < (rc - 1e-6) ** 2)
        r = torch.sqrt(torch.where(mask, r2, torch.ones_like(r2)))
        sig, eps = self.sigma, self.epsilon
        denom = torch.where(mask, r - rc, -torch.ones_like(r))
        zero = torch.zeros_like(r)
        # two-body over the full list, halved
        sr = sig / r
        e2 = self.A * eps * (self.B * sr ** self.p - sr ** self.q) * torch.exp(sig / denom)
        e2 = 0.5 * torch.sum(torch.where(mask, e2, zero), (-1, -2))
        # three-body via the per-atom moments
        g = torch.where(mask, torch.exp(self.gamma * sig / denom), zero)
        u = dr / r[..., None]
        s = torch.sum(g, -1)
        gsq = torch.sum(g * g, -1)
        m = torch.sum(g[..., None] * u, -2)
        Q = torch.einsum("...k,...ka,...kb->...ab", g, u, u)
        trq2 = torch.einsum("...ab,...ba->...", Q, Q)
        c0 = self.costheta0
        e3_atom = (trq2 - gsq) - 2.0 * c0 * (torch.sum(m * m, -1) - gsq) \
            + c0 * c0 * (s * s - gsq)
        return e2 + 0.5 * self.lam * eps * torch.sum(e3_atom, -1)


def read_sw_file(path: str, element: str = "Si") -> SW:
    """Parse the first matching single-element entry of a LAMMPS .sw file."""
    vals = []
    with open(path) as f:
        for line in f:
            line = line.split("#")[0].strip()
            if line:
                vals.extend(line.split())
    # find "el el el" triple
    for i in range(len(vals) - 2):
        if vals[i] == element and vals[i + 1] == element and vals[i + 2] == element:
            nums = [float(x) for x in vals[i + 3 : i + 14]]
            (epsilon, sigma, a, lam, gamma, costheta0, A, B_, p, q, _tol) = nums
            return SW(
                epsilon=epsilon, sigma=sigma, a=a, lam=lam, gamma=gamma,
                costheta0=costheta0, A=A, B=B_, p=p, q=q,
            )
    raise ValueError(f"no {element} entry found in {path}")


# The shipped example's parameters (examples/.../lammps_scripts_sisw/Si.sw):
SI = SW(
    epsilon=2.1683, sigma=2.0951, a=1.80, lam=21.0, gamma=1.20,
    costheta0=-0.333333333333, A=7.049556277, B=0.6022245584, p=4.0, q=0.0,
)
