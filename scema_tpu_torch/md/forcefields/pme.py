"""Smooth particle-mesh Ewald: the reference's ``kspace_style pppm`` on an
FFT mesh.

Torch twin of ``scema_tpu/md/forcefields/pme.py`` (Essmann et al., J. Chem.
Phys. 103, 8577 (1995)), batched over a leading job axis with each job's
own box: cardinal B-spline charge assignment onto a (K1, K2, K3) mesh per
job, a real-to-complex 3-D FFT over the mesh axes (half spectrum, the JAX
package's default), a diagonal influence-function multiply, and the force
interpolation from autograd (the spread's adjoint is the force gather).

The JAX version builds the spread from per-axis (N, K) matrices and one
matrix product (a TPU has no fast scatter); here the (N, order^3) weights
go onto the mesh with one ``index_add`` — the same sum in another order.
The mesh sizes come from ``create`` exactly as in the JAX package.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from .. import box as B
from .coulomb import QQR2E_REAL, ewald_alpha

SPLINE_ORDER = 5  # LAMMPS pppm default interpolation order


def bspline_m(order: int, u):
    """Cardinal B-spline M_order(u) (support (0, order)), for numpy arrays
    and torch tensors:  M_2(u) = 1 - |u - 1|;
    M_n(u) = u/(n-1) M_{n-1}(u) + (n-u)/(n-1) M_{n-1}(u-1)."""
    if torch.is_tensor(u):
        def m2(x):
            return torch.clamp(1.0 - torch.abs(x - 1.0), min=0.0)
    else:
        def m2(x):
            return np.maximum(0.0, 1.0 - np.abs(x - 1.0))

    def m(n, x):
        if n == 2:
            return m2(x)
        return (x * m(n - 1, x) + (n - x) * m(n - 1, x - 1.0)) / (n - 1.0)

    return m(order, u)


def _euler_b2(K: int, order: int) -> np.ndarray:
    """|b(m)|^2 Euler exponential-spline factors for one axis (length K).
    Modes where the denominator vanishes (m = K/2 at odd order) are
    dropped (b2 = 0), as in the JAX package."""
    m = np.arange(K)
    ks = np.arange(order - 1)
    Mk = bspline_m(order, ks + 1.0)
    denom = (Mk[None, :] * np.exp(2j * np.pi * m[:, None] * ks[None, :] / K)).sum(axis=1)
    d2 = np.abs(denom) ** 2
    return np.where(d2 > 1e-10, 1.0 / np.maximum(d2, 1e-10), 0.0)


def _next_fast(n: int) -> int:
    """Smallest 2^a * 3^b * 5^c >= n (FFT-friendly sizes)."""
    best = 1 << (int(n) - 1).bit_length()
    x = 1
    while x < 4 * n:
        y = x
        while y < 4 * n:
            z = y
            while z < n:
                z *= 2
            if n <= z < best:
                best = z
            y *= 3
        x *= 5
    return best


@dataclass(frozen=True)
class PME:
    """Smooth particle-mesh Ewald with a static mesh."""

    charges: torch.Tensor  # (N,)
    cutoff: float
    alpha: float
    mesh: tuple  # (K1, K2, K3)
    b2x: torch.Tensor  # (K1,) |b|^2 factors
    b2y: torch.Tensor
    b2z: torch.Tensor
    order: int = SPLINE_ORDER
    qqr2e: float = QQR2E_REAL

    @staticmethod
    def create(charges, cutoff: float, h0, accuracy: float = 1.0e-4,
               dtype=torch.float64, device=None, mesh=None) -> "PME":
        alpha = ewald_alpha(accuracy, cutoff)
        h0 = np.asarray(h0, dtype=float)
        L = np.array([h0[0, 0], h0[1, 1], h0[2, 2]])
        if mesh is None:
            # the dense-Ewald k range with 2x headroom
            km = np.ceil(alpha * L / np.pi * np.sqrt(-np.log(accuracy)))
            mesh = tuple(_next_fast(int(4 * k + 1)) for k in km)

        def t(x):
            return torch.as_tensor(np.asarray(x, dtype=np.float64), dtype=dtype, device=device)

        return PME(charges=t(charges), cutoff=cutoff, alpha=alpha, mesh=tuple(mesh),
                   b2x=t(_euler_b2(mesh[0], SPLINE_ORDER)),
                   b2y=t(_euler_b2(mesh[1], SPLINE_ORDER)),
                   b2z=t(_euler_b2(mesh[2], SPLINE_ORDER)))

    def self_energy(self) -> torch.Tensor:
        return -self.qqr2e * self.alpha / math.sqrt(math.pi) * torch.sum(self.charges ** 2)

    def _spread(self, pos: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """B-spline charge assignment of pos (B, N, 3) in boxes h (B, 3, 3)
        -> (B, K1, K2, K3) meshes."""
        K = self.mesh
        p = self.order
        Bn, n = pos.shape[0], pos.shape[1]
        s = B.to_fractional(h, pos)
        s = s - torch.floor(s)  # [0, 1)
        u = s * torch.tensor(K, dtype=pos.dtype, device=pos.device)
        fl = torch.floor(u)
        frac = u - fl
        j = torch.arange(p, dtype=pos.dtype, device=pos.device)
        w = bspline_m(p, frac[..., None] + j)  # (B, N, 3, p): weight at grid fl - j
        g = fl.to(torch.int64)[..., None] - torch.arange(p, device=pos.device)
        g = torch.remainder(g, torch.tensor(K, device=pos.device)[:, None])
        wq = w[:, :, 0] * self.charges.to(pos.dtype)[:, None]  # (B, N, p)
        vals = (wq[:, :, :, None, None] * w[:, :, 1, None, :, None]
                * w[:, :, 2, None, None, :])  # (B, N, p, p, p)
        job = torch.arange(Bn, device=pos.device)[:, None, None, None, None]
        idx = (((job * K[0] + g[:, :, 0, :, None, None]) * K[1]
                + g[:, :, 1, None, :, None]) * K[2] + g[:, :, 2, None, None, :])
        rho = torch.zeros(Bn * K[0] * K[1] * K[2], dtype=pos.dtype, device=pos.device)
        rho = rho.index_add(0, idx.reshape(-1), vals.reshape(-1))
        return rho.reshape(Bn, *K)

    def reciprocal_energy(self, pos: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
        """(2 pi / V) sum_{k != 0} e^{-k^2/4a^2}/k^2 B(m) |F(rho)(m)|^2 per
        job: pos (B, N, 3), h (B, 3, 3) -> (B,).  Half spectrum: the K3
        axis of a real mesh's transform is conjugate-symmetric, so the
        interior columns count twice."""
        K = self.mesh
        dt, dev = pos.dtype, pos.device
        rho = self._spread(pos, h)
        F = torch.fft.rfftn(rho, dim=(1, 2, 3))  # (B, K1, K2, K3//2 + 1)
        L3 = K[2] // 2 + 1
        s2 = F.real ** 2 + F.imag ** 2
        mx = torch.fft.fftfreq(K[0], d=1.0 / K[0], dtype=dt, device=dev)
        my = torch.fft.fftfreq(K[1], d=1.0 / K[1], dtype=dt, device=dev)
        mz = torch.arange(L3, dtype=dt, device=dev)
        m3 = torch.stack(torch.meshgrid(mx, my, mz, indexing="ij"), -1)  # (K1, K2, L3, 3)
        k_cart = 2.0 * math.pi * (m3.reshape(-1, 3) @ B.inv_h(h))  # (B, M, 3)
        k2 = torch.sum(k_cart * k_cart, -1).reshape(-1, K[0], K[1], L3)
        Bm = (self.b2x.to(dt)[:, None, None] * self.b2y.to(dt)[None, :, None]
              * self.b2z.to(dt)[None, None, :L3])
        pref = torch.where(k2 > 0, torch.exp(-k2 / (4.0 * self.alpha ** 2))
                           / torch.where(k2 > 0, k2, torch.ones_like(k2)),
                           torch.zeros_like(k2))
        idx = torch.arange(L3, device=dev)
        single = (idx == 0) | (idx == K[2] // 2) if K[2] % 2 == 0 else idx == 0
        pref = pref * torch.where(single, 1.0, 2.0).to(dt)
        return self.qqr2e * (2.0 * math.pi / B.volume(h)) * torch.sum(pref * Bm * s2, (1, 2, 3))
