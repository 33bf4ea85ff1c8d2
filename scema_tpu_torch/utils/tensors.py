"""Symmetric-tensor math: Voigt packing, rank-4 stiffness, rotations.

Torch twin of ``scema_tpu/utils/tensors.py`` with the same conventions:

* Voigt-6 component order is ``[xx, yy, zz, xy, xz, yz]`` (deal.II
  ``SymmetricTensor<2,3>::access_raw_entry`` order, the reference's FE<->MD
  wire format).
* Off-diagonal Voigt entries store the plain tensor component.
* Rank-4 stiffness tensors are 6x6 matrices ``C66[I,J] = C_{i(I) j(I) k(J)
  l(J)}``; ``sigma = C : eps`` is ``sigma_I = C66[I,J] * w_J * eps_J`` with
  ``w = [1,1,1,2,2,2]``.

Every function broadcasts over leading batch dimensions.
"""
from __future__ import annotations

import torch

# Voigt index -> (i, j) tensor indices, deal.II raw-entry order.
VOIGT_IJ = ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
# Double-contraction weights for off-diagonal Voigt components.
VOIGT_WEIGHTS = (1.0, 1.0, 1.0, 2.0, 2.0, 2.0)
# (i, j) tensor pair -> Voigt index, inverse of VOIGT_IJ.
_PAIR_TO_VOIGT = ((0, 3, 4), (3, 1, 5), (4, 5, 2))


_KEPT_WEIGHTS: dict = {}


def voigt_weights(dtype=torch.float64, device=None) -> torch.Tensor:
    """``VOIGT_WEIGHTS`` as a tensor, made once per (dtype, device) by fills
    (no copy from the host, which would make the host wait for the device)
    and kept: callers only read it."""
    key = (dtype, None if device is None else torch.device(device))
    w = _KEPT_WEIGHTS.get(key)
    if w is None:
        w = torch.empty((6,), dtype=dtype, device=device)
        for i, x in enumerate(VOIGT_WEIGHTS):
            w[i].fill_(x)
        _KEPT_WEIGHTS[key] = w
    return w


def sym_to_voigt(t: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) symmetric tensor -> (..., 6) Voigt components."""
    return torch.stack([t[..., i, j] for (i, j) in VOIGT_IJ], dim=-1)


def voigt_to_sym(v: torch.Tensor) -> torch.Tensor:
    """(..., 6) Voigt -> (..., 3, 3) symmetric tensor."""
    xx, yy, zz, xy, xz, yz = v.unbind(-1)
    row0 = torch.stack([xx, xy, xz], dim=-1)
    row1 = torch.stack([xy, yy, yz], dim=-1)
    row2 = torch.stack([xz, yz, zz], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def voigt_norm(v: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of the symmetric tensor held in Voigt form
    (deal.II ``SymmetricTensor<2,3>::norm()``)."""
    w = voigt_weights(v.dtype, v.device)
    return torch.sqrt(torch.sum(w * v * v, dim=-1))


def sym_contract_c66(c66: torch.Tensor, eps_v: torch.Tensor) -> torch.Tensor:
    """sigma = C : eps in Voigt form: (..., 6, 6) x (..., 6) -> (..., 6)."""
    w = voigt_weights(eps_v.dtype, eps_v.device)
    return torch.einsum("...ij,...j->...i", c66, w * eps_v)


def c66_to_rank4(c66: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) -> full (..., 3, 3, 3, 3) with all minor symmetries."""
    idx = torch.tensor(_PAIR_TO_VOIGT, device=c66.device)
    return c66[..., idx[:, :, None, None], idx[None, None, :, :]]


def rank4_to_c66(c: torch.Tensor) -> torch.Tensor:
    """Full (..., 3, 3, 3, 3) -> (..., 6, 6) Voigt matrix."""
    ii = torch.tensor([p[0] for p in VOIGT_IJ], device=c.device)
    jj = torch.tensor([p[1] for p in VOIGT_IJ], device=c.device)
    return c[..., ii[:, None], jj[:, None], ii[None, :], jj[None, :]]


def compute_rotation_tensor(vorig: torch.Tensor, vdest: torch.Tensor) -> torch.Tensor:
    """Rotation matrix taking unit vector ``vorig`` onto ``vdest``
    (math_calc.h:23-50): ``R = I + S + S^2 / (1 + cos)`` with
    ``S[i][j] = vorig[j] * vdest[i] - vorig[i] * vdest[j]``."""
    eye = torch.eye(3, dtype=vorig.dtype, device=vorig.device)
    ccos = torch.sum(vorig * vdest, dim=-1)
    skew = (vdest[..., :, None] * vorig[..., None, :]
            - vorig[..., :, None] * vdest[..., None, :])
    return eye + skew + (1.0 / (1.0 + ccos))[..., None, None] * (skew @ skew)


def rotate_sym(t: torch.Tensor, rotam: torch.Tensor) -> torch.Tensor:
    """Rotate a symmetric (..., 3, 3) tensor: ``R t R^T``, symmetrized
    (math_calc.h:52-71)."""
    tmp = torch.einsum("...im,...mn,...jn->...ij", rotam, t, rotam)
    return 0.5 * (tmp + tmp.transpose(-1, -2))


def rotate_voigt(v: torch.Tensor, rotam: torch.Tensor) -> torch.Tensor:
    """Rotate a Voigt-packed symmetric tensor."""
    return sym_to_voigt(rotate_sym(voigt_to_sym(v), rotam))


def rotate_rank4(c: torch.Tensor, rotam: torch.Tensor) -> torch.Tensor:
    """Rotate a full rank-4 tensor on all indices (math_calc.h:73-100):
    ``C'_klst = C_mnpr R_km R_ln R_sp R_tr``."""
    return torch.einsum(
        "...mnpr,...km,...ln,...sp,...tr->...klst", c, rotam, rotam, rotam, rotam
    )


def rotate_c66(c66: torch.Tensor, rotam: torch.Tensor) -> torch.Tensor:
    """Rotate a Voigt 6x6 stiffness matrix (via the full rank-4 tensor)."""
    return rank4_to_c66(rotate_rank4(c66_to_rank4(c66), rotam))


def strain_from_grad(grad_u: torch.Tensor) -> torch.Tensor:
    """Small-strain tensor ``(grad + grad^T)/2`` (math_calc.h:121-137)."""
    return 0.5 * (grad_u + grad_u.transpose(-1, -2))


def isotropic_c66(E: float, nu: float, dtype=torch.float64, device=None) -> torch.Tensor:
    """Isotropic stiffness in the framework Voigt convention."""
    lam = E * nu / ((1 + nu) * (1 - 2 * nu))
    mu = E / (2 * (1 + nu))
    c = torch.zeros((6, 6), dtype=dtype, device=device)
    c[:3, :3] += lam
    for i in range(3):
        c[i, i] += 2 * mu
    for i in range(3, 6):
        c[i, i] = mu
    return c
