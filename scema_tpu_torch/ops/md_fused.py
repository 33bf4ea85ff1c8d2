"""K1 and K3: the fused all-pairs MD kernel — whole strain and sampling runs
of many MD jobs in one launch — and its host glue.

The port of the all-pairs LJ/OPLS branch of
``scema_tpu/ops/md_fused.py::_make_kernel`` (launched by ``fused_chunk``):
velocity Verlet with an NHC-3 thermostat (``nhc_half``), all-pairs LJ from
dense lj1/lj2 parameter planes with the special-bond weights folded in
(``forces_allpairs``), minimum image by sequential triclinic rounding
(``refresh_images``), chain bonds, angles and OPLS dihedrals
(``bonded_chain_forces``), the fix-deform remap (``_h_at``,
``_remap_coeffs``) and per-step virial-pressure sampling.  That is K1.

K3 is the same kernel with the charged all-atom additions compiled in (the
reference's OPLS material: ``lj/cut/coul/long`` + ``pppm`` + ``fix shake``):
a Coulomb pair force from a dense qq plane, plain cutoff or the damped
real-space Ewald form with the A&S erfc polynomial (``_ewald_fcoul``,
``erfc_poly``); offset-pattern bonded terms (``bonded_pattern_forces``);
Jacobi SHAKE/RATTLE over static partner offsets (``shake_rolls``,
``rattle_rolls``); and a frozen per-atom force ``fext`` — the smooth k-space
remainder, refreshed by the host every ``kspace_every`` steps — with per-job
step offsets so a chunk deforms along its whole run's path.  A runner whose
``spec.k3`` is set launches K3; any other launches K1.

Two entries, each a wrapper that launches ``csrc/md_allpairs.cu`` on CUDA
tensors (counting the launch: ``launches`` for K1, ``launches_k3`` for K3)
and runs the plain PyTorch version of the same function on CPU tensors:

* :func:`md_run` — one whole run (``deform`` and/or ``sample`` mode) of B
  jobs; the kernel runs one thread block per job.
* :func:`md_forces_virial` — one force + virial evaluation of B boxes (FIRE
  minimisation and the stiffness probe); the k-space remainder is added by
  the caller.

Layouts: a job's state is (6, N) rows ``[x y z vx vy vz]``; ``fscal`` rows
are ``[dt, T, lx, ly, lz, xy, xz, yz, exx, eyy, ezz, exy, exz, eyz, 0, 0]``.
A job with ``n_run = 0`` is left bit-identical (the TPU's one-step ``dt = 0``
padding job is a Mosaic workaround and is not ported).
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..md import box as B
from ..md.forcefields.coulomb import QQR2E_REAL
from . import _build

NHC_LEN = 3

# fscal layout
F_DT, F_T, F_H0, F_EPS, FSCAL = 0, 1, 2, 8, 16

# topo rows (chain-structured bonded terms; term k starts at atom k),
# the same row numbering as the JAX package's pack_topo
T_BMASK, T_BK, T_BR0 = 0, 1, 2  # bond (k, k+1)
T_AMASK, T_AK, T_ATH0 = 3, 4, 5  # angle (k, k+1, k+2)
T_DMASK, T_DK1 = 6, 7  # dihedral (k..k+3), OPLS K1..K4 in rows 7..10
TOPO = 16

# 2/sqrt(pi) — LAMMPS pair_lj_cut_coul_long's EWALD_F
EWALD_F = 1.12837916709551257
# pack_patterns / pack_shake bounds (the kernel's MAXPAT and MAXSHK)
MAX_PATTERNS, MAX_PATTERN_OFFSET, MAX_SHAKE_OFFSET = 64, 32, 8
_PATTERN_KIND = {"bond": 0, "angle": 1, "dihedral": 2}


@dataclass(frozen=True)
class FusedSpec:
    """Static configuration of K1/K3 for one MD system."""

    n_atoms: int
    cutoff2: float  # LJ cutoff squared
    ndof: int  # thermostat degrees of freedom (3N - 3 - constraints)
    boltz: float
    ftm2v: float
    nktv2p: float
    tdamp: float = 100.0
    r2min: float = 0.25  # close-range clamp (forcefields/lj.py semantics)
    # K3 flags: Coulomb from the qq plane inside coul_cutoff2 ...
    coul: bool = False
    coul_cutoff2: float = 0.0
    # ... in the damped real-space Ewald form when > 0
    ewald_alpha: float = 0.0
    # frozen k-space remainder force channel (and per-job step offsets)
    fext: bool = False
    # offset patterns (pack_patterns) in place of the chain terms
    bonded_pattern: tuple = ()
    # SHAKE/RATTLE partner offsets (pack_shake)
    shake_offsets: tuple = ()
    shake_iters: int = 20  # fix shake's iteration bound
    rattle_iters: int = 10
    shake_relax: float = 0.8

    @property
    def k3(self) -> bool:
        """Any charged all-atom addition on: the runner launches K3."""
        return self.coul or self.fext or bool(self.bonded_pattern) or bool(self.shake_offsets)

    @property
    def flags(self) -> str:
        """K3's compile-time flag set of this runner ("none" for K1)."""
        on = [name for name, v in (("COUL", self.coul), ("EWALD", self.ewald_alpha > 0.0),
                                   ("PATTERNS", bool(self.bonded_pattern)),
                                   ("SHAKE", bool(self.shake_offsets)), ("FEXT", self.fext))
              if v]
        return "+".join(on) or "none"


@dataclass(frozen=True)
class FusedRunner:
    """Position-independent device inputs of K1/K3 for one MD system."""

    spec: FusedSpec
    invm: torch.Tensor  # (N,) ftm2v / m
    mftm: torch.Tensor  # (N,) m / ftm2v
    lj1: torch.Tensor  # (N, N) 48 eps sig^12 w, zero diagonal
    lj2: torch.Tensor  # (N, N) 24 eps sig^6 w
    topo: torch.Tensor  # (16, N) chain-term rows (zero with patterns)
    qq: torch.Tensor | None = None  # (N, N) qqr2e q_i q_j w_coul (COUL)
    pat: torch.Tensor | None = None  # (R, N) pattern parameter rows (PATTERNS)
    shk: torch.Tensor | None = None  # (n_off, N) SHAKE d0^2 rows (SHAKE)
    # smooth k-space remainder: kspace(pos (B, N, 3), h (B, 3, 3),
    # want_virial) -> (F (B, N, 3), W (B, 6) or None), refreshed every
    # kspace_every steps (material.build_kspace_split)
    kspace: object = None
    kspace_every: int = 10

    def to(self, device=None, dtype=None) -> "FusedRunner":
        def mv(x):
            return None if x is None else x.to(device=device, dtype=dtype).contiguous()

        return replace(self, invm=mv(self.invm), mftm=mv(self.mftm), lj1=mv(self.lj1),
                       lj2=mv(self.lj2), topo=mv(self.topo), qq=mv(self.qq),
                       pat=mv(self.pat), shk=mv(self.shk))


def pack_topo(ff, n_atoms: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Linear-chain topology -> (16, N) per-atom term rows (the JAX
    package's ``pack_topo``, md_fused.py:2087).  Every bond must be
    (i, i+1), every angle (i, i+1, i+2), every dihedral (i..i+3), and there
    may be no impropers; anything else raises ValueError."""
    rows = np.zeros((TOPO, n_atoms), dtype=np.float64)
    for arr, name, width in ((ff.bonds, "bond", 2), (ff.angles, "angle", 3),
                             (ff.dihedrals, "dihedral", 4)):
        arr = np.asarray(arr)
        if arr.shape[0] and not (arr == arr[:, :1] + np.arange(width)[None, :]).all():
            raise ValueError(f"pack_topo: non-chain {name} topology")
    if np.asarray(ff.impropers).shape[0]:
        raise ValueError("pack_topo: impropers not supported in chain mode")
    bk, br0 = ff.bond_k.cpu().double().numpy(), ff.bond_r0.cpu().double().numpy()
    for (i, _), t in zip(np.asarray(ff.bonds), np.asarray(ff.bond_type)):
        if t >= 0:
            rows[T_BMASK, i], rows[T_BK, i], rows[T_BR0, i] = 1.0, bk[t], br0[t]
    ak, ath = ff.angle_k.cpu().double().numpy(), ff.angle_theta0.cpu().double().numpy()
    for (i, _, _), t in zip(np.asarray(ff.angles), np.asarray(ff.angle_type)):
        if t >= 0:
            rows[T_AMASK, i], rows[T_AK, i], rows[T_ATH0, i] = 1.0, ak[t], ath[t]
    dk = ff.dihedral_k.cpu().double().numpy()
    for (i, *_), t in zip(np.asarray(ff.dihedrals), np.asarray(ff.dihedral_type)):
        if t >= 0:
            rows[T_DMASK, i] = 1.0
            rows[T_DK1:T_DK1 + 4, i] = dk[t]
    return torch.as_tensor(rows, dtype=dtype, device=device)


def pack_patterns(ff, n_atoms: int, dtype=torch.float64, device=None):
    """Topology -> (static pattern tuple, (R, N) parameter rows) — the JAX
    package's ``pack_patterns`` (md_fused.py:609) without the lane padding.

    Every term is binned by its atom-index offsets from an anchor: bond
    (a, a+o) -> ("bond", o), rows [K, r0]; angle centred at a with partners
    a+oa, a+ob -> ("angle", oa, ob), rows [K, th0]; dihedral (a, a+ob, a+oc,
    a+od) -> ("dihedral", ob, oc, od), rows [K1..K4].  Raises ValueError for
    impropers, more than 64 patterns or an offset of 32 or more."""
    if np.asarray(ff.impropers).shape[0]:
        raise ValueError("pack_patterns: impropers not supported")
    groups: dict[tuple, dict[int, tuple]] = {}

    def add(key, anchor, params):
        g = groups.setdefault(key, {})
        if anchor in g:
            raise ValueError(f"pack_patterns: duplicate {key} at {anchor}")
        g[anchor] = params

    bk, br0 = ff.bond_k.cpu().double().numpy(), ff.bond_r0.cpu().double().numpy()
    for (i, j), t in zip(np.asarray(ff.bonds), np.asarray(ff.bond_type)):
        if t >= 0:
            a, b = (int(i), int(j)) if j > i else (int(j), int(i))
            add(("bond", b - a), a, (bk[t], br0[t]))
    ak, ath = ff.angle_k.cpu().double().numpy(), ff.angle_theta0.cpu().double().numpy()
    for (i, j, k), t in zip(np.asarray(ff.angles), np.asarray(ff.angle_type)):
        if t >= 0:
            oa, ob = sorted((int(i) - int(j), int(k) - int(j)))
            add(("angle", oa, ob), int(j), (ak[t], ath[t]))
    dk = ff.dihedral_k.cpu().double().numpy()
    for (a, b, c, d), t in zip(np.asarray(ff.dihedrals), np.asarray(ff.dihedral_type)):
        if t >= 0:
            a, b, c, d = int(a), int(b), int(c), int(d)
            add(("dihedral", b - a, c - a, d - a), a, tuple(dk[t]))
    if len(groups) > MAX_PATTERNS:
        raise ValueError(f"pack_patterns: {len(groups)} patterns > {MAX_PATTERNS} "
                         "(irregular topology)")
    for key in groups:
        if any(abs(o) >= MAX_PATTERN_OFFSET for o in key[1:]):
            raise ValueError(f"pack_patterns: offset too large in {key}")
    patterns = tuple(sorted(groups.keys(), key=str))
    rows = []
    for key in patterns:
        block = np.zeros((2 if key[0] in ("bond", "angle") else 4, n_atoms))
        for anchor, params in groups[key].items():
            block[:, anchor] = params
        rows.append(block)
    rows = np.concatenate(rows) if rows else np.zeros((0, n_atoms))
    return patterns, torch.as_tensor(rows, dtype=dtype, device=device)


def pack_shake(cons_idx, d0, n_atoms: int, dtype=torch.float64, device=None):
    """Constraints -> (static offsets tuple, (n_off, N) d0^2 rows) — the JAX
    package's ``pack_shake`` (md_fused.py:492) without the lane padding.
    Each constraint (i, j) sits at anchor min(i, j) in the row of its
    offset |j - i| < 8 (the [C H H (H)] layout gives 1..3); a zero entry
    disables the slot."""
    groups: dict[int, dict[int, float]] = {}
    for (i, j), d in zip(np.asarray(cons_idx), np.asarray(d0)):
        a, b = (int(i), int(j)) if j > i else (int(j), int(i))
        o = b - a
        if o >= MAX_SHAKE_OFFSET:
            raise ValueError(f"pack_shake: constraint offset {o} too large")
        g = groups.setdefault(o, {})
        if a in g:
            raise ValueError(f"pack_shake: duplicate constraint at {a}+{o}")
        g[a] = float(d)
    offsets = tuple(sorted(groups))
    rows = np.zeros((len(offsets), n_atoms))
    for k, o in enumerate(offsets):
        for a, d in groups[o].items():
            rows[k, a] = d * d
    return offsets, torch.as_tensor(rows, dtype=dtype, device=device)


def dense_planes(ff, dtype=torch.float64, device=None):
    """Dense (N, N) LAMMPS pair_lj force coefficients with the special-bond
    weights folded in (material.py:397-424): lj1 = 48 eps sig^12 w,
    lj2 = 24 eps sig^6 w, so that F/r = lj1/r^14 - lj2/r^8."""
    types = ff.types.cpu().numpy()
    eps = ff.lj_epsilon.cpu().double().numpy()[types[:, None], types[None, :]]
    sig = ff.lj_sigma.cpu().double().numpy()[types[:, None], types[None, :]]
    W = ff.pair_weights(ff.special_lj)
    sig6 = sig ** 6
    lj1 = 48.0 * eps * sig6 * sig6 * W
    lj2 = 24.0 * eps * sig6 * W
    return (torch.as_tensor(lj1, dtype=dtype, device=device),
            torch.as_tensor(lj2, dtype=dtype, device=device))


def dense_qq(ff, dtype=torch.float64, device=None) -> torch.Tensor:
    """Dense (N, N) Coulomb plane qqr2e q_i q_j w with the Coulomb
    special-bond weights (special_coul, separate from LJ's; material.py:
    425-433), zero diagonal."""
    q = ff.charges.cpu().double().numpy() * np.sqrt(QQR2E_REAL)
    return torch.as_tensor(q[:, None] * q[None, :] * ff.pair_weights(ff.special_coul),
                           dtype=dtype, device=device)


def make_runner(ff, masses: torch.Tensor, units, tdamp: float = 100.0,
                dtype=torch.float64, device=None, constraints=None, kspace=None,
                kspace_every: int = 10) -> FusedRunner:
    """K1's or K3's inputs for one system.

    A linear-chain topology takes the chain terms, any other the offset
    patterns; nonzero charges add the qq plane (cutoff Coulomb, or the
    real-space Ewald form when ``ff.ewald`` is set — then ``kspace``, the
    smooth remainder from ``material.build_kspace_split``, is required);
    ``constraints`` add SHAKE/RATTLE.  What no kernel of the port runs yet
    — impropers, irregular topologies, wide constraint offsets, for which
    the JAX package falls back to its XLA path — raises
    NotImplementedError."""
    n = int(masses.shape[0])
    m = masses.to(torch.float64).cpu()
    patterns, pat = (), None
    try:
        topo = pack_topo(ff, n, dtype, device)
    except ValueError:
        try:
            patterns, pat = pack_patterns(ff, n, dtype, device)
        except ValueError as e:
            raise NotImplementedError(
                f"{e}: the XLA bonded path for such topologies is not ported "
                "(ROADMAP queue 1)") from e
        topo = torch.zeros((TOPO, n), dtype=dtype, device=device)
    coul = bool(torch.any(ff.charges != 0))
    ewald = ff.ewald
    if (ewald is None) != (kspace is None):
        raise ValueError("make_runner: the k-space remainder (material.build_kspace_split) "
                         "goes with an Ewald/PME force field, and only with one")
    shake_offsets, shk, n_cons = (), None, 0
    if constraints is not None and len(constraints.idx):
        try:
            shake_offsets, shk = pack_shake(constraints.idx, constraints.d0, n, dtype, device)
        except ValueError as e:
            raise NotImplementedError(
                f"{e}: the segment-sum SHAKE path is not ported (ROADMAP queue 1)") from e
        n_cons = int(torch.count_nonzero(shk))
    spec = FusedSpec(n_atoms=n, cutoff2=float(ff.lj_cutoff) ** 2, ndof=3 * n - 3 - n_cons,
                     boltz=units.boltz, ftm2v=units.ftm2v, nktv2p=units.nktv2p,
                     tdamp=tdamp, coul=coul, coul_cutoff2=float(ff.coul_cutoff) ** 2,
                     ewald_alpha=float(ewald.alpha) if ewald is not None else 0.0,
                     fext=ewald is not None, bonded_pattern=patterns,
                     shake_offsets=shake_offsets)
    lj1, lj2 = dense_planes(ff, dtype, device)
    return FusedRunner(
        spec=spec,
        invm=torch.where(m > 0, units.ftm2v / m, torch.zeros_like(m)).to(device=device, dtype=dtype),
        mftm=(m / units.ftm2v).to(device=device, dtype=dtype),
        lj1=lj1, lj2=lj2, topo=topo,
        qq=dense_qq(ff, dtype, device) if coul else None, pat=pat, shk=shk,
        kspace=kspace, kspace_every=kspace_every)


# --------------------------------------------------------------------------
# Plain PyTorch version of K1/K3 (batched over jobs; same math and layout)


def _fwd(x, o=1):  # y[..., k] = x[..., k + o]
    return torch.roll(x, -o, dims=-1)


def _bwd(x, o=1):  # y[..., k] = x[..., k - o]
    return torch.roll(x, o, dims=-1)


def _sh(x, o):  # y[..., i] = x[..., i + o] (make_shift_o off the kernel)
    return torch.roll(x, -o, dims=-1) if o else x


def _sym6(W):
    """Voigt-6 of the symmetric part of 3x3 sums held as {(a, b): tensor}."""
    return [W[0, 0], W[1, 1], W[2, 2], 0.5 * (W[0, 1] + W[1, 0]),
            0.5 * (W[0, 2] + W[2, 0]), 0.5 * (W[1, 2] + W[2, 1])]


def _outer_add(W, F, d):
    for a in range(3):
        for b in range(3):
            W[a, b] = W[a, b] + torch.sum(F[a] * d[b], dim=-1)


def erfc_poly(x, ex):
    """erfc(x) for x >= 0 by Abramowitz-Stegun 7.1.26, given ex = exp(-x^2)
    (shared with the Ewald damped-force factor; |err| <= 1.5e-7) — the
    polynomial the TPU kernel and LAMMPS's pair_lj_cut_coul_long use."""
    t = 1.0 / (1.0 + 0.3275911 * x)
    return t * ex * (0.254829592 + t * (-0.284496736 + t * (
        1.421413741 + t * (-1.453152027 + t * 1.061405429))))


def ewald_fcoul(qq, r2c, inv_r, inv_r2, alpha: float):
    """Damped real-space Ewald pair force factor F/r = qq (erfc(x)/r +
    EWALD_F a e^{-x^2}) / r^2 with x = a r (``_ewald_fcoul``)."""
    x = alpha * (r2c * inv_r)
    ex = torch.exp(-x * x)
    return qq * inv_r2 * (erfc_poly(x, ex) * inv_r + EWALD_F * alpha * ex)


def bonded_chain_forces_plain(p, topo):
    """Chain bonded forces (bond_style harmonic, angle_style harmonic,
    dihedral_style opls) on (B, N) position rows ``p = (px, py, pz)`` —
    the hand-derived formulas of ``bonded_chain_forces`` (md_fused.py:349).
    Returns ((fx, fy, fz), W) with W the 3x3 virial sums
    sum_terms sum_roles F_r (x) (r_{k+r} - r_k)."""
    dt = p[0].dtype
    bm = topo[T_BMASK] > 0.5
    am = topo[T_AMASK] > 0.5
    dm = topo[T_DMASK] > 0.5
    zero = torch.zeros((), dtype=dt, device=p[0].device)
    one = torch.ones((), dtype=dt, device=p[0].device)
    b = [_fwd(x) - x for x in p]  # b_k = p_{k+1} - p_k
    r2b = b[0] * b[0] + b[1] * b[1] + b[2] * b[2]
    W = {(a, c): torch.zeros_like(p[0][..., 0]) for a in range(3) for c in range(3)}

    # bonds: E = K (r - r0)^2 ; role 0 gets +fb b, role 1 gets -fb b
    rb = torch.sqrt(torch.where(bm, r2b, one))
    fb = torch.where(bm, 2.0 * topo[T_BK] * (rb - topo[T_BR0]) / rb, zero)
    f = [fb * x - _bwd(fb * x) for x in b]
    _outer_add(W, [-fb * x for x in b], b)

    # angles (k, k+1, k+2): r1 = -b_k, r2 = b_{k+1}
    b2 = [_fwd(x) for x in b]
    d11 = torch.where(am, r2b, one)
    d22 = torch.where(am, _fwd(r2b), one)
    d12 = -(b[0] * b2[0] + b[1] * b2[1] + b[2] * b2[2])
    inv12 = torch.rsqrt(d11 * d22)
    c = torch.clamp(d12 * inv12, -1.0 + 1e-7, 1.0 - 1e-7)
    sin_th = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-30))
    aE = torch.where(am, -2.0 * topo[T_AK] * (torch.arccos(c) - topo[T_ATH0]) / sin_th, zero)
    g1 = [b2[a] * inv12 + c * b[a] / d11 for a in range(3)]
    g2 = [-b[a] * inv12 - c * b2[a] / d22 for a in range(3)]
    f = [f[a] - aE * g1[a] + _bwd(aE * (g1[a] + g2[a])) - _bwd(aE * g2[a], 2)
         for a in range(3)]
    _outer_add(W, [-aE * x for x in g1], [-x for x in b])
    _outer_add(W, [-aE * x for x in g2], b2)

    # OPLS dihedrals (k..k+3): b1 = b_k, b2 = b_{k+1}, b3 = b_{k+2}
    b3 = [_fwd(x) for x in b2]
    F = _dihedral_roles(b, b2, b3, dm, [topo[T_DK1 + i] for i in range(4)])
    f = [f[a] + F[0][a] + _bwd(F[1][a]) + _bwd(F[2][a], 2) + _bwd(F[3][a], 3)
         for a in range(3)]
    s12 = [b[a] + b2[a] for a in range(3)]
    s123 = [s12[a] + b3[a] for a in range(3)]
    _outer_add(W, F[1], b)
    _outer_add(W, F[2], s12)
    _outer_add(W, F[3], s123)
    return f, W


def _dihedral_roles(b1, b2, b3, mask, K):
    """OPLS dihedral role forces [F0, F1, F2, F3] (each [x, y, z]) on the
    bond vectors b1, b2, b3 — the Blondel-Karplus gradient; masked terms
    give zero."""
    one = torch.ones((), dtype=b1[0].dtype, device=b1[0].device)
    zero = torch.zeros_like(one)
    n1 = [b1[1] * b2[2] - b1[2] * b2[1], b1[2] * b2[0] - b1[0] * b2[2],
          b1[0] * b2[1] - b1[1] * b2[0]]
    n2 = [b2[1] * b3[2] - b2[2] * b3[1], b2[2] * b3[0] - b2[0] * b3[2],
          b2[0] * b3[1] - b2[1] * b3[0]]
    n1sq = torch.where(mask, n1[0] ** 2 + n1[1] ** 2 + n1[2] ** 2, one)
    n2sq = torch.where(mask, n2[0] ** 2 + n2[1] ** 2 + n2[2] ** 2, one)
    b2sq = torch.where(mask, b2[0] ** 2 + b2[1] ** 2 + b2[2] ** 2, one)
    nb2 = torch.sqrt(b2sq)
    inv_nn = torch.rsqrt(n1sq * n2sq)
    cphi = (n1[0] * n2[0] + n1[1] * n2[1] + n1[2] * n2[2]) * inv_nn
    cx = [n1[1] * n2[2] - n1[2] * n2[1], n1[2] * n2[0] - n1[0] * n2[2],
          n1[0] * n2[1] - n1[1] * n2[0]]
    s = (cx[0] * b2[0] + cx[1] * b2[1] + cx[2] * b2[2]) * inv_nn / nb2
    sin2 = 2.0 * s * cphi
    sin3 = s * (3.0 - 4.0 * s * s)
    cos2 = 1.0 - 2.0 * s * s
    sin4 = 2.0 * sin2 * cos2
    K1, K2, K3, K4 = K
    dE = torch.where(mask, 0.5 * (-K1 * s + 2.0 * K2 * sin2 - 3.0 * K3 * sin3
                                  + 4.0 * K4 * sin4), zero)
    c0 = nb2 / n1sq
    c3 = nb2 / n2sq
    ts = (b1[0] * b2[0] + b1[1] * b2[1] + b1[2] * b2[2]) / b2sq
    tu = (b3[0] * b2[0] + b3[1] * b2[1] + b3[2] * b2[2]) / b2sq
    dp0 = [-c0 * x for x in n1]
    dp3 = [c3 * x for x in n2]
    dp1 = [-(1.0 + ts) * dp0[a] + tu * dp3[a] for a in range(3)]
    dp2 = [ts * dp0[a] - (1.0 + tu) * dp3[a] for a in range(3)]
    return [[-dE * d[a] for a in range(3)] for d in (dp0, dp1, dp2, dp3)]


def bonded_pattern_forces_plain(p, rows, patterns):
    """Offset-pattern bonded forces on (B, N) position rows — the formulas
    of ``bonded_pattern_forces`` (md_fused.py:674) with the exact acos.
    Returns ((fx, fy, fz), w6) with w6 the Voigt virial sum_i f_i (x) r_i
    over the pattern forces (list of six (B,))."""
    dt = p[0].dtype
    one = torch.ones((), dtype=dt, device=p[0].device)
    zero = torch.zeros_like(one)
    f = [torch.zeros_like(x) for x in p]

    def at(o):
        return [_sh(x, o) for x in p]

    r = 0
    for key in patterns:
        kind = key[0]
        if kind == "bond":
            (o,) = key[1:]
            K, r0 = rows[r], rows[r + 1]
            r += 2
            mask = K > 0.0
            b = [q - x for q, x in zip(at(o), p)]
            r2b = b[0] * b[0] + b[1] * b[1] + b[2] * b[2]
            rb = torch.sqrt(torch.where(mask, r2b, one))
            fb = torch.where(mask, 2.0 * K * (rb - r0) / rb, zero)
            g = [fb * x for x in b]
            f = [f[a] + g[a] - _sh(g[a], -o) for a in range(3)]
        elif kind == "angle":
            oa, ob = key[1:]
            K, th0 = rows[r], rows[r + 1]
            r += 2
            mask = K > 0.0
            r1 = [q - x for q, x in zip(at(oa), p)]
            r2 = [q - x for q, x in zip(at(ob), p)]
            d11 = torch.where(mask, r1[0] * r1[0] + r1[1] * r1[1] + r1[2] * r1[2], one)
            d22 = torch.where(mask, r2[0] * r2[0] + r2[1] * r2[1] + r2[2] * r2[2], one)
            d12 = r1[0] * r2[0] + r1[1] * r2[1] + r1[2] * r2[2]
            inv12 = torch.rsqrt(d11 * d22)
            c = torch.clamp(d12 * inv12, -1.0 + 1e-7, 1.0 - 1e-7)
            sin_th = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-30))
            aE = torch.where(mask, -2.0 * K * (torch.arccos(c) - th0) / sin_th, zero)
            g1 = [r2[a] * inv12 - c * r1[a] / d11 for a in range(3)]
            g2 = [r1[a] * inv12 - c * r2[a] / d22 for a in range(3)]
            f = [f[a] + aE * (g1[a] + g2[a]) - _sh(aE * g1[a], -oa) - _sh(aE * g2[a], -ob)
                 for a in range(3)]
        else:  # dihedral (i, i+ob, i+oc, i+od)
            ob, oc, od = key[1:]
            Ks = [rows[r + i] for i in range(4)]
            r += 4
            mask = (torch.abs(Ks[0]) + torch.abs(Ks[1]) + torch.abs(Ks[2])
                    + torch.abs(Ks[3])) > 0.0
            p1, p2, p3 = at(ob), at(oc), at(od)
            b1 = [p1[a] - p[a] for a in range(3)]
            b2 = [p2[a] - p1[a] for a in range(3)]
            b3 = [p3[a] - p2[a] for a in range(3)]
            F = _dihedral_roles(b1, b2, b3, mask, Ks)
            f = [f[a] + F[0][a] + _sh(F[1][a], -ob) + _sh(F[2][a], -oc) + _sh(F[3][a], -od)
                 for a in range(3)]
    w6 = [torch.sum(f[0] * p[0], -1), torch.sum(f[1] * p[1], -1), torch.sum(f[2] * p[2], -1),
          0.5 * torch.sum(f[0] * p[1] + f[1] * p[0], -1),
          0.5 * torch.sum(f[0] * p[2] + f[2] * p[0], -1),
          0.5 * torch.sum(f[1] * p[2] + f[2] * p[1], -1)]
    return f, w6


def shake_rolls_plain(p, p_old, invm, offsets, rows, n_iters: int = 20,
                      relax: float = 0.8):
    """Jacobi SHAKE on (B, N) position rows (``shake_rolls``): ``n_iters``
    sweeps, each applying every constraint's under-relaxed Lagrange
    correction along its pre-drift direction.  ``invm`` may carry any
    constant factor (it cancels).  Returns the corrected rows."""
    masks = [rows[k] > 0.0 for k in range(len(offsets))]
    winv = [invm + _sh(invm, o) for o in offsets]
    invm_j = [_sh(invm, o) for o in offsets]
    old = [[_sh(c, o) - c for c in p_old] for o in offsets]
    zero = torch.zeros((), dtype=p[0].dtype, device=p[0].device)
    for _ in range(n_iters):
        acc = [torch.zeros_like(x) for x in p]
        for k, o in enumerate(offsets):
            rr = [_sh(x, o) - x for x in p]
            ok = old[k]
            diff = rr[0] * rr[0] + rr[1] * rr[1] + rr[2] * rr[2] - rows[k]
            denom = 2.0 * (rr[0] * ok[0] + rr[1] * ok[1] + rr[2] * ok[2]) * winv[k] + 1e-30
            g = torch.where(masks[k], relax * diff / denom, zero)
            for a in range(3):
                c = g * ok[a]
                acc[a] = acc[a] + c * invm - _sh(c * invm_j[k], -o)
        p = [p[a] + acc[a] for a in range(3)]
    return p


def rattle_rolls_plain(v, p, invm, offsets, rows, n_iters: int = 10,
                       relax: float = 0.8):
    """Jacobi RATTLE on (B, N) velocity rows (``rattle_rolls``): remove the
    relative velocity along every constrained bond."""
    masks = [rows[k] > 0.0 for k in range(len(offsets))]
    winv = [invm + _sh(invm, o) for o in offsets]
    invm_j = [_sh(invm, o) for o in offsets]
    geo = []
    for o in offsets:
        rr = [_sh(x, o) - x for x in p]
        geo.append((rr, rr[0] * rr[0] + rr[1] * rr[1] + rr[2] * rr[2]))
    zero = torch.zeros((), dtype=v[0].dtype, device=v[0].device)
    for _ in range(n_iters):
        acc = [torch.zeros_like(x) for x in v]
        for k, o in enumerate(offsets):
            rr, r2 = geo[k]
            dv = [_sh(x, o) - x for x in v]
            kk = torch.where(masks[k], relax * (dv[0] * rr[0] + dv[1] * rr[1] + dv[2] * rr[2])
                             / (r2 * winv[k] + 1e-30), zero)
            for a in range(3):
                c = kk * rr[a]
                acc[a] = acc[a] + c * invm - _sh(c * invm_j[k], -o)
        v = [v[a] + acc[a] for a in range(3)]
    return v


# (B, N, N) pair planes per slice of jobs in the plain pair loop
_PLAIN_PAIRS = 1 << 24


def _pair_forces_plain(runner: FusedRunner, p, h6, want_virial: bool):
    """All-pairs LJ (+ Coulomb) with per-pair sequential triclinic minimum
    image on (B, N) rows, in slices of jobs to bound the (B, N, N) planes.
    Returns ((fx, fy, fz), w6 list of (B,) or None)."""
    spec = runner.spec
    n = p[0].shape[-1]
    step = max(1, _PLAIN_PAIRS // max(n * n, 1))
    parts = []
    for s in range(0, p[0].shape[0], step):
        sl = slice(s, s + step)
        parts.append(_pair_block_plain(runner, spec, [x[sl] for x in p],
                                       [h[sl] for h in h6], want_virial))
    f = [torch.cat([pt[0][a] for pt in parts]) for a in range(3)]
    w6 = [torch.cat([pt[1][k] for pt in parts]) for k in range(6)] if want_virial else None
    return f, w6


def _pair_block_plain(runner, spec, p, h6, want_virial):
    lx, ly, lz, xy, xz, yz = (h[:, None, None] for h in h6)
    # d[b, i, j] = r_j - r_i (source minus target)
    dx = p[0][:, None, :] - p[0][:, :, None]
    dy = p[1][:, None, :] - p[1][:, :, None]
    dz = p[2][:, None, :] - p[2][:, :, None]
    n3 = torch.round(dz / lz)
    dz = dz - n3 * lz
    dy = dy - n3 * yz
    n2 = torch.round(dy / ly)
    dy = dy - n2 * ly
    dx = dx - n3 * xz - n2 * xy
    n1 = torch.round(dx / lx)
    dx = dx - n1 * lx
    r2 = dx * dx + dy * dy + dz * dz
    r2c = torch.clamp(r2, min=spec.r2min)
    zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
    if spec.coul:
        inv_r = torch.rsqrt(r2c)
        inv_r2 = inv_r * inv_r
    else:
        inv_r2 = 1.0 / r2c
    u2 = inv_r2 * inv_r2
    u3 = u2 * inv_r2
    fpair = torch.where(r2 < spec.cutoff2, (runner.lj1 * u3 - runner.lj2) * u2 * u2, zero)
    if spec.coul:
        if spec.ewald_alpha > 0.0:
            fcoul = ewald_fcoul(runner.qq, r2c, inv_r, inv_r2, spec.ewald_alpha)
        else:
            fcoul = runner.qq * inv_r * inv_r2
        fpair = fpair + torch.where(r2 < spec.coul_cutoff2, fcoul, zero)
    f = [-(fpair * d).sum(-1) for d in (dx, dy, dz)]
    w6 = None
    if want_virial:
        w6 = [0.5 * (fpair * u * v).sum((-1, -2))
              for u, v in ((dx, dx), (dy, dy), (dz, dz), (dx, dy), (dx, dz), (dy, dz))]
    return f, w6


def _forces_plain(runner: FusedRunner, p, h6, want_virial: bool):
    """Pair + bonded (chain or pattern) forces on (B, N) rows; h6 is a list
    of six (B,) box scalars.  Returns ((fx, fy, fz), w6 list of (B,) or
    None).  The frozen k-space force is not included."""
    f, w6 = _pair_forces_plain(runner, p, h6, want_virial)
    if runner.spec.bonded_pattern:
        fb, wb = bonded_pattern_forces_plain(p, runner.pat, runner.spec.bonded_pattern)
    else:
        fb, Wb = bonded_chain_forces_plain(p, runner.topo)
        wb = _sym6(Wb)
    f = [f[a] + fb[a] for a in range(3)]
    if want_virial:
        w6 = [a + b for a, b in zip(w6, wb)]
    return f, w6


def _h_at(h0, eps, frac):
    """deform_path on scalar rows: lengths scale, tilts shift (_h_at :814)."""
    lx0, ly0, lz0, xy0, xz0, yz0 = h0
    return [lx0 * (1.0 + frac * eps[0]), ly0 * (1.0 + frac * eps[1]),
            lz0 * (1.0 + frac * eps[2]), xy0 + frac * eps[3] * ly0,
            xz0 + frac * eps[4] * lz0, yz0 + frac * eps[5] * lz0]


def _remap_coeffs(h_old, h_new):
    """Upper-triangular A = h_new @ inv(h_old) (_remap_coeffs :827)."""
    lx, ly, lz, xy, xz, yz = h_old
    nlx, nly, nlz, nxy, nxz, nyz = h_new
    i00, i11, i22 = 1.0 / lx, 1.0 / ly, 1.0 / lz
    i01 = -xy / (lx * ly)
    i12 = -yz / (ly * lz)
    i02 = (xy * yz - xz * ly) / (lx * ly * lz)
    return (nlx * i00, nlx * i01 + nxy * i11, nlx * i02 + nxy * i12 + nxz * i22,
            nly * i11, nly * i12 + nyz * i22, nlz * i22)


def _nhc_half(runner, v, vxi, dt, T):
    """Half-step Nose-Hoover chain (MTK) on (B, N) velocity rows with
    per-job dt and T (B,); vxi is a list of three (B,) tensors
    (``nhc_half`` :1413 / engine._nhc_half)."""
    spec = runner.spec
    kt = spec.boltz * T
    q = [spec.ndof * kt * spec.tdamp ** 2] + [kt * spec.tdamp ** 2] * (NHC_LEN - 1)
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0
    ke2 = torch.sum(runner.mftm * (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), -1)
    vxi = list(vxi)

    def g(k, ke2_):
        if k == 0:
            return (ke2_ - spec.ndof * kt) / q[0]
        return (q[k - 1] * vxi[k - 1] ** 2 - kt) / q[k]

    for k in range(NHC_LEN - 1, -1, -1):
        if k == NHC_LEN - 1:
            vxi[k] = vxi[k] + dt4 * g(k, ke2)
        else:
            s = torch.exp(-dt8 * vxi[k + 1])
            vxi[k] = s * (s * vxi[k] + dt4 * g(k, ke2))
    scale = torch.exp(-dt2 * vxi[0])
    v = [x * scale[:, None] for x in v]
    ke2 = ke2 * scale * scale
    for k in range(NHC_LEN):
        if k == NHC_LEN - 1:
            vxi[k] = vxi[k] + dt4 * g(k, ke2)
        else:
            s = torch.exp(-dt8 * vxi[k + 1])
            vxi[k] = s * (s * vxi[k] + dt4 * g(k, ke2))
    return v, vxi


def md_run_plain(runner: FusedRunner, state: torch.Tensor, vxi: torch.Tensor,
                 n_run: torch.Tensor, fscal: torch.Tensor, deform: bool,
                 sample: bool, fext: torch.Tensor | None = None,
                 gstep0: torch.Tensor | None = None, n_tot: torch.Tensor | None = None):
    """Plain version of the run entry; see :func:`md_run`."""
    spec = runner.spec
    n_run = n_run.to(torch.int64)
    steps = int(n_run.max()) if n_run.numel() else 0
    dtype = state.dtype
    p = [state[:, a] for a in range(3)]
    v = [state[:, 3 + a] for a in range(3)]
    xi = [vxi[:, k] for k in range(NHC_LEN)]
    dt0, T = fscal[:, F_DT], fscal[:, F_T]
    h0 = [fscal[:, F_H0 + k] for k in range(6)]
    eps = [fscal[:, F_EPS + k] for k in range(6)]
    g0 = torch.zeros_like(dt0) if gstep0 is None else gstep0.to(dtype)
    nt = (torch.clamp(n_run, min=1) if n_tot is None else n_tot).to(dtype)
    invm = runner.invm
    shake = bool(spec.shake_offsets)
    pacc = [torch.zeros_like(dt0) for _ in range(6)]

    def h_of(s):
        return _h_at(h0, eps, (g0 + s) / nt) if deform else h0

    def forces(p, h, want):
        f, w6 = _forces_plain(runner, p, h, want)
        if fext is not None:
            f = [f[a] + fext[:, a] for a in range(3)]
        return f, w6

    f, _ = forces(p, h_of(0), False)
    for s in range(steps):
        live = s < n_run
        lv = live[:, None]
        dt = torch.where(live, dt0, torch.zeros_like(dt0))
        h = h_of(s)
        v_in, xi_in = v, xi
        v, xi = _nhc_half(runner, v, xi, dt, T)
        half = (0.5 * dt)[:, None]
        v = [v[a] + half * f[a] * invm for a in range(3)]
        p_old = p
        p = [torch.where(lv, p[a] + dt[:, None] * v[a], p[a]) for a in range(3)]
        if shake:
            # project the drifted positions, fold the correction into the
            # velocities; a job with dt = 0 is left as it is
            pc = shake_rolls_plain(p, p_old, invm, spec.shake_offsets, runner.shk,
                                   spec.shake_iters, spec.shake_relax)
            live_dt = (dt > 0.0)[:, None]
            inv_dt = torch.where(live_dt, 1.0 / torch.where(live_dt, dt[:, None], 1.0), 0.0)
            v = [v[a] + (pc[a] - p[a]) * inv_dt for a in range(3)]
            p = [torch.where(live_dt, pc[a], p[a]) for a in range(3)]
        f, w6 = forces(p, h, sample)
        v = [v[a] + half * f[a] * invm for a in range(3)]
        if shake:
            rv = rattle_rolls_plain(v, p, invm, spec.shake_offsets, runner.shk,
                                    spec.rattle_iters, spec.shake_relax)
            v = [torch.where(live_dt, rv[a], v[a]) for a in range(3)]
        v, xi = _nhc_half(runner, v, xi, dt, T)
        v = [torch.where(lv, v[a], v_in[a]) for a in range(3)]
        xi = [torch.where(live, xi[k], xi_in[k]) for k in range(NHC_LEN)]
        if sample:
            conv = spec.nktv2p / (h[0] * h[1] * h[2])
            m = runner.mftm
            kin = [torch.sum(m * v[a] * v[b], -1)
                   for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]
            pacc = [pacc[k] + torch.where(live, (kin[k] + w6[k]) * conv,
                                          torch.zeros_like(conv)) for k in range(6)]
        if deform:
            a00, a01, a02, a11, a12, a22 = (c[:, None] for c in _remap_coeffs(h, h_of(s + 1)))
            pn = [a00 * p[0] + a01 * p[1] + a02 * p[2], a11 * p[1] + a12 * p[2], a22 * p[2]]
            p = [torch.where(lv, pn[a], p[a]) for a in range(3)]
    out = torch.stack(p + v, dim=1)
    return out, torch.stack(xi, dim=1), torch.stack(pacc, dim=1)


def md_forces_virial_plain(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor):
    """Plain version of the force entry; see :func:`md_forces_virial`."""
    p = [pos[:, a] for a in range(3)]
    f, w6 = _forces_plain(runner, p, [h6[:, k] for k in range(6)], True)
    return torch.stack(f, dim=1), torch.stack(w6, dim=1)


# --------------------------------------------------------------------------
# Wrappers: the CUDA kernel on CUDA tensors, the plain version on the CPU

_MAX_SMEM = 232448  # bytes of shared memory a Hopper block can opt into
_SMEM_FIXED = 32 * 12 + 16  # reduction scratch + NHC chain and broadcasts (floats)


def _smem_rows(spec: FusedSpec) -> int:
    """Rows of N floats one block keeps: positions, velocities and forces
    (9) and the bonded role buffer (12: four roles x three components for
    the chain or pattern terms; SHAKE reuses it for the pre-drift
    positions and one factor row per offset, 3 + n_offsets rows) — the
    carve of csrc/md_allpairs.cu for every flag set."""
    if 3 + len(spec.shake_offsets) > 12:
        raise ValueError(f"K3: {len(spec.shake_offsets)} SHAKE offsets exceed the "
                         "12-row role buffer")
    return 9 + 12


def smem_bytes(spec: FusedSpec) -> int:
    """Shared memory one block of this runner's kernel keeps."""
    return 4 * (_smem_rows(spec) * spec.n_atoms + _SMEM_FIXED)


def max_atoms(spec: FusedSpec) -> int:
    """The largest box this runner's flag set fits in one block."""
    return (_MAX_SMEM // 4 - _SMEM_FIXED) // _smem_rows(spec)


def check_smem(spec: FusedSpec) -> None:
    """Raise on the host when a box exceeds its kernel's shared-memory budget."""
    need = smem_bytes(spec)
    if need > _MAX_SMEM:
        name = "K3" if spec.k3 else "K1"
        raise ValueError(
            f"{name} (flags {spec.flags}): {spec.n_atoms} atoms need {need} B of shared "
            f"memory per block, above the {_MAX_SMEM} B a Hopper block can use; this "
            f"flag set fits at most {max_atoms(spec)} atoms")


def _check_cuda(runner: FusedRunner, *tensors):
    for t in (runner.lj1, runner.lj2, runner.topo, runner.invm, runner.mftm, runner.qq,
              runner.pat, runner.shk) + tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError("K1/K3: all operands must be on the same CUDA device")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"K1/K3 kernels take float32 (int32 counts), got {t.dtype}")
    check_smem(runner.spec)


def _f(x) -> int:
    return x.contiguous().data_ptr()


class _Topo3(ctypes.Structure):
    """Mirror of the kernel's Topo3 (offset patterns and SHAKE offsets)."""

    _fields_ = [("n_pat", ctypes.c_int), ("kind", ctypes.c_int * MAX_PATTERNS),
                ("off", (ctypes.c_int * 3) * MAX_PATTERNS),
                ("row", ctypes.c_int * MAX_PATTERNS), ("n_shk", ctypes.c_int),
                ("shk_off", ctypes.c_int * MAX_SHAKE_OFFSET),
                ("shake_iters", ctypes.c_int), ("rattle_iters", ctypes.c_int),
                ("relax", ctypes.c_float)]


class _MDArgs(ctypes.Structure):
    """Mirror of the kernel's MDArgs, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "lj1", "lj2", "topo", "qq", "pat", "shk", "invm", "mftm", "state", "vxi", "press",
        "n_run", "gstep0", "n_tot", "fscal", "fext", "pos", "h6", "force", "virial")]
        + [(name, ctypes.c_int) for name in ("B", "N", "deform", "sample", "coul", "ewald")]
        + [(name, ctypes.c_float) for name in (
            "cutoff2", "r2min", "coul_cutoff2", "alpha", "ndof", "boltz", "nktv2p", "tdamp")]
        + [("topo3", _Topo3)])


def _md_args(runner: FusedRunner, B_: int, **ptrs) -> _MDArgs:
    spec = runner.spec
    a = _MDArgs()
    a.lj1, a.lj2, a.topo, a.invm, a.mftm = (_f(t) for t in (
        runner.lj1, runner.lj2, runner.topo, runner.invm, runner.mftm))
    for name, t in (("qq", runner.qq), ("pat", runner.pat), ("shk", runner.shk)):
        if t is not None:
            setattr(a, name, _f(t))
    for name, v in ptrs.items():
        setattr(a, name, v)
    a.B, a.N = B_, spec.n_atoms
    a.coul, a.ewald = int(spec.coul), int(spec.ewald_alpha > 0.0)
    a.cutoff2, a.r2min, a.coul_cutoff2, a.alpha = (spec.cutoff2, spec.r2min,
                                                   spec.coul_cutoff2, spec.ewald_alpha)
    a.ndof, a.boltz, a.nktv2p, a.tdamp = float(spec.ndof), spec.boltz, spec.nktv2p, spec.tdamp
    t3 = a.topo3
    row = 0
    t3.n_pat = len(spec.bonded_pattern)
    for p, key in enumerate(spec.bonded_pattern):
        t3.kind[p] = _PATTERN_KIND[key[0]]
        for k, o in enumerate(key[1:]):
            t3.off[p][k] = o
        t3.row[p] = row
        row += 2 if key[0] in ("bond", "angle") else 4
    t3.n_shk = len(spec.shake_offsets)
    for k, o in enumerate(spec.shake_offsets):
        t3.shk_off[k] = o
    t3.shake_iters, t3.rattle_iters, t3.relax = (spec.shake_iters, spec.rattle_iters,
                                                 spec.shake_relax)
    return a


def md_run(runner: FusedRunner, state: torch.Tensor, vxi: torch.Tensor,
           n_run: torch.Tensor, fscal: torch.Tensor, deform: bool,
           sample: bool, fext: torch.Tensor | None = None,
           gstep0: torch.Tensor | None = None, n_tot: torch.Tensor | None = None):
    """One whole NVT (+ fix-deform) (+ virial-sampling) run of B jobs.

    state (B, 6, N), vxi (B, 3), n_run (B,) steps per job, fscal (B, 16).
    With ``spec.fext``: fext (B, 3, N) is the frozen k-space force added to
    every step's force, and the deform path runs from global step
    ``gstep0`` (B,) of a ``n_tot`` (B,)-step run (defaults 0 and n_run).
    Returns (state', vxi', press_sum (B, 6)): press_sum is the sum over the
    job's steps of the instantaneous Voigt pressure without fext's virial
    (zero unless ``sample``).  Inputs are not modified."""
    spec = runner.spec
    if spec.fext != (fext is not None):
        raise ValueError(f"md_run: fext must be given exactly when the runner has the "
                         f"k-space split (spec.fext={spec.fext})")
    if state.device.type == "cpu":
        return md_run_plain(runner, state, vxi, n_run, fscal, deform, sample, fext,
                            gstep0, n_tot)
    if state.device.type != "cuda":
        raise ValueError(f"md_run: unsupported device {state.device}")
    Bn, six, N = state.shape
    if six != 6 or N != spec.n_atoms:
        raise ValueError(f"md_run: state shape {tuple(state.shape)} != (B, 6, {spec.n_atoms})")
    st = state.contiguous().clone()
    xi = vxi.contiguous().clone()
    nr = n_run.to(torch.int32).contiguous()
    fs = fscal.contiguous()
    _check_cuda(runner, st, xi, nr, fs)
    press = torch.zeros((Bn, 6), dtype=st.dtype, device=st.device)
    if Bn == 0:
        return st, xi, press
    ptrs = dict(state=st.data_ptr(), vxi=xi.data_ptr(), press=press.data_ptr(),
                n_run=nr.data_ptr(), fscal=fs.data_ptr())
    if spec.fext:
        fx = fext.contiguous()
        g0 = (torch.zeros_like(nr) if gstep0 is None else gstep0.to(torch.int32)).contiguous()
        ntot = (nr if n_tot is None else n_tot.to(torch.int32)).contiguous()
        if fx.shape != (Bn, 3, N):
            raise ValueError(f"md_run: fext shape {tuple(fx.shape)} != ({Bn}, 3, {N})")
        _check_cuda(runner, fx, g0, ntot)
        ptrs.update(fext=fx.data_ptr(), gstep0=g0.data_ptr(), n_tot=ntot.data_ptr())
    args = _md_args(runner, Bn, **ptrs)
    args.deform, args.sample = int(deform), int(sample)
    rc = _build.library().md_allpairs_run_f32(ctypes.byref(args),
                                              _build.stream_handle(st.device))
    _build.check(rc, f"md_allpairs_run_f32 (flags {spec.flags})")
    if spec.k3:
        md_run.launches_k3 += 1
    else:
        md_run.launches += 1
    return st, xi, press


md_run.launches = 0
md_run.launches_k3 = 0


def md_forces_virial(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor):
    """Forces and virial of B boxes: pos (B, 3, N) rows, h6 (B, 6) box
    scalars [lx ly lz xy xz yz].  Returns (F (B, 3, N), W (B, 6)) with W
    the Voigt virial sum (pair sum_{i<j} f_ij d (x) d plus the bonded
    terms, in energy units).  Pair terms are LJ and, with ``spec.coul``,
    the cutoff or real-space Ewald Coulomb term; the k-space remainder is
    the caller's (``engine.forces_virial``)."""
    if pos.device.type == "cpu":
        return md_forces_virial_plain(runner, pos, h6)
    if pos.device.type != "cuda":
        raise ValueError(f"md_forces_virial: unsupported device {pos.device}")
    spec = runner.spec
    Bn, three, N = pos.shape
    if three != 3 or N != spec.n_atoms:
        raise ValueError(f"md_forces_virial: pos shape {tuple(pos.shape)} != (B, 3, {spec.n_atoms})")
    pos = pos.contiguous()
    h6 = h6.contiguous()
    _check_cuda(runner, pos, h6)
    force = torch.empty_like(pos)
    vir = torch.empty((Bn, 6), dtype=pos.dtype, device=pos.device)
    if Bn == 0:
        return force, vir
    args = _md_args(runner, Bn, pos=pos.data_ptr(), h6=h6.data_ptr(),
                    force=force.data_ptr(), virial=vir.data_ptr())
    rc = _build.library().md_allpairs_forces_f32(ctypes.byref(args),
                                                 _build.stream_handle(pos.device))
    _build.check(rc, f"md_allpairs_forces_f32 (flags {spec.flags})")
    if spec.k3:
        md_forces_virial.launches_k3 += 1
    else:
        md_forces_virial.launches += 1
    return force, vir


md_forces_virial.launches = 0
md_forces_virial.launches_k3 = 0


# --------------------------------------------------------------------------
# Engine-level runs (md/engine.py dispatches here)


def h6_of(h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) upper-triangular box -> (..., 6) [lx ly lz xy xz yz]."""
    return torch.stack([h[..., 0, 0], h[..., 1, 1], h[..., 2, 2],
                        h[..., 0, 1], h[..., 0, 2], h[..., 1, 2]], -1)


def make_fscal(dt, T, h: torch.Tensor, eps: torch.Tensor | None = None) -> torch.Tensor:
    """(B, 16) scalar rows for a batch of jobs (dt and T scalars or (B,))."""
    Bn = h.shape[0]
    f = torch.zeros((Bn, FSCAL), dtype=h.dtype, device=h.device)
    f[:, F_DT] = torch.as_tensor(dt, dtype=h.dtype, device=h.device)
    f[:, F_T] = torch.as_tensor(T, dtype=h.dtype, device=h.device)
    f[:, F_H0:F_H0 + 6] = h6_of(h)
    if eps is not None:
        f[:, F_EPS:F_EPS + 6] = eps.to(h.dtype)
    return f


def pack_state(pos: torch.Tensor, vel: torch.Tensor) -> torch.Tensor:
    """(B, N, 3) x 2 -> (B, 6, N) rows."""
    return torch.cat([pos.transpose(1, 2), vel.transpose(1, 2)], dim=1).contiguous()


def unpack_state(st: torch.Tensor):
    """(B, 6, N) -> (pos (B, N, 3), vel (B, N, 3))."""
    return st[:, :3].transpose(1, 2), st[:, 3:].transpose(1, 2)


def _kspace_chunks(runner: FusedRunner, st6, vxi, n_steps, fscal, h0, eps,
                   deform: bool, sample: bool):
    """The rRESPA outer level (md_fused.py:2329-2353, :2503-2533): runs of
    ``kspace_every`` steps with the smooth k-space remainder frozen at each
    chunk's start, one batched launch per chunk (each job runs
    min(ns - g0, kspace_every) trips; finished and inactive jobs none).
    With ``sample``, the remainder's virial joins the pressure sums here.
    Returns (st6, vxi, press_sum)."""
    Rk = runner.kspace_every
    dtype = st6.dtype
    n_max = int(n_steps.max()) if n_steps.numel() else 0
    ns = torch.clamp(n_steps, min=1)
    conv = runner.spec.nktv2p / B.volume(h0)
    pacc = torch.zeros((st6.shape[0], 6), dtype=dtype, device=st6.device)
    for c in range(math.ceil(n_max / Rk)):
        g0 = c * Rk
        trips = torch.clamp(torch.minimum(n_steps - g0, torch.full_like(n_steps, Rk)), min=0)
        act = torch.nonzero(trips > 0).flatten()
        h_c = B.deform_path(h0, eps, g0 / ns.to(dtype)) if deform else h0
        pos_c, _ = unpack_state(st6)
        Fk, Wk = runner.kspace(pos_c[act], h_c[act], want_virial=sample)
        fk = torch.zeros((st6.shape[0], 3, st6.shape[2]), dtype=dtype, device=st6.device)
        fk[act] = Fk.transpose(1, 2).to(dtype)
        st6, vxi, pk = md_run(runner, st6, vxi, trips, fscal, deform, sample, fext=fk,
                              gstep0=torch.full_like(n_steps, g0),
                              n_tot=ns if deform else torch.ones_like(n_steps))
        if sample:
            wk = torch.zeros((st6.shape[0], 6), dtype=dtype, device=st6.device)
            wk[act] = Wk.to(dtype)
            pacc = pacc + pk + trips.to(dtype)[:, None] * wk * conv[:, None]
    return st6, vxi, pacc


def run_strain_fused(runner: FusedRunner, state, eps_eff: torch.Tensor,
                     n_steps: torch.Tensor, T, dt):
    """engine.run_strain semantics for a (B,) batch of jobs: NVT with the
    box moved linearly toward ``eps_eff`` over each job's ``n_steps``
    (0 = inactive: state returned unchanged).  One launch for the whole
    run, or one per ``kspace_every`` steps with the k-space split."""
    from ..md.engine import MDState

    n_steps = torch.as_tensor(n_steps, device=state.pos.device).to(torch.int64)
    eps = eps_eff.to(state.pos.dtype)
    fscal = make_fscal(dt, T, state.h, eps)
    st6 = pack_state(state.pos, state.vel)
    if runner.kspace is None:
        st6, vxi, _ = md_run(runner, st6, state.vxi, n_steps, fscal, deform=True, sample=False)
    else:
        st6, vxi, _ = _kspace_chunks(runner, st6, state.vxi, n_steps, fscal, state.h, eps,
                                     deform=True, sample=False)
    pos, vel = unpack_state(st6)
    frac_end = (n_steps > 0).to(state.pos.dtype)
    h_end = B.deform_path(state.h, eps, frac_end)
    return MDState(pos=pos, vel=vel, h=h_end, vxi=vxi)


def sample_stress_fused(runner: FusedRunner, state, n_steps: torch.Tensor, T, dt):
    """engine.sample_stress semantics for a (B,) batch: NVT run returning the
    time-averaged virial pressure (B, 6) in pressure units."""
    from ..md.engine import MDState

    n_steps = torch.as_tensor(n_steps, device=state.pos.device).to(torch.int64)
    fscal = make_fscal(dt, T, state.h)
    st6 = pack_state(state.pos, state.vel)
    if runner.kspace is None:
        st6, vxi, pacc = md_run(runner, st6, state.vxi, n_steps, fscal, deform=False,
                                sample=True)
    else:
        st6, vxi, pacc = _kspace_chunks(runner, st6, state.vxi, n_steps, fscal, state.h,
                                        None, deform=False, sample=True)
    pos, vel = unpack_state(st6)
    press = pacc / torch.clamp(n_steps, min=1).to(pacc.dtype)[:, None]
    return MDState(pos=pos, vel=vel, h=state.h, vxi=vxi), press
