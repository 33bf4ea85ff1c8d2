"""K1, K3 and K4: the fused MD kernel — whole strain and sampling runs of
many MD jobs in one launch — and its host glue.

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

K4 is the gather-list branch of the same TPU kernel (``forces`` ->
``pair_tile``, ``gather3``; with ``k_chunk`` its HBM-streamed job-grid
form ``_build_streamed_grid_call``, K4s): the pair loop walks a
fixed-width full neighbor list (``md/neighbor.py``) whose slot channels —
index, lj1/lj2 and qq with the special-bond weights, image integers fixed
at the build — the host packs at each chunk start (:func:`pack_channels`,
``FusedRunner.channels``); the pair displacement uses each step's box.  A
runner whose ``spec.k`` is set (boxes above the all-pairs gate, or
``force_list_kernel``) launches K4, with K3's or K1's other flags.

K5 is the Stillinger-Weber branch of the same TPU kernel (``FusedSpec.sw``
-> ``forces_allpairs_sw``): the p = 4, q = 0 family (Si) over all pairs in
two sweeps per force call — the per-atom three-body moments (s, m, Q),
then the ordered-pair w = dT/dd from per-atom adjoints in both roles — with
no parameter planes and no bonded terms.  A runner from
:func:`make_runner_sw` launches K5.

K1m is K1's run with J jobs per thread block (the TPU kernel's
``FusedSpec.jobs``): :func:`md_run_multi`, behind
:func:`run_strain_fused_multi` and :func:`sample_stress_fused_multi` over a
(G, J) grouping of the batch — the coupler's ``pack_jobs``.

Three entries, each a wrapper that launches ``csrc/md_allpairs.cu`` (K1,
K3), ``csrc/md_multi.cu`` (K1m), ``csrc/md_list.cu`` (K4) or
``csrc/md_sw.cu`` (K5) on CUDA tensors (counting the launch: ``launches`` for K1, ``launches_k3`` for K3,
``launches_k4`` for K4, ``launches_k5`` for K5, ``launches_k1m`` for K1m)
and runs the plain PyTorch version of the same function on CPU tensors:

* :func:`md_run` — one whole run (``deform`` and/or ``sample`` mode) of B
  jobs; the kernel runs one thread block per job;
* :func:`md_run_multi` — the same run of a K1 runner, J jobs per block.
* :func:`md_forces_virial` — one force + virial evaluation of B boxes (FIRE
  minimisation and the stiffness probe; K4 builds a fresh list per call);
  the k-space remainder is added by the caller.

Layouts: a job's state is (6, N) rows ``[x y z vx vy vz]``; ``fscal`` rows
are ``[dt, T, lx, ly, lz, xy, xz, yz, exx, eyy, ezz, exy, exz, eyz, 0, 0]``.
A job with ``n_run = 0`` is left bit-identical (the TPU's one-step ``dt = 0``
padding job is a Mosaic workaround and is not ported).
"""
from __future__ import annotations

import ctypes
import math
from dataclasses import dataclass, field, replace

import numpy as np
import torch

from ..md import box as B
from ..md import neighbor as NB
from ..md.forcefields.coulomb import QQR2E_REAL
from ..md.forcefields.lj import LJ
from ..md.forcefields.sw import SW
from . import _build
from . import sw_bricks as SWB

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
    """Static configuration of K1/K3/K4/K5 for one MD system."""

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
    # K4: neighbor-list width (slots per atom); 0 = the all-pairs planes
    k: int = 0
    # K5: Stillinger-Weber (p = 4, q = 0) over all pairs, with the eight
    # constants in the JAX package's order (eps, sigma, a, lam, gamma,
    # costheta0, A, B); no planes, no bonded terms
    sw: bool = False
    sw_params: tuple = ()

    @property
    def k3(self) -> bool:
        """Any charged all-atom addition on (with K4, its charged flags)."""
        return self.coul or self.fext or bool(self.bonded_pattern) or bool(self.shake_offsets)

    @property
    def kernel(self) -> str:
        """The kernel this runner launches: K5 (SW), K4 (list), K3 or K1."""
        if self.sw:
            return "K5"
        return "K4" if self.k else ("K3" if self.k3 else "K1")

    @property
    def flags(self) -> str:
        """The compile-time flag set of this runner ("none" for K1)."""
        on = [name for name, v in (("COUL", self.coul), ("EWALD", self.ewald_alpha > 0.0),
                                   ("PATTERNS", bool(self.bonded_pattern)),
                                   ("SHAKE", bool(self.shake_offsets)), ("FEXT", self.fext),
                                   ("LIST", self.k > 0), ("SW", self.sw))
              if v]
        return "+".join(on) or "none"


@dataclass(frozen=True)
class FusedRunner:
    """Position-independent device inputs of K1/K3/K4/K5 for one MD system
    (K4 gathers its per-slot lj1/lj2/qq from the same dense planes; K5
    has no planes and no topology)."""

    spec: FusedSpec
    invm: torch.Tensor  # (N,) ftm2v / m
    mftm: torch.Tensor  # (N,) m / ftm2v
    lj1: torch.Tensor | None = None  # (N, N) 48 eps sig^12 w, zero diagonal
    lj2: torch.Tensor | None = None  # (N, N) 24 eps sig^6 w
    topo: torch.Tensor | None = None  # (16, N) chain-term rows (zero with patterns)
    qq: torch.Tensor | None = None  # (N, N) qqr2e q_i q_j w_coul (COUL)
    pat: torch.Tensor | None = None  # (R, N) pattern parameter rows (PATTERNS)
    shk: torch.Tensor | None = None  # (n_off, N) SHAKE d0^2 rows (SHAKE)
    # smooth k-space remainder: kspace(pos (B, N, 3), h (B, 3, 3),
    # want_virial) -> (F (B, N, 3), W (B, 6) or None), refreshed every
    # kspace_every steps (material.build_kspace_split)
    kspace: object = None
    kspace_every: int = 10
    # K4: the neighbor list (md.neighbor.NeighborSpec) and its rebuild period
    nspec: object = None
    rebuild_every: int = 10
    # K4's channel buffers of the chunk loop, one set per batch size
    _buffers: dict = field(default_factory=dict, init=False, compare=False, repr=False)

    def to(self, device=None, dtype=None) -> "FusedRunner":
        def mv(x):
            return None if x is None else x.to(device=device, dtype=dtype).contiguous()

        return replace(self, invm=mv(self.invm), mftm=mv(self.mftm), lj1=mv(self.lj1),
                       lj2=mv(self.lj2), topo=mv(self.topo), qq=mv(self.qq),
                       pat=mv(self.pat), shk=mv(self.shk))

    @property
    def channel_names(self) -> tuple:
        """K4's (B, K, N) channels: neighbor index (int32), coefficients,
        image integers (and qq with Coulomb)."""
        return ("idx", "lj1", "lj2", "imx", "imy", "imz") + (("qq",) if self.spec.coul else ())

    def channels(self, pos: torch.Tensor, h: torch.Tensor, jobs: torch.Tensor | None = None,
                 reuse: bool = False) -> dict:
        """K4's channels for positions pos (B, N, 3) in boxes h (B, 3, 3):
        a fresh list (``neighbor.build``) packed by :func:`pack_channels`,
        built in slices of jobs.  ``jobs`` limits the rebuild to those
        jobs (the others keep their last list; a launch that gives them no
        steps skips them); ``reuse`` writes into one buffer set kept
        per batch size (the chunk loop's: 70 MB per job at N = 2240, K =
        1112), which the next reusing call overwrites."""
        spec = self.spec
        Bn, n = pos.shape[0], spec.n_atoms
        out = self._buffers.get((Bn, pos.dtype, pos.device)) if reuse else None
        if out is None:
            # every slot starts dead (self-padded, zero coefficients), so a
            # job that is never rebuilt holds a valid empty list
            out = {name: torch.zeros((Bn, spec.k, n), device=pos.device,
                                     dtype=torch.int32 if name == "idx" else pos.dtype)
                   for name in self.channel_names}
            out["idx"][:] = torch.arange(n, dtype=torch.int32, device=pos.device)
            if reuse:
                self._buffers.clear()
                self._buffers[(Bn, pos.dtype, pos.device)] = out
        if jobs is None:
            jobs = torch.arange(Bn, device=pos.device)
        step = NB.jobs_per_slice(n)
        for s in range(0, jobs.shape[0], step):
            js = jobs[s:s + step]
            p, hh = pos[js], h[js]
            pack_channels(self, p, hh, NB.build(self.nspec, p, hh), out, js)
        return out


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
    lj2 = 24 eps sig^6 w, so that F/r = lj1/r^14 - lj2/r^8.  A plain
    ``LJ`` has weight 1 off the diagonal."""
    types = ff.types.cpu().numpy()
    if isinstance(ff, LJ):
        eps_t, sig_t = ff.epsilon, ff.sigma
        W = 1.0 - np.eye(len(types))
    else:
        eps_t, sig_t = ff.lj_epsilon, ff.lj_sigma
        W = ff.pair_weights(ff.special_lj)
    eps = eps_t.cpu().double().numpy()[types[:, None], types[None, :]]
    sig = sig_t.cpu().double().numpy()[types[:, None], types[None, :]]
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
                kspace_every: int = 10, nspec=None, rebuild_every: int = 10) -> FusedRunner:
    """K1's, K3's or K4's inputs for one system: an OPLS force field, or a
    plain ``LJ`` (K1 with no bonded terms and no charges).

    A linear-chain topology takes the chain terms, any other the offset
    patterns; nonzero charges add the qq plane (cutoff Coulomb, or the
    real-space Ewald form when ``ff.ewald`` is set — then ``kspace``, the
    smooth remainder from ``material.build_kspace_split``, is required);
    ``constraints`` add SHAKE/RATTLE; a neighbor spec ``nspec`` selects
    K4's list of width ``nspec.k_max``, rebuilt every ``rebuild_every``
    steps (the all-pairs planes otherwise).  What no kernel of the port
    runs yet — impropers, irregular topologies, wide constraint offsets, for which
    the JAX package falls back to its XLA path — raises
    NotImplementedError."""
    n = int(masses.shape[0])
    m = masses.to(torch.float64).cpu()
    if isinstance(ff, LJ):
        spec = FusedSpec(n_atoms=n, cutoff2=float(ff.cutoff) ** 2, ndof=3 * n - 3,
                         boltz=units.boltz, ftm2v=units.ftm2v, nktv2p=units.nktv2p,
                         tdamp=tdamp)
        lj1, lj2 = dense_planes(ff, dtype, device)
        return FusedRunner(spec=spec, **_mass_rows(m, units, dtype, device), lj1=lj1, lj2=lj2,
                           topo=torch.zeros((TOPO, n), dtype=dtype, device=device))
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
                     shake_offsets=shake_offsets, k=int(nspec.k_max) if nspec is not None else 0)
    lj1, lj2 = dense_planes(ff, dtype, device)
    return FusedRunner(
        spec=spec, **_mass_rows(m, units, dtype, device), lj1=lj1, lj2=lj2, topo=topo,
        qq=dense_qq(ff, dtype, device) if coul else None, pat=pat, shk=shk,
        kspace=kspace, kspace_every=kspace_every, nspec=nspec, rebuild_every=rebuild_every)


def make_runner_sw(sw, masses: torch.Tensor, units, tdamp: float = 100.0,
                   dtype=torch.float64, device=None) -> FusedRunner:
    """K5's inputs for a single-element Stillinger-Weber system ``sw``
    (``forcefields.sw.SW``) — the JAX package's ``_build_fused_runner_sw``
    (material.py:512-551): the SW constants go into the spec, the kernel
    keeps no planes, and the thermostat counts 3N - 3 degrees of freedom.
    Only the p = 4, q = 0 family (Si) has a kernel; any other raises
    NotImplementedError (``material.build_system`` sends such a box to the
    unfused engine, as the JAX package sends it to its XLA engine)."""
    if not (abs(float(sw.p) - 4.0) < 1e-12 and abs(float(sw.q)) < 1e-12):
        raise NotImplementedError(
            f"K5 computes the p = 4, q = 0 SW family only (got p = {sw.p}, q = {sw.q}); "
            "other families run on the unfused engine (material.build_system)")
    n = int(masses.shape[0])
    m = masses.to(torch.float64).cpu()
    spec = FusedSpec(n_atoms=n, cutoff2=float(sw.cutoff) ** 2, ndof=3 * n - 3,
                     boltz=units.boltz, ftm2v=units.ftm2v, nktv2p=units.nktv2p, tdamp=tdamp,
                     sw=True,
                     sw_params=(float(sw.epsilon), float(sw.sigma), float(sw.a), float(sw.lam),
                                float(sw.gamma), float(sw.costheta0), float(sw.A), float(sw.B)))
    return FusedRunner(spec=spec, **_mass_rows(m, units, dtype, device))


def _mass_rows(m: torch.Tensor, units, dtype, device) -> dict:
    """The runner's per-atom rows from float64 masses m (N,): invm =
    ftm2v / m (zero for massless sites) and mftm = m / ftm2v."""
    return dict(invm=torch.where(m > 0, units.ftm2v / m, torch.zeros_like(m)).to(device=device,
                                                                              dtype=dtype),
                mftm=(m / units.ftm2v).to(device=device, dtype=dtype))


def sw_consts(spec: FusedSpec) -> dict:
    """K5's constants (K6's, ``sw_bricks.sw_consts``, without q and c0),
    derived on the host in double precision from ``spec.sw_params`` with
    the TPU kernel's association
    (md_fused.py:923-1050), so that the kernel (which takes them in
    float32) and the plain version see the same numbers: the cutoff rc =
    a sig and the mask bound (rc - 1e-6)^2; gs = gam sig; the two-body
    factors A eps, B and -4 B; the adjoint factors lam eps c0^2 (a_s),
    -2 lam eps c0 (a_m), lam eps (a_Q) and the constant a_gsq =
    -(lam eps / 2)(1 - c0)^2."""
    c = SWB.sw_consts(SW(*spec.sw_params, p=4.0, q=0.0))
    return {k: c[k] for k in ("rc", "rc2", "sig", "gs", "aeps", "b", "m4b", "lam_eps", "k_s",
                              "k_m", "a_gsq")}


def pack_channels(runner: FusedRunner, pos: torch.Tensor, h: torch.Tensor,
                  nbr: NB.NeighborList, out: dict | None = None,
                  jobs: torch.Tensor | None = None) -> dict:
    """K4's channels of the lists ``nbr`` (b, N, k) built at pos (b, N, 3)
    in boxes h (b, 3, 3), written into rows ``jobs`` of the (B, K, N)
    buffers ``out`` (new (b, K, N) tensors by default) — the generic
    branch of the JAX package's ``FusedRunner.channels`` +
    ``pack_channels`` (md_fused.py:2241-2256, :1954-2041) in slot-major
    layout.  Per slot: the neighbor index, dead
    slots self-padded (also the k..K tail); lj1/lj2 (and qq) from the
    dense planes, which carry the special_lj (special_coul) weights, zero
    on dead slots; the image integers n_ij = -round(inv_h (x_j - x_i)),
    fixed here, so that x_j + h n_ij - x_i is the minimum image at the build
    and follows any later affine deform."""
    spec = runner.spec
    b, n, k = nbr.idx.shape
    if out is None:
        out = {name: torch.empty((b, spec.k, n), device=pos.device,
                                 dtype=torch.int32 if name == "idx" else pos.dtype)
               for name in runner.channel_names}
        jobs = torch.arange(b, device=pos.device)
    if k > spec.k:
        raise ValueError(f"pack_channels: list width {k} exceeds the kernel's K = {spec.k}")
    idx, m = nbr.idx, nbr.mask.to(pos.dtype)
    ii = torch.arange(n, device=pos.device)[:, None]
    vals = {"idx": idx, "lj1": runner.lj1[ii, idx] * m, "lj2": runner.lj2[ii, idx] * m}
    if spec.coul:
        vals["qq"] = runner.qq[ii, idx] * m
    ih = B.inv_h(h)
    flat = idx.reshape(b, n * k)
    d = [torch.gather(pos[..., a], 1, flat).reshape(b, n, k) - pos[..., a, None]
         for a in range(3)]
    for a, name in enumerate(("imx", "imy", "imz")):
        vals[name] = -torch.round(ih[:, a, 0, None, None] * d[0] + ih[:, a, 1, None, None] * d[1]
                                  + ih[:, a, 2, None, None] * d[2])
    for name, x in vals.items():
        dst = out[name]
        full = torch.empty((b, spec.k, n), dtype=dst.dtype, device=dst.device)
        full[:, :k] = x.transpose(1, 2)
        if name == "idx":
            full[:, k:] = ii[:, 0].to(dst.dtype)
        else:
            full[:, k:] = 0.0
        dst.index_copy_(0, jobs, full)
    return out


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


# (B, N, N) pair planes, or (B, K, N) list slots, per slice of jobs in the
# plain pair loop
_PLAIN_PAIRS = 1 << 24


def _pair_forces_plain(runner: FusedRunner, p, h6, want_virial: bool, nbr: dict | None = None):
    """LJ (+ Coulomb) pair forces on (B, N) rows in slices of jobs that bound
    the per-pair temporaries: all pairs with the per-pair sequential
    triclinic minimum image (K1/K3), or K4's list slots from the (B, K, N)
    channels ``nbr``.  Returns ((fx, fy, fz), w6 list of (B,) or None)."""
    n = p[0].shape[-1]
    step = max(1, _PLAIN_PAIRS // max(n * (nbr["idx"].shape[1] if nbr else n), 1))
    parts = []
    for s in range(0, p[0].shape[0], step):
        sl = slice(s, s + step)
        ps, hs = [x[sl] for x in p], [h[sl] for h in h6]
        if nbr:
            parts.append(_list_block_plain(runner.spec, ps, hs,
                                           {k: v[sl] for k, v in nbr.items()}, want_virial))
        else:
            parts.append(_pair_block_plain(runner, ps, hs, want_virial))
    f = [torch.cat([pt[0][a] for pt in parts]) for a in range(3)]
    w6 = [torch.cat([pt[1][k] for pt in parts]) for k in range(6)] if want_virial else None
    return f, w6


def _fpair_plain(spec: FusedSpec, r2, lj1, lj2, qq, above=None):
    """Pair F/r at squared distances r2 from the coefficients lj1, lj2 (and
    qq with Coulomb): live inside each cutoff and, with ``above`` (the
    list's r2 > r2min), only there — the arithmetic of the kernel's
    pair_force."""
    r2c = torch.clamp(r2, min=spec.r2min)
    zero = torch.zeros((), dtype=r2.dtype, device=r2.device)
    if spec.coul:
        inv_r = torch.rsqrt(r2c)
        inv_r2 = inv_r * inv_r
    else:
        inv_r2 = 1.0 / r2c
    u2 = inv_r2 * inv_r2
    u3 = u2 * inv_r2
    lj_live = r2 < spec.cutoff2
    if above is not None:
        lj_live = lj_live & above
    fpair = torch.where(lj_live, (lj1 * u3 - lj2) * u2 * u2, zero)
    if spec.coul:
        if spec.ewald_alpha > 0.0:
            fcoul = ewald_fcoul(qq, r2c, inv_r, inv_r2, spec.ewald_alpha)
        else:
            fcoul = qq * inv_r * inv_r2
        q_live = r2 < spec.coul_cutoff2
        if above is not None:
            q_live = q_live & above
        fpair = fpair + torch.where(q_live, fcoul, zero)
    return fpair


def _apply_plain(fpair, dx, dy, dz, axis: int, want_virial: bool):
    """Forces summed over the pair axis and half of each pair's virial."""
    f = [-(fpair * d).sum(axis) for d in (dx, dy, dz)]
    w6 = None
    if want_virial:
        w6 = [0.5 * (fpair * u * v).sum((-1, -2))
              for u, v in ((dx, dx), (dy, dy), (dz, dz), (dx, dy), (dx, dz), (dy, dz))]
    return f, w6


def _pair_block_plain(runner, p, h6, want_virial):
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
    fpair = _fpair_plain(runner.spec, r2, runner.lj1, runner.lj2, runner.qq)
    return _apply_plain(fpair, dx, dy, dz, -1, want_virial)


def _list_block_plain(spec, p, h6, nbr, want_virial):
    """K4's slots: d = r_j + h n_ij - r_i with this box h, live where r2min
    < r2 < cutoff (self-padded dead slots have r2 = 0), half of each slot's
    virial (the list is full)."""
    lx, ly, lz, xy, xz, yz = (h[:, None, None] for h in h6)
    b, K, n = nbr["idx"].shape
    flat = nbr["idx"].reshape(b, K * n).long()
    g = [torch.gather(x, 1, flat).reshape(b, K, n) for x in p]
    nx, ny, nz = nbr["imx"], nbr["imy"], nbr["imz"]
    # d[b, s, i] for slot s of atom i
    dx = g[0] + nx * lx + ny * xy + nz * xz - p[0][:, None, :]
    dy = g[1] + ny * ly + nz * yz - p[1][:, None, :]
    dz = g[2] + nz * lz - p[2][:, None, :]
    r2 = dx * dx + dy * dy + dz * dz
    fpair = _fpair_plain(spec, r2, nbr["lj1"], nbr["lj2"], nbr.get("qq"), above=r2 > spec.r2min)
    return _apply_plain(fpair, dx, dy, dz, 1, want_virial)


def _sw_w(c, ux, uy, uz, inv_r, g, dg, radial0, adj):
    """w = dT/dd of ordered pairs whose centres have the adjoints ``adj``
    = (a_s, a_mx, a_my, a_mz, a_Qxx, a_Qyy, a_Qzz, a_Qxy, a_Qxz, a_Qyz),
    broadcastable against the pair planes (``w_of``, md_fused.py:1011)."""
    a_s, amx, amy, amz, qxx, qyy, qzz, qxy, qxz, qyz = adj
    am_u = amx * ux + amy * uy + amz * uz
    qu_x = qxx * ux + qxy * uy + qxz * uz
    qu_y = qxy * ux + qyy * uy + qyz * uz
    qu_z = qxz * ux + qyz * uy + qzz * uz
    uqu = ux * qu_x + uy * qu_y + uz * qu_z
    radial = radial0 + dg * (a_s + 2.0 * c["a_gsq"] * g + am_u + uqu)
    tang = g * inv_r
    t2 = am_u + 2.0 * uqu
    return (radial * ux + tang * (amx + 2.0 * qu_x - t2 * ux),
            radial * uy + tang * (amy + 2.0 * qu_y - t2 * uy),
            radial * uz + tang * (amz + 2.0 * qu_z - t2 * uz))


def _sw_block_plain(spec, p, h6, want_virial):
    """K5's two sweeps on (b, N) rows over the (b, N, N) ordered pairs
    (``forces_allpairs_sw``, md_fused.py:910-1081), centre i on axis 1,
    neighbour j on axis 2, d = r_j - r_i by the sequential triclinic
    minimum image (``block_geom``).

    Sweep 1: per-atom moments s = sum g, m = sum g u, Q = sum g u (x) u with
    g = exp(gam sig / (r - rc)) on live pairs (r2 < (rc - 1e-6)^2, r2 >
    1e-8, j != i); sum g^2 is not needed, its adjoint being a constant.
    Adjoints: a_s = lam eps c0^2 s, a_m = -2 lam eps c0 m, a_Q = lam eps Q.
    Sweep 2: w_A with the centre's adjoints, w_B with the neighbour's
    (direction -u); f_i = sum_j (w_A - w_B); the virial W -= sym(w_A (x) d)
    over role A's ordered pairs."""
    c = sw_consts(spec)
    lx, ly, lz, xy, xz, yz = (h[:, None, None] for h in h6)
    n = p[0].shape[-1]
    dx = p[0][:, None, :] - p[0][:, :, None]
    dy = p[1][:, None, :] - p[1][:, :, None]
    dz = p[2][:, None, :] - p[2][:, :, None]
    n3 = torch.round(dz * (1.0 / lz))
    dz = dz - n3 * lz
    dy = dy - n3 * yz
    n2 = torch.round(dy * (1.0 / ly))
    dy = dy - n2 * ly
    dx = dx - n3 * xz - n2 * xy
    n1 = torch.round(dx * (1.0 / lx))
    dx = dx - n1 * lx
    r2 = dx * dx + dy * dy + dz * dz
    eye = torch.eye(n, dtype=torch.bool, device=r2.device)
    mask = (r2 < c["rc2"]) & (r2 > 1e-8) & ~eye
    one = torch.ones((), dtype=r2.dtype, device=r2.device)
    zero = torch.zeros_like(one)
    r = torch.sqrt(torch.where(mask, r2, one))
    inv_r = 1.0 / r
    ux, uy, uz = dx * inv_r, dy * inv_r, dz * inv_r
    denom = torch.where(mask, r - c["rc"], -one)
    g = torch.where(mask, torch.exp(c["gs"] / denom), zero)

    # sweep 1: moments, then the per-atom adjoints
    gx, gy, gz = g * ux, g * uy, g * uz
    mom = [g, gx, gy, gz, gx * ux, gy * uy, gz * uz, gx * uy, gx * uz, gy * uz]
    mom = [x.sum(-1) for x in mom]
    adj = ([c["k_s"] * mom[0]] + [c["k_m"] * x for x in mom[1:4]]
           + [c["lam_eps"] * x for x in mom[4:]])

    # sweep 2: the pair term and both roles' w
    expo = torch.exp(c["sig"] / denom)
    sr2 = (c["sig"] * inv_r) ** 2
    srp = sr2 * sr2
    phi2 = c["aeps"] * (c["b"] * srp - 1.0) * expo
    id2 = denom * denom
    dphi2 = c["aeps"] * (c["m4b"] * srp * inv_r) * expo + phi2 * (-c["sig"] / id2)
    dg = g * (-c["gs"] / id2)
    radial0 = 0.5 * dphi2
    wa = _sw_w(c, ux, uy, uz, inv_r, g, dg, radial0, [a[:, :, None] for a in adj])
    wb = _sw_w(c, -ux, -uy, -uz, inv_r, g, dg, radial0, [a[:, None, :] for a in adj])
    wa = [torch.where(mask, x, zero) for x in wa]
    wb = [torch.where(mask, x, zero) for x in wb]
    f = [(wa[k] - wb[k]).sum(-1) for k in range(3)]
    w6 = None
    if want_virial:
        w6 = [-(wa[0] * dx).sum((-1, -2)), -(wa[1] * dy).sum((-1, -2)),
              -(wa[2] * dz).sum((-1, -2)),
              -0.5 * (wa[0] * dy + wa[1] * dx).sum((-1, -2)),
              -0.5 * (wa[0] * dz + wa[2] * dx).sum((-1, -2)),
              -0.5 * (wa[1] * dz + wa[2] * dy).sum((-1, -2))]
    return f, w6


def _sw_forces_plain(runner: FusedRunner, p, h6, want_virial: bool):
    """K5's plain version on (B, N) rows, in slices of jobs that bound the
    (b, N, N) pair temporaries, as :func:`_pair_forces_plain` does.
    Returns ((fx, fy, fz), w6 list of (B,) or None)."""
    n = p[0].shape[-1]
    step = max(1, _PLAIN_PAIRS // max(n * n, 1))
    parts = [_sw_block_plain(runner.spec, [x[s:s + step] for x in p],
                             [h[s:s + step] for h in h6], want_virial)
             for s in range(0, p[0].shape[0], step)]
    f = [torch.cat([pt[0][a] for pt in parts]) for a in range(3)]
    w6 = [torch.cat([pt[1][k] for pt in parts]) for k in range(6)] if want_virial else None
    return f, w6


def _forces_plain(runner: FusedRunner, p, h6, want_virial: bool, nbr: dict | None = None):
    """Pair + bonded (chain or pattern) forces on (B, N) rows; h6 is a list
    of six (B,) box scalars; ``nbr`` K4's channels for a list runner; an
    SW runner takes K5's two sweeps (no bonded terms).
    Returns ((fx, fy, fz), w6 list of (B,) or None).  The frozen k-space
    force is not included."""
    if runner.spec.sw:
        return _sw_forces_plain(runner, p, h6, want_virial)
    f, w6 = _pair_forces_plain(runner, p, h6, want_virial, nbr if runner.spec.k else None)
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
                 gstep0: torch.Tensor | None = None, n_tot: torch.Tensor | None = None,
                 nbr: dict | None = None):
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
        f, w6 = _forces_plain(runner, p, h, want, nbr)
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


def md_forces_virial_plain(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor,
                           nbr: dict | None = None):
    """Plain version of the force entry; see :func:`md_forces_virial`."""
    if runner.spec.k and nbr is None:
        nbr = runner.channels(pos.transpose(1, 2), h_of_h6(h6))
    p = [pos[:, a] for a in range(3)]
    f, w6 = _forces_plain(runner, p, [h6[:, k] for k in range(6)], True, nbr)
    return torch.stack(f, dim=1), torch.stack(w6, dim=1)


# --------------------------------------------------------------------------
# Wrappers: the CUDA kernel on CUDA tensors, the plain version on the CPU

_MAX_SMEM = 232448  # bytes of shared memory a Hopper block can opt into
_SMEM_RED, _SMEM_MISC = 32 * 12, 16  # reduction scratch; NHC chain + broadcasts (floats)
_SMEM_FIXED = _SMEM_RED + _SMEM_MISC


def _smem_rows(spec: FusedSpec) -> int:
    """Rows of N floats one block keeps: positions, velocities and forces
    (9) and the bonded role buffer (12: four roles x three components for
    the chain or pattern terms; SHAKE reuses it for the pre-drift
    positions and one factor row per offset, 3 + n_offsets rows; K5 keeps
    its ten per-atom adjoints there) — the carve of csrc/md_kernel.cuh for
    every flag set."""
    if 3 + len(spec.shake_offsets) > 12:
        raise ValueError(f"K3: {len(spec.shake_offsets)} SHAKE offsets exceed the "
                         "12-row role buffer")
    return 9 + 12


def smem_bytes(spec: FusedSpec, jobs: int = 1) -> int:
    """Shared memory one block of this runner's kernel keeps: ``jobs`` sets
    of the per-job rows and NHC slots (K1m keeps J), one reduction
    scratch."""
    return 4 * (jobs * (_smem_rows(spec) * spec.n_atoms + _SMEM_MISC) + _SMEM_RED)


def max_atoms(spec: FusedSpec) -> int:
    """The largest box this runner's flag set fits in one block."""
    return (_MAX_SMEM // 4 - _SMEM_FIXED) // _smem_rows(spec)


def check_smem(spec: FusedSpec) -> None:
    """Raise on the host when a box exceeds its kernel's shared-memory budget."""
    need = smem_bytes(spec)
    if need > _MAX_SMEM:
        raise ValueError(
            f"{spec.kernel} (flags {spec.flags}): {spec.n_atoms} atoms need {need} B of shared "
            f"memory per block, above the {_MAX_SMEM} B a Hopper block can use; this "
            f"flag set fits at most {max_atoms(spec)} atoms")


def _check_cuda(runner: FusedRunner, *tensors):
    name = runner.spec.kernel
    for t in (runner.lj1, runner.lj2, runner.topo, runner.invm, runner.mftm, runner.qq,
              runner.pat, runner.shk) + tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on the same CUDA device")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"{name} takes float32 (int32 counts and indices), got {t.dtype}")
    check_smem(runner.spec)


def _check_channels(runner: FusedRunner, nbr: dict | None, Bn: int) -> dict:
    """K4's channels, contiguous, each (B, K, N) — or raise."""
    spec = runner.spec
    if nbr is None:
        raise ValueError("K4: a list runner needs its neighbor channels (FusedRunner.channels)")
    out = {}
    for name in runner.channel_names:
        t = nbr[name].contiguous()
        if t.shape != (Bn, spec.k, spec.n_atoms):
            raise ValueError(f"K4: channel {name} shape {tuple(t.shape)} != "
                             f"({Bn}, {spec.k}, {spec.n_atoms})")
        if t.dtype != (torch.int32 if name == "idx" else torch.float32):
            raise TypeError(f"K4: channel {name} has dtype {t.dtype}")
        out[name] = t
    _check_cuda(runner, *out.values())
    return out


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


class _SWC(ctypes.Structure):
    """Mirror of the kernel's SWC: K5's constants (:func:`sw_consts`)."""

    _fields_ = [(name, ctypes.c_float) for name in (
        "rc", "rc2", "sig", "gs", "aeps", "b", "m4b", "lam_eps", "k_s", "k_m", "a_gsq")]


class _MDArgs(ctypes.Structure):
    """Mirror of the kernel's MDArgs, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "lj1", "lj2", "topo", "qq", "pat", "shk", "invm", "mftm", "state", "vxi", "press",
        "n_run", "gstep0", "n_tot", "fscal", "fext", "pos", "h6", "force", "virial",
        "nidx", "nlj1", "nlj2", "nqq", "nimx", "nimy", "nimz")]
        + [(name, ctypes.c_int) for name in ("B", "N", "K", "deform", "sample", "coul",
                                             "ewald")]
        + [(name, ctypes.c_float) for name in (
            "cutoff2", "r2min", "coul_cutoff2", "alpha", "ndof", "boltz", "nktv2p", "tdamp")]
        + [("topo3", _Topo3), ("sw", _SWC)])


def _md_args(runner: FusedRunner, B_: int, nbr: dict | None = None, **ptrs) -> _MDArgs:
    spec = runner.spec
    a = _MDArgs()
    if nbr is not None:
        for name, t in nbr.items():
            setattr(a, "n" + name, t.data_ptr())
    a.invm, a.mftm = _f(runner.invm), _f(runner.mftm)
    for name, t in (("lj1", runner.lj1), ("lj2", runner.lj2), ("topo", runner.topo),
                    ("qq", runner.qq), ("pat", runner.pat), ("shk", runner.shk)):
        if t is not None:
            setattr(a, name, _f(t))
    if spec.sw:
        for name, v in sw_consts(spec).items():
            setattr(a.sw, name, v)
    for name, v in ptrs.items():
        setattr(a, name, v)
    a.B, a.N, a.K = B_, spec.n_atoms, spec.k
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
           gstep0: torch.Tensor | None = None, n_tot: torch.Tensor | None = None,
           nbr: dict | None = None):
    """One whole NVT (+ fix-deform) (+ virial-sampling) run of B jobs.

    state (B, 6, N), vxi (B, 3), n_run (B,) steps per job, fscal (B, 16).
    With ``spec.fext``: fext (B, 3, N) is the frozen k-space force added to
    every step's force.  With ``spec.fext`` or a list (K4), the deform path
    runs from global step ``gstep0`` (B,) of a ``n_tot`` (B,)-step run
    (defaults 0 and n_run).  K4 reads the (B, K, N) channels ``nbr``
    (``FusedRunner.channels``; idx int32).
    Returns (state', vxi', press_sum (B, 6)): press_sum is the sum over the
    job's steps of the instantaneous Voigt pressure without fext's virial
    (zero unless ``sample``).  Inputs are not modified."""
    spec = runner.spec
    if spec.fext != (fext is not None):
        raise ValueError(f"md_run: fext must be given exactly when the runner has the "
                         f"k-space split (spec.fext={spec.fext})")
    if state.device.type == "cpu":
        return md_run_plain(runner, state, vxi, n_run, fscal, deform, sample, fext,
                            gstep0, n_tot, nbr)
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
    if spec.fext or spec.k:
        g0 = (torch.zeros_like(nr) if gstep0 is None else gstep0.to(torch.int32)).contiguous()
        ntot = (nr if n_tot is None else n_tot.to(torch.int32)).contiguous()
        _check_cuda(runner, g0, ntot)
        ptrs.update(gstep0=g0.data_ptr(), n_tot=ntot.data_ptr())
    if spec.fext:
        fx = fext.contiguous()
        if fx.shape != (Bn, 3, N):
            raise ValueError(f"md_run: fext shape {tuple(fx.shape)} != ({Bn}, 3, {N})")
        _check_cuda(runner, fx)
        ptrs.update(fext=fx.data_ptr())
    ch = _check_channels(runner, nbr, Bn) if spec.k else None
    args = _md_args(runner, Bn, ch, **ptrs)
    args.deform, args.sample = int(deform), int(sample)
    entry = _ENTRY[spec.kernel] + "_run_f32"
    rc = getattr(_build.library(), entry)(ctypes.byref(args), _build.stream_handle(st.device))
    _build.check(rc, f"{entry} (flags {spec.flags})")
    _count(md_run, spec)
    return st, xi, press


# exported entry prefix and launch counter of each kernel
_ENTRY = {"K1": "md_allpairs", "K3": "md_allpairs", "K4": "md_list", "K5": "md_sw"}
_COUNTER = {"K1": "launches", "K3": "launches_k3", "K4": "launches_k4", "K5": "launches_k5"}


def _count(fn, spec: FusedSpec) -> None:
    """One launch more on the wrapper's counter of this runner's kernel."""
    attr = _COUNTER[spec.kernel]
    setattr(fn, attr, getattr(fn, attr) + 1)


md_run.launches = 0
md_run.launches_k3 = 0
md_run.launches_k4 = 0
md_run.launches_k5 = 0

# jobs per block K1m is built for (csrc/md_kernel.cuh run_multi_entry)
MULTI_JOBS = (2, 4)


def check_multi(runner: FusedRunner, jobs: int) -> None:
    """Raise ValueError unless K1m takes this runner at ``jobs`` per block:
    K1's flag set only, as the JAX package asserts ``allpairs and not sw
    and not fext`` (md_fused.py:2427, :2458)."""
    if runner.spec.kernel != "K1" or runner.kspace is not None:
        raise ValueError(f"pack_jobs={jobs}: multi-job packing (K1m) runs K1's all-pairs "
                         f"runner only, not {runner.spec.kernel} (flags {runner.spec.flags})")
    if jobs not in MULTI_JOBS:
        raise ValueError(f"pack_jobs={jobs}: K1m is built for {MULTI_JOBS} jobs per block")


def md_run_multi(runner: FusedRunner, state: torch.Tensor, vxi: torch.Tensor,
                 n_run: torch.Tensor, fscal: torch.Tensor, deform: bool, sample: bool,
                 jobs: int):
    """K1m: :func:`md_run` of a K1 runner with ``jobs`` (J) jobs per thread
    block — the TPU kernel's ``FusedSpec.jobs`` packing.  The batch is
    grouped (G, J) in order: jobs g J .. g J + J - 1 share block g; B must
    be a multiple of J (the caller pads with zero-step jobs).  Every job
    keeps K1's per-job semantics, so the result equals :func:`md_run`'s,
    and on the CPU the plain version is :func:`md_run_plain` over the
    grouped batch.  Counts its launches in ``launches_k1m``."""
    check_multi(runner, jobs)
    Bn = state.shape[0]
    if Bn % jobs:
        raise ValueError(f"md_run_multi: {Bn} jobs are not a multiple of {jobs} per block")
    if state.device.type == "cpu":
        return md_run_plain(runner, state, vxi, n_run, fscal, deform, sample)
    if state.device.type != "cuda":
        raise ValueError(f"md_run_multi: unsupported device {state.device}")
    spec = runner.spec
    if state.shape[1:] != (6, spec.n_atoms):
        raise ValueError(f"md_run_multi: state shape {tuple(state.shape)} != "
                         f"(B, 6, {spec.n_atoms})")
    need = smem_bytes(spec, jobs)
    if need > _MAX_SMEM:
        raise ValueError(f"K1m: {jobs} jobs of {spec.n_atoms} atoms need {need} B of shared "
                         f"memory per block, above the {_MAX_SMEM} B a Hopper block can use")
    st = state.contiguous().clone()
    xi = vxi.contiguous().clone()
    nr = n_run.to(torch.int32).contiguous()
    fs = fscal.contiguous()
    _check_cuda(runner, st, xi, nr, fs)
    press = torch.zeros((Bn, 6), dtype=st.dtype, device=st.device)
    if Bn == 0:
        return st, xi, press
    args = _md_args(runner, Bn, None, state=st.data_ptr(), vxi=xi.data_ptr(),
                    press=press.data_ptr(), n_run=nr.data_ptr(), fscal=fs.data_ptr())
    args.deform, args.sample = int(deform), int(sample)
    rc = _build.library().md_allpairs_run_multi_f32(ctypes.byref(args), jobs,
                                                    _build.stream_handle(st.device))
    _build.check(rc, f"md_allpairs_run_multi_f32 (jobs {jobs})")
    md_run_multi.launches_k1m += 1
    return st, xi, press


md_run_multi.launches_k1m = 0


def md_forces_virial(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor,
                     nbr: dict | None = None):
    """Forces and virial of B boxes: pos (B, 3, N) rows, h6 (B, 6) box
    scalars [lx ly lz xy xz yz].  Returns (F (B, 3, N), W (B, 6)) with W
    the Voigt virial sum (pair sum_{i<j} f_ij d (x) d plus the bonded
    terms, in energy units).  Pair terms are LJ and, with ``spec.coul``,
    the cutoff or real-space Ewald Coulomb term; the k-space remainder is
    the caller's (``engine.forces_virial``).  A list runner (K4) builds a
    fresh list at these positions unless given its channels ``nbr``."""
    if runner.spec.k and nbr is None:
        nbr = runner.channels(pos.transpose(1, 2), h_of_h6(h6))
    if pos.device.type == "cpu":
        return md_forces_virial_plain(runner, pos, h6, nbr)
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
    ch = _check_channels(runner, nbr, Bn) if spec.k else None
    args = _md_args(runner, Bn, ch, pos=pos.data_ptr(), h6=h6.data_ptr(),
                    force=force.data_ptr(), virial=vir.data_ptr())
    entry = _ENTRY[spec.kernel] + "_forces_f32"
    rc = getattr(_build.library(), entry)(ctypes.byref(args), _build.stream_handle(pos.device))
    _build.check(rc, f"{entry} (flags {spec.flags})")
    _count(md_forces_virial, spec)
    return force, vir


md_forces_virial.launches = 0
md_forces_virial.launches_k3 = 0
md_forces_virial.launches_k4 = 0
md_forces_virial.launches_k5 = 0


# --------------------------------------------------------------------------
# Engine-level runs (md/engine.py dispatches here)


def h6_of(h: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) upper-triangular box -> (..., 6) [lx ly lz xy xz yz]."""
    return torch.stack([h[..., 0, 0], h[..., 1, 1], h[..., 2, 2],
                        h[..., 0, 1], h[..., 0, 2], h[..., 1, 2]], -1)


def h_of_h6(h6: torch.Tensor) -> torch.Tensor:
    """(..., 6) [lx ly lz xy xz yz] -> (..., 3, 3) upper-triangular box."""
    lx, ly, lz, xy, xz, yz = h6.unbind(-1)
    return B.h_from_lengths_tilts(torch.stack([lx, ly, lz], -1), torch.stack([xy, xz, yz], -1))


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


def _chunk_steps(rebuild_every: int) -> int:
    """The list path's rebuild period: the largest divisor of 10 not above
    ``rebuild_every`` (md_fused.py:2284 — nts is always a multiple of 10)."""
    for d in (10, 5, 2, 1):
        if rebuild_every >= d:
            return d
    return 1


def launch_steps(runner: FusedRunner) -> int:
    """Steps per launch of the chunk loop: the k-space period for K3; for
    K4 the rebuild period, or the shorter of it and the k-space period so
    that both refreshes come on time (md_fused.py:2358-2364)."""
    if not runner.spec.k:
        return runner.kspace_every
    R = _chunk_steps(runner.rebuild_every)
    return min(R, max(1, int(runner.kspace_every))) if runner.kspace is not None else R


def _chunks(runner: FusedRunner, st6, vxi, n_steps, fscal, h0, eps,
            deform: bool, sample: bool):
    """The chunk loop: the rRESPA outer level (md_fused.py:2329-2353,
    :2503-2533) with the smooth k-space remainder frozen at each chunk's
    start, and K4's list rebuilds (:2358-2393, :2534-2569) — one batched
    launch per chunk of :func:`launch_steps` steps.  Each job runs
    min(n - g0, R) trips; finished and inactive jobs none, and only the
    jobs still running get a new remainder and list.  With ``sample``, the
    remainder's virial joins the pressure sums here.  Where a job's step
    count is not a multiple of R its last chunk is short (the JAX list path
    floors the count instead; HMM runs are multiples of 10).
    Returns (st6, vxi, press_sum)."""
    R = launch_steps(runner)
    dtype = st6.dtype
    n_max = int(n_steps.max()) if n_steps.numel() else 0
    ns = torch.clamp(n_steps, min=1)
    conv = runner.spec.nktv2p / B.volume(h0)
    pacc = torch.zeros((st6.shape[0], 6), dtype=dtype, device=st6.device)
    fk = nbr = None
    for c in range(math.ceil(n_max / R)):
        g0 = c * R
        trips = torch.clamp(torch.minimum(n_steps - g0, torch.full_like(n_steps, R)), min=0)
        act = torch.nonzero(trips > 0).flatten()
        h_c = B.deform_path(h0, eps, g0 / ns.to(dtype)) if deform else h0
        pos_c, _ = unpack_state(st6)
        if runner.kspace is not None:
            Fk, Wk = runner.kspace(pos_c[act], h_c[act], want_virial=sample)
            fk = torch.zeros((st6.shape[0], 3, st6.shape[2]), dtype=dtype, device=st6.device)
            fk[act] = Fk.transpose(1, 2).to(dtype)
        if runner.spec.k:
            nbr = runner.channels(pos_c, h_c, jobs=act, reuse=True)
        st6, vxi, pk = md_run(runner, st6, vxi, trips, fscal, deform, sample, fext=fk,
                              gstep0=torch.full_like(n_steps, g0),
                              n_tot=ns if deform else torch.ones_like(n_steps), nbr=nbr)
        pacc = pacc + pk
        if sample and runner.kspace is not None:
            wk = torch.zeros((st6.shape[0], 6), dtype=dtype, device=st6.device)
            wk[act] = Wk.to(dtype)
            pacc = pacc + trips.to(dtype)[:, None] * wk * conv[:, None]
    return st6, vxi, pacc


def run_strain_fused(runner: FusedRunner, state, eps_eff: torch.Tensor,
                     n_steps: torch.Tensor, T, dt):
    """engine.run_strain semantics for a (B,) batch of jobs: NVT with the
    box moved linearly toward ``eps_eff`` over each job's ``n_steps``
    (0 = inactive: state returned unchanged).  One launch for the whole
    run, or one per chunk with the k-space split or a list (K4)."""
    from ..md.engine import MDState

    n_steps = torch.as_tensor(n_steps, device=state.pos.device).to(torch.int64)
    eps = eps_eff.to(state.pos.dtype)
    fscal = make_fscal(dt, T, state.h, eps)
    st6 = pack_state(state.pos, state.vel)
    if runner.kspace is None and not runner.spec.k:
        st6, vxi, _ = md_run(runner, st6, state.vxi, n_steps, fscal, deform=True, sample=False)
    else:
        st6, vxi, _ = _chunks(runner, st6, state.vxi, n_steps, fscal, state.h, eps,
                              deform=True, sample=False)
    pos, vel = unpack_state(st6)
    frac_end = (n_steps > 0).to(state.pos.dtype)
    h_end = B.deform_path(state.h, eps, frac_end)
    return MDState(pos=pos, vel=vel, h=h_end, vxi=vxi)


def _grouped(state):
    """A multi-job run's (G, J)-grouped batch: (flat MDState, J)."""
    if state.pos.dim() != 4:
        raise ValueError(f"multi-job run: state batch {tuple(state.pos.shape[:-2])} is not (G, J)")
    return state.flat(), state.pos.shape[1]


def run_strain_fused_multi(runner: FusedRunner, state, eps_eff: torch.Tensor,
                           n_steps: torch.Tensor, T, dt):
    """:func:`run_strain_fused` on K1m (md_fused.py:2411-2445): ``state``
    leaves, ``eps_eff`` (G, J, 6) and ``n_steps`` (G, J) carry the (G, J)
    grouping, J jobs per block; each job's result is the unpacked run's
    (a job with 0 steps comes back unchanged)."""
    from ..md.engine import MDState

    flat, J = _grouped(state)
    n = torch.as_tensor(n_steps, device=flat.pos.device).to(torch.int64).reshape(-1)
    eps = eps_eff.to(flat.pos.dtype).reshape(-1, 6)
    st6, vxi, _ = md_run_multi(runner, pack_state(flat.pos, flat.vel), flat.vxi, n,
                               make_fscal(dt, T, flat.h, eps), True, False, J)
    pos, vel = unpack_state(st6)
    h_end = B.deform_path(flat.h, eps, (n > 0).to(flat.pos.dtype))
    return MDState(pos=pos, vel=vel, h=h_end, vxi=vxi).unflat(state.batch_shape)


def sample_stress_fused_multi(runner: FusedRunner, state, n_steps: torch.Tensor, T, dt):
    """:func:`sample_stress_fused` on K1m (md_fused.py:2448-2475), over the
    (G, J) grouping; returns (state, mean pressure (G, J, 6))."""
    from ..md.engine import MDState

    flat, J = _grouped(state)
    n = torch.as_tensor(n_steps, device=flat.pos.device).to(torch.int64).reshape(-1)
    st6, vxi, pacc = md_run_multi(runner, pack_state(flat.pos, flat.vel), flat.vxi, n,
                                  make_fscal(dt, T, flat.h), False, True, J)
    pos, vel = unpack_state(st6)
    press = pacc / torch.clamp(n, min=1).to(pacc.dtype)[:, None]
    out = MDState(pos=pos, vel=vel, h=flat.h, vxi=vxi).unflat(state.batch_shape)
    return out, press.reshape(state.batch_shape + (6,))


def sample_stress_fused(runner: FusedRunner, state, n_steps: torch.Tensor, T, dt):
    """engine.sample_stress semantics for a (B,) batch: NVT run returning the
    time-averaged virial pressure (B, 6) in pressure units."""
    from ..md.engine import MDState

    n_steps = torch.as_tensor(n_steps, device=state.pos.device).to(torch.int64)
    fscal = make_fscal(dt, T, state.h)
    st6 = pack_state(state.pos, state.vel)
    if runner.kspace is None and not runner.spec.k:
        st6, vxi, pacc = md_run(runner, st6, state.vxi, n_steps, fscal, deform=False,
                                sample=True)
    else:
        st6, vxi, pacc = _chunks(runner, st6, state.vxi, n_steps, fscal, state.h, None,
                                 deform=False, sample=True)
    pos, vel = unpack_state(st6)
    press = pacc / torch.clamp(n_steps, min=1).to(pacc.dtype)[:, None]
    return MDState(pos=pos, vel=vel, h=state.h, vxi=vxi), press
