"""K1, K3 and K4: the fused MD kernel — whole strain and sampling runs of
many MD jobs in one launch — and its host glue.

The port of the all-pairs LJ/OPLS branch of
``scema_tpu/ops/md_fused.py::_make_kernel`` (launched by ``fused_chunk``):
velocity Verlet with an NHC-3 thermostat (``nhc_half``), all-pairs LJ from
dense lj1/lj2 parameter planes with the special-bond weights folded in
(``forces_allpairs``), minimum image by sequential triclinic rounding
(``refresh_images``), chain bonds, angles and OPLS dihedrals
(``bonded_chain_forces``), the fix-deform remap (``_h_at``,
``_remap_coeffs``) and per-step virial-pressure sampling.  That is K1: its
kernel (``csrc/md_k1.cu``, redesigned for Hopper) reads a per-type table and a
window of chain offsets for the special-bond weights (:func:`k1_tables`)
where the plain version reads the planes, and its force entry runs one
block per (tile of 32 rows, box).  The earlier design, one block per job
and per box over the planes, is ``csrc/md_kernel.cuh`` with every flag off
(``md_allpairs.cu``): K1m copies it, and only the checks reach it
(:func:`_run_first`, :func:`_forces_first`).

K3 is the same kernel with the charged all-atom additions (the reference's
OPLS material: ``lj/cut/coul/long`` + ``pppm`` + ``fix shake``): a Coulomb
pair force, plain cutoff or the damped real-space Ewald form with the A&S
erfc polynomial (``_ewald_fcoul``, ``erfc_poly``); offset-pattern bonded
terms (``bonded_pattern_forces``); Jacobi SHAKE/RATTLE over static partner
offsets (``shake_rolls``, ``rattle_rolls``); and a frozen per-atom force
``fext`` — the smooth k-space remainder, refreshed by the host every
``kspace_every`` steps — with per-job step offsets so a chunk deforms along
its whole run's path.  A runner whose ``spec.k3`` is set launches K3; any
other launches K1.

K4 is the gather-list branch of the same TPU kernel (``forces`` ->
``pair_tile``, ``gather3``; with ``k_chunk`` its HBM-streamed job-grid
form ``_build_streamed_grid_call``, K4s): the pair loop walks a
fixed-width full neighbor list (``md/neighbor.py``), packed by the host at
each chunk start (``FusedRunner.channels``); the pair displacement uses
each step's box.  A runner whose ``spec.k`` is set (boxes above the
all-pairs gate, or ``force_list_kernel``) launches K4, with K3's or K1's
other flags.

K3 and K4 are one kernel body redesigned for Hopper
(``csrc/md_charged.cuh``; ``md_k3.cu`` all-pairs, ``md_k4.cu`` the list):
no N x N planes — a type table, per-atom charges and, for K3, a window of
special-bond offsets (:func:`k3_tables`) — and for K4 one 32-bit word per
live list slot (neighbor, image integers, special-bond order) with a count
per row (:func:`pack_slots`), two rows per thread (K3) or eight list words
in flight per row (K4), and a force entry over (tile of 32 rows, box)
blocks.  Their plain versions read the planes, and
K4's decodes its words back to the seven channels the first design read
(:func:`k4_slots_to_channels`).  The first designs (``csrc/md_kernel.cuh``
with the flags on: ``md_allpairs.cu``, ``md_list.cu`` over
:func:`pack_channels`' seven channels) stay built for the A/B timings and
the checks, reached only through :func:`_run_first` and
:func:`_forces_first`.

K5 is the Stillinger-Weber branch of the same TPU kernel (``FusedSpec.sw``
-> ``forces_allpairs_sw``): the p = 4, q = 0 family (Si) over all pairs in
two sweeps per force call — the per-atom three-body moments (s, m, Q),
then the ordered-pair w = dT/dd from per-atom adjoints in both roles — with
no parameter planes and no bonded terms.  A runner from
:func:`make_runner_sw` launches K5, redesigned for Hopper
(``csrc/md_k5.cu``): sweep 1 writes each atom's live js to a list of
:data:`K5_CAP` slots, sweep 2 walks the list (:func:`k5_forces_list_plain`
models it), and the force entry runs over (tile of 32 rows, box) blocks;
its first design is ``csrc/md_sw.cu`` (:func:`_run_first`).

K4's boxes above one block's shared memory (:func:`max_atoms`, 2509 atoms
with one type) run its cluster form (``csrc/md_k4_big.cu``: one job on a
thread-block cluster of C CTAs, :func:`k4_cluster_size`, each keeping the
job's positions and its own rows in shared memory), up to
:func:`k4_big_max_atoms`; :func:`k4_big` says which a box takes.  The
global form before it (one block per job, its velocities and role/SHAKE
buffer in device memory) stays for the A/B timings, :func:`k4_global_run`.

K1m is K1's run with J jobs per thread block (the TPU kernel's
``FusedSpec.jobs``): :func:`md_run_multi`, behind
:func:`run_strain_fused_multi` and :func:`sample_stress_fused_multi` over a
(G, J) grouping of the batch — the coupler's ``pack_jobs``.  Its redesign
(``csrc/md_k1m.cu``) runs K1's arithmetic per job with the jobs' pair loops
interleaved; its first design (``csrc/md_multi.cu``, J copies of K1's
first design) is :func:`_run_multi_first`.

Three entries, each a wrapper that launches ``csrc/md_k1.cu`` (K1),
``csrc/md_k3.cu`` (K3), ``csrc/md_k1m.cu`` (K1m), ``csrc/md_k4.cu`` or
``csrc/md_k4_big.cu`` (K4) or ``csrc/md_k5.cu`` (K5) on CUDA tensors
(counting the launch: ``launches`` for K1, ``launches_k3`` for K3,
``launches_k4`` for K4, ``launches_k4cluster`` for K4's cluster form
(``launches_k4big`` its global form's, through :func:`k4_global_run`),
``launches_k5`` for K5, ``launches_k1m`` for K1m) and runs the plain
PyTorch version of the same function on CPU tensors:

* :func:`md_run` — one whole run (``deform`` and/or ``sample`` mode) of B
  jobs; the kernel runs one thread block per job;
* :func:`md_run_multi` — the same run of a K1 runner, J jobs per block.
* :func:`md_forces_virial` — one force + virial evaluation of B boxes (FIRE
  minimisation and the stiffness probe; K4 builds a fresh list per call;
  K1, K3 and K4 over (tile, box) blocks); the k-space remainder is added by
  the caller.

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
from ..utils import trace
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
    # K3/K4: the 1-2, 1-3, 1-4 special-bond weights of LJ and Coulomb (K4's
    # slots carry the order and the kernel multiplies by these)
    special_lj: tuple = (0.0, 0.0, 0.0)
    special_coul: tuple = (0.0, 0.0, 0.0)

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
    (K5 has no planes and no topology; K1, K3 and K4 read their type tables,
    charges and special-bond windows or orders, and keep the planes for their
    plain versions and their first designs)."""

    spec: FusedSpec
    invm: torch.Tensor  # (N,) ftm2v / m
    mftm: torch.Tensor  # (N,) m / ftm2v
    lj1: torch.Tensor | None = None  # (N, N) 48 eps sig^12 w, zero diagonal
    lj2: torch.Tensor | None = None  # (N, N) 24 eps sig^6 w
    topo: torch.Tensor | None = None  # (16, N) chain-term rows (zero with patterns)
    qq: torch.Tensor | None = None  # (N, N) qqr2e q_i q_j w_coul (COUL)
    pat: torch.Tensor | None = None  # (R, N) pattern parameter rows (PATTERNS)
    shk: torch.Tensor | None = None  # (n_off, N) SHAKE d0^2 rows (SHAKE)
    # K1 (:func:`k1_tables`): (T, T, 2) lj1/lj2 of (type i, type j), (N,)
    # int32 atom codes, (N, 7) special-bond weights of the offsets -3..3
    k1_tbl: torch.Tensor | None = None
    k1_code: torch.Tensor | None = None
    k1_win: torch.Tensor | None = None
    # K3/K4 (:func:`k3_tables`): (T, T, 2) lj1/lj2 of (type i, type j), (N,)
    # scaled charges sqrt(qqr2e) q_i, (N,) int32 atom codes (K3: with the
    # window's exclusion bits), (N,) int32 window offsets with other weights
    # and their (N, 2W + 1, 2) (lj, coul) weights (K3); K4's (N, N) int8
    # special-bond orders (:func:`k4_orders`), read by the list pack only
    k34_tbl: torch.Tensor | None = None
    k34_q: torch.Tensor | None = None
    k34_code: torch.Tensor | None = None
    k34_spec: torch.Tensor | None = None
    k34_win: torch.Tensor | None = None
    k4_ord: torch.Tensor | None = None
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
    # K4's cluster form: row cuts by CTAs per job (k4_cluster_cuts)
    _cluster: dict = field(default_factory=dict, init=False, compare=False, repr=False)

    def to(self, device=None, dtype=None) -> "FusedRunner":
        def mv(x):
            return None if x is None else x.to(device=device, dtype=dtype).contiguous()

        def mv_int(x):
            return None if x is None else x.to(device=device)

        return replace(self, invm=mv(self.invm), mftm=mv(self.mftm), lj1=mv(self.lj1),
                       lj2=mv(self.lj2), topo=mv(self.topo), qq=mv(self.qq),
                       pat=mv(self.pat), shk=mv(self.shk), k1_tbl=mv(self.k1_tbl),
                       k1_code=mv_int(self.k1_code), k1_win=mv(self.k1_win),
                       k34_tbl=mv(self.k34_tbl), k34_q=mv(self.k34_q),
                       k34_code=mv_int(self.k34_code), k34_spec=mv_int(self.k34_spec),
                       k34_win=mv(self.k34_win), k4_ord=mv_int(self.k4_ord))

    @property
    def channel_names(self) -> tuple:
        """The first design's (B, K, N) channels of K4 (:func:`pack_channels`):
        neighbor index (int32), coefficients, image integers (and qq with
        Coulomb)."""
        return ("idx", "lj1", "lj2", "imx", "imy", "imz") + (("qq",) if self.spec.coul else ())

    def channels(self, pos: torch.Tensor, h: torch.Tensor, jobs: torch.Tensor | None = None,
                 reuse: bool = False) -> dict:
        """K4's compact list for positions pos (B, N, 3) in boxes h (B, 3, 3):
        a fresh list (``neighbor.build``) packed by :func:`pack_slots` into
        ``{"slot": (B, K, N) int32, "count": (B, N) int32}``, built in slices
        of jobs.  ``jobs`` limits the rebuild to those jobs (the others keep
        their last list; a launch that gives them no steps skips them);
        ``reuse`` writes into one buffer set kept per batch size (the chunk
        loop's: 10 MB per job at N = 2240, K = 1112), which the next reusing
        call overwrites."""
        spec = self.spec
        Bn, n = pos.shape[0], spec.n_atoms
        out = self._buffers.get((Bn, pos.device)) if reuse else None
        if out is None:
            # every slot starts dead (self-padded, count 0), so a job that is
            # never rebuilt holds a valid empty list
            out = {"slot": torch.arange(n, dtype=torch.int32, device=pos.device).expand(
                       Bn, spec.k, n).contiguous(),
                   "count": torch.zeros((Bn, n), dtype=torch.int32, device=pos.device)}
            if reuse:
                self._buffers.clear()
                self._buffers[(Bn, pos.device)] = out
        if jobs is None:
            jobs = torch.arange(Bn, device=pos.device)
        step = NB.jobs_per_slice(self.nspec, n)
        for s in range(0, jobs.shape[0], step):
            js = jobs[s:s + step]
            p, hh = pos[js], h[js]
            pack_slots(self, p, hh, NB.build(self.nspec, p, hh), out, js)
        return out

    def channels_first(self, pos: torch.Tensor, h: torch.Tensor) -> dict:
        """The first design's seven (B, K, N) channels (:attr:`channel_names`)
        of a fresh list at pos (B, N, 3) in boxes h (B, 3, 3), packed by
        :func:`pack_channels` — for the A/B timings and the checks only."""
        step = NB.jobs_per_slice(self.nspec, self.spec.n_atoms)
        parts = [pack_channels(self, pos[s:s + step], h[s:s + step],
                               NB.build(self.nspec, pos[s:s + step], h[s:s + step]))
                 for s in range(0, pos.shape[0], step)]
        return {k: torch.cat([p[k] for p in parts]) for k in self.channel_names}


def pack_topo(ff, n_atoms: int, dtype=torch.float64, device=None) -> torch.Tensor:
    """Linear-chain topology -> (16, N) per-atom term rows (the JAX
    package's ``pack_topo``, md_fused.py:2087).  Every bond must be
    (i, i+1), every angle (i, i+1, i+2), every dihedral (i..i+3), and there
    may be no impropers; anything else raises ValueError."""
    why = _topo_refusal(ff)
    if why:
        raise ValueError(why)
    rows = np.zeros((TOPO, n_atoms), dtype=np.float64)
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


def _topo_refusal(ff) -> str | None:
    """Why :func:`pack_topo` refuses a topology, or None."""
    for arr, name, width in ((ff.bonds, "bond", 2), (ff.angles, "angle", 3),
                             (ff.dihedrals, "dihedral", 4)):
        arr = np.asarray(arr)
        if arr.shape[0] and not (arr == arr[:, :1] + np.arange(width)[None, :]).all():
            return f"pack_topo: non-chain {name} topology"
    if np.asarray(ff.impropers).shape[0]:
        return "pack_topo: impropers not supported in chain mode"
    return None


def _pattern_groups(ff) -> tuple[dict, str | None]:
    """The offset patterns of a topology, {key: {anchor: params}}, and why
    :func:`pack_patterns` refuses it (None where it packs)."""
    if np.asarray(ff.impropers).shape[0]:
        return {}, "pack_patterns: impropers not supported"
    groups: dict[tuple, dict[int, tuple]] = {}
    dup = []

    def add(key, anchor, params):
        g = groups.setdefault(key, {})
        if anchor in g:
            dup.append(f"pack_patterns: duplicate {key} at {anchor}")
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
    if dup:
        return groups, dup[0]
    if len(groups) > MAX_PATTERNS:
        return groups, (f"pack_patterns: {len(groups)} patterns > {MAX_PATTERNS} "
                        "(irregular topology)")
    for key in groups:
        if any(abs(o) >= MAX_PATTERN_OFFSET for o in key[1:]):
            return groups, f"pack_patterns: offset too large in {key}"
    return groups, None


def pack_patterns(ff, n_atoms: int, dtype=torch.float64, device=None):
    """Topology -> (static pattern tuple, (R, N) parameter rows) — the JAX
    package's ``pack_patterns`` (md_fused.py:609) without the lane padding.

    Every term is binned by its atom-index offsets from an anchor: bond
    (a, a+o) -> ("bond", o), rows [K, r0]; angle centred at a with partners
    a+oa, a+ob -> ("angle", oa, ob), rows [K, th0]; dihedral (a, a+ob, a+oc,
    a+od) -> ("dihedral", ob, oc, od), rows [K1..K4].  Raises ValueError for
    impropers, more than 64 patterns or an offset of 32 or more."""
    groups, why = _pattern_groups(ff)
    if why:
        raise ValueError(why)
    patterns = tuple(sorted(groups.keys(), key=str))
    rows = []
    for key in patterns:
        block = np.zeros((2 if key[0] in ("bond", "angle") else 4, n_atoms))
        for anchor, params in groups[key].items():
            block[:, anchor] = params
        rows.append(block)
    rows = np.concatenate(rows) if rows else np.zeros((0, n_atoms))
    return patterns, torch.as_tensor(rows, dtype=dtype, device=device)


def _shake_groups(cons_idx, d0) -> tuple[dict, str | None]:
    """The constraints by offset, {offset: {anchor: d0}}, and why
    :func:`pack_shake` refuses them (None where it packs)."""
    groups: dict[int, dict[int, float]] = {}
    for (i, j), d in zip(np.asarray(cons_idx), np.asarray(d0)):
        a, b = (int(i), int(j)) if j > i else (int(j), int(i))
        o = b - a
        if o >= MAX_SHAKE_OFFSET:
            return groups, f"pack_shake: constraint offset {o} too large"
        g = groups.setdefault(o, {})
        if a in g:
            return groups, f"pack_shake: duplicate constraint at {a}+{o}"
        g[a] = float(d)
    return groups, None


def pack_shake(cons_idx, d0, n_atoms: int, dtype=torch.float64, device=None):
    """Constraints -> (static offsets tuple, (n_off, N) d0^2 rows) — the JAX
    package's ``pack_shake`` (md_fused.py:492) without the lane padding.
    Each constraint (i, j) sits at anchor min(i, j) in the row of its
    offset |j - i| < 8 (the [C H H (H)] layout gives 1..3); a zero entry
    disables the slot."""
    groups, why = _shake_groups(cons_idx, d0)
    if why:
        raise ValueError(why)
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


# K1's special-bond window: offsets j - i = -3..3 of a linear chain's 1-2,
# 1-3 and 1-4 partners, and the bit fields of an atom's code
# (csrc/md_k1.cu): type, excluded offsets, offsets with another weight
K1_REACH, K1_WIN = 3, 7
K1_EXCL, K1_SPEC = 8, 16
# rows of one box per block of K1's force + virial entry (md_k1.cu K1_ROWS)
K1_TILE_ROWS = 32


def k1_tables(ff, dtype=torch.float64, device=None):
    """K1's pair parameters without N x N planes: the (T, T, 2) table
    [type i, type j] -> (lj1, lj2) of the planes' entry [j, i] (48 eps
    sig^12 and 24 eps sig^6, built in float64 as :func:`dense_planes`
    builds them, then cast), the (N,) int32 atom codes (bits 0-7 the type,
    bit 8 + d set where the weight of partner j = i + d - 3 is 0, bit 16 + d
    where it is neither 0 nor 1) and the (N, 7) weights of those partners.
    The planes are the table entry times that weight inside the window and
    the bare entry outside it (:func:`k1_dense_planes`).  Raises
    NotImplementedError when a special-bond partner lies outside |j - i| <=
    3, or when K1's block cannot hold the box with its table
    (:func:`smem_refusal`; no box fits from ~170 types, so the code's
    8-bit type field never overflows)."""
    types = ff.types.cpu().numpy()
    n = len(types)
    eps_t, sig_t = (ff.epsilon, ff.sigma) if isinstance(ff, LJ) else (ff.lj_epsilon, ff.lj_sigma)
    n_types, W = _k1_weights(ff)
    why = _k1_refusal(n_types, W)
    if why:
        raise NotImplementedError(why)
    # the planes' entry [j, i] is eps[t_j, t_i]: the table [t_i, t_j] takes the transpose
    eps = eps_t.cpu().double().numpy().T
    sig = sig_t.cpu().double().numpy().T
    sig6 = sig ** 6
    tbl = np.stack([48.0 * eps * sig6 * sig6, 24.0 * eps * sig6], axis=-1)
    code = types.astype(np.int64).copy()
    win = np.zeros((n, K1_WIN))
    for d in range(K1_WIN):
        i = np.arange(max(0, K1_REACH - d), min(n, n + K1_REACH - d))
        w = W[i + d - K1_REACH, i]
        win[i, d] = w
        code[i] |= ((w == 0.0).astype(np.int64) << (K1_EXCL + d)
                    | ((w != 0.0) & (w != 1.0)).astype(np.int64) << (K1_SPEC + d))
    return (torch.as_tensor(tbl, dtype=dtype, device=device),
            torch.as_tensor(code, dtype=torch.int32, device=device),
            torch.as_tensor(win, dtype=dtype, device=device))


def _k1_weights(ff) -> tuple[int, np.ndarray]:
    """The number of atom types and the (N, N) LJ special-bond weights K1
    reads (1 off the diagonal for a plain ``LJ``)."""
    if isinstance(ff, LJ):
        return int(ff.epsilon.shape[0]), 1.0 - np.eye(int(ff.types.shape[0]))
    return int(ff.lj_epsilon.shape[0]), ff.pair_weights(ff.special_lj)


def _k1_refusal(n_types: int, W: np.ndarray) -> str | None:
    """Why K1's window and shared memory cannot hold a system of
    ``n_types`` types and LJ special-bond weights W (N, N), or None."""
    n = W.shape[0]
    off = np.abs(np.arange(n)[:, None] - np.arange(n)[None, :]) > K1_REACH
    if bool((W[off] != 1.0).any()):
        j, i = np.argwhere(off & (W != 1.0))[0]
        return (f"K1: atoms {i} and {j} are special-bond partners {abs(int(j) - int(i))} "
                f"apart; K1's window holds chain partners at most {K1_REACH} apart")
    return smem_refusal(_kernel_spec(n), n_types)


def k1_dense_planes(tbl: torch.Tensor, code: torch.Tensor, win: torch.Tensor):
    """The (N, N) lj1, lj2 planes [j, i] that K1's table and window stand
    for, in their dtype: the entry of (type i, type j), times the window's
    weight in that arithmetic where it is neither 0 nor 1, zero where it is
    0 — what the kernel's pair loop reads."""
    n = code.shape[0]
    t = (code & 0xFF).long()
    planes = tbl[t[None, :], t[:, None]]  # [j, i] -> tbl[t_i, t_j]
    ii = torch.arange(n, device=code.device)
    for d in range(K1_WIN):
        i = ii[max(0, K1_REACH - d):min(n, n + K1_REACH - d)]
        j = i + d - K1_REACH
        excl = ((code[i] >> (K1_EXCL + d)) & 1).bool()
        spec = ((code[i] >> (K1_SPEC + d)) & 1).bool()
        w = win[i, d]
        cur = planes[j, i]
        cur = torch.where(spec[:, None], cur * w[:, None], cur)
        planes[j, i] = torch.where(excl[:, None], torch.zeros_like(cur), cur)
    return planes[..., 0], planes[..., 1]


def dense_qq(ff, dtype=torch.float64, device=None) -> torch.Tensor:
    """Dense (N, N) Coulomb plane qqr2e q_i q_j w with the Coulomb
    special-bond weights (special_coul, separate from LJ's; material.py:
    425-433), zero diagonal."""
    q = ff.charges.cpu().double().numpy() * np.sqrt(QQR2E_REAL)
    return torch.as_tensor(q[:, None] * q[None, :] * ff.pair_weights(ff.special_coul),
                           dtype=dtype, device=device)


# K3/K4 (csrc/md_charged.cuh): the bit fields of an atom's code (type, and
# K3's excluded window offsets from bit 6), the largest window, the most
# types, the rows per block of the force entry, K4's slot word fields
K34_TYPE, K34_EXCL, K34_MAX_WINDOW, K34_MAX_TYPES = 0x3F, 6, 12, 64
K34_TILE_ROWS = 32
K4_MAX_ATOMS, K4_IMAGE = 65535, (-8, 7)


def k3_tables(ff, dtype=torch.float64, device=None, window: bool = True) -> dict:
    """K3's (and K4's) pair parameters without N x N planes, as a dict:

    * ``tbl`` (T, T, 2): [type i, type j] -> (lj1, lj2) of the planes' entry
      [j, i] (48 eps sig^12 and 24 eps sig^6, built in float64 as
      :func:`dense_planes` builds them, then cast);
    * ``q`` (N,): the charges times sqrt(qqr2e), in float64 then cast, so that
      q_i q_j is :func:`dense_qq`'s entry without the weight;
    * ``code`` (N,) int32: bits 0-5 the type and, with ``window``, bit 6 + d
      set where partner j = i + d - W is excluded (its LJ and Coulomb weights
      both 0; d = W is the atom itself);
    * ``spec`` (N,) int32: bit d set where that partner's weights are not
      both 1 (and it is not excluded), ``win`` (N, 2W + 1, 2) their (LJ,
      Coulomb) weights.

    W is the largest offset |j - i| of a special-bond pair of the topology
    (0 without ``window``, as K4 takes the weights from its slots' orders).
    The planes are the table entry (times q_i q_j for qq) times the window's
    weights, zero where excluded, and the bare entry outside the window
    (:func:`k3_dense_planes`).  Raises NotImplementedError when W exceeds
    12 (the code's bits) or for more than 64 atom types."""
    types = ff.types.cpu().numpy()
    n = len(types)
    why = k34_refusal(ff, window)
    if why:
        raise NotImplementedError(why)
    # the planes' entry [j, i] is eps[t_j, t_i]: the table [t_i, t_j] takes the transpose
    eps = ff.lj_epsilon.cpu().double().numpy().T
    sig = ff.lj_sigma.cpu().double().numpy().T
    sig6 = sig ** 6
    tbl = np.stack([48.0 * eps * sig6 * sig6, 24.0 * eps * sig6], axis=-1)
    q = ff.charges.cpu().double().numpy() * np.sqrt(QQR2E_REAL)
    code = types.astype(np.int64).copy()
    spec = np.zeros(n, dtype=np.int64)
    W = 0
    if window:
        wl, wc = ff.pair_weights(ff.special_lj), ff.pair_weights(ff.special_coul)
        W = _k3_reach(wl, wc)[0]
    win = np.zeros((n, 2 * W + 1, 2))
    if window:
        for d in range(2 * W + 1):
            i = np.arange(max(0, W - d), min(n, n + W - d))
            a, c = wl[i + d - W, i], wc[i + d - W, i]
            win[i, d, 0], win[i, d, 1] = a, c
            excl = (a == 0.0) & (c == 0.0)
            code[i] |= excl.astype(np.int64) << (K34_EXCL + d)
            spec[i] |= (~excl & ((a != 1.0) | (c != 1.0))).astype(np.int64) << d
    return dict(tbl=torch.as_tensor(tbl, dtype=dtype, device=device),
                q=torch.as_tensor(q, dtype=dtype, device=device),
                code=torch.as_tensor(code, dtype=torch.int32, device=device),
                spec=torch.as_tensor(spec, dtype=torch.int32, device=device),
                win=torch.as_tensor(win, dtype=dtype, device=device))


def _k3_reach(wl: np.ndarray, wc: np.ndarray) -> tuple[int, tuple]:
    """The largest offset |j - i| of a special-bond pair of the (N, N) LJ and
    Coulomb weights, and one pair (i, j) that reaches it."""
    special = (wl != 1.0) | (wc != 1.0)
    np.fill_diagonal(special, False)
    far = np.argwhere(special)
    if not far.size:
        return 0, (0, 0)
    k = int(np.argmax(np.abs(far[:, 0] - far[:, 1])))
    j, i = far[k]
    return abs(int(j) - int(i)), (int(i), int(j))


def k34_refusal(ff, window: bool = True) -> str | None:
    """Why K3's (``window``) or K4's table cannot hold an OPLS system: more
    than 64 atom types, or (K3) a special-bond partner beyond its window of
    12; None where it can."""
    n_types = int(ff.lj_epsilon.shape[0])
    if n_types > K34_MAX_TYPES:
        return f"K3/K4: {n_types} atom types exceed the {K34_MAX_TYPES}-type table"
    if window:
        W, (i, j) = _k3_reach(ff.pair_weights(ff.special_lj), ff.pair_weights(ff.special_coul))
        if W > K34_MAX_WINDOW:
            return (f"K3: atoms {i} and {j} are special-bond partners {W} apart; K3's window "
                    f"holds partners at most {K34_MAX_WINDOW} apart")
    return None


def k3_window(runner: "FusedRunner") -> int:
    """W of a K3 runner's window (its table holds offsets -W..W)."""
    return (int(runner.k34_win.shape[1]) - 1) // 2


def k3_dense_planes(tbl, q, code, spec, win):
    """The (N, N) lj1, lj2 and qq planes [j, i] that K3's tables stand for,
    in their dtype: the table entry of (type i, type j) and q_j q_i, times
    the window's weights where they are not both 1, zero where excluded —
    what the kernel's pair loop reads."""
    n = code.shape[0]
    W = (win.shape[1] - 1) // 2
    t = (code & K34_TYPE).long()
    planes = tbl[t[None, :], t[:, None]]  # [j, i] -> tbl[t_i, t_j]
    qq = q[:, None] * q[None, :]  # [j, i] = q_j q_i
    ii = torch.arange(n, device=code.device)
    for d in range(2 * W + 1):
        i = ii[max(0, W - d):min(n, n + W - d)]
        j = i + d - W
        excl = ((code[i] >> (K34_EXCL + d)) & 1).bool()
        sp = ((spec[i] >> d) & 1).bool()
        cur = torch.where(sp[:, None], planes[j, i] * win[i, d, 0, None], planes[j, i])
        planes[j, i] = torch.where(excl[:, None], torch.zeros_like(cur), cur)
        cq = torch.where(sp, qq[j, i] * win[i, d, 1], qq[j, i])
        qq[j, i] = torch.where(excl, torch.zeros_like(cq), cq)
    return planes[..., 0], planes[..., 1], qq


def k4_orders(ff, device=None) -> torch.Tensor:
    """The (N, N) int8 special-bond order of each pair (1, 2, 3 for 1-2,
    1-3, 1-4 partners, a later order over an earlier one as in
    ``pair_weights``; 0 for none and on the diagonal), which K4's pack
    writes into each slot."""
    n = int(ff.types.shape[0])
    ordp = np.zeros((n, n), dtype=np.int8)
    rows = np.arange(n)[:, None]
    for order in range(3):
        partners = ff.excl[:, order, :]
        hit = partners >= 0
        ordp[np.broadcast_to(rows, partners.shape)[hit], partners[hit]] = order + 1
    np.fill_diagonal(ordp, 0)
    return torch.as_tensor(ordp, device=device)


def _k4_dropped(spec: FusedSpec, device) -> torch.Tensor:
    """(4,) bool by special order: the slots K4's pack drops (both weights
    0; the Coulomb weight counts only with Coulomb)."""
    drop = [False] + [a == 0.0 and (c == 0.0 or not spec.coul)
                      for a, c in zip(spec.special_lj, spec.special_coul)]
    return torch.tensor(drop, device=device)


def pack_slots(runner: "FusedRunner", pos: torch.Tensor, h: torch.Tensor,
               nbr: NB.NeighborList, out: dict | None = None,
               jobs: torch.Tensor | None = None) -> dict:
    """K4's compact list of the lists ``nbr`` (b, N, k) built at pos (b, N, 3)
    in boxes h (b, 3, 3), written into rows ``jobs`` of ``out`` = {"slot":
    (B, K, N) int32, "count": (B, N) int32} (new tensors by default) —
    the replacement of :func:`pack_channels` on the path, the same on the
    card and the CPU.  One word per slot, slot-major: bits 0-15 the
    neighbor j, 16-19 / 20-23 / 24-27 the image integers n_ij =
    -round(inv_h (x_j - x_i)) (4-bit two's complement), fixed here so that
    x_j + h n_ij - x_i is the minimum image at the build and follows any
    later affine deform, and 28-29 the pair's special-bond order
    (:func:`k4_orders`).  The slots whose LJ and Coulomb weights are both 0
    are dropped; the rest are kept first, in the list's distance order, and
    ``count`` says how many; the tail is self-padded (j = i, image 0).
    Raises ValueError when N exceeds 65535, a list is wider than the
    kernel's K, or an image integer leaves -8..7."""
    spec = runner.spec
    b, n, k = nbr.idx.shape
    if n > K4_MAX_ATOMS:
        raise ValueError(f"pack_slots: {n} atoms exceed the slot word's {K4_MAX_ATOMS}")
    if k > spec.k:
        raise ValueError(f"pack_slots: list width {k} exceeds the kernel's K = {spec.k}")
    if out is None:
        out = {"slot": torch.empty((b, spec.k, n), dtype=torch.int32, device=pos.device),
               "count": torch.empty((b, n), dtype=torch.int32, device=pos.device)}
        jobs = torch.arange(b, device=pos.device)
    idx = nbr.idx
    ii = torch.arange(n, device=pos.device)[:, None]
    order = runner.k4_ord[ii, idx]
    keep = nbr.mask & ~_k4_dropped(spec, pos.device)[order.long()]
    ih = B.inv_h(h)
    flat = idx.reshape(b, n * k)
    d = [torch.gather(pos[..., a], 1, flat).reshape(b, n, k) - pos[..., a, None]
         for a in range(3)]
    word = idx.to(torch.int32) | (order.to(torch.int32) << 28)
    lo, hi = K4_IMAGE
    for a in range(3):
        im = -torch.round(ih[:, a, 0, None, None] * d[0] + ih[:, a, 1, None, None] * d[1]
                          + ih[:, a, 2, None, None] * d[2])
        if bool(((im < lo) | (im > hi)).any()):
            raise ValueError(f"pack_slots: an image integer leaves {lo}..{hi} (box too small "
                             "for the list range, or positions far outside the box)")
        word |= (im.to(torch.int32) & 15) << (16 + 4 * a)
    # the kept slots first, in their order (column k takes the dropped ones
    # and is cut off); the tail self-padded
    dst = torch.where(keep, keep.cumsum(-1) - 1, k)
    full = ii.to(torch.int32).expand(b, n, k + 1).clone()
    full.scatter_(-1, dst, word)
    pad = ii[:, 0].to(torch.int32).expand(b, spec.k - k, n)
    out["slot"].index_copy_(0, jobs, torch.cat([full[..., :k].transpose(1, 2), pad], 1))
    out["count"].index_copy_(0, jobs, keep.sum(-1, dtype=torch.int32))
    return out


def k4_slots_to_channels(runner: "FusedRunner", slots: dict) -> dict:
    """The seven (B, K, N) channels of :func:`pack_channels` that K4's compact
    list stands for, in the runner's dtype: each live slot's index, its
    image integers and its coefficients from the type table and the charges
    times the special weights of its order; every slot past the row's count
    dead (self index, zero coefficients).  K4's plain version runs on
    these; the slots' order is the pack's (the dropped slots absent)."""
    spec = runner.spec
    w = slots["slot"].long()
    b, K, n = w.shape
    live = torch.arange(K, device=w.device)[None, :, None] < slots["count"].long()[:, None, :]
    j = w & 0xFFFF
    t = (runner.k34_code & K34_TYPE).long()
    c = runner.k34_tbl[t[j], t[None, None, :]]  # pack_channels' [i, j] -> tbl[t_j, t_i]
    o = (w >> 28) & 3
    dt = runner.k34_tbl.dtype
    one = torch.ones((1,), dtype=dt, device=w.device)
    wl = torch.cat([one, torch.tensor(spec.special_lj, dtype=dt, device=w.device)])[o]
    zero = torch.zeros((), dtype=dt, device=w.device)
    out = {"idx": j.to(torch.int32)}
    for a, name in enumerate(("lj1", "lj2")):
        out[name] = torch.where(live, torch.where(o > 0, c[..., a] * wl, c[..., a]), zero)
    for a, name in enumerate(("imx", "imy", "imz")):
        f = (w >> (16 + 4 * a)) & 15
        out[name] = (f - 16 * (f >= 8).long()).to(dt)
    if spec.coul:
        wc = torch.cat([one, torch.tensor(spec.special_coul, dtype=dt, device=w.device)])[o]
        qq = runner.k34_q[None, None, :] * runner.k34_q[j]
        out["qq"] = torch.where(live, torch.where(o > 0, qq * wc, qq), zero)
    return out


def _list_channels(runner: "FusedRunner", nbr: dict | None) -> dict | None:
    """The seven channels the plain list loop reads: decoded from K4's compact
    list, or the first design's channels as given."""
    return k4_slots_to_channels(runner, nbr) if nbr is not None and "slot" in nbr else nbr


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
    steps (the all-pairs planes otherwise).  A K1 runner also carries
    its type table and special-bond window (:func:`k1_tables`), a K3 or K4
    runner its table, charges and window (:func:`k3_tables`; K4 the pairs'
    special-bond orders, :func:`k4_orders`).  What no kernel of the port
    runs yet — impropers, irregular topologies, wide constraint offsets,
    special-bond partners beyond K1's or K3's window, for which the JAX
    package falls back to its XLA path — raises NotImplementedError
    (:func:`fused_refusal` says which, and ``material.build_system`` runs
    such a system on the unfused engine)."""
    n = int(masses.shape[0])
    m = masses.to(torch.float64).cpu()
    if isinstance(ff, LJ):
        spec = FusedSpec(n_atoms=n, cutoff2=float(ff.cutoff) ** 2, ndof=3 * n - 3,
                         boltz=units.boltz, ftm2v=units.ftm2v, nktv2p=units.nktv2p,
                         tdamp=tdamp)
        lj1, lj2 = dense_planes(ff, dtype, device)
        return FusedRunner(spec=spec, **_mass_rows(m, units, dtype, device), lj1=lj1, lj2=lj2,
                           topo=torch.zeros((TOPO, n), dtype=dtype, device=device),
                           **_k1_fields(ff, dtype, device))
    patterns, pat = (), None
    try:
        topo = pack_topo(ff, n, dtype, device)
    except ValueError:
        try:
            patterns, pat = pack_patterns(ff, n, dtype, device)
        except ValueError as e:
            raise NotImplementedError(
                f"{e}: no kernel runs this topology; material.build_system takes such a "
                "system to the unfused engine (fused_refusal)") from e
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
                f"{e}: K3/K4 take constraint offsets below {MAX_SHAKE_OFFSET}; "
                "material.build_system takes such a system to the unfused engine, which "
                "runs any set (fused_refusal)") from e
        n_cons = int(torch.count_nonzero(shk))
    spec = FusedSpec(n_atoms=n, cutoff2=float(ff.lj_cutoff) ** 2, ndof=3 * n - 3 - n_cons,
                     boltz=units.boltz, ftm2v=units.ftm2v, nktv2p=units.nktv2p,
                     tdamp=tdamp, coul=coul, coul_cutoff2=float(ff.coul_cutoff) ** 2,
                     ewald_alpha=float(ewald.alpha) if ewald is not None else 0.0,
                     fext=ewald is not None, bonded_pattern=patterns,
                     shake_offsets=shake_offsets, k=int(nspec.k_max) if nspec is not None else 0,
                     special_lj=tuple(float(x) for x in ff.special_lj),
                     special_coul=tuple(float(x) for x in ff.special_coul))
    if spec.kernel == "K1":
        tables = _k1_fields(ff, dtype, device)
    else:
        t = k3_tables(ff, dtype, device, window=spec.kernel == "K3")
        tables = {"k34_" + name: x for name, x in t.items()}
        if spec.kernel == "K4":
            tables["k4_ord"] = k4_orders(ff, device)
    lj1, lj2 = dense_planes(ff, dtype, device)
    return FusedRunner(
        spec=spec, **_mass_rows(m, units, dtype, device), lj1=lj1, lj2=lj2, topo=topo,
        qq=dense_qq(ff, dtype, device) if coul else None, pat=pat, shk=shk,
        kspace=kspace, kspace_every=kspace_every, nspec=nspec, rebuild_every=rebuild_every,
        **tables)


def fused_refusal(ff, masses: torch.Tensor, constraints=None,
                  list_kernel: bool = False) -> str | None:
    """Why no kernel of the port runs an OPLS or LJ system, or None where
    K1, K3 or (``list_kernel``) K4 does: the checks :func:`make_runner`
    makes, as a predicate, so that ``material.build_system`` chooses the
    unfused engine before it builds a runner.  The JAX package takes its
    XLA route where its ``_build_fused_runner`` returns None
    (material.py:253-310): impropers, a topology that fits neither the
    chain rows nor the offset patterns, constraint offsets that
    :func:`pack_shake` refuses.  The port's route also takes what the
    Hopper redesigns refuse where the TPU kernels read planes: more atom
    types than K3/K4's table holds (64), special-bond partners beyond K1's
    window of 3 or K3's of 12, and boxes above the
    kernel's shared-memory budget for their type count (:func:`smem_refusal`,
    the test :func:`check_smem` makes at launch: K1 keeps its (T, T) table
    beside 22 rows of N floats, so it fits 1714 atoms at 100 types and none
    from ~170; K3 and K4's shared form 23 rows, K4's cluster form 20 B per
    atom and 72 per row of a CTA)."""
    if isinstance(ff, LJ):
        return _k1_refusal(*_k1_weights(ff))
    if np.asarray(ff.impropers).shape[0]:
        return "impropers"
    patterns, offsets = {}, {}
    if _topo_refusal(ff):
        patterns, why = _pattern_groups(ff)
        if why:
            return f"irregular topology ({why})"
    if constraints is not None and len(constraints.idx):
        offsets, why = _shake_groups(constraints.idx, constraints.d0)
        if why:
            return f"constraint offsets ({why})"
    # the kernel make_runner's spec would select
    spec = _kernel_spec(int(masses.shape[0]), coul=bool(torch.any(ff.charges != 0)),
                        fext=ff.ewald is not None, bonded_pattern=tuple(patterns),
                        shake_offsets=tuple(offsets), k=int(list_kernel))
    if spec.kernel == "K1":
        return _k1_refusal(*_k1_weights(ff))
    return (k34_refusal(ff, window=spec.kernel == "K3")
            or smem_refusal(spec, int(ff.lj_epsilon.shape[0])))


def _kernel_spec(n_atoms: int, **flags) -> FusedSpec:
    """A spec of ``n_atoms`` with the flags that select a kernel and size its
    shared memory, the rest zero."""
    return FusedSpec(n_atoms=n_atoms, cutoff2=0.0, ndof=0, boltz=0.0, ftm2v=0.0, nktv2p=0.0,
                     **flags)


def _k1_fields(ff, dtype, device) -> dict:
    """A K1 runner's table, codes and window (:func:`k1_tables`)."""
    tbl, code, win = k1_tables(ff, dtype, device)
    return dict(k1_tbl=tbl, k1_code=code, k1_win=win)


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


def _sw_block_plain(spec, p, h6, want_virial, walk=None):
    """K5's two sweeps on (b, N) rows over the (b, N, N) ordered pairs
    (``forces_allpairs_sw``, md_fused.py:910-1081), centre i on axis 1,
    neighbour j on axis 2, d = r_j - r_i by the sequential triclinic
    minimum image (``block_geom``, :func:`_sw_disp`).  ``walk`` (b, N, N)
    bool: the ordered pairs sweep 2 takes (K5's lists,
    :func:`k5_forces_list_plain`; default every live pair).

    Sweep 1: per-atom moments s = sum g, m = sum g u, Q = sum g u (x) u with
    g = exp(gam sig / (r - rc)) on live pairs (r2 < (rc - 1e-6)^2, r2 >
    1e-8, j != i); sum g^2 is not needed, its adjoint being a constant.
    Adjoints: a_s = lam eps c0^2 s, a_m = -2 lam eps c0 m, a_Q = lam eps Q.
    Sweep 2: w_A with the centre's adjoints, w_B with the neighbour's
    (direction -u); f_i = sum_j (w_A - w_B); the virial W -= sym(w_A (x) d)
    over role A's ordered pairs."""
    c = sw_consts(spec)
    n = p[0].shape[-1]
    (dx, dy, dz), r2 = _sw_disp(torch.stack(p, 1), torch.stack(h6, 1))
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
    sel = mask if walk is None else walk & mask
    wa = [torch.where(sel, x, zero) for x in wa]
    wb = [torch.where(sel, x, zero) for x in wb]
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
    """Plain version of the run entry; see :func:`md_run`.  K4's plain
    version reads the seven channels its compact list stands for
    (:func:`k4_slots_to_channels`), or the first design's channels as given."""
    spec = runner.spec
    nbr = _list_channels(runner, nbr)
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
    nbr = _list_channels(runner, nbr)
    p = [pos[:, a] for a in range(3)]
    f, w6 = _forces_plain(runner, p, [h6[:, k] for k in range(6)], True, nbr)
    return torch.stack(f, dim=1), torch.stack(w6, dim=1)


def k1_tiles_plain(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor,
                   rows: int = K1_TILE_ROWS):
    """K1's force + virial entry as its kernel tiles it, in the plain
    version's arithmetic: the tile of rows [s, s + rows) takes those rows'
    pair forces over every j, the chain roles of anchors s - 3 .. s + rows
    - 1 (the 3 anchors before the tile recomputed as its halo) gathered on
    its rows, and a partial virial — the pair halves of its rows and the
    terms of the anchors it owns; the partials are summed in tile order.
    Returns (F (B, 3, N), W (B, 6)), :func:`md_forces_virial_plain`'s."""
    spec = runner.spec
    n = spec.n_atoms
    p = [pos[:, a] for a in range(3)]
    lx, ly, lz, xy, xz, yz = (h6[:, k, None, None] for k in range(6))
    force = torch.empty_like(pos)
    vir = torch.zeros((pos.shape[0], 6), dtype=pos.dtype, device=pos.device)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        # d[b, i, j] = r_j - r_i for the tile's rows i
        d = [p[a][:, None, :] - p[a][:, s:e, None] for a in range(3)]
        n3 = torch.round(d[2] / lz)
        d[2] = d[2] - n3 * lz
        d[1] = d[1] - n3 * yz
        n2 = torch.round(d[1] / ly)
        d[1] = d[1] - n2 * ly
        d[0] = d[0] - n3 * xz - n2 * xy
        n1 = torch.round(d[0] / lx)
        d[0] = d[0] - n1 * lx
        r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
        fpair = _fpair_plain(spec, r2, runner.lj1[s:e], runner.lj2[s:e], None)
        fp, wp = _apply_plain(fpair, *d, -1, True)
        halo = torch.zeros_like(runner.topo)
        halo[:, max(s - K1_REACH, 0):e] = runner.topo[:, max(s - K1_REACH, 0):e]
        fb, _ = bonded_chain_forces_plain(p, halo)
        own = torch.zeros_like(runner.topo)
        own[:, s:e] = runner.topo[:, s:e]
        _, Wb = bonded_chain_forces_plain(p, own)
        for a in range(3):
            force[:, a, s:e] = fp[a] + fb[a][:, s:e]
        vir = vir + torch.stack([x + y for x, y in zip(wp, _sym6(Wb))], dim=1)
    return force, vir


def pattern_reach(patterns) -> tuple:
    """(anchors before, anchors after) a row whose bonded pattern roles land
    on it: the largest positive and negative offsets of the patterns."""
    offs = [o for key in patterns for o in key[1:]]
    return max([0] + offs), max([0] + [-o for o in offs])


def k34_tiles_plain(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor,
                    nbr: dict | None = None, rows: int = K34_TILE_ROWS):
    """K3's or K4's force + virial entry as its kernel tiles it, in the plain
    version's arithmetic: the tile of rows [s, s + rows) takes those rows'
    pair forces (K3 over every j, K4 over their list slots) and a partial
    virial, the pair halves of its rows; the bonded terms come from the
    tile's anchors and a halo around them, recomputed per tile — the
    patterns' anchors within :func:`pattern_reach` of the tile, whose
    virial on the tile's rows is sum_i f_i (x) r_i, or the chain's anchors s
    - 3 .. s + rows - 1, the tile owning the terms of its own anchors.  The
    partials are summed in tile order.  Returns (F (B, 3, N), W (B, 6)),
    :func:`md_forces_virial_plain`'s."""
    spec = runner.spec
    n = spec.n_atoms
    if spec.k:
        if nbr is None:
            nbr = runner.channels(pos.transpose(1, 2), h_of_h6(h6))
        nbr = _list_channels(runner, nbr)
    p = [pos[:, a] for a in range(3)]
    h = [h6[:, k] for k in range(6)]
    lx, ly, lz, xy, xz, yz = (x[:, None, None] for x in h)
    force = torch.empty_like(pos)
    vir = torch.zeros((pos.shape[0], 6), dtype=pos.dtype, device=pos.device)
    lo, hi = pattern_reach(spec.bonded_pattern) if spec.bonded_pattern else (K1_REACH, 0)
    for s in range(0, n, rows):
        e = min(s + rows, n)
        if spec.k:
            # the tile's rows of every slot: the list loop on a (b, K, rows) view
            rows_nbr = {k: v[:, :, s:e] for k, v in nbr.items()}
            b, K = rows_nbr["idx"].shape[:2]
            flat = rows_nbr["idx"].reshape(b, -1).long()
            g = [torch.gather(x, 1, flat).reshape(b, K, e - s) for x in p]
            nx, ny, nz = rows_nbr["imx"], rows_nbr["imy"], rows_nbr["imz"]
            d = [g[0] + nx * lx + ny * xy + nz * xz - p[0][:, None, s:e],
                 g[1] + ny * ly + nz * yz - p[1][:, None, s:e], g[2] + nz * lz - p[2][:, None, s:e]]
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            fpair = _fpair_plain(spec, r2, rows_nbr["lj1"], rows_nbr["lj2"], rows_nbr.get("qq"),
                                 above=r2 > spec.r2min)
            fp, wp = _apply_plain(fpair, *d, 1, True)
        else:
            # d[b, i, j] = r_j - r_i for the tile's rows i
            d = [p[a][:, None, :] - p[a][:, s:e, None] for a in range(3)]
            n3 = torch.round(d[2] / lz)
            d[2] = d[2] - n3 * lz
            d[1] = d[1] - n3 * yz
            n2 = torch.round(d[1] / ly)
            d[1] = d[1] - n2 * ly
            d[0] = d[0] - n3 * xz - n2 * xy
            n1 = torch.round(d[0] / lx)
            d[0] = d[0] - n1 * lx
            r2 = d[0] * d[0] + d[1] * d[1] + d[2] * d[2]
            fpair = _fpair_plain(spec, r2, runner.lj1[s:e], runner.lj2[s:e],
                                 runner.qq[s:e] if spec.coul else None)
            fp, wp = _apply_plain(fpair, *d, -1, True)
        a0, a1 = max(s - lo, 0), min(e + hi, n)
        if spec.bonded_pattern:
            halo = torch.zeros_like(runner.pat)
            halo[:, a0:a1] = runner.pat[:, a0:a1]
            fb, _ = bonded_pattern_forces_plain(p, halo, spec.bonded_pattern)
            fr = [x[:, s:e] for x in fb]
            pr = [x[:, s:e] for x in p]
            wb = [torch.sum(fr[0] * pr[0], -1), torch.sum(fr[1] * pr[1], -1),
                  torch.sum(fr[2] * pr[2], -1),
                  0.5 * torch.sum(fr[0] * pr[1] + fr[1] * pr[0], -1),
                  0.5 * torch.sum(fr[0] * pr[2] + fr[2] * pr[0], -1),
                  0.5 * torch.sum(fr[1] * pr[2] + fr[2] * pr[1], -1)]
        else:
            halo = torch.zeros_like(runner.topo)
            halo[:, a0:e] = runner.topo[:, a0:e]
            fb, _ = bonded_chain_forces_plain(p, halo)
            own = torch.zeros_like(runner.topo)
            own[:, s:e] = runner.topo[:, s:e]
            _, Wb = bonded_chain_forces_plain(p, own)
            wb = _sym6(Wb)
        for a in range(3):
            force[:, a, s:e] = fp[a] + fb[a][:, s:e]
        vir = vir + torch.stack([x + y for x, y in zip(wp, wb)], dim=1)
    return force, vir


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
    """Shared memory one block of this runner's md_kernel.cuh kernel keeps
    (K5, K1m and the first designs of K1, K3 and K4): ``jobs`` sets of the
    per-job rows and NHC slots (K1m keeps J), one reduction scratch."""
    return 4 * (jobs * (_smem_rows(spec) * spec.n_atoms + _SMEM_MISC) + _SMEM_RED)


# K1 (csrc/md_k1.cu) keeps 22 rows of N floats (a float4 of position and
# code, velocities, forces, the role buffer), its type table, the reduction
# scratch and the NHC chain + broadcast
_K1_ROWS, _K1_MISC = 22, 4


def k1_smem_bytes(spec: FusedSpec, n_types: int = 1) -> int:
    """Shared memory one block of K1's run kernel keeps with a table of
    ``n_types`` atom types (md_k1.cu k1_run_smem)."""
    return 4 * (_K1_ROWS * spec.n_atoms + 2 * n_types ** 2 + _SMEM_RED + _K1_MISC)


# K3/K4 (csrc/md_charged.cuh) keep 23 rows of N floats (a float4 of
# position and code, velocities, forces, the role buffer, the charges), the
# type table, the reduction scratch and the NHC chain + broadcast
_K34_ROWS = 23
# K4's global form (md_k4_big.cu, V_GLOBAL; the A/B partner of the cluster
# form, reached only through k4_global_run) keeps 8 of them and the other
# 15 in a (B, 15, N) scratch in device memory
K4_SCRATCH_ROWS = 15


def _k34_rows_fit(rows: int, n_types: int) -> int:
    return (_MAX_SMEM // 4 - 2 * n_types ** 2 - _SMEM_RED - _K1_MISC) // rows


# K4's cluster form (csrc/md_k4_big.cu) runs one job on C CTAs (a power of
# two up to K4_CLUSTER_MAX; above 8 the card's non-portable cluster sizes).
# Each CTA keeps the whole job's float4 and charges (20 B per atom) and
# the type table, 18 floats per row it owns (velocities, forces, the
# 12-row role/SHAKE buffer) and a halo of _CL_HALO rows on each side in that
# buffer, the block and cluster reduction slots and the NHC chain.  The
# host moves each even cut by at most _CL_SLACK // 2 rows to where no SHAKE
# constraint crosses it, so the budget counts _CL_SLACK rows more per CTA.
K4_CLUSTER_MAX = 16
_CL_HALO, _CL_SLACK = 32, 16
_CL_FIXED = 4 * (12 * 2 * _CL_HALO + _SMEM_RED + 2 * K4_CLUSTER_MAX * 12 + 4)
_CL_SIZES = tuple(1 << k for k in range(K4_CLUSTER_MAX.bit_length()))
_SMS = 132  # streaming multiprocessors of an H100 SXM


def k4_cluster_smem_bytes(n_atoms: int, n_types: int, rows: int) -> int:
    """Shared memory one CTA of K4's cluster form keeps at ``rows`` rows of
    its own (md_k4_big.cu cl_smem)."""
    return 20 * n_atoms + 8 * n_types ** 2 + 72 * rows + _CL_FIXED


def _cluster_rows(n_atoms: int, C: int) -> int:
    """The most rows a CTA of C per job may own (the budget's)."""
    return min(n_atoms, -(-n_atoms // C) + _CL_SLACK)


def k4_cluster_fits(n_atoms: int, n_types: int = 1) -> tuple:
    """The cluster sizes whose CTA holds this box in its shared memory."""
    return tuple(C for C in _CL_SIZES
                 if k4_cluster_smem_bytes(n_atoms, n_types, _cluster_rows(n_atoms, C))
                 <= _MAX_SMEM)


def k4_cluster_size(n_atoms: int, n_types: int, jobs: int, active=None, sms: int = _SMS) -> int:
    """CTAs per job of a K4 cluster-form run of ``jobs`` jobs: the fewest
    whose CTA fits (:func:`k4_cluster_fits`), doubled while the larger size
    still runs every job at once on one CTA per SM — jobs x 2C <= ``sms``
    (the card's SMs, 132 on an H100 SXM) and the card holds ``jobs``
    clusters of 2C.  More CTAs per job only pay
    where SMs would idle: each CTA keeps the whole job's positions and runs
    every pass of a step, so a CTA of fewer rows works at a lower rate, and
    a batch larger than one wave of clusters pays a wave per remainder.
    ``active(C)`` is how many clusters of C the card holds at once (the
    wrapper asks the card, cudaOccupancyMaxActiveClusters); by default one
    CTA per SM, sms // C.  Raises where none fits or the card can hold no
    cluster of the size chosen."""
    fits = k4_cluster_fits(n_atoms, n_types)
    if not fits:
        raise ValueError(f"K4's cluster form: {n_atoms} atoms of {n_types} atom types fit no "
                         f"cluster of up to {K4_CLUSTER_MAX} CTAs")
    held = active if active is not None else (lambda c: sms // c)
    C = fits[0]
    while 2 * C in fits and jobs * 2 * C <= sms and held(2 * C) >= jobs:
        C *= 2
    if held(C) < 1:
        raise _build.KernelError(f"K4's cluster form: the card schedules no cluster of {C} "
                                 f"CTAs for {n_atoms} atoms of {n_types} atom types")
    return C


def k4_big(spec: FusedSpec, n_types: int = 1) -> bool:
    """Whether a K4 run of this box takes K4's cluster form: its box is above
    the shared form's cap (:func:`max_atoms`)."""
    return spec.kernel == "K4" and spec.n_atoms > _k34_rows_fit(_K34_ROWS, n_types)


def k4_big_max_atoms(spec: FusedSpec, n_types: int = 1) -> int:
    """The largest box K4's cluster form holds with a table of ``n_types``
    atom types: its CTA fits at :data:`K4_CLUSTER_MAX` CTAs per job (the
    force entry, 5 rows of N floats, fits wider boxes)."""
    lo, hi = 0, (_MAX_SMEM - 8 * n_types ** 2 - _CL_FIXED) // 20 + 1
    while hi - lo > 1:  # fits lo, not hi (the budget grows with the box)
        mid = (lo + hi) // 2
        lo, hi = (mid, hi) if k4_cluster_fits(mid, n_types) else (lo, mid)
    return lo


def k34_smem_bytes(spec: FusedSpec, n_types: int = 1) -> int:
    """Shared memory one block of K3's or K4's run kernel keeps with a table
    of ``n_types`` atom types (md_charged.cuh c_run_smem), in the form the
    box takes: above the shared form's cap, one CTA of K4's cluster form at
    the fewest CTAs per job that fit, or at :data:`K4_CLUSTER_MAX` where
    none fits (md_k4_big.cu cl_smem)."""
    _smem_rows(spec)  # SHAKE's rows must fit the role buffer
    n = spec.n_atoms
    if k4_big(spec, n_types):
        fits = k4_cluster_fits(n, n_types)
        C = fits[0] if fits else K4_CLUSTER_MAX
        return k4_cluster_smem_bytes(n, n_types, _cluster_rows(n, C))
    return 4 * (_K34_ROWS * n + 2 * n_types ** 2 + _SMEM_RED + _K1_MISC)


# K5 (csrc/md_k5.cu) keeps a float4 of position and 16 rows of N floats
# (velocities, forces, ten adjoints), the reduction scratch and 8 misc
# floats, and cap + 1 rows of N 16-bit list slots and live counts
_K5_ROW_BYTES, _K5_MISC = 4 * (4 + 16), 8


def k5_smem_bytes(spec: FusedSpec) -> int:
    """Shared memory one block of K5's run kernel keeps with its live list
    of :data:`K5_CAP` slots per atom (md_k5.cu k5_run_smem)."""
    return ((_K5_ROW_BYTES + 2 * (K5_CAP + 1)) * spec.n_atoms
            + 4 * (_SMEM_RED + _K5_MISC))


def max_atoms(spec: FusedSpec, n_types: int = 1) -> int:
    """The largest box this runner's kernel fits in one block (K1, K3 and
    K4 with a table of ``n_types`` atom types; for K4 its shared form's, above
    which a run takes the cluster form up to :func:`k4_big_max_atoms`)."""
    if spec.kernel in ("K1", "K3", "K4"):
        return _k34_rows_fit(_K1_ROWS if spec.kernel == "K1" else _K34_ROWS, n_types)
    return ((_MAX_SMEM - 4 * (_SMEM_RED + _K5_MISC))
            // (_K5_ROW_BYTES + 2 * (K5_CAP + 1)))


def check_smem(spec: FusedSpec, n_types: int = 1) -> None:
    """Raise on the host when a box exceeds its kernel's shared-memory budget
    (K1's, K3's and K4's, with a table of ``n_types`` atom types, cover their
    first designs', which keep fewer rows; K4 above its shared form's cap is
    held to its cluster form's CTA; K5's run, with its live list, keeps more
    than its first design and the force entry)."""
    need = (k1_smem_bytes(spec, n_types) if spec.kernel == "K1"
            else k34_smem_bytes(spec, n_types) if spec.kernel in ("K3", "K4")
            else k5_smem_bytes(spec))
    if need > _MAX_SMEM:
        cap, form = ((k4_big_max_atoms(spec, n_types), " in K4's cluster form")
                     if spec.kernel == "K4" else (max_atoms(spec, n_types), ""))
        raise ValueError(
            f"{spec.kernel} (flags {spec.flags}): {spec.n_atoms} atoms need {need} B of shared "
            f"memory per block{form}, above the {_MAX_SMEM} B a Hopper block can use; this "
            f"flag set fits at most {cap} atoms")


def smem_refusal(spec: FusedSpec, n_types: int) -> str | None:
    """Why K1's, K3's or K4's block cannot hold this box with a table of
    ``n_types`` atom types, or None: :func:`check_smem`'s test, from the
    same budget functions, as a reason for the route (``fused_refusal``)."""
    need = (k1_smem_bytes(spec, n_types) if spec.kernel == "K1"
            else k34_smem_bytes(spec, n_types))
    if need <= _MAX_SMEM:
        return None
    form = " in its cluster form" if spec.kernel == "K4" else ""
    cap = k4_big_max_atoms(spec, n_types) if form else max_atoms(spec, n_types)
    types = f"{n_types} atom type" + ("s" if n_types > 1 else "")
    return (f"{spec.kernel}: {spec.n_atoms} atoms of {types} need {need} B of shared "
            f"memory per block, above the {_MAX_SMEM} B a Hopper block can use; "
            f"{spec.kernel}{form} fits " + (f"at most {cap} atoms" if cap > 0 else "no box")
            + f" of {types}")


def _check_cuda(runner: FusedRunner, *tensors):
    name = runner.spec.kernel
    for t in (runner.lj1, runner.lj2, runner.topo, runner.invm, runner.mftm, runner.qq,
              runner.pat, runner.shk, runner.k1_tbl, runner.k1_code, runner.k1_win,
              runner.k34_tbl, runner.k34_q, runner.k34_code, runner.k34_spec,
              runner.k34_win) + tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: all operands must be on the same CUDA device")
        if t.dtype not in (torch.float32, torch.int32):
            raise TypeError(f"{name} takes float32 (int32 counts and indices), got {t.dtype}")
    tbl = runner.k1_tbl if runner.k1_tbl is not None else runner.k34_tbl
    check_smem(runner.spec, 1 if tbl is None else int(tbl.shape[0]))


def _check_slots(runner: FusedRunner, nbr: dict | None, Bn: int) -> dict:
    """K4's compact list, contiguous: slot (B, K, N) and count (B, N) int32 —
    or raise."""
    spec = runner.spec
    if nbr is None or "slot" not in nbr:
        raise ValueError("K4: a list runner needs its compact list (FusedRunner.channels)")
    out = {}
    for name, shape in (("slot", (Bn, spec.k, spec.n_atoms)), ("count", (Bn, spec.n_atoms))):
        t = nbr[name].contiguous()
        if t.shape != shape:
            raise ValueError(f"K4: {name} shape {tuple(t.shape)} != {shape}")
        if t.dtype != torch.int32:
            raise TypeError(f"K4: {name} has dtype {t.dtype}, not int32")
        out[name] = t
    _check_cuda(runner, *out.values())
    return out


def _check_channels(runner: FusedRunner, nbr: dict | None, Bn: int) -> dict:
    """The first design's K4 channels, contiguous, each (B, K, N) — or raise."""
    spec = runner.spec
    if nbr is None or "idx" not in nbr:
        raise ValueError("K4's first design needs its seven channels "
                         "(FusedRunner.channels_first)")
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
    _fill_topo3(a.topo3, spec)
    return a


def _fill_topo3(t3: _Topo3, spec: FusedSpec) -> None:
    """The kernel's Topo3: pattern kinds, offsets and parameter rows, SHAKE
    offsets and iteration counts."""
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
    (defaults 0 and n_run).  K4 reads its compact list ``nbr``
    (``FusedRunner.channels``: {"slot": (B, K, N), "count": (B, N)}, int32);
    on the CPU its plain version also takes the first design's seven
    channels (``FusedRunner.channels_first``).
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
    st, xi, nr, fs, press = _run_inputs(runner, state, vxi, n_run, fscal, "md_run")
    Bn, N = st.shape[0], spec.n_atoms
    if Bn == 0:
        return st, xi, press
    ptrs = dict(state=st.data_ptr(), vxi=xi.data_ptr(), press=press.data_ptr(),
                n_run=nr.data_ptr(), fscal=fs.data_ptr())
    if spec.kernel == "K1":
        _k1_run(runner, Bn, deform, sample, ptrs)
    elif spec.kernel == "K4" and k4_big(spec, int(runner.k34_tbl.shape[0])):
        _k4_cluster_chunk(runner, ptrs, nr, fext, gstep0, n_tot, nbr, deform, sample)
        md_run.launches_k4cluster += 1
        return st, xi, press
    elif spec.kernel in ("K3", "K4"):
        _k34_chunk(runner, False, ptrs, nr, fext, gstep0, n_tot, nbr, deform, sample)
    else:
        _k5_run(runner, Bn, deform, sample, ptrs, K5_CAP)
    _count(md_run, spec)
    return st, xi, press


def _k34_chunk(runner: FusedRunner, big: bool, ptrs: dict, nr, fext, gstep0, n_tot, nbr,
               deform: bool, sample: bool) -> None:
    """Launch a K3 or K4 run (with ``big`` K4's global form, the A/B
    partner, its velocities and role buffer in a (B, 15, N) scratch) on the pointers of
    :func:`_run_inputs`' operands."""
    spec = runner.spec
    Bn = nr.shape[0]
    keep = _chunk_ptrs(runner, ptrs, nr, fext, gstep0, n_tot)
    if big:
        keep += (torch.empty((Bn, K4_SCRATCH_ROWS, spec.n_atoms), dtype=runner.invm.dtype,
                             device=nr.device),)
        ptrs.update(scratch=keep[-1].data_ptr())
    _k34_run(runner, "md_k4_big_run_f32" if big else _K34_ENTRY[spec.kernel] + "_run_f32", Bn,
             deform, sample, ptrs, _check_slots(runner, nbr, Bn) if spec.k else None)
    del keep


def k4_global_run(runner: FusedRunner, state: torch.Tensor, vxi: torch.Tensor,
                  n_run: torch.Tensor, fscal: torch.Tensor, deform: bool, sample: bool,
                  fext: torch.Tensor | None = None, gstep0: torch.Tensor | None = None,
                  n_tot: torch.Tensor | None = None, nbr: dict | None = None):
    """:func:`md_run` of a K4 runner on K4's global form (one block per job,
    its velocities and role buffer in device memory) whatever its box size,
    for chip_smoke.py's timings against the shared and the cluster form;
    no path launches it.  Counted in ``md_run.launches_k4big``."""
    if runner.spec.kernel != "K4" or state.device.type != "cuda":
        raise ValueError("k4_global_run: a K4 runner on the card")
    st, xi, nr, fs, press = _run_inputs(runner, state, vxi, n_run, fscal, "k4_global_run")
    if st.shape[0]:
        _k34_chunk(runner, True, dict(state=st.data_ptr(), vxi=xi.data_ptr(),
                                      press=press.data_ptr(), n_run=nr.data_ptr(),
                                      fscal=fs.data_ptr()),
                   nr, fext, gstep0, n_tot, nbr, deform, sample)
        md_run.launches_k4big += 1
    return st, xi, press


def _shake_split(runner: FusedRunner) -> np.ndarray:
    """(N + 1,) bool: a SHAKE constraint (a, a + o) with a < c <= a + o
    splits at cut c.  Cached on the runner."""
    got = runner._cluster.get("split")
    if got is None:
        n = runner.spec.n_atoms
        got = np.zeros(n + 1, bool)
        if runner.shk is not None:
            rows = runner.shk.detach().cpu().numpy()
            for k, o in enumerate(runner.spec.shake_offsets):
                a = np.nonzero(rows[k] > 0)[0]
                for d in range(1, o + 1):
                    got[np.minimum(a + d, n)] = True
        runner._cluster["split"] = got
    return got


def k4_cluster_cuts(runner: FusedRunner, C: int, cuts=None) -> tuple:
    """(row cuts (C + 1,), cross) of a K4 cluster-form run with C CTAs per
    job: CTA r owns rows [cuts[r], cuts[r + 1]).  Each cut is the even split
    moved by at most _CL_SLACK // 2 rows, nearest first, to where no SHAKE
    constraint crosses it (or the given ``cuts``); ``cross`` says that some
    cut still splits a constraint (the kernel then reads the partner from
    its CTA).  Cached on the runner."""
    split = _shake_split(runner)
    if cuts is not None:
        return tuple(int(c) for c in cuts), bool(any(split[c] for c in cuts[1:-1]))
    got = runner._cluster.get(C)
    if got is None:
        n = runner.spec.n_atoms
        cuts = [0]
        for r in range(1, C):
            even = round(r * n / C)
            near = [even + d for m in range(_CL_SLACK // 2 + 1) for d in ((m, -m) if m else (0,))]
            cuts.append(next((c for c in near if cuts[-1] < c < n and not split[c]), even))
        cuts.append(n)
        got = runner._cluster[C] = (tuple(cuts), bool(any(split[c] for c in cuts[1:-1])))
    return got


_CLUSTER_INFO: dict = {}


def k4_cluster_kernel_info(n_atoms: int, n_types: int, C: int, rows: int | None = None) -> dict:
    """Registers, local (spill) bytes per thread, clusters of C CTAs the
    card holds at once (cudaOccupancyMaxActiveClusters), threads and shared
    bytes per CTA of K4's cluster-form run kernel (the charged slices' flag
    set) at ``n_atoms`` atoms of ``n_types`` types and ``rows`` rows per CTA
    (default the budget's).  Cached."""
    rows = _cluster_rows(n_atoms, C) if rows is None else rows
    key = (n_atoms, n_types, C, rows)
    if key not in _CLUSTER_INFO:
        out = (ctypes.c_int * 5)()
        rc = _build.library().md_k4_cluster_info(n_atoms, n_types, rows, C, out)
        _build.check(rc, f"K4 cluster info (C={C}, {rows} rows)")
        _CLUSTER_INFO[key] = dict(zip(("registers", "local_bytes", "clusters", "threads",
                                       "smem_bytes"), out))
    return _CLUSTER_INFO[key]


def k4_cluster_plan(runner: FusedRunner, jobs: int, cluster: int | None = None,
                    cuts=None) -> dict:
    """The launch of a K4 cluster-form run of ``jobs`` jobs on the card: C
    (:func:`k4_cluster_size` with the card's resident clusters, or
    ``cluster``), the cuts and cross flag (:func:`k4_cluster_cuts`) and
    the kernel's info at those rows."""
    n, T = runner.spec.n_atoms, int(runner.k34_tbl.shape[0])

    def info(C, cut=None):
        cut = k4_cluster_cuts(runner, C, cut)[0]
        return k4_cluster_kernel_info(n, T, C, int(max(np.diff(cut))))

    sms = torch.cuda.get_device_properties(runner.invm.device).multi_processor_count
    C = (len(cuts) - 1 if cuts is not None else cluster
         or k4_cluster_size(n, T, jobs, active=lambda c: info(c)["clusters"], sms=sms))
    cut, cross = k4_cluster_cuts(runner, C, cuts)
    return dict(C=C, cuts=cut, cross=cross, rows=int(max(np.diff(cut))), **info(C, cuts))


def _k4_cluster_chunk(runner: FusedRunner, ptrs: dict, nr, fext, gstep0, n_tot, nbr,
                      deform: bool, sample: bool, cluster: int | None = None,
                      cuts=None) -> None:
    """Launch K4's cluster form (md_k4_big.cu) on the pointers of
    :func:`_run_inputs`' operands (C and the cuts by
    :func:`k4_cluster_plan`).  A launch the card refuses raises."""
    spec = runner.spec
    Bn = nr.shape[0]
    keep = _chunk_ptrs(runner, ptrs, nr, fext, gstep0, n_tot)
    plan = k4_cluster_plan(runner, Bn, cluster, cuts)
    if plan["clusters"] < 1:
        raise _build.KernelError(f"K4's cluster form: the card holds no cluster of {plan['C']} "
                                 f"CTAs of {plan['smem_bytes']} B")
    args = _K4ClArgs()
    args.a = _k34_args(runner, Bn, _check_slots(runner, nbr, Bn), **ptrs)
    args.a.deform, args.a.sample = int(deform), int(sample)
    args.C, args.rmax, args.cross = plan["C"], plan["rows"], int(plan["cross"])
    for r, c in enumerate(plan["cuts"]):
        args.cut[r] = c
    rc = _build.library().md_k4_cluster_run_f32(ctypes.byref(args),
                                                _build.stream_handle(nr.device))
    _build.check(rc, f"md_k4_cluster_run_f32 (flags {spec.flags}, {plan['C']} CTAs per job)")
    del keep


def k4_cluster_run(runner: FusedRunner, state: torch.Tensor, vxi: torch.Tensor,
                   n_run: torch.Tensor, fscal: torch.Tensor, deform: bool, sample: bool,
                   fext: torch.Tensor | None = None, gstep0: torch.Tensor | None = None,
                   n_tot: torch.Tensor | None = None, nbr: dict | None = None,
                   cluster: int | None = None, cuts=None):
    """:func:`md_run` of a K4 runner on K4's cluster form with C =
    ``cluster`` CTAs per job or the given row ``cuts`` (C + 1 of them), for
    chip_smoke.py's checks and timings of other cluster sizes and of cuts
    that split SHAKE constraints; md_run takes the host's choice.  Counted
    in ``md_run.launches_k4cluster``."""
    if runner.spec.kernel != "K4" or state.device.type != "cuda":
        raise ValueError("k4_cluster_run: a K4 runner on the card")
    st, xi, nr, fs, press = _run_inputs(runner, state, vxi, n_run, fscal, "k4_cluster_run")
    if st.shape[0]:
        _k4_cluster_chunk(runner, dict(state=st.data_ptr(), vxi=xi.data_ptr(),
                                       press=press.data_ptr(), n_run=nr.data_ptr(),
                                       fscal=fs.data_ptr()),
                          nr, fext, gstep0, n_tot, nbr, deform, sample, cluster, cuts)
        md_run.launches_k4cluster += 1
    return st, xi, press


def _chunk_ptrs(runner: FusedRunner, ptrs: dict, nr, fext, gstep0, n_tot) -> tuple:
    """Add a K3/K4 run's per-job step offsets (defaults 0 and n_run) and, with
    the k-space split, its frozen force to the launch pointers; returns the
    tensors behind them (kept alive until the launch)."""
    Bn, N = nr.shape[0], runner.spec.n_atoms
    g0 = (torch.zeros_like(nr) if gstep0 is None else gstep0.to(torch.int32)).contiguous()
    ntot = (nr if n_tot is None else n_tot.to(torch.int32)).contiguous()
    _check_cuda(runner, g0, ntot)
    ptrs.update(gstep0=g0.data_ptr(), n_tot=ntot.data_ptr())
    fx = None
    if runner.spec.fext:
        fx = fext.contiguous()
        if fx.shape != (Bn, 3, N):
            raise ValueError(f"md_run: fext shape {tuple(fx.shape)} != ({Bn}, 3, {N})")
        _check_cuda(runner, fx)
        ptrs.update(fext=fx.data_ptr())
    return g0, ntot, fx


def _run_inputs(runner: FusedRunner, state, vxi, n_run, fscal, name: str):
    """A run's CUDA operands as contiguous copies, checked, and its zeroed
    pressure sums: (state', vxi', n_run int32, fscal, press)."""
    spec = runner.spec
    Bn, six, N = state.shape
    if six != 6 or N != spec.n_atoms:
        raise ValueError(f"{name}: state shape {tuple(state.shape)} != (B, 6, {spec.n_atoms})")
    st = state.contiguous().clone()
    xi = vxi.contiguous().clone()
    nr = n_run.to(torch.int32).contiguous()
    fs = fscal.contiguous()
    _check_cuda(runner, st, xi, nr, fs)
    return st, xi, nr, fs, torch.zeros((Bn, 6), dtype=st.dtype, device=st.device)


def _md_run_entry(runner: FusedRunner, entry: str, device, Bn: int, deform: bool,
                  sample: bool, ptrs: dict, nbr: dict | None = None) -> None:
    """Launch an md_kernel.cuh run entry (K5, the first designs of K1, K3
    and K4)."""
    args = _md_args(runner, Bn, nbr, **ptrs)
    args.deform, args.sample = int(deform), int(sample)
    rc = getattr(_build.library(), entry)(ctypes.byref(args), _build.stream_handle(device))
    _build.check(rc, f"{entry} (flags {runner.spec.flags})")


# exported entry prefix of K3's and K4's redesign (md_charged.cuh) and of
# the first designs of K1, K3 and K4 (md_kernel.cuh), and the launch
# counter of each kernel on its wrapper
_K34_ENTRY = {"K3": "md_k3", "K4": "md_k4"}
_FIRST_ENTRY = {"K1": "md_allpairs", "K3": "md_allpairs", "K4": "md_list", "K5": "md_sw"}
_COUNTER = {"K1": "launches", "K3": "launches_k3", "K4": "launches_k4", "K5": "launches_k5"}


def _count(fn, spec: FusedSpec) -> None:
    """One launch more on the wrapper's counter of this runner's kernel."""
    attr = _COUNTER[spec.kernel]
    setattr(fn, attr, getattr(fn, attr) + 1)


md_run.launches = 0
md_run.launches_k3 = 0
md_run.launches_k4 = 0
md_run.launches_k4cluster = 0  # K4's cluster form (boxes above the shared form's cap)
md_run.launches_k4big = 0  # K4's global form (its A/B partner: k4_global_run only)
md_run.launches_k5 = 0

# jobs per block K1m is built for (csrc/md_k1m.cu; its first design in
# md_multi.cu)
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


def k1m_smem_bytes(spec: FusedSpec, jobs: int, n_types: int = 1) -> int:
    """Shared memory one block of K1m's run kernel keeps: ``jobs`` sets of
    K1's 22 rows of N floats, one type table of ``n_types`` types, a J-wide
    reduction scratch and J NHC slots (md_k1m.cu k1m_smem)."""
    return 4 * (jobs * (_K1_ROWS * spec.n_atoms + _SMEM_RED + 4) + 2 * n_types ** 2)


def _multi_inputs(runner: FusedRunner, state, vxi, n_run, fscal, jobs: int, name: str):
    """A K1m run's CUDA operands as :func:`_run_inputs` gives them, after
    the (G, J) grouping's checks."""
    Bn = state.shape[0]
    if Bn % jobs:
        raise ValueError(f"{name}: {Bn} jobs are not a multiple of {jobs} per block")
    if state.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {state.device}")
    return _run_inputs(runner, state, vxi, n_run, fscal, name)


def md_run_multi(runner: FusedRunner, state: torch.Tensor, vxi: torch.Tensor,
                 n_run: torch.Tensor, fscal: torch.Tensor, deform: bool, sample: bool,
                 jobs: int):
    """K1m: :func:`md_run` of a K1 runner with ``jobs`` (J) jobs per thread
    block — the TPU kernel's ``FusedSpec.jobs`` packing.  The batch is
    grouped (G, J) in order: jobs g J .. g J + J - 1 share block g; B must
    be a multiple of J (the caller pads with zero-step jobs).  Every job
    keeps K1's per-job semantics (csrc/md_k1m.cu: K1's arithmetic per job,
    the jobs' pair loops interleaved), so the result is :func:`md_run`'s,
    and on the CPU the plain version is :func:`md_run_plain` over the
    grouped batch.  Counts its launches in ``launches_k1m``."""
    check_multi(runner, jobs)
    if state.device.type == "cpu":
        if state.shape[0] % jobs:
            raise ValueError(f"md_run_multi: {state.shape[0]} jobs are not a multiple of "
                             f"{jobs} per block")
        return md_run_plain(runner, state, vxi, n_run, fscal, deform, sample)
    st, xi, nr, fs, press = _multi_inputs(runner, state, vxi, n_run, fscal, jobs,
                                          "md_run_multi")
    need = k1m_smem_bytes(runner.spec, jobs, int(runner.k1_tbl.shape[0]))
    if need > _MAX_SMEM:
        raise ValueError(f"K1m: {jobs} jobs of {runner.spec.n_atoms} atoms need {need} B of "
                         f"shared memory per block, above the {_MAX_SMEM} B a Hopper block "
                         f"can use")
    Bn = st.shape[0]
    if Bn == 0:
        return st, xi, press
    args = _k1_args(runner, Bn, state=st.data_ptr(), vxi=xi.data_ptr(), press=press.data_ptr(),
                    n_run=nr.data_ptr(), fscal=fs.data_ptr())
    args.deform, args.sample = int(deform), int(sample)
    rc = _build.library().md_k1m_run_f32(ctypes.byref(args), jobs,
                                         _build.stream_handle(st.device))
    _build.check(rc, f"md_k1m_run_f32 (jobs {jobs})")
    md_run_multi.launches_k1m += 1
    return st, xi, press


md_run_multi.launches_k1m = 0


def _run_multi_first(runner: FusedRunner, state: torch.Tensor, vxi: torch.Tensor,
                     n_run: torch.Tensor, fscal: torch.Tensor, deform: bool, sample: bool,
                     jobs: int):
    """:func:`md_run_multi` on K1m's first design (csrc/md_multi.cu: J
    copies of K1's first design in turn per block), for the A/B timings and
    the checks only; no path calls it.  Counts its launches in
    ``launches_k1m``."""
    check_multi(runner, jobs)
    st, xi, nr, fs, press = _multi_inputs(runner, state, vxi, n_run, fscal, jobs,
                                          "_run_multi_first")
    need = smem_bytes(runner.spec, jobs)
    if need > _MAX_SMEM:
        raise ValueError(f"K1m's first design: {jobs} jobs of {runner.spec.n_atoms} atoms need "
                         f"{need} B of shared memory per block, above {_MAX_SMEM} B")
    Bn = st.shape[0]
    if Bn == 0:
        return st, xi, press
    args = _md_args(runner, Bn, None, state=st.data_ptr(), vxi=xi.data_ptr(),
                    press=press.data_ptr(), n_run=nr.data_ptr(), fscal=fs.data_ptr())
    args.deform, args.sample = int(deform), int(sample)
    rc = _build.library().md_allpairs_run_multi_f32(ctypes.byref(args), jobs,
                                                    _build.stream_handle(st.device))
    _build.check(rc, f"md_allpairs_run_multi_f32 (jobs {jobs})")
    _run_multi_first.launches_k1m += 1
    return st, xi, press


_run_multi_first.launches_k1m = 0


def k1m_kernel_info(jobs: int, n_atoms: int, n_types: int = 1, sample: bool = False) -> dict:
    """Registers, local (spill) bytes per thread, resident blocks per SM and
    block width of K1m's deform-run kernel (or, with ``sample``, its
    sampling kernel) at ``jobs`` jobs per block."""
    out = (ctypes.c_int * 4)()
    _build.check(_build.library().md_k1m_info(jobs, int(sample), n_atoms, n_types, out),
                 f"md_k1m_info (jobs {jobs})")
    return _info(out)


def md_forces_virial(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor,
                     nbr: dict | None = None):
    """Forces and virial of B boxes: pos (B, 3, N) rows, h6 (B, 6) box
    scalars [lx ly lz xy xz yz].  Returns (F (B, 3, N), W (B, 6)) with W
    the Voigt virial sum (pair sum_{i<j} f_ij d (x) d plus the bonded
    terms, in energy units).  Pair terms are LJ and, with ``spec.coul``,
    the cutoff or real-space Ewald Coulomb term; the k-space remainder is
    the caller's (``engine.forces_virial``).  A list runner (K4) builds a
    fresh list at these positions unless given its compact list ``nbr``."""
    if runner.spec.k and nbr is None:
        nbr = runner.channels(pos.transpose(1, 2), h_of_h6(h6))
    if pos.device.type == "cpu":
        return md_forces_virial_plain(runner, pos, h6, nbr)
    if pos.device.type != "cuda":
        raise ValueError(f"md_forces_virial: unsupported device {pos.device}")
    spec = runner.spec
    pos, h6, force, vir = _forces_inputs(runner, pos, h6)
    Bn = pos.shape[0]
    if Bn == 0:
        return force, vir
    if spec.kernel == "K1":
        _k1_forces(runner, pos, h6, force, vir)
    elif spec.kernel in ("K3", "K4"):
        _k34_forces(runner, pos, h6, force, vir,
                    _check_slots(runner, nbr, Bn) if spec.k else None)
    else:
        _k5_forces(runner, pos, h6, force, vir)
    _count(md_forces_virial, spec)
    return force, vir


def _forces_inputs(runner: FusedRunner, pos, h6):
    """A force call's CUDA operands, contiguous and checked, and its outputs:
    (pos, h6, force, virial)."""
    Bn, three, N = pos.shape
    if three != 3 or N != runner.spec.n_atoms:
        raise ValueError(f"md_forces_virial: pos shape {tuple(pos.shape)} != "
                         f"(B, 3, {runner.spec.n_atoms})")
    pos = pos.contiguous()
    h6 = h6.contiguous()
    _check_cuda(runner, pos, h6)
    return (pos, h6, torch.empty_like(pos),
            torch.empty((Bn, 6), dtype=pos.dtype, device=pos.device))


def _md_forces_entry(runner: FusedRunner, entry: str, pos, h6, force, vir,
                     nbr: dict | None = None) -> None:
    """Launch an md_kernel.cuh force entry (K5, the first designs of K1, K3
    and K4)."""
    args = _md_args(runner, pos.shape[0], nbr, pos=pos.data_ptr(), h6=h6.data_ptr(),
                    force=force.data_ptr(), virial=vir.data_ptr())
    rc = getattr(_build.library(), entry)(ctypes.byref(args), _build.stream_handle(pos.device))
    _build.check(rc, f"{entry} (flags {runner.spec.flags})")


md_forces_virial.launches = 0
md_forces_virial.launches_k3 = 0
md_forces_virial.launches_k4 = 0
md_forces_virial.launches_k5 = 0


# --------------------------------------------------------------------------
# K1 (csrc/md_k1.cu): the type table and special-bond window in place of
# the planes, two blocks per SM, the force entry over (box, tile) blocks

class _K1Args(ctypes.Structure):
    """Mirror of md_k1.cu's K1Args, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "tbl", "code", "win", "topo", "invm", "mftm", "state", "vxi", "press",
        "n_run", "fscal", "pos", "h6", "force", "virial", "partial")]
        + [(name, ctypes.c_int) for name in ("B", "N", "T", "deform", "sample", "tiles")]
        + [(name, ctypes.c_float) for name in (
            "cutoff2", "r2min", "ndof", "boltz", "nktv2p", "tdamp")])


def k1_tiles(n_atoms: int) -> int:
    """Row tiles of one box in K1's force entry."""
    return -(-n_atoms // K1_TILE_ROWS)


def _k1_args(runner: FusedRunner, B_: int, **ptrs) -> _K1Args:
    spec = runner.spec
    if runner.k1_tbl is None or runner.k1_code is None or runner.k1_win is None:
        raise ValueError("K1: the runner has no type table and window (make_runner builds them)")
    a = _K1Args()
    for name, t in (("tbl", runner.k1_tbl), ("code", runner.k1_code), ("win", runner.k1_win),
                    ("topo", runner.topo),
                    ("invm", runner.invm), ("mftm", runner.mftm)):
        setattr(a, name, _f(t))
    for name, v in ptrs.items():
        setattr(a, name, v)
    a.B, a.N, a.T, a.tiles = B_, spec.n_atoms, int(runner.k1_tbl.shape[0]), k1_tiles(spec.n_atoms)
    a.cutoff2, a.r2min = spec.cutoff2, spec.r2min
    a.ndof, a.boltz, a.nktv2p, a.tdamp = float(spec.ndof), spec.boltz, spec.nktv2p, spec.tdamp
    return a


def _k1_run(runner: FusedRunner, Bn: int, deform: bool, sample: bool, ptrs: dict) -> None:
    args = _k1_args(runner, Bn, **ptrs)
    args.deform, args.sample = int(deform), int(sample)
    rc = _build.library().md_k1_run_f32(ctypes.byref(args),
                                        _build.stream_handle(runner.invm.device))
    _build.check(rc, "md_k1_run_f32")


def _k1_forces(runner: FusedRunner, pos, h6, force, vir) -> None:
    """K1's force entry: one block per (tile, box), the tiles' partial
    virials in a (B, tiles, 6) scratch summed in tile order by the entry's
    second kernel."""
    partial = torch.empty((pos.shape[0], k1_tiles(runner.spec.n_atoms), 6), dtype=pos.dtype,
                          device=pos.device)
    args = _k1_args(runner, pos.shape[0], pos=pos.data_ptr(), h6=h6.data_ptr(),
                    force=force.data_ptr(), virial=vir.data_ptr(), partial=partial.data_ptr())
    rc = _build.library().md_k1_forces_f32(ctypes.byref(args), _build.stream_handle(pos.device))
    _build.check(rc, "md_k1_forces_f32")


def _first_design(runner: FusedRunner, device, name: str) -> None:
    if runner.spec.kernel not in _FIRST_ENTRY:
        raise ValueError(f"{name}: the first designs take K1, K3, K4 or K5 runners, not "
                         f"{runner.spec.kernel}")
    if device.type != "cuda":
        raise ValueError(f"{name}: the first designs run on the card only, not on {device}")


def _run_first(runner: FusedRunner, state: torch.Tensor, vxi: torch.Tensor,
               n_run: torch.Tensor, fscal: torch.Tensor, deform: bool, sample: bool,
               fext: torch.Tensor | None = None, gstep0: torch.Tensor | None = None,
               n_tot: torch.Tensor | None = None, nbr: dict | None = None):
    """:func:`md_run` of a K1, K3, K4 or K5 runner on that kernel's first
    design (md_kernel.cuh, one block per job over the N x N planes; K4 over
    the seven channels of ``FusedRunner.channels_first`` in ``nbr``; K5's
    two full sweeps), which K1m's first design copies J times per block: for
    the A/B timings and the checks of chip_smoke.py and the card tests; no
    path of the port calls it.  Counts its launches in ``launches`` (K1),
    ``launches_k3``, ``launches_k4`` and ``launches_k5``."""
    _first_design(runner, state.device, "_run_first")
    spec = runner.spec
    if spec.fext != (fext is not None):
        raise ValueError("_run_first: fext goes with the k-space split, and only with it")
    st, xi, nr, fs, press = _run_inputs(runner, state, vxi, n_run, fscal, "_run_first")
    Bn = st.shape[0]
    if Bn == 0:
        return st, xi, press
    ptrs = dict(state=st.data_ptr(), vxi=xi.data_ptr(), press=press.data_ptr(),
                n_run=nr.data_ptr(), fscal=fs.data_ptr())
    keep = (_chunk_ptrs(runner, ptrs, nr, fext, gstep0, n_tot) if spec.kernel in ("K3", "K4")
            else None)
    _md_run_entry(runner, _FIRST_ENTRY[spec.kernel] + "_run_f32", st.device, Bn, deform,
                  sample, ptrs, _check_channels(runner, nbr, Bn) if spec.k else None)
    del keep
    _count(_run_first, spec)
    return st, xi, press


def _forces_first(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor,
                  nbr: dict | None = None):
    """:func:`md_forces_virial` of a K1, K3 or K4 runner on its first design
    (one block per box; K4 builds the first design's channels at these
    positions unless given them in ``nbr``), as :func:`_run_first`."""
    _first_design(runner, pos.device, "_forces_first")
    if runner.spec.k and nbr is None:
        nbr = runner.channels_first(pos.transpose(1, 2), h_of_h6(h6))
    pos, h6, force, vir = _forces_inputs(runner, pos, h6)
    Bn = pos.shape[0]
    if Bn == 0:
        return force, vir
    _md_forces_entry(runner, _FIRST_ENTRY[runner.spec.kernel] + "_forces_f32", pos, h6, force,
                     vir, _check_channels(runner, nbr, Bn) if runner.spec.k else None)
    _count(_forces_first, runner.spec)
    return force, vir


for _fn in (_run_first, _forces_first):
    _fn.launches = _fn.launches_k3 = _fn.launches_k4 = _fn.launches_k5 = 0


def k1_kernel_info(entry: str, n_atoms: int, n_types: int = 1) -> dict:
    """Registers, local (spill) bytes per thread, resident blocks per SM (the
    card's occupancy calculator) and block width of K1's run kernel
    (``entry="run"``) or force kernel (``"forces"``) at ``n_atoms`` atoms of
    ``n_types`` types."""
    out = (ctypes.c_int * 4)()
    rc = _build.library().md_k1_info({"run": 0, "forces": 1}[entry], n_atoms, n_types, out)
    _build.check(rc, f"md_k1_info ({entry})")
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "threads"), out))


# --------------------------------------------------------------------------
# K3 and K4 (csrc/md_charged.cuh): the type table, charges and special-bond
# window or slot orders in place of the planes, K4's compact list, the force
# entry over (box, tile) blocks

class _K34Args(ctypes.Structure):
    """Mirror of md_charged.cuh's CArgs, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "tbl", "q", "code", "spec", "win", "topo", "pat", "shk", "invm", "mftm", "state", "vxi",
        "press", "n_run", "gstep0", "n_tot", "fscal", "fext", "pos", "h6", "force", "virial",
        "partial", "slot", "count", "scratch")]
        + [(name, ctypes.c_int) for name in (
            "B", "N", "T", "K", "W", "deform", "sample", "tiles", "coul", "ewald", "reach_lo",
            "reach_hi")]
        + [(name, ctypes.c_float) for name in (
            "cutoff2", "r2min", "coul_cutoff2", "alpha", "ndof", "boltz", "nktv2p", "tdamp")]
        + [("slj", ctypes.c_float * 4), ("sco", ctypes.c_float * 4), ("topo3", _Topo3)])


class _K4ClArgs(ctypes.Structure):
    """Mirror of md_k4_big.cu's ClArgs: K4's operands, the CTAs per job,
    their most rows, whether a SHAKE constraint crosses a cut and the row
    cuts."""

    _fields_ = [("a", _K34Args), ("C", ctypes.c_int), ("rmax", ctypes.c_int),
                ("cross", ctypes.c_int), ("cut", ctypes.c_int * (K4_CLUSTER_MAX + 1))]


def k34_tiles(n_atoms: int) -> int:
    """Row tiles of one box in K3's and K4's force entry."""
    return -(-n_atoms // K34_TILE_ROWS)


def _k34_args(runner: FusedRunner, B_: int, slots: dict | None = None, **ptrs) -> _K34Args:
    spec = runner.spec
    if runner.k34_tbl is None or runner.k34_code is None:
        raise ValueError(f"{spec.kernel}: the runner has no type table (make_runner builds it)")
    a = _K34Args()
    for name, t in (("tbl", runner.k34_tbl), ("q", runner.k34_q), ("code", runner.k34_code),
                    ("spec", runner.k34_spec), ("win", runner.k34_win), ("topo", runner.topo),
                    ("pat", runner.pat), ("shk", runner.shk), ("invm", runner.invm),
                    ("mftm", runner.mftm)):
        if t is not None:
            setattr(a, name, _f(t))
    if slots is not None:
        a.slot, a.count = slots["slot"].data_ptr(), slots["count"].data_ptr()
    for name, v in ptrs.items():
        setattr(a, name, v)
    a.B, a.N, a.T, a.K = B_, spec.n_atoms, int(runner.k34_tbl.shape[0]), spec.k
    a.W = 0 if spec.k else k3_window(runner)
    a.tiles = k34_tiles(spec.n_atoms)
    a.coul, a.ewald = int(spec.coul), int(spec.ewald_alpha > 0.0)
    a.reach_lo, a.reach_hi = pattern_reach(spec.bonded_pattern)
    a.cutoff2, a.r2min, a.coul_cutoff2, a.alpha = (spec.cutoff2, spec.r2min,
                                                   spec.coul_cutoff2, spec.ewald_alpha)
    a.ndof, a.boltz, a.nktv2p, a.tdamp = float(spec.ndof), spec.boltz, spec.nktv2p, spec.tdamp
    for k in range(3):
        a.slj[k + 1], a.sco[k + 1] = spec.special_lj[k], spec.special_coul[k]
    a.slj[0] = a.sco[0] = 1.0
    _fill_topo3(a.topo3, spec)
    return a


def _k34_run(runner: FusedRunner, entry: str, Bn: int, deform: bool, sample: bool,
             ptrs: dict, slots: dict | None) -> None:
    """Launch K3's or K4's run entry (``entry``)."""
    args = _k34_args(runner, Bn, slots, **ptrs)
    args.deform, args.sample = int(deform), int(sample)
    rc = getattr(_build.library(), entry)(ctypes.byref(args),
                                          _build.stream_handle(runner.invm.device))
    _build.check(rc, f"{entry} (flags {runner.spec.flags})")


def _k34_forces(runner: FusedRunner, pos, h6, force, vir, slots: dict | None) -> None:
    """K3's or K4's force entry: one block per (tile, box), the tiles'
    partial virials in a (B, tiles, 6) scratch summed in tile order by the
    entry's second kernel."""
    partial = torch.empty((pos.shape[0], k34_tiles(runner.spec.n_atoms), 6), dtype=pos.dtype,
                          device=pos.device)
    args = _k34_args(runner, pos.shape[0], slots, pos=pos.data_ptr(), h6=h6.data_ptr(),
                     force=force.data_ptr(), virial=vir.data_ptr(), partial=partial.data_ptr())
    entry = _K34_ENTRY[runner.spec.kernel] + "_forces_f32"
    rc = getattr(_build.library(), entry)(ctypes.byref(args), _build.stream_handle(pos.device))
    _build.check(rc, f"{entry} (flags {runner.spec.flags})")


def k34_kernel_info(kernel: str, entry: str, n_atoms: int, n_types: int = 1) -> dict:
    """Registers, local (spill) bytes per thread, resident blocks per SM (the
    card's occupancy calculator) and block width of K3's or K4's (``kernel``)
    run kernel (``entry="run"``, the charged slices' flag set; ``"big_run"``
    K4's global form) or force kernel (``"forces"``) at ``n_atoms`` atoms of
    ``n_types`` types."""
    out = (ctypes.c_int * 4)()
    lib = _build.library()
    if entry == "big_run":
        rc = lib.md_k4_big_info(n_atoms, n_types, out)
    else:
        rc = getattr(lib, _K34_ENTRY[kernel] + "_info")({"run": 0, "forces": 1}[entry], n_atoms,
                                                         n_types, out)
    _build.check(rc, f"{kernel} info ({entry})")
    return _info(out)


def _info(out) -> dict:
    return dict(zip(("registers", "local_bytes", "blocks_per_sm", "threads"), out))


# --------------------------------------------------------------------------
# K5 (csrc/md_k5.cu): sweep 1 writes each atom's live js, sweep 2 walks
# them; the force entry over (tile, box) blocks

# live-list slots per atom of K5's run (an atom with more live js walks all
# N in sweep 2): the diamond box has 4, its melt rarely above 10
K5_CAP = 16
K5_TILE_ROWS = 32


class _K5Args(ctypes.Structure):
    """Mirror of md_k5.cu's K5Args, field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "invm", "mftm", "state", "vxi", "press", "n_run", "fscal", "pos", "h6", "force",
        "virial", "partial", "adj", "stats")]
        + [(name, ctypes.c_int) for name in ("B", "N", "cap", "deform", "sample", "tiles")]
        + [(name, ctypes.c_float) for name in ("ndof", "boltz", "nktv2p", "tdamp")]
        + [("sw", _SWC)])


def k5_tiles(n_atoms: int) -> int:
    """Row tiles of one box in K5's force entry."""
    return -(-n_atoms // K5_TILE_ROWS)


def _k5_args(runner: FusedRunner, B_: int, **ptrs) -> _K5Args:
    spec = runner.spec
    a = _K5Args()
    a.invm, a.mftm = _f(runner.invm), _f(runner.mftm)
    for name, v in ptrs.items():
        setattr(a, name, v)
    a.B, a.N, a.tiles = B_, spec.n_atoms, k5_tiles(spec.n_atoms)
    a.ndof, a.boltz, a.nktv2p, a.tdamp = float(spec.ndof), spec.boltz, spec.nktv2p, spec.tdamp
    for name, v in sw_consts(spec).items():
        setattr(a.sw, name, v)
    return a


def _k5_run(runner: FusedRunner, Bn: int, deform: bool, sample: bool, ptrs: dict,
            cap: int) -> torch.Tensor:
    """Launch K5's run with a live list of ``cap`` slots per atom; returns
    its (B, 2) int32 stats: each job's atom-calls above the cap (sweep 2
    walked all N js) and the most live js of one atom."""
    stats = torch.empty((Bn, 2), dtype=torch.int32, device=runner.invm.device)
    args = _k5_args(runner, Bn, stats=stats.data_ptr(), **ptrs)
    args.deform, args.sample, args.cap = int(deform), int(sample), int(cap)
    rc = _build.library().md_k5_run_f32(ctypes.byref(args),
                                        _build.stream_handle(runner.invm.device))
    _build.check(rc, f"md_k5_run_f32 (cap {cap})")
    return stats


def k5_run_stats(runner: FusedRunner, state: torch.Tensor, vxi: torch.Tensor,
                 n_run: torch.Tensor, fscal: torch.Tensor, deform: bool, sample: bool,
                 cap: int = K5_CAP):
    """:func:`md_run` of a K5 runner on the card with a live list of ``cap``
    slots per atom; returns (state', vxi', press_sum, stats (B, 2) int32:
    atom-calls above the cap, most live js of one atom).  Counts its
    launches in ``md_run.launches_k5``."""
    if runner.spec.kernel != "K5" or state.device.type != "cuda":
        raise ValueError("k5_run_stats: a K5 runner on the card")
    st, xi, nr, fs, press = _run_inputs(runner, state, vxi, n_run, fscal, "k5_run_stats")
    stats = _k5_run(runner, st.shape[0], deform, sample,
                    dict(state=st.data_ptr(), vxi=xi.data_ptr(), press=press.data_ptr(),
                         n_run=nr.data_ptr(), fscal=fs.data_ptr()), cap)
    md_run.launches_k5 += 1
    return st, xi, press, stats


def _k5_forces(runner: FusedRunner, pos, h6, force, vir) -> None:
    """K5's force entry: a moments kernel and a forces kernel over (tile,
    box) blocks, the adjoints in a (B, 10, N) scratch, the tiles' partial
    virials in a (B, tiles, 6) scratch summed in tile order."""
    Bn, N = pos.shape[0], runner.spec.n_atoms
    adj = torch.empty((Bn, 10, N), dtype=pos.dtype, device=pos.device)
    partial = torch.empty((Bn, k5_tiles(N), 6), dtype=pos.dtype, device=pos.device)
    args = _k5_args(runner, Bn, pos=pos.data_ptr(), h6=h6.data_ptr(), force=force.data_ptr(),
                    virial=vir.data_ptr(), partial=partial.data_ptr(), adj=adj.data_ptr())
    args.cap = K5_CAP
    rc = _build.library().md_k5_forces_f32(ctypes.byref(args), _build.stream_handle(pos.device))
    _build.check(rc, "md_k5_forces_f32")


def k5_kernel_info(entry: str, n_atoms: int, cap: int = K5_CAP) -> dict:
    """Registers, local (spill) bytes per thread, resident blocks per SM and
    block width of K5's run kernel (``entry="run"``, a list of ``cap``
    slots) or of its force entry's ``"moments"`` or ``"forces"`` kernel."""
    out = (ctypes.c_int * 4)()
    rc = _build.library().md_k5_info({"run": 0, "moments": 1, "forces": 2}[entry], n_atoms, cap,
                                     out)
    _build.check(rc, f"md_k5_info ({entry})")
    return _info(out)


def k5_live_lists(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor,
                  cap: int = K5_CAP):
    """Sweep 1's live lists as K5's run kernel writes them, in the plain
    version's arithmetic: for boxes pos (B, 3, N), h6 (B, 6), each atom's
    first ``cap`` live js in j order ((B, cap, N) int64, a dead slot the
    atom itself) and its count of live js ((B, N), above ``cap`` for an atom
    whose sweep 2 walks all N)."""
    c = sw_consts(runner.spec)
    d, r2 = _sw_disp(pos, h6)
    n = pos.shape[-1]
    live = (r2 < c["rc2"]) & (r2 > 1e-8) & ~torch.eye(n, dtype=torch.bool, device=pos.device)
    cnt = live.sum(-1)
    rank = torch.cumsum(live.long(), -1) - 1
    slot = torch.where(live & (rank < cap), rank, torch.full_like(rank, cap))
    lst = torch.arange(n, device=pos.device).view(1, 1, n).expand(pos.shape[0], cap + 1, n).clone()
    j = torch.arange(n, device=pos.device).view(1, 1, n).expand_as(slot)
    lst.scatter_(1, slot.transpose(1, 2), j.transpose(1, 2))
    return lst[:, :cap], cnt


def _sw_disp(pos, h6):
    """d[b, i, j] = r_j - r_i by the sequential triclinic minimum image, and
    r2, for boxes pos (B, 3, N), h6 (B, 6) (``_sw_block_plain``'s)."""
    lx, ly, lz, xy, xz, yz = (h6[:, k, None, None] for k in range(6))
    p = [pos[:, a] for a in range(3)]
    dx, dy, dz = (p[a][:, None, :] - p[a][:, :, None] for a in range(3))
    n3 = torch.round(dz * (1.0 / lz))
    dz = dz - n3 * lz
    dy = dy - n3 * yz
    n2 = torch.round(dy * (1.0 / ly))
    dy = dy - n2 * ly
    dx = dx - n3 * xz - n2 * xy
    n1 = torch.round(dx * (1.0 / lx))
    dx = dx - n1 * lx
    return (dx, dy, dz), dx * dx + dy * dy + dz * dz


def k5_forces_list_plain(runner: FusedRunner, pos: torch.Tensor, h6: torch.Tensor,
                         cap: int = K5_CAP):
    """K5's run-kernel force call as it walks its lists, in the plain
    version's arithmetic: sweep 1 over all pairs (the moments, the
    adjoints and :func:`k5_live_lists`), sweep 2 over each atom's listed js
    — or, for an atom above ``cap``, over all N.  Returns (F (B, 3, N), W
    (B, 6)), :func:`md_forces_virial_plain`'s."""
    lst, cnt = k5_live_lists(runner, pos, h6, cap)
    take = torch.arange(cap, device=pos.device).view(1, cap, 1) < cnt[:, None, :]
    walk = torch.zeros((pos.shape[0], pos.shape[-1], pos.shape[-1]), dtype=torch.bool,
                       device=pos.device)
    walk.scatter_(2, lst.transpose(1, 2), take.transpose(1, 2))
    walk |= (cnt > cap)[:, :, None]
    f, w6 = _sw_block_plain(runner.spec, [pos[:, a] for a in range(3)],
                            [h6[:, k] for k in range(6)], True, walk)
    return torch.stack(f, 1), torch.stack(w6, 1)


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
    """(B, 16) scalar rows for a batch of jobs.  ``dt`` and ``T`` are
    numbers, written by a fill, or (B,) tensors on ``h``'s device, copied
    as they are: nothing comes from host memory, so the host does not wait
    for the device here."""
    Bn = h.shape[0]
    f = torch.zeros((Bn, FSCAL), dtype=h.dtype, device=h.device)
    for col, v in ((F_DT, dt), (F_T, T)):
        if torch.is_tensor(v):
            f[:, col] = v
        else:
            f[:, col].fill_(v)
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
    with trace.sync("md.chunk_count"):
        n_max = int(n_steps.max()) if n_steps.numel() else 0
    ns = torch.clamp(n_steps, min=1)
    conv = runner.spec.nktv2p / B.volume(h0)
    pacc = torch.zeros((st6.shape[0], 6), dtype=dtype, device=st6.device)
    fk = nbr = None
    for c in range(math.ceil(n_max / R)):
        g0 = c * R
        trips = torch.clamp(torch.minimum(n_steps - g0, torch.full_like(n_steps, R)), min=0)
        with trace.sync("md.chunk_jobs"):
            act = torch.nonzero(trips > 0).flatten()
        h_c = B.deform_path(h0, eps, g0 / ns.to(dtype)) if deform else h0
        pos_c, _ = unpack_state(st6)
        if runner.kspace is not None:
            with trace.span("md.kspace"):
                Fk, Wk = runner.kspace(pos_c[act], h_c[act], want_virial=sample)
                fk = torch.zeros((st6.shape[0], 3, st6.shape[2]), dtype=dtype,
                                 device=st6.device)
                fk[act] = Fk.transpose(1, 2).to(dtype)
        if runner.spec.k:
            with trace.span("md.neighbors"):
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
