"""P1: the slim all-pairs LJ run of the kernel lab, variants v1-v8.

The port of ``scripts/probe_allpairs.py`` (``run_slim`` -> the Pallas
kernel of ``make_slim_kernel``): one program runs ``n_run`` steps of one
box, or of J boxes that share one thermostat chain.  Each step is an NHC-3
half-step, half-kick, drift, all-pairs LJ forces, half-kick, a second NHC
half-step and the fix-deform remap from h(g) to h(g + 1).  No bonded
terms, no virial.  The variants are the levers the lab times for K1's
layout (:data:`VARIANTS`):

* v1  minimum image per pair at every step, ``R2MIN < r2 < CUTOFF2``, the
      x6 of the force applied in the loop;
* v2  v1 with cached integer images ``n = -round(.)``, computed at each
      ``R_REFRESH``-step chunk start from that chunk's positions and h(g0);
* v3  v2 with trims: ``live = r2 < CUTOFF2`` only (pairs with r2 <= R2MIN
      take the clamped force), x6 baked into the w4e plane, one reduction;
* v4  v3 with the uniform sigma^2 :data:`SIG2_UNIFORM` instead of the plane;
* v5  v3 with Newton halving: each unordered pair once, its reaction added
      to the partner;
* v5p v5 in the lj1/lj2 form ``(lj1 u^3 - lj2) u^2 u^2`` (u = 1/r^2);
      v5r the same with ``u = rsqrt(r2)^2``; v5m the v5p form with the
      reaction gathered in per-warp partials and reduced once per force call;
* v7, v7d4, v7p  v5 (v7p: v5p) with J = 2, 4, 2 boxes per program: one
      NHC chain over all J boxes (ke summed, ndof x J), one h, one plane set;
* v8  the v5 form with the reaction reduced per 32-atom tile pair by warp
      shuffles.

The probe's cached variants read their image scratch before the first
refresh (probe_allpairs.py:543 vs :580), which is undefined memory on the
TPU; the port refreshes before the first force call, the function the
probe's docstring promises.

:func:`slim_run` launches the Hopper redesign, ``csrc/md_slim_ring.cu``,
on CUDA tensors (counting the launch in ``slim_run.launches_<variant>``):
float4 positions, and the planes and image cache streamed through a ring of
shared-memory stages by TMA bulk copies (:func:`ring_layout` mirrors its
block).  It holds at most its block width of atoms per box: 512 for J = 1,
1024 for J > 1.  :func:`slim_run_first` launches the first design,
``csrc/md_slim.cu`` (``slim_run_first.launches_<variant>``), kept for A/B
timings and checks.  Both run :func:`slim_run_plain` on CPU tensors.
Layouts are the probe's, batched
over P programs: ``state`` (P, 8, J NT, 128) rows x y z vx vy vz
``invm = FTM2V/m`` ``m/FTM2V``; ``iscal`` (P, 2) [n_run, n_tot];
``fscal`` (P, 20) [dt, T, h0 (6), eps (6), vxi (3), 0...] (a (2,) or
(20,) row serves every program); the planes ``w4e``, ``sig2`` (N, N) per
job, one copy read by every program and job, prepared per variant by
:func:`variant_planes`.  Returns the new state and ``sacc`` (P, 8) =
[vxi0, vxi1, vxi2, ke2, 0, 0, 0, 0].
"""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from . import _build

LANE = 128
NHC_LEN = 3
N_JOBS = 576
N_STEPS = 500
N_ATOMS = 512
R_REFRESH = 20
CUTOFF2 = 100.0
R2MIN = 0.25
BOLTZ = 0.0019872067
FTM2V = 1.0 / 48.88821291 / 48.88821291
TDAMP = 100.0
DT = 2.0
TEMP = 300.0
SIG2_UNIFORM = 3.905 ** 2  # v4's scalar sigma^2 (probe_allpairs.py:430)
FSCAL, ISCAL, SACC = 20, 2, 8


@dataclass(frozen=True)
class Variant:
    """Flags of one slim variant; ``vid`` is its instance in md_slim.cu."""

    vid: int
    cache: bool  # images cached at each R_REFRESH-step chunk start
    trim: bool  # live = r2 < CUTOFF2 only, x6 in the w4e plane
    unisig: bool  # SIG2_UNIFORM instead of the sig2 plane
    form: str  # "sig": w4e (2 s^12 - s^6) / r^2; "lj": (lj1 u^3 - lj2) u^4; "rsqrt"
    newton: str  # "": full rows; "atomic", "partials", "shuffle": each pair once
    jobs: int  # boxes per program, one thermostat chain


VARIANTS = {
    "v1": Variant(0, False, False, False, "sig", "", 1),
    "v2": Variant(1, True, False, False, "sig", "", 1),
    "v3": Variant(2, True, True, False, "sig", "", 1),
    "v4": Variant(3, True, True, True, "sig", "", 1),
    "v5": Variant(4, True, True, False, "sig", "atomic", 1),
    "v5p": Variant(5, True, True, False, "lj", "atomic", 1),
    "v5r": Variant(6, True, True, False, "rsqrt", "atomic", 1),
    "v5m": Variant(7, True, True, False, "lj", "partials", 1),
    "v7": Variant(8, True, True, False, "sig", "atomic", 2),
    "v7d4": Variant(9, True, True, False, "sig", "atomic", 4),
    "v7p": Variant(10, True, True, False, "lj", "atomic", 2),
    "v8": Variant(11, True, True, False, "sig", "shuffle", 1),
}


# --------------------------------------------------------------------------
# The lab's inputs (numpy copies of probe_allpairs.py:49-74, :640-652)


def build_inputs(n_atoms: int = N_ATOMS, dtype=np.float32):
    """The probe's random 512-atom box from ``default_rng(0)``: (pos, vel,
    masses, h6, w4e, sig2) in ``dtype``.  Atoms are drawn uniformly, so
    some overlap and the box explodes within a few steps (ROADMAP §3)."""
    rng = np.random.default_rng(0)
    L = 24.6
    pos = rng.uniform(0, L, (n_atoms, 3))
    vel = rng.normal(0, 0.004, (n_atoms, 3))
    masses = np.full(n_atoms, 14.0)
    h6 = np.array([L, L, L, 0.0, 0.0, 0.0])
    types = rng.integers(0, 2, n_atoms)
    eps_t = np.array([0.175, 0.118])
    epsp = np.sqrt(eps_t[types][:, None] * eps_t[types][None, :])
    w = 1.0 - np.eye(n_atoms)
    for i in range(n_atoms - 1):
        w[i, i + 1] = w[i + 1, i] = 0.0
    w4e = 4.0 * epsp * w
    sig2 = np.full((n_atoms, n_atoms), 3.905 ** 2)
    return tuple(np.asarray(a, dtype) for a in (pos, vel, masses, h6, w4e, sig2))


def pack_state(pos, vel, masses, dtype=np.float32) -> np.ndarray:
    """(N, 3) positions and velocities, (N,) masses -> the (8, NT, 128)
    state rows, padded with zeros to whole lane tiles.  ``invm`` and
    ``m/FTM2V`` are formed in the masses' own type, as the probe does."""
    pos, vel, masses = np.asarray(pos), np.asarray(vel), np.asarray(masses)
    n = pos.shape[0]
    npad = ((n + LANE - 1) // LANE) * LANE

    def ch(x):
        return np.pad(np.asarray(x).astype(dtype), (0, npad - n)).reshape(npad // LANE, LANE)

    invm = masses.dtype.type(FTM2V) / masses
    mftm = masses / masses.dtype.type(FTM2V)
    return np.stack([ch(pos[:, 0]), ch(pos[:, 1]), ch(pos[:, 2]),
                     ch(vel[:, 0]), ch(vel[:, 1]), ch(vel[:, 2]), ch(invm), ch(mftm)])


def variant_planes(variant: str, w4e, sig2):
    """The planes the probe's host hands each variant (:691-697): plain
    4 eps w for v1/v2, 6 x that for the trimmed sigma form, and lj1 =
    12 w4e sig^12 (in the w4e slot), lj2 = 6 w4e sig^6 (in the sig2 slot)
    for the lj1/lj2 form."""
    v = VARIANTS[variant]
    if v.form != "sig":
        return 12.0 * w4e * sig2 ** 6, 6.0 * w4e * sig2 ** 3
    return (6.0 * w4e if v.trim else w4e), sig2


def make_fscal(h6, eps, dt: float = DT, T: float = TEMP, vxi=(0.0, 0.0, 0.0)) -> np.ndarray:
    """The probe's 20 scalar slots (float64; the caller casts)."""
    f = np.zeros(FSCAL)
    f[0], f[1] = dt, T
    f[2:8] = np.asarray(h6, np.float64)
    f[8:14] = np.asarray(eps, np.float64)
    f[14:17] = vxi
    return f


# --------------------------------------------------------------------------
# Plain version

_PLAIN_PAIRS = 1 << 22  # pair elements per program chunk of the plain run


def _h_at(h0, eps, frac):
    """The probe's deform path (:86-94) on per-program rows."""
    lx0, ly0, lz0, xy0, xz0, yz0 = h0
    return (lx0 * (1.0 + frac * eps[0]), ly0 * (1.0 + frac * eps[1]),
            lz0 * (1.0 + frac * eps[2]), xy0 + frac * eps[3] * ly0,
            xz0 + frac * eps[4] * lz0, yz0 + frac * eps[5] * lz0)


def _remap_coeffs(h_old, h_new):
    """A = h_new inv(h_old), upper triangular (:97-108)."""
    lx, ly, lz, xy, xz, yz = h_old
    nlx, nly, nlz, nxy, nxz, nyz = h_new
    i00, i11, i22 = 1.0 / lx, 1.0 / ly, 1.0 / lz
    i01 = -xy / (lx * ly)
    i12 = -yz / (ly * lz)
    i02 = (xy * yz - xz * ly) / (lx * ly * lz)
    return (nlx * i00, nlx * i01 + nxy * i11, nlx * i02 + nxy * i12 + nxz * i22,
            nly * i11, nly * i12 + nyz * i22, nlz * i22)


def _diffs(p):
    """d[..., b, a] = x_b - x_a per component: row b is the partner j,
    column a the atom i, as in the probe's (u, t) blocks."""
    return [c.unsqueeze(-1) - c.unsqueeze(-2) for c in p]


def _bcast(h):
    return [c[:, None, None, None] for c in h]


def _images(p, h):
    """The cached images of every pair at positions p and box h
    (``refresh_images``, :182-212), and per program whether one lies beyond
    the kernel's int8 cache (|n| > 127, or NaN)."""
    lx, ly, lz, xy, xz, yz = _bcast(h)
    dx, dy, dz = _diffs(p)
    n3 = -torch.round(dz * (1.0 / lz))
    dz = dz + n3 * lz
    dy = dy + n3 * yz
    n2 = -torch.round(dy * (1.0 / ly))
    dy = dy + n2 * ly
    dx = dx + n3 * xz + n2 * xy
    n1 = -torch.round(dx * (1.0 / lx))
    over = ~torch.stack([(n.abs() <= 127.0).flatten(1).all(1) for n in (n1, n2, n3)]).all(0)
    return (n1, n2, n3), over


def _forces(v: Variant, p, img, h, w4e, sig2):
    """Forces (3 x (P, J, N)) of every atom from all pairs of its own box."""
    lx, ly, lz, xy, xz, yz = _bcast(h)
    dx, dy, dz = _diffs(p)
    if v.cache:
        n1, n2, n3 = img
        dx = dx + n1 * lx + n2 * xy + n3 * xz
        dy = dy + n2 * ly + n3 * yz
        dz = dz + n3 * lz
    else:  # the sequential triclinic minimum image of forces_v1 (:155-165)
        n3 = torch.round(dz * (1.0 / lz))
        dz = dz - n3 * lz
        dy = dy - n3 * yz
        n2 = torch.round(dy * (1.0 / ly))
        dy = dy - n2 * ly
        dx = dx - n3 * xz - n2 * xy
        n1 = torch.round(dx * (1.0 / lx))
        dx = dx - n1 * lx
    r2 = dx * dx + dy * dy + dz * dz
    live = r2 < CUTOFF2
    if not v.trim:
        live = live & (r2 > R2MIN)
    r2c = torch.clamp(r2, min=R2MIN)
    if v.form == "sig":
        inv_r2 = 1.0 / r2c
        s2 = (SIG2_UNIFORM if v.unisig else sig2) * inv_r2
        s6 = s2 * s2 * s2
        fpair = w4e * (2.0 * s6 * s6 - s6) * inv_r2
        if not v.trim:
            fpair = 6.0 * fpair
    else:
        if v.form == "rsqrt":
            ir = torch.rsqrt(r2c)
            inv_r2 = ir * ir
        else:
            inv_r2 = 1.0 / r2c
        u2 = inv_r2 * inv_r2
        u3 = u2 * inv_r2
        fpair = (w4e * u3 - sig2) * u2 * u2
    fpair = torch.where(live, fpair, torch.zeros_like(fpair))
    return [-(fpair * d).sum(-2) for d in (dx, dy, dz)]


def _nhc_half(vel, vxi, mftm, dt, T, ndof: int):
    """The probe's nhc_half (:505-533): one chain per program over all its
    atoms; vel 3 x (P, J, N), vxi 3 x (P,)."""
    kt = BOLTZ * T
    q = [ndof * kt * TDAMP ** 2] + [kt * TDAMP ** 2] * (NHC_LEN - 1)
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0
    ke2 = torch.sum(mftm * (vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2]), (1, 2))
    vxi = list(vxi)

    def g(k, ke2_):
        if k == 0:
            return (ke2_ - ndof * kt) / q[0]
        return (q[k - 1] * vxi[k - 1] ** 2 - kt) / q[k]

    for k in range(NHC_LEN - 1, -1, -1):
        if k == NHC_LEN - 1:
            vxi[k] = vxi[k] + dt4 * g(k, ke2)
        else:
            s = torch.exp(-dt8 * vxi[k + 1])
            vxi[k] = s * (s * vxi[k] + dt4 * g(k, ke2))
    scale = torch.exp(-dt2 * vxi[0])[:, None, None]
    vel = [x * scale for x in vel]
    ke2 = ke2 * scale[:, 0, 0] * scale[:, 0, 0]
    for k in range(NHC_LEN):
        if k == NHC_LEN - 1:
            vxi[k] = vxi[k] + dt4 * g(k, ke2)
        else:
            s = torch.exp(-dt8 * vxi[k + 1])
            vxi[k] = s * (s * vxi[k] + dt4 * g(k, ke2))
    return vel, vxi


def _run_plain(v: Variant, J: int, state, w4e, sig2, iscal, fscal):
    Pn, _, rows, _ = state.shape
    N = rows * LANE // J
    dtype = state.dtype
    r = [state[:, k].reshape(Pn, J, N) for k in range(8)]
    p, vel, invm, mftm = r[0:3], r[3:6], r[6], r[7]
    n_run = iscal[:, 0].to(torch.int64)
    n_tot = iscal[:, 1].to(dtype)
    dt, T = fscal[:, 0], fscal[:, 1]
    h0 = [fscal[:, 2 + k] for k in range(6)]
    eps = [fscal[:, 8 + k] for k in range(6)]
    xi = [fscal[:, 14 + k] for k in range(NHC_LEN)]
    ndof = (3 * N - 3) * J
    half = (0.5 * dt)[:, None, None]
    dtb = dt[:, None, None]

    def h_of(g):
        return _h_at(h0, eps, torch.full_like(dt, g) / n_tot)

    img, bad = None, torch.zeros(Pn, dtype=torch.bool, device=state.device)
    if v.cache:
        img, over = _images(p, h_of(0))
        bad = over & (n_run > 0)
    f = _forces(v, p, img, h_of(0), w4e, sig2)
    for s in range(int(n_run.max()) if Pn else 0):
        live = s < n_run
        lv = live[:, None, None]
        if v.cache and s > 0 and s % R_REFRESH == 0:
            img, over = _images(p, h_of(s))
            bad = bad | (over & live)
        h = h_of(s)
        v1, xi1 = _nhc_half(vel, xi, mftm, dt, T, ndof)
        v1 = [v1[a] + half * f[a] * invm for a in range(3)]
        p1 = [p[a] + dtb * v1[a] for a in range(3)]
        f1 = _forces(v, p1, img, h, w4e, sig2)
        v1 = [v1[a] + half * f1[a] * invm for a in range(3)]
        v1, xi1 = _nhc_half(v1, xi1, mftm, dt, T, ndof)
        a00, a01, a02, a11, a12, a22 = (c[:, None, None]
                                        for c in _remap_coeffs(h, h_of(s + 1)))
        p1 = [a00 * p1[0] + a01 * p1[1] + a02 * p1[2], a11 * p1[1] + a12 * p1[2], a22 * p1[2]]
        p = [torch.where(lv, p1[a], p[a]) for a in range(3)]
        vel = [torch.where(lv, v1[a], vel[a]) for a in range(3)]
        f = [torch.where(lv, f1[a], f[a]) for a in range(3)]
        xi = [torch.where(live, xi1[k], xi[k]) for k in range(NHC_LEN)]
    ke2 = torch.sum(mftm * (vel[0] * vel[0] + vel[1] * vel[1] + vel[2] * vel[2]), (1, 2))
    nan = torch.full_like(p[0], float("nan"))
    p = [torch.where(bad[:, None, None], nan, c) for c in p]  # the kernel's int8 guard
    out = torch.stack(p + vel + [invm, mftm], 1).reshape(state.shape)
    sacc = torch.zeros((Pn, SACC), dtype=dtype, device=state.device)
    sacc[:, :NHC_LEN] = torch.stack(xi, 1)
    sacc[:, NHC_LEN] = ke2
    return out, sacc


def _batched(x: torch.Tensor, Pn: int, width: int) -> torch.Tensor:
    return x.reshape(1, width).expand(Pn, width) if x.dim() == 1 else x


def _checked(variant: str, state, w4e, sig2, jobs):
    """The variant's flags and J, after checking the operands' shapes."""
    if variant not in VARIANTS:
        raise ValueError(f"md_slim: unknown variant {variant!r} (known: {list(VARIANTS)})")
    v = VARIANTS[variant]
    J = v.jobs if jobs is None else jobs
    if state.dim() != 4 or state.shape[1] != 8 or state.shape[3] != LANE or state.shape[2] % J:
        raise ValueError(f"md_slim: state shape {tuple(state.shape)} is not (P, 8, J NT, "
                         f"{LANE}) with J = {J}")
    N = state.shape[2] * LANE // J
    if w4e.shape != (N, N) or sig2.shape != (N, N):
        raise ValueError(f"md_slim: planes {tuple(w4e.shape)}, {tuple(sig2.shape)} are not "
                         f"({N}, {N}): one job-independent plane each")
    return v, J, N


def slim_run_plain(variant: str, state: torch.Tensor, w4e: torch.Tensor, sig2: torch.Tensor,
                   iscal: torch.Tensor, fscal: torch.Tensor, jobs: int | None = None):
    """Plain version of :func:`slim_run` (float32 or float64), program
    chunk by program chunk.  ``jobs`` defaults to the variant's J.  As the
    kernel does, a cached variant returns NaN positions for a program whose
    images at a refresh go beyond int8."""
    v, J, N = _checked(variant, state, w4e, sig2, jobs)
    Pn = state.shape[0]
    iscal, fscal = _batched(iscal, Pn, ISCAL), _batched(fscal, Pn, FSCAL)
    step = max(1, _PLAIN_PAIRS // (J * N * N))
    outs = [_run_plain(v, J, state[a:a + step], w4e, sig2, iscal[a:a + step],
                       fscal[a:a + step]) for a in range(0, Pn, step)]
    if not outs:
        return state.clone(), torch.zeros((0, SACC), dtype=state.dtype, device=state.device)
    return torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])


# --------------------------------------------------------------------------
# Kernel wrapper

_MAX_SMEM = 232448  # bytes of shared memory a Hopper block can opt into
_TILE = 32  # v8's tile: one warp's atoms


def threads(v: Variant, N: int) -> int:
    """Block width of the variant's instance in either design."""
    M = v.jobs * N
    return min(((M + 31) // 32) * 32, 512 if v.jobs == 1 else 1024)


def smem_bytes(v: Variant, N: int) -> int:
    """Shared memory of one block of the first design (csrc/md_slim.cu,
    launch): eleven rows per atom, the reduction scratch and the chain, and
    v5m's per-warp reaction partials."""
    M = v.jobs * N
    floats = 11 * M + 32 + 8
    if v.newton == "partials":
        floats += (threads(v, N) // 32) * 3 * M
    return 4 * floats


def layout_slots(v: Variant, N: int) -> int:
    """Pair slots per job of the variant's image-cache and plane layout:
    all N^2 ordered pairs (full rows), the half shell (N/2) N, or the
    T (T + 1) / 2 tile pairs of 32 x 32 (T = N / 32)."""
    if v.newton == "":
        return N * N
    if v.newton == "shuffle":
        t = N // _TILE
        return t * (t + 1) // 2 * _TILE * _TILE
    return N // 2 * N


def layout_pairs(v: Variant, N: int, device=None):
    """(row, column) = (j, i) of every slot of the variant's layout, as two
    (slots,) int64 tensors: the plane read at slot o is plane[j, i]."""
    if v.newton == "":
        o = torch.arange(N * N, device=device)
        return o // N, o % N
    if v.newton == "shuffle":
        t = N // _TILE
        tiles = torch.tensor([(a, b) for a in range(t) for b in range(a, t)], device=device)
        k = torch.arange(_TILE, device=device)[:, None]
        lane = torch.arange(_TILE, device=device)[None, :]
        rows = tiles[:, 1, None, None] * _TILE + (lane + k)[None] % _TILE
        cols = (tiles[:, 0, None, None] * _TILE + lane[None]).expand_as(rows)
        return rows.reshape(-1), cols.reshape(-1)
    d = torch.arange(1, N // 2 + 1, device=device)[:, None]
    i = torch.arange(N, device=device)[None, :]
    return ((i + d) % N).reshape(-1), i.expand(N // 2, N).reshape(-1)


class _SlimArgs(ctypes.Structure):
    """Mirror of the kernels' SlimArgs (csrc/md_slim.cuh), field for field."""

    _fields_ = ([(name, ctypes.c_void_p) for name in (
        "state", "out", "sacc", "w4e", "sig2", "iscal", "fscal", "img")]
        + [(name, ctypes.c_int) for name in ("P", "N", "J")]
        + [(name, ctypes.c_float) for name in (
            "cutoff2", "r2min", "boltz", "tdamp", "sig2u", "ndof")])


class _RingArgs(ctypes.Structure):
    """Mirror of the redesign's RingArgs (csrc/md_slim_ring.cu)."""

    _fields_ = [("a", _SlimArgs), ("depth", ctypes.c_int)]


# --------------------------------------------------------------------------
# The redesign's shared memory (a mirror of md_slim_ring.cu)

RING_DEPTH = 3  # stages at most
_SM_SMEM = 233472  # shared memory of an H100 SM
_BLOCK_RESERVED = 1024  # the shared memory the card reserves per block


@dataclass(frozen=True)
class RingLayout:
    """One block of the redesign (``ring_layout`` in md_slim_ring.cu)."""

    threads: int
    jobs_per_group: int  # jobs whose rows the block walks at once
    groups: int
    chunks: int  # stages per group and force call (v8: per tile pair)
    arrays: int  # bulk copies per stage: the planes read, then the group's images
    rows: int  # layout rows per stage (v8: shuffle steps), ring_rows
    depth: int
    stage_bytes: int  # v8: of one warp's stage
    ring_bytes: int
    smem_bytes: int

    @property
    def two_blocks(self) -> bool:
        """Whether two blocks fit one SM's shared memory."""
        return 2 * (self.smem_bytes + _BLOCK_RESERVED) <= _SM_SMEM


def _ring_layout(v: Variant, N: int, depth: int) -> RingLayout | None:
    M, nt, rows = v.jobs * N, threads(v, N), ring_rows(v)
    at = 2 if v.jobs == 4 else 1  # atoms per thread, their velocities in registers
    if N <= 0 or N % LANE or N > nt or M > at * nt or depth <= 0:
        return None
    planes = 1 if v.unisig else 2
    warps = nt // 32
    if v.newton == "shuffle":
        jg, groups, arrays = v.jobs, 1, planes + int(v.cache)
        chunks, stage = _TILE // rows, arrays * rows * _TILE * 4
        ring, bars, counts = warps * depth * stage, warps * depth, 0
    else:
        jg = min(v.jobs, nt // N)
        groups, arrays = v.jobs // jg, planes + (jg if v.cache else 0)
        R = N if v.newton == "" else N // 2
        if v.jobs % jg or R % rows:
            return None
        chunks, stage = R // rows, arrays * rows * N * 4
        ring, bars, counts = depth * stage, depth, 4 * depth  # the release counts
    # float4 positions (x, y, z, 1/m), the ring, the forces (full rows keep
    # theirs in registers), the reduction scratch and chain
    part = 16 * M + ring + 4 * ((0 if v.newton == "" else 3 * M) + 32 + 8)
    bar = part + (4 * warps * 3 * M if v.newton == "partials" else 0)
    smem = (bar + 7) // 8 * 8 + 8 * bars + counts
    if smem > _MAX_SMEM:
        return None
    return RingLayout(nt, jg, groups, chunks, arrays, rows, depth, stage, ring, smem)


def ring_rows(v: Variant | str) -> int:
    """Layout rows per stage of the block ring, 8, and v8's shuffle steps
    per stage of a warp's ring, 4: fixed per kernel instance (``ring_rows``
    in md_slim_ring.cu)."""
    v = VARIANTS[v] if isinstance(v, str) else v
    return 4 if v.newton == "shuffle" else 8


def ring_layout(v: Variant | str, N: int) -> RingLayout:
    """The redesign's block for variant ``v`` at N atoms per box: stages of
    :func:`ring_rows` rows, the most of them up to ``RING_DEPTH`` that fit,
    keeping a one-box variant other than v5m at two blocks per SM.
    ValueError where nothing fits: the redesign holds at most its block
    width of atoms per box (512 for J = 1, 1024 for J > 1)."""
    v = VARIANTS[v] if isinstance(v, str) else v
    fits = [lay for lay in (_ring_layout(v, N, d)
                            for d in range(RING_DEPTH, 0, -1)) if lay is not None]
    pair = v.jobs == 1 and v.newton != "partials"
    for lay in fits:
        if lay.two_blocks or not pair:
            return lay
    if fits:
        return fits[0]
    raise ValueError(f"md_slim: no ring fits {v.jobs} x {N} atoms: the redesign runs at most "
                     f"{threads(v, N)} atoms per box in shared memory")


# --------------------------------------------------------------------------
# Kernel wrappers


def _launch(who: str, variant: str, state, w4e, sig2, iscal, fscal, jobs, run, smem: int):
    """Check the operands, allocate the outputs and the image cache, and call
    ``run(SlimArgs, variant, stream)`` (one kernel launch); returns (state',
    sacc)."""
    v, J, N = _checked(variant, state, w4e, sig2, jobs)
    if state.device.type != "cuda":
        raise ValueError(f"{who}: unsupported device {state.device}")
    if J != v.jobs:
        raise ValueError(f"{who}: the {variant} kernel is built for J = {v.jobs}, not {J}")
    Pn = state.shape[0]
    iscal = _batched(iscal, Pn, ISCAL).to(torch.int32).contiguous()
    fscal = _batched(fscal, Pn, FSCAL).contiguous()
    st = state.contiguous()
    for t in (st, w4e, sig2, iscal, fscal):
        if t.device != st.device:
            raise ValueError(f"{who}: all operands must be on the same CUDA device")
    if st.dtype != torch.float32 or fscal.dtype != torch.float32:
        raise TypeError(f"{who}: the kernel takes float32, got {st.dtype}, {fscal.dtype}")
    if smem > _MAX_SMEM:
        raise ValueError(f"{who}: {variant} with {J} x {N} atoms needs {smem} B of shared "
                         f"memory per block, above the {_MAX_SMEM} B of a Hopper block")
    out = torch.empty_like(st)
    sacc = torch.empty((Pn, SACC), dtype=torch.float32, device=st.device)
    if Pn == 0:
        return out, sacc
    # the planes in the variant's pair layout, once for every program, on
    # 16-byte boundaries (the bulk copies' alignment)
    if v.newton == "":
        wl, sl = w4e.float().contiguous(), sig2.float().contiguous()
        wl, sl = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (wl, sl))
    else:
        rows_, cols_ = layout_pairs(v, N, st.device)
        wl, sl = w4e.float()[rows_, cols_], sig2.float()[rows_, cols_]
    # the image cache: one (n1, n2, n3, 0) int8 quadruple per pair slot
    img = (torch.empty((Pn, J, layout_slots(v, N), 4), dtype=torch.int8, device=st.device)
           if v.cache else None)
    a = _SlimArgs(state=st.data_ptr(), out=out.data_ptr(), sacc=sacc.data_ptr(),
                  w4e=wl.data_ptr(), sig2=sl.data_ptr(), iscal=iscal.data_ptr(),
                  fscal=fscal.data_ptr(), img=img.data_ptr() if img is not None else None,
                  P=Pn, N=N, J=J, cutoff2=CUTOFF2, r2min=R2MIN, boltz=BOLTZ, tdamp=TDAMP,
                  sig2u=SIG2_UNIFORM, ndof=float((3 * N - 3) * J))
    _build.check(run(a, v, _build.stream_handle(st.device)), f"{who} ({variant})")
    return out, sacc


def _count(fn, variant: str) -> None:
    name = "launches_" + variant
    setattr(fn, name, getattr(fn, name) + 1)


def slim_run(variant: str, state: torch.Tensor, w4e: torch.Tensor, sig2: torch.Tensor,
             iscal: torch.Tensor, fscal: torch.Tensor, jobs: int | None = None):
    """One slim run of P programs: the variant's redesigned CUDA kernel on
    CUDA tensors (one block per program, float32; csrc/md_slim_ring.cu, its
    block from :func:`ring_layout`), :func:`slim_run_plain` on CPU tensors.
    N must be a multiple of 128 and at most the block width: 512 atoms per
    box for J = 1, 1024 for J > 1 (ValueError beyond).  Inputs are not
    modified; returns (state', sacc)."""
    if state.device.type == "cpu":
        return slim_run_plain(variant, state, w4e, sig2, iscal, fscal, jobs)
    v, _, N = _checked(variant, state, w4e, sig2, jobs)
    lay = ring_layout(v, N)

    def run(a, v, stream):
        ra = _RingArgs(a=a, depth=lay.depth)
        return _build.library().md_slim_ring_run_f32(ctypes.byref(ra), v.vid, stream)

    out = _launch("slim_run", variant, state, w4e, sig2, iscal, fscal, jobs, run,
                  lay.smem_bytes)
    _count(slim_run, variant)
    return out


def slim_run_first(variant: str, state: torch.Tensor, w4e: torch.Tensor, sig2: torch.Tensor,
                   iscal: torch.Tensor, fscal: torch.Tensor, jobs: int | None = None):
    """:func:`slim_run` on P1's first design (csrc/md_slim.cu), kept for A/B
    timings and checks; :func:`slim_run_plain` on CPU tensors."""
    if state.device.type == "cpu":
        return slim_run_plain(variant, state, w4e, sig2, iscal, fscal, jobs)
    v, _, N = _checked(variant, state, w4e, sig2, jobs)

    def run(a, v, stream):
        return _build.library().md_slim_run_f32(ctypes.byref(a), v.vid, stream)

    out = _launch("slim_run_first", variant, state, w4e, sig2, iscal, fscal, jobs, run,
                  smem_bytes(v, N))
    _count(slim_run_first, variant)
    return out


def ring_info(variant: str, N: int = N_ATOMS) -> dict:
    """The redesign's instance as the card reports it at N atoms per box and
    :func:`ring_layout`'s depth: registers, local (spill) bytes, resident
    blocks per SM, and ``layout``, the kernel's own block (a
    :class:`RingLayout`, to hold the mirror against)."""
    depth = ring_layout(variant, N).depth
    out = (ctypes.c_int * 12)()
    rc = _build.library().md_slim_ring_info(VARIANTS[variant].vid, N, depth, out)
    _build.check(rc, f"md_slim_ring_info ({variant})")
    nt, jg, groups, chunks, arrays, rows, stage, ring, smem = out[3:]
    return {"registers": out[0], "local_bytes": out[1], "blocks_per_sm": out[2],
            "layout": RingLayout(nt, jg, groups, chunks, arrays, rows, depth, stage, ring, smem)}


def occupancy_first(variant: str, N: int = N_ATOMS) -> int:
    """Resident blocks per SM of the first design's kernel at N atoms per
    box, as the card's occupancy calculator gives it (registers, block
    width, shared memory)."""
    blocks = ctypes.c_int(0)
    rc = _build.library().md_slim_occupancy(VARIANTS[variant].vid, N, ctypes.byref(blocks))
    _build.check(rc, f"md_slim_occupancy ({variant})")
    return blocks.value


for _fn in (slim_run, slim_run_first):
    for _v in VARIANTS:
        setattr(_fn, "launches_" + _v, 0)
del _fn, _v
