"""Plain MD reference: the strained NVT run and the virial sampling of one
HMM MD job, for the g0 united-atom alkane melt and Stillinger-Weber Si.

A frozen copy of the arithmetic of ``scema_tpu_torch/ops/md_fused.py``'s
plain versions at commit ce23eb3 (``md_run_plain``, ``_nhc_half``,
``_pair_block_plain``, ``_fpair_plain``, ``bonded_chain_forces_plain``,
``_dihedral_roles``, ``_sw_block_plain``, ``_sw_w``, ``_h_at``,
``_remap_coeffs``) and of ``md/homogenization.strain_and_homogenize``, in
plain PyTorch on (B, N) rows.  It imports nothing of the port, and it
builds every table itself from the material's definition
(:func:`g0_system`, :func:`sw_system`): the masses, the N x N LJ
coefficient planes with the chain's 1-2, 1-3 and 1-4 partners excluded, the
chain's bonded rows and the SW constants.  It runs in whatever dtype its
inputs have: float64 for the check, bfloat16 for the control.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field

import torch

from .fe import voigt_norm

# LAMMPS "real" units (kcal/mol, A, fs, g/mol, atm)
BOLTZ = 0.0019872067
FTM2V = 1.0 / 48.88821291 / 48.88821291
NKTV2P = 68568.415
ATM_TO_PA = 1.01325e5
NHC_LEN = 3
TDAMP = 100.0
# the LJ pair force's close-range clamp (r^2 in A^2)
R2MIN = 0.25

# g0: united-atom alkane beads (TraPPE-like OPLS-UA), one type
G0_MASS = 14.027
G0_EPS, G0_SIG = 0.118, 3.905
G0_BOND = (260.0, 1.54)  # K (kcal/mol/A^2), r0 (A)
G0_ANGLE = (63.0, 112.0)  # K (kcal/mol/rad^2), theta0 (deg)
G0_DIHEDRAL = (1.411, -0.271, 3.145, 0.0)  # OPLS K1..K4 (kcal/mol)

# Stillinger-Weber Si (Si.sw's metal-unit numbers read under units real)
SI_MASS = 28.0855
SI_SW = dict(epsilon=2.1683, sigma=2.0951, a=1.80, lam=21.0, gamma=1.20,
             costheta0=-0.333333333333, A=7.049556277, B=0.6022245584)


@dataclass
class System:
    """One material's MD system: masses, thermostat degrees of freedom and
    the force field's tables, all in float64 until :meth:`to`."""

    kind: str  # "chain" (LJ + chain bonded terms) or "sw"
    masses: torch.Tensor  # (N,)
    ndof: int
    cutoff2: float = 0.0
    lj1: torch.Tensor | None = None  # (N, N)
    lj2: torch.Tensor | None = None
    topo: dict = field(default_factory=dict)  # name -> (N,) rows
    sw: dict = field(default_factory=dict)

    def to(self, device, dtype) -> "System":
        def c(x):
            return None if x is None else x.to(device=device, dtype=dtype)

        return System(kind=self.kind, masses=c(self.masses), ndof=self.ndof,
                      cutoff2=self.cutoff2, lj1=c(self.lj1), lj2=c(self.lj2),
                      topo={k: c(v) for k, v in self.topo.items()}, sw=dict(self.sw))


def g0_system(n_chains: int = 64, chain_length: int = 8, cutoff: float = 10.0) -> System:
    """The g0 melt: ``n_chains`` chains of ``chain_length`` beads, the beads
    of a chain consecutive, one bead type; LJ with geometric mixing inside
    ``cutoff`` and the 1-2, 1-3, 1-4 partners of a chain excluded
    (special_bonds lj 0 0 0); harmonic bonds and angles and OPLS dihedrals
    along each chain."""
    n = n_chains * chain_length
    idx = torch.arange(n)
    chain, k = idx // chain_length, idx % chain_length
    same = chain[:, None] == chain[None, :]
    sep = (idx[None, :] - idx[:, None]).abs()
    w = (~(same & (sep <= 3))).double()  # the diagonal has sep 0
    sig6 = G0_SIG ** 6
    lj1 = 48.0 * G0_EPS * sig6 * sig6 * w
    lj2 = 24.0 * G0_EPS * sig6 * w
    left = chain_length - 1 - k  # bonds that follow bead k in its chain
    topo = {
        "bmask": (left >= 1).double(), "bk": torch.full((n,), G0_BOND[0], dtype=torch.float64),
        "br0": torch.full((n,), G0_BOND[1], dtype=torch.float64),
        "amask": (left >= 2).double(), "ak": torch.full((n,), G0_ANGLE[0], dtype=torch.float64),
        "ath0": torch.full((n,), math.radians(G0_ANGLE[1]), dtype=torch.float64),
        "dmask": (left >= 3).double(),
    }
    for i, kd in enumerate(G0_DIHEDRAL):
        topo[f"dk{i + 1}"] = torch.full((n,), kd, dtype=torch.float64)
    return System(kind="chain", masses=torch.full((n,), G0_MASS, dtype=torch.float64),
                  ndof=3 * n - 3, cutoff2=cutoff * cutoff, lj1=lj1, lj2=lj2, topo=topo)


def sw_system(cells: tuple = (3, 3, 3)) -> System:
    """Diamond Si of ``cells`` (x, y, z) cells, 8 atoms each, under SW."""
    n = 8 * math.prod(cells)
    p = SI_SW
    rc = p["a"] * p["sigma"]
    lam_eps = p["lam"] * p["epsilon"]
    c0 = p["costheta0"]
    sw = dict(rc=rc, rc2=(rc - 1e-6) ** 2, sig=p["sigma"], gs=p["gamma"] * p["sigma"],
              aeps=p["A"] * p["epsilon"], b=p["B"], m4b=-4.0 * p["B"], lam_eps=lam_eps,
              k_s=lam_eps * c0 * c0, k_m=-2.0 * lam_eps * c0,
              a_gsq=-(lam_eps / 2.0) * (1.0 - c0) ** 2)
    return System(kind="sw", masses=torch.full((n,), SI_MASS, dtype=torch.float64),
                  ndof=3 * n - 3, cutoff2=rc * rc, sw=sw)


# -- geometry ---------------------------------------------------------------


def h6_of(h: torch.Tensor) -> list:
    """(B, 3, 3) upper-triangular boxes -> [lx, ly, lz, xy, xz, yz] of (B,)."""
    return [h[:, 0, 0], h[:, 1, 1], h[:, 2, 2], h[:, 0, 1], h[:, 0, 2], h[:, 1, 2]]


def h_of_h6(h6: list) -> torch.Tensor:
    lx, ly, lz, xy, xz, yz = h6
    z = torch.zeros_like(lx)
    return torch.stack([torch.stack([lx, xy, xz], -1), torch.stack([z, ly, yz], -1),
                        torch.stack([z, z, lz], -1)], -2)


def h_at(h0: list, eps: list, frac) -> list:
    """The fix-deform box at fraction ``frac``: lengths scale, tilts shift."""
    lx0, ly0, lz0, xy0, xz0, yz0 = h0
    return [lx0 * (1.0 + frac * eps[0]), ly0 * (1.0 + frac * eps[1]),
            lz0 * (1.0 + frac * eps[2]), xy0 + frac * eps[3] * ly0,
            xz0 + frac * eps[4] * lz0, yz0 + frac * eps[5] * lz0]


def remap_coeffs(h_old: list, h_new: list):
    """Upper-triangular A = h_new inv(h_old)."""
    lx, ly, lz, xy, xz, yz = h_old
    nlx, nly, nlz, nxy, nxz, nyz = h_new
    i00, i11, i22 = 1.0 / lx, 1.0 / ly, 1.0 / lz
    i01 = -xy / (lx * ly)
    i12 = -yz / (ly * lz)
    i02 = (xy * yz - xz * ly) / (lx * ly * lz)
    return (nlx * i00, nlx * i01 + nxy * i11, nlx * i02 + nxy * i12 + nxz * i22,
            nly * i11, nly * i12 + nyz * i22, nlz * i22)


def min_image(p: list, h6: list):
    """d[b, i, j] = r_j - r_i by the sequential triclinic minimum image
    (z, then y, then x), and r^2."""
    lx, ly, lz, xy, xz, yz = (x[:, None, None] for x in h6)
    dx, dy, dz = (p[a][:, None, :] - p[a][:, :, None] for a in range(3))
    n3 = torch.round(dz / lz)
    dz = dz - n3 * lz
    dy = dy - n3 * yz
    n2 = torch.round(dy / ly)
    dy = dy - n2 * ly
    dx = dx - n3 * xz - n2 * xy
    n1 = torch.round(dx / lx)
    dx = dx - n1 * lx
    return (dx, dy, dz), dx * dx + dy * dy + dz * dz


# -- forces -----------------------------------------------------------------


def _fwd(x, o=1):  # y[..., k] = x[..., k + o]
    return torch.roll(x, -o, dims=-1)


def _bwd(x, o=1):  # y[..., k] = x[..., k - o]
    return torch.roll(x, o, dims=-1)


def _outer_add(W, F, d):
    for a in range(3):
        for b in range(3):
            W[a, b] = W[a, b] + torch.sum(F[a] * d[b], dim=-1)


def _dihedral_roles(b1, b2, b3, mask, K):
    """OPLS dihedral role forces [F0, F1, F2, F3] on the bond vectors b1,
    b2, b3 (the Blondel-Karplus gradient); masked terms give zero."""
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


def bonded_forces(p, topo):
    """Harmonic bonds and angles and OPLS dihedrals along each chain on
    (B, N) rows; bonds start at atom k towards k + 1 where ``bmask``.
    Returns ((fx, fy, fz), W) with W the 3x3 virial sums."""
    bm, am, dm = topo["bmask"] > 0.5, topo["amask"] > 0.5, topo["dmask"] > 0.5
    zero = torch.zeros((), dtype=p[0].dtype, device=p[0].device)
    one = torch.ones_like(zero)
    b = [_fwd(x) - x for x in p]
    r2b = b[0] * b[0] + b[1] * b[1] + b[2] * b[2]
    W = {(a, c): torch.zeros_like(p[0][..., 0]) for a in range(3) for c in range(3)}

    rb = torch.sqrt(torch.where(bm, r2b, one))
    fb = torch.where(bm, 2.0 * topo["bk"] * (rb - topo["br0"]) / rb, zero)
    f = [fb * x - _bwd(fb * x) for x in b]
    _outer_add(W, [-fb * x for x in b], b)

    b2 = [_fwd(x) for x in b]
    d11 = torch.where(am, r2b, one)
    d22 = torch.where(am, _fwd(r2b), one)
    d12 = -(b[0] * b2[0] + b[1] * b2[1] + b[2] * b2[2])
    inv12 = torch.rsqrt(d11 * d22)
    c = torch.clamp(d12 * inv12, -1.0 + 1e-7, 1.0 - 1e-7)
    sin_th = torch.sqrt(torch.clamp(1.0 - c * c, min=1e-30))
    aE = torch.where(am, -2.0 * topo["ak"] * (torch.arccos(c) - topo["ath0"]) / sin_th, zero)
    g1 = [b2[a] * inv12 + c * b[a] / d11 for a in range(3)]
    g2 = [-b[a] * inv12 - c * b2[a] / d22 for a in range(3)]
    f = [f[a] - aE * g1[a] + _bwd(aE * (g1[a] + g2[a])) - _bwd(aE * g2[a], 2)
         for a in range(3)]
    _outer_add(W, [-aE * x for x in g1], [-x for x in b])
    _outer_add(W, [-aE * x for x in g2], b2)

    b3 = [_fwd(x) for x in b2]
    F = _dihedral_roles(b, b2, b3, dm, [topo[f"dk{i}"] for i in range(1, 5)])
    f = [f[a] + F[0][a] + _bwd(F[1][a]) + _bwd(F[2][a], 2) + _bwd(F[3][a], 3)
         for a in range(3)]
    s12 = [b[a] + b2[a] for a in range(3)]
    s123 = [s12[a] + b3[a] for a in range(3)]
    _outer_add(W, F[1], b)
    _outer_add(W, F[2], s12)
    _outer_add(W, F[3], s123)
    return f, W


def _sym6(W):
    return [W[0, 0], W[1, 1], W[2, 2], 0.5 * (W[0, 1] + W[1, 0]),
            0.5 * (W[0, 2] + W[2, 0]), 0.5 * (W[1, 2] + W[2, 1])]


def _pair_forces(sys: System, p, h6, want_virial: bool):
    (dx, dy, dz), r2 = min_image(p, h6)
    r2c = torch.clamp(r2, min=R2MIN)
    inv_r2 = 1.0 / r2c
    u2 = inv_r2 * inv_r2
    u3 = u2 * inv_r2
    fpair = torch.where(r2 < sys.cutoff2, (sys.lj1 * u3 - sys.lj2) * u2 * u2,
                        torch.zeros((), dtype=r2.dtype, device=r2.device))
    f = [-(fpair * d).sum(-1) for d in (dx, dy, dz)]
    w6 = None
    if want_virial:
        w6 = [0.5 * (fpair * u * v).sum((-1, -2))
              for u, v in ((dx, dx), (dy, dy), (dz, dz), (dx, dy), (dx, dz), (dy, dz))]
    return f, w6


def _sw_w(c, ux, uy, uz, inv_r, g, dg, radial0, adj):
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


def _sw_forces(sys: System, p, h6, want_virial: bool):
    """SW (p = 4, q = 0) in its moment form over all ordered pairs: sweep 1
    the per-atom moments and adjoints, sweep 2 both roles' pair terms."""
    c = sys.sw
    n = p[0].shape[-1]
    (dx, dy, dz), r2 = min_image(p, h6)
    eye = torch.eye(n, dtype=torch.bool, device=r2.device)
    mask = (r2 < c["rc2"]) & (r2 > 1e-8) & ~eye
    one = torch.ones((), dtype=r2.dtype, device=r2.device)
    zero = torch.zeros_like(one)
    r = torch.sqrt(torch.where(mask, r2, one))
    inv_r = 1.0 / r
    ux, uy, uz = dx * inv_r, dy * inv_r, dz * inv_r
    denom = torch.where(mask, r - c["rc"], -one)
    g = torch.where(mask, torch.exp(c["gs"] / denom), zero)
    gx, gy, gz = g * ux, g * uy, g * uz
    mom = [g, gx, gy, gz, gx * ux, gy * uy, gz * uz, gx * uy, gx * uz, gy * uz]
    mom = [x.sum(-1) for x in mom]
    adj = ([c["k_s"] * mom[0]] + [c["k_m"] * x for x in mom[1:4]]
           + [c["lam_eps"] * x for x in mom[4:]])
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


def forces(sys: System, p, h6, want_virial: bool):
    """Forces on (B, N) rows and, with ``want_virial``, the Voigt-6 virial."""
    if sys.kind == "sw":
        return _sw_forces(sys, p, h6, want_virial)
    f, w6 = _pair_forces(sys, p, h6, want_virial)
    fb, Wb = bonded_forces(p, sys.topo)
    f = [f[a] + fb[a] for a in range(3)]
    if want_virial:
        w6 = [a + b for a, b in zip(w6, _sym6(Wb))]
    return f, w6


# -- integrator -------------------------------------------------------------


def _nhc_half(sys: System, mftm, v, vxi, dt, T):
    """Half-step Nose-Hoover chain (MTK) on (B, N) velocity rows."""
    kt = BOLTZ * T
    q = [sys.ndof * kt * TDAMP ** 2] + [kt * TDAMP ** 2] * (NHC_LEN - 1)
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0
    ke2 = torch.sum(mftm * (v[0] * v[0] + v[1] * v[1] + v[2] * v[2]), -1)
    vxi = list(vxi)

    def g(k, ke2_):
        if k == 0:
            return (ke2_ - sys.ndof * kt) / q[0]
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


def run(sys: System, pos, vel, vxi, h, n_run, dt: float, T: float, eps=None,
        sample: bool = False):
    """NVT velocity Verlet with Nose-Hoover chains for B jobs: pos, vel (B,
    N, 3), vxi (B, 3), h (B, 3, 3), n_run (B,) steps each.  With ``eps``
    (B, 6) the box moves linearly from h to its strained shape over each
    job's steps, the positions remapped after every step (fix deform ...
    remap x); with ``sample`` the instantaneous virial pressure is summed.
    Returns (pos, vel, vxi, pressure sum (B, 6))."""
    dtype = pos.dtype
    invm = (FTM2V / sys.masses)
    mftm = sys.masses / FTM2V
    p = [pos[..., a] for a in range(3)]
    v = [vel[..., a] for a in range(3)]
    xi = [vxi[:, k] for k in range(NHC_LEN)]
    n_run = n_run.to(torch.int64)
    steps = int(n_run.max()) if n_run.numel() else 0
    h0 = h6_of(h)
    nt = torch.clamp(n_run, min=1).to(dtype)
    dt0 = torch.full_like(h0[0], dt)

    def h_of(s):
        return h_at(h0, [eps[:, k] for k in range(6)], s / nt) if eps is not None else h0

    pacc = [torch.zeros_like(dt0) for _ in range(6)]
    f, _ = forces(sys, p, h_of(0), False)
    for s in range(steps):
        live = s < n_run
        lv = live[:, None]
        dts = torch.where(live, dt0, torch.zeros_like(dt0))
        hs = h_of(s)
        v_in, xi_in = v, xi
        v, xi = _nhc_half(sys, mftm, v, xi, dts, T)
        half = (0.5 * dts)[:, None]
        v = [v[a] + half * f[a] * invm for a in range(3)]
        p = [torch.where(lv, p[a] + dts[:, None] * v[a], p[a]) for a in range(3)]
        f, w6 = forces(sys, p, hs, sample)
        v = [v[a] + half * f[a] * invm for a in range(3)]
        v, xi = _nhc_half(sys, mftm, v, xi, dts, T)
        v = [torch.where(lv, v[a], v_in[a]) for a in range(3)]
        xi = [torch.where(live, xi[k], xi_in[k]) for k in range(NHC_LEN)]
        if sample:
            conv = NKTV2P / (hs[0] * hs[1] * hs[2])
            kin = [torch.sum(mftm * v[a] * v[b], -1)
                   for a, b in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))]
            pacc = [pacc[k] + torch.where(live, (kin[k] + w6[k]) * conv,
                                          torch.zeros_like(conv)) for k in range(6)]
        if eps is not None:
            a00, a01, a02, a11, a12, a22 = (c[:, None] for c in remap_coeffs(hs, h_of(s + 1)))
            pn = [a00 * p[0] + a01 * p[1] + a02 * p[2], a11 * p[1] + a12 * p[2], a22 * p[2]]
            p = [torch.where(lv, pn[a], p[a]) for a in range(3)]
    return (torch.stack(p, -1), torch.stack(v, -1), torch.stack(xi, -1),
            torch.stack(pacc, -1))


def job_steps(h: torch.Tensor, dlength: torch.Tensor, strain_rate: float, dt: float):
    """(eps_eff (B, 6), nts (B,)): the per-run strain, the length variation
    over the current box (diagonals by L_j, [xy, xz, yz] by [lz, ly, lx]),
    and its steps ceil(|eps| / rate / dt / 10) * 10, at least 10."""
    L = torch.stack([h[:, 0, 0], h[:, 1, 1], h[:, 2, 2]], -1)
    div = torch.stack([L[:, 0], L[:, 1], L[:, 2], L[:, 2], L[:, 1], L[:, 0]], -1)
    eps = dlength / div
    nts = torch.ceil(voigt_norm(eps) / strain_rate / dt / 10.0) * 10.0
    return eps, torch.clamp(nts, min=10.0).to(torch.int64)


def strain_and_sample(sys: System, pos, vel, vxi, h, dlength, strain_rate: float, dt: float,
                      T: float, n_sample: int):
    """One HMM MD job per batch entry: strain the box by ``dlength`` (B, 6)
    under NVT, then sample the virial stress over ``n_sample`` NVT steps.
    Returns (pos, vel, vxi, h, stress in Pa (B, 6), nts (B,))."""
    eps, nts = job_steps(h, dlength, strain_rate, dt)
    pos, vel, vxi, _ = run(sys, pos, vel, vxi, h, nts, dt, T, eps=eps.to(pos.dtype))
    h_end = h_of_h6(h_at(h6_of(h), [eps[:, k].to(h.dtype) for k in range(6)], 1.0))
    ns = torch.full_like(nts, n_sample)
    pos, vel, vxi, pacc = run(sys, pos, vel, vxi, h_end, ns, dt, T, sample=True)
    press = pacc / float(n_sample)
    return pos, vel, vxi, h_end, -press * ATM_TO_PA, nts
