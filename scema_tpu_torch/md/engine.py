"""The batched MD engine: velocity Verlet + Nose-Hoover chains, fix-deform
strain driving, virial pressure sampling, FIRE relaxation.

Torch twin of ``scema_tpu/md/engine.py`` (the replacement for the LAMMPS
instances the reference spawns per quadrature point,
stmd_problem.h:83-383), with two paths, as in the JAX package:

* the fused path (``MDSystem.fused`` set): every dynamics run goes through
  kernel K1 (``ops/md_fused.py``), or K3 for charged all-atom systems, K4
  (the gather-list pair loop) for boxes above the all-pairs gate, or K5
  for Stillinger-Weber silicon; FIRE and the stiffness probe take their
  forces from the kernel's force + virial entry (K4 builds a fresh list per
  call) plus, with Ewald/PME, the smooth k-space remainder;
* the unfused path (``fused`` None): the XLA engine's chunked loops
  (engine.py:313-353, :580-624, :627-674) in PyTorch — one neighbor list
  per ``rebuild_every``-step chunk (``build_neighbors``; a force field with
  a static structure of its own, the SW brick kernels K6c/K6d, needs none),
  forces re-evaluated at each chunk start after the deform remap, and
  forces from the force field's own entry or autograd of its energy.  SW
  boxes above K5's gate run here (``material.build_system``), any OPLS
  box built with ``use_fused=False``, and every ReaxFF box, whose QEq CG
  the strain and sampling loops warm-start within a chunk.

Constraints (SHAKE after the drift, RATTLE after the second kick,
``constraints.py``) run inside K3 on the fused runs and on the host in
every loop of this module: the unfused engine's, the NPT loops and
Berendsen, whichever engine gives the forces (engine.py:259-265, :274-275,
:522-536).  Like the JAX package's XLA engine, the sampled virial carries
no constraint term.

States carry any leading batch shape: pos/vel (..., N, 3), h (..., 3, 3),
vxi (..., 3).  Both paths flatten the batch into one job axis: the fused
kernels integrate B jobs in one launch, the unfused loops evaluate the
force field on all running jobs at once.  Every job runs its own step
count; a job with 0 steps comes back bit-identical.
"""
from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import torch

from ..ops import md_fused as MF
from . import box as B
from . import constraints as CN
from . import neighbor as NB
from .units import REAL, UnitSystem

NHC_LEN = 3  # thermostat chain length (LAMMPS default tchain=3)
TDAMP = 100.0  # thermostat damping, time units (fix nvt ... 100.0)


@dataclass(frozen=True)
class MDState:
    pos: torch.Tensor  # (..., N, 3)
    vel: torch.Tensor  # (..., N, 3)
    h: torch.Tensor  # (..., 3, 3) upper-triangular box
    vxi: torch.Tensor  # (..., NHC_LEN) thermostat velocities

    def replace(self, **kw) -> "MDState":
        return dataclasses.replace(self, **kw)

    @property
    def batch_shape(self) -> torch.Size:
        return self.pos.shape[:-2]

    def flat(self) -> "MDState":
        """Leading batch dims folded into one job axis."""
        n = self.pos.shape[-2]
        return MDState(pos=self.pos.reshape(-1, n, 3), vel=self.vel.reshape(-1, n, 3),
                       h=self.h.reshape(-1, 3, 3), vxi=self.vxi.reshape(-1, NHC_LEN))

    def unflat(self, batch_shape) -> "MDState":
        n = self.pos.shape[-2]
        bs = tuple(batch_shape)
        return MDState(pos=self.pos.reshape(bs + (n, 3)), vel=self.vel.reshape(bs + (n, 3)),
                       h=self.h.reshape(bs + (3, 3)), vxi=self.vxi.reshape(bs + (NHC_LEN,)))


@dataclass(frozen=True)
class MDSystem:
    """Static MD configuration: force field, masses, units, kernel inputs."""

    ff: object  # forcefields.opls.OPLS, forcefields.sw.SW or ops.sw_bricks.SWBricksFF
    masses: torch.Tensor  # (N,)
    fused: MF.FusedRunner | None = None  # None: the unfused engine
    units: UnitSystem = REAL
    constraints: object = None  # constraints.Constraints (SHAKE/RATTLE)
    nspec: NB.NeighborSpec | None = None  # the unfused engine's neighbor list
    # neighbor-list reuse (neigh_modify analog): the unfused loops' chunk
    # length, and FIRE's velocity-restart period on both paths
    rebuild_every: int = 10
    # the route material.build_system chose: the kernel ("K1", "K3", "K4",
    # "K5") or "unfused: <reason>"
    route: str = ""
    # parallel.spatial_md.SpatialRunner: the unfused SW force calls sharded
    # into x-slabs over ranks (P4; engine.py:56)
    spatial: object = None

    @property
    def n_atoms(self) -> int:
        return int(self.masses.shape[0])

    @functools.cached_property
    def shake_set(self):
        """The constraint set as tensors on the masses' device, made once
        for the host loops (None without constraints)."""
        if self.constraints is None:
            return None
        return CN.on_device(self.constraints, self.masses.device, self.masses.dtype)

    @property
    def ndof(self) -> int:
        # fix shake subtracts each rigid bond from the temperature DOF count
        n_cons = 0 if self.constraints is None else int(self.constraints.mask.sum())
        return 3 * self.n_atoms - 3 - n_cons

    def build_neighbors(self, pos: torch.Tensor, h: torch.Tensor):
        """The unfused force field's interaction structure at pos (B, N, 3)
        in boxes h (B, 3, 3): a neighbor list, or None for a force field
        with a static structure of its own (``slot_ids``, the brick
        kernels; engine.py:76-93); with ``spatial`` the rank's slab of the
        list."""
        if self.spatial is not None:
            return self.spatial.build(self.nspec, pos, h)
        if getattr(self.ff, "slot_ids", None) is not None:
            return None
        return NB.build(self.nspec, pos, h)


def init_state(pos, h, vel=None) -> MDState:
    pos = torch.as_tensor(pos)
    vel = torch.zeros_like(pos) if vel is None else torch.as_tensor(vel).to(pos)
    h = torch.as_tensor(h).to(pos)
    vxi = torch.zeros(pos.shape[:-2] + (NHC_LEN,), dtype=pos.dtype, device=pos.device)
    return MDState(pos=pos, vel=vel, h=h, vxi=vxi)


def maxwell_velocities(sys: MDSystem, T: float, generator: torch.Generator,
                       dtype=torch.float64, device=None) -> torch.Tensor:
    """Maxwell-Boltzmann velocities at T with zero centre-of-mass momentum,
    rescaled to exactly T.  Normal draws come from ``generator`` on the CPU
    (not the JAX package's draws; tests inject those instead)."""
    u = sys.units
    m = sys.masses.to(torch.float64).cpu()[:, None]
    std = torch.sqrt(u.boltz * T * u.ftm2v / m)
    v = torch.randn((sys.n_atoms, 3), generator=generator, dtype=torch.float64) * std
    v = v - torch.sum(m * v, 0) / torch.sum(m)
    ke2 = torch.sum(m * v * v) / u.ftm2v
    t_now = ke2 / (sys.ndof * u.boltz)
    v = v * torch.sqrt(T / torch.clamp(t_now, min=1e-30))
    return v.to(dtype=dtype, device=device)


def temperature(sys: MDSystem, vel: torch.Tensor) -> torch.Tensor:
    ke2 = torch.sum(sys.masses[:, None] * vel * vel, dim=(-1, -2)) / sys.units.ftm2v
    return ke2 / (sys.ndof * sys.units.boltz)


def _voigt(W: torch.Tensor) -> torch.Tensor:
    return torch.stack([W[..., 0, 0], W[..., 1, 1], W[..., 2, 2], W[..., 0, 1], W[..., 0, 2],
                        W[..., 1, 2]], -1)


def forces(sys: MDSystem, pos: torch.Tensor, h: torch.Tensor, nbr) -> torch.Tensor:
    """Unfused forces (B, N, 3) at pos (B, N, 3) in boxes h (B, 3, 3) over
    the structure ``nbr``: the force field's own ``forces`` (the brick
    kernels) or -grad of its energy (engine.py:124-127); with ``spatial``
    the slab-sharded gradient, summed over the ranks."""
    if sys.spatial is not None:
        return sys.spatial.forces(sys.ff, pos, h, nbr)
    if hasattr(sys.ff, "forces"):
        return sys.ff.forces(pos, h, nbr)
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        (g,) = torch.autograd.grad(sys.ff.energy(p, h, nbr).sum(), p)
    return -g


def forces_energy_virial(sys: MDSystem, pos: torch.Tensor, h: torch.Tensor, nbr):
    """Unfused (F (B, N, 3), E (B,), W (B, 6)): forces, potential energy and
    the Voigt potential virial W_ab = -dE/d eps_ab for the affine
    deformation pos -> (1 + eps) pos, h -> (1 + eps) h with a full 3x3 eps,
    symmetrised (engine.py:130-148, where W is 3x3) — one backward pass for
    both gradients; or the force field's own entry (the brick kernels); or
    with ``spatial`` the slab-sharded sums."""
    if sys.spatial is not None:
        return sys.spatial.forces_energy_virial(sys.ff, pos, h, nbr)
    if hasattr(sys.ff, "forces_energy_virial"):
        return sys.ff.forces_energy_virial(pos, h, nbr)
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        eps = torch.zeros(pos.shape[:-2] + (3, 3), dtype=pos.dtype, device=pos.device,
                          requires_grad=True)
        F = torch.eye(3, dtype=pos.dtype, device=pos.device) + eps
        E = sys.ff.energy(p @ F.transpose(-1, -2), F @ h, nbr)
        gp, ge = torch.autograd.grad(E.sum(), (p, eps))
    return -gp, E.detach(), _voigt(-0.5 * (ge + ge.transpose(-1, -2)))


def forces_virial(sys: MDSystem, pos: torch.Tensor, h: torch.Tensor,
                  want_virial: bool = True):
    """(F (..., N, 3), W (..., 6)): forces and Voigt potential virial.  Fused:
    the kernel's force entry (W_ab = -dE/d eps_ab, symmetric), plus the
    smooth k-space remainder's force and virial for Ewald/PME systems — so
    F is the full Ewald gradient, as the JAX package's FIRE takes it;
    ``want_virial=False`` skips the remainder's virial (W then lacks it).
    Unfused: a fresh neighbor structure and :func:`forces_energy_virial`,
    or with ``want_virial=False`` :func:`forces` alone (W is then None)."""
    bs = pos.shape[:-2]
    n = pos.shape[-2]
    pf, hf = pos.reshape(-1, n, 3), h.reshape(-1, 3, 3)
    if sys.fused is None:
        nbr = sys.build_neighbors(pf, hf)
        if not want_virial:
            return forces(sys, pf, hf, nbr).reshape(bs + (n, 3)), None
        F, _, W = forces_energy_virial(sys, pf, hf, nbr)
        return F.reshape(bs + (n, 3)), W.reshape(bs + (6,))
    F, W = MF.md_forces_virial(sys.fused, pf.transpose(1, 2), MF.h6_of(hf))
    F = F.transpose(1, 2)
    if sys.fused.kspace is not None:
        Fk, Wk = sys.fused.kspace(pf, hf, want_virial=want_virial)
        F = F + Fk
        if want_virial:
            W = W + Wk
    return F.reshape(bs + (n, 3)), W.reshape(bs + (6,))


def _qeq_warm_enabled(sys: MDSystem) -> bool:
    """True when the force field warm-starts its QEq CG between the steps
    of a neighbor-rebuild chunk (``ReaxFFList.qeq_warm``; engine.py:151-
    158): one cold solve per chunk, then few-trip seeded solves."""
    ff = sys.ff
    return bool(getattr(ff, "qeq_warm", False) and getattr(ff, "qeq", False)
                and hasattr(ff, "energy_qeq"))


def _forces_qeq(sys: MDSystem, pos: torch.Tensor, h: torch.Tensor, nbr, guess):
    """(F (B, N, 3), qeq_aux (B, 2, N)): forces with the QEq CG seeded by
    ``guess`` (None: a cold solve; engine.py:161-166)."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        E, aux = sys.ff.energy_qeq(p, h, nbr, qeq_guess=guess)
        (g,) = torch.autograd.grad(E.sum(), p)
    return -g, aux


def _forces_virial_qeq(sys: MDSystem, pos: torch.Tensor, h: torch.Tensor, nbr, guess):
    """(F, W (B, 6), qeq_aux) from one energy evaluation (the sampling
    loop's; engine.py:169-180)."""
    with torch.enable_grad():
        p = pos.detach().requires_grad_(True)
        eps = torch.zeros(pos.shape[:-2] + (3, 3), dtype=pos.dtype, device=pos.device,
                          requires_grad=True)
        F = torch.eye(3, dtype=pos.dtype, device=pos.device) + eps
        E, aux = sys.ff.energy_qeq(p @ F.transpose(-1, -2), F @ h, nbr, qeq_guess=guess)
        gp, ge = torch.autograd.grad(E.sum(), (p, eps))
    return -gp, _voigt(-0.5 * (ge + ge.transpose(-1, -2))), aux


def pressure_tensor(sys: MDSystem, state: MDState, W6: torch.Tensor) -> torch.Tensor:
    """Instantaneous virial pressure (Voigt-6, pressure units):
    P = (sum m v x v / ftm2v + W) / V * nktv2p (engine.py:183-191)."""
    return _pressure(sys, state.vel, state.h, W6)


def _pressure(sys: MDSystem, vel: torch.Tensor, h: torch.Tensor, W6: torch.Tensor):
    m = sys.masses[:, None]
    kin = torch.einsum("...na,...nb->...ab", m * vel, vel) / sys.units.ftm2v
    return (_voigt(kin) + W6) / B.volume(h)[..., None] * sys.units.nktv2p


def _steps(n_steps, batch: int, device) -> torch.Tensor:
    n = torch.as_tensor(n_steps, dtype=torch.int64, device=device)
    return n.expand(batch).contiguous() if n.dim() == 0 else n.reshape(batch)


def _nhc_half(sys: MDSystem, vel: torch.Tensor, vxi: torch.Tensor, T: float, dt: float):
    """Half-step Nose-Hoover chain update (MTK) of each job's velocities
    (B, N, 3) and chain (B, 3) (engine.py:194-235); returns (vel, vxi)."""
    u = sys.units
    kt = u.boltz * T
    ndof = sys.ndof
    q = [ndof * kt * TDAMP ** 2] + [kt * TDAMP ** 2] * (NHC_LEN - 1)
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0
    ke2 = torch.sum(sys.masses[:, None] * vel * vel, (-1, -2)) / u.ftm2v  # 2 KE
    x = list(vxi.unbind(-1))

    def g(k, ke2_):
        if k == 0:
            return (ke2_ - ndof * kt) / q[0]
        return (q[k - 1] * x[k - 1] ** 2 - kt) / q[k]

    def sweep(ks, ke2_):
        for k in ks:
            if k == NHC_LEN - 1:
                x[k] = x[k] + dt4 * g(k, ke2_)
            else:
                s = torch.exp(-dt8 * x[k + 1])
                x[k] = s * (s * x[k] + dt4 * g(k, ke2_))

    sweep(range(NHC_LEN - 1, -1, -1), ke2)  # chain tail -> head
    scale = torch.exp(-dt2 * x[0])
    vel = vel * scale[:, None, None]
    sweep(range(NHC_LEN), ke2 * scale * scale)  # head -> tail
    return vel, torch.stack(x, -1)


def _verlet_step(sys: MDSystem, st: MDState, F: torch.Tensor, T: float, dt: float,
                 force_fn):
    """One NVT velocity-Verlet step of the running jobs (engine.py:238-281).
    With constraints, SHAKE corrects the drifted positions against the old
    ones and the velocities take the constraint impulse (pos_c - pos) /
    dt; RATTLE follows the second kick.  ``force_fn(pos, h) -> (F,
    extra)`` evaluates the new forces (the sampling loop takes the virial
    from the same evaluation); returns (state, F_new, extra)."""
    minv = (sys.units.ftm2v / sys.masses)[:, None]
    cons = sys.shake_set
    vel, vxi = _nhc_half(sys, st.vel, st.vxi, T, dt)
    vel = vel + 0.5 * dt * F * minv
    pos = st.pos + dt * vel
    if cons is not None:
        pos_c = CN.shake_positions(cons, st.pos, pos, st.h, 1.0 / sys.masses)
        vel = vel + (pos_c - pos) / dt
        pos = pos_c
    F_new, extra = force_fn(pos, st.h)
    vel = vel + 0.5 * dt * F_new * minv
    if cons is not None:
        vel = CN.rattle_velocities(cons, pos, vel, st.h, 1.0 / sys.masses)
    vel, vxi = _nhc_half(sys, vel, vxi, T, dt)
    return st.replace(pos=pos, vel=vel, vxi=vxi), F_new, extra


def _subset(st: MDState, act: torch.Tensor, full: bool) -> MDState:
    if full:
        return st
    return MDState(pos=st.pos[act], vel=st.vel[act], h=st.h[act], vxi=st.vxi[act])


def _merge(st: MDState, act: torch.Tensor, sub: MDState, full: bool) -> MDState:
    if full:
        return sub
    return MDState(*(getattr(st, f).index_copy(0, act, getattr(sub, f))
                     for f in ("pos", "vel", "h", "vxi")))


def _chunks(n_chunks: torch.Tensor):
    """Per chunk c, the jobs that still run it: (c, act, all jobs run)."""
    c_max = int(n_chunks.max()) if n_chunks.numel() else 0
    for c in range(c_max):
        act = torch.nonzero(n_chunks > c).flatten()
        yield c, act, act.numel() == n_chunks.numel()


def _run_strain_unfused(sys: MDSystem, st: MDState, eps: torch.Tensor,
                        n_steps: torch.Tensor, T: float, dt: float) -> MDState:
    """The XLA engine's chunked strain run (engine.py:313-353) on (B,) jobs:
    a running job takes max(n, R) // R chunks of R = rebuild_every steps
    (the JAX floor; 0 steps: untouched), each starting with a fresh list
    and a force evaluation after the previous chunk's remap, and the box
    moves to deform_path(h0, eps, (step + 1) / max(n, R)) after each step.
    With the QEq warm start (:func:`_qeq_warm_enabled`, engine.py:316-345)
    each chunk starts with a cold solve and every later step seeds its CG
    with the previous step's (s, tv) vectors, one pair per job of the
    chunk's batch (the chunk's jobs are fixed, so nothing merges back)."""
    R = sys.rebuild_every
    h0 = st.h
    warm = _qeq_warm_enabled(sys)
    n_eff = torch.where(n_steps > 0, torch.clamp(n_steps, min=R), torch.zeros_like(n_steps))
    for c, act, full in _chunks(n_eff // R):
        sub = _subset(st, act, full)
        h0a, ea = (h0, eps) if full else (h0[act], eps[act])
        ne = (n_eff if full else n_eff[act]).to(st.pos.dtype)
        nbr = sys.build_neighbors(sub.pos, sub.h)
        if warm:
            F, aux = _forces_qeq(sys, sub.pos, sub.h, nbr, None)  # cold solve
        else:
            F, aux = forces(sys, sub.pos, sub.h, nbr), None

        def fn(pos, h):  # reads the aux of the step before (late binding)
            if warm:
                return _forces_qeq(sys, pos, h, nbr, aux)
            return forces(sys, pos, h, nbr), None

        for i in range(R):
            sub, F, aux = _verlet_step(sys, sub, F, T, dt, fn)
            # fix deform end_of_step: the box at its target for step + 1
            h_new = B.deform_path(h0a, ea, (c * R + i + 1) / ne)
            sub = sub.replace(pos=B.remap_affine(sub.h, h_new, sub.pos), h=h_new)
        st = _merge(st, act, sub, full)
    return st


def _sample_stress_unfused(sys: MDSystem, st: MDState, n_steps: torch.Tensor, T: float,
                           dt: float):
    """The XLA engine's sampling run (engine.py:580-624) on (B,) jobs:
    max(1, n // R) chunks per running job, one energy evaluation per step
    for the force and the virial; returns (state, mean pressure (B, 6)).
    With the QEq warm start, as in the strain run (engine.py:581-600)."""
    R = sys.rebuild_every
    n_chunks = torch.where(n_steps > 0, torch.clamp(n_steps // R, min=1),
                           torch.zeros_like(n_steps))
    warm = _qeq_warm_enabled(sys)
    acc = torch.zeros(st.pos.shape[:-2] + (6,), dtype=st.pos.dtype, device=st.pos.device)
    for _, act, full in _chunks(n_chunks):
        sub = _subset(st, act, full)
        nbr = sys.build_neighbors(sub.pos, sub.h)
        if warm:
            F, _, aux = _forces_virial_qeq(sys, sub.pos, sub.h, nbr, None)  # cold solve
        else:
            F, aux = forces(sys, sub.pos, sub.h, nbr), None

        def fn(pos, h):  # reads the aux of the step before (late binding)
            if warm:
                Fx, Wx, ax = _forces_virial_qeq(sys, pos, h, nbr, aux)
                return Fx, (Wx, ax)
            Fx, _, Wx = forces_energy_virial(sys, pos, h, nbr)
            return Fx, (Wx, None)

        acc_c = torch.zeros_like(acc[:act.numel()])
        for _ in range(R):
            sub, F, (W, aux) = _verlet_step(sys, sub, F, T, dt, fn)
            acc_c = acc_c + pressure_tensor(sys, sub, W)
        st = _merge(st, act, sub, full)
        acc = acc + acc_c if full else acc.index_add(0, act, acc_c)
    press = acc / torch.clamp(n_chunks * R, min=1).to(acc.dtype)[:, None]
    return st, press


def run_strain(sys: MDSystem, state: MDState, eps_eff: torch.Tensor, n_steps,
               T: float, dt: float) -> MDState:
    """NVT run with ``fix deform ... erate`` toward strain ``eps_eff``
    (in.strain.lammps).  Fused: one kernel launch for the whole batch (one
    per chunk with the k-space split or a list); unfused: the chunked loop.
    ``n_steps`` is a scalar or per-job; a job with 0 steps is returned
    unchanged."""
    bs = state.batch_shape
    flat = state.flat()
    Bn = flat.pos.shape[0]
    eps = eps_eff.to(flat.pos).expand(bs + (6,)).reshape(Bn, 6)
    steps = _steps(n_steps, Bn, flat.pos.device)
    if sys.fused is None:
        out = _run_strain_unfused(sys, flat, eps, steps, T, dt)
    else:
        out = MF.run_strain_fused(sys.fused, flat, eps, steps, T, dt)
    return out.unflat(bs)


def run_nvt(sys: MDSystem, state: MDState, n_steps, T: float, dt: float) -> MDState:
    """Plain NVT run."""
    zero = torch.zeros((6,), dtype=state.pos.dtype, device=state.pos.device)
    return run_strain(sys, state, zero, n_steps, T, dt)


def sample_stress(sys: MDSystem, state: MDState, n_steps, T: float,
                  dt: float) -> tuple[MDState, torch.Tensor]:
    """NVT run returning the time-averaged virial pressure (..., 6)
    (ELASTIC/in.homogenization.lammps, ``fix ave/time``); the caller
    converts to Pa."""
    bs = state.batch_shape
    flat = state.flat()
    Bn = flat.pos.shape[0]
    steps = _steps(n_steps, Bn, flat.pos.device)
    if sys.fused is None:
        out, press = _sample_stress_unfused(sys, flat, steps, T, dt)
    else:
        out, press = MF.sample_stress_fused(sys.fused, flat, steps, T, dt)
    return out.unflat(bs), press.reshape(bs + (6,))


def _npt_forces(sys: MDSystem):
    """The NPT loops' force call: ``fv(pos, h, nbr) -> (F (B, N, 3), W (B,
    6))`` from one evaluation — the fused kernel's force + virial entry
    (with the k-space remainder), or :func:`forces_energy_virial` over the
    chunk's list ``nbr`` on the unfused engine — and ``nb(pos, h)``, the
    chunk's list (None on the fused engine)."""
    if sys.fused is not None:
        return (lambda pos, h, nbr: forces_virial(sys, pos, h)), (lambda pos, h: None)

    def fv(pos, h, nbr):
        F, _, W = forces_energy_virial(sys, pos, h, nbr)
        return F, W

    return fv, sys.build_neighbors


def _p_iso(sys: MDSystem, vel: torch.Tensor, h: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    p6 = _pressure(sys, vel, h, W)
    return (p6[..., 0] + p6[..., 1] + p6[..., 2]) / 3.0


def run_npt(sys: MDSystem, state: MDState, n_steps: int, T_start: float, T_end: float,
            dt: float, p_target: float = 1.0, pdamp: float = 1000.0,
            compressibility: float = 4.5e-5, barostat: str = "mtk") -> MDState:
    """NPT with a temperature ramp — the reference's material-prep stages
    (``fix npt temp T1 T2 100.0 iso 1.0 1.0 1000``, in.init.lammps;
    engine.py:362-419), batched over jobs: every box keeps its own
    barostat.  ``barostat="mtk"`` is the isotropic Martyna-Tobias-Klein
    barostat of ``fix npt`` (:func:`_run_npt_mtk`); ``"berendsen"`` the
    weak-coupling relaxer, whose box scale mu = clip(1 - dt/pdamp
    compressibility (p_target - p_iso), 0.9, 1.1)^(1/3) follows each NVT
    step (``compressibility`` applies to it only).  The loop runs
    max(1, n // R) chunks of R = rebuild_every steps, the temperature
    ramping with frac = step / total, total = max(1, n // R) R.  Forces
    and virial come from one evaluation per step (:func:`_npt_forces`);
    constraints, SHAKE and RATTLE around it on the host, as in the NVT
    step."""
    if barostat == "mtk":
        return _run_npt_mtk(sys, state, n_steps, T_start, T_end, dt, p_target, pdamp)
    if barostat != "berendsen":
        raise ValueError(f"run_npt: unknown barostat {barostat!r}")
    bs = state.batch_shape
    st = state.flat()
    R = sys.rebuild_every
    n_chunks = max(1, n_steps // R)
    total = n_chunks * R
    fv, nb = _npt_forces(sys)
    for c in range(n_chunks):
        nbr = nb(st.pos, st.h)
        F, _ = fv(st.pos, st.h, nbr)
        for i in range(R):
            T = T_start + (T_end - T_start) * ((c * R + i) / total)
            st, F, W = _verlet_step(sys, st, F, T, dt, lambda p, h: fv(p, h, nbr))
            p_iso = _p_iso(sys, st.vel, st.h, W)
            mu_base = torch.clamp(1.0 - dt / pdamp * compressibility * (p_target - p_iso),
                                  0.9, 1.1)
            mu = (mu_base ** (1.0 / 3.0))[:, None, None]
            st = st.replace(pos=st.pos * mu, h=st.h * mu)
    return st.unflat(bs)


def _baro_nhc_half(vxi_b: torch.Tensor, omega_dot: torch.Tensor, w_b: float, kt: float,
                   pdamp: float, dt: float):
    """Half-step Nose-Hoover chain on each job's barostat momentum (LAMMPS
    fix_nh::nhc_press_integrate; engine.py:422-452): one dof, chain masses
    kT pdamp^2; vxi_b (B, 3), omega_dot (B,)."""
    q = kt * pdamp * pdamp
    dt2, dt4, dt8 = dt / 2.0, dt / 4.0, dt / 8.0
    ke2 = w_b * omega_dot * omega_dot
    x = list(vxi_b.unbind(-1))

    def g(k, ke2_):
        if k == 0:
            return (ke2_ - kt) / q
        return (q * x[k - 1] ** 2 - kt) / q

    def sweep(ks, ke2_):
        for k in ks:
            if k == NHC_LEN - 1:
                x[k] = x[k] + dt4 * g(k, ke2_)
            else:
                s = torch.exp(-dt8 * x[k + 1])
                x[k] = s * (s * x[k] + dt4 * g(k, ke2_))

    sweep(range(NHC_LEN - 1, -1, -1), ke2)
    scale = torch.exp(-dt2 * x[0])
    omega_dot = omega_dot * scale
    sweep(range(NHC_LEN), ke2 * scale * scale)
    return torch.stack(x, -1), omega_dot


def _run_npt_mtk(sys: MDSystem, state: MDState, n_steps: int, T_start: float, T_end: float,
                 dt: float, p_target: float, pdamp: float) -> MDState:
    """Isotropic MTK NPT in LAMMPS fix_nh's order (engine.py:455-557), per
    step: particle and barostat chains (dt/2) -> omega_dot (dt/2) -> MTK
    velocity scale exp(-dt/2 (1 + 1/N) omega_dot) -> kick (dt/2) ->
    dilated drift x = (x e1 + dt v) e1, h = h e1^2 with e1 = exp(dt/2
    omega_dot) -> forces and virial -> kick -> MTK scale -> omega_dot ->
    chains.  f_omega = (3 V (P - P0) / nktv2p + 2 KE / N) / W_b with W_b =
    3 (N + 1) kT pdamp^2 reads the half-scaled velocities and the virial
    of the previous force call.  With constraints, SHAKE follows the drift
    against the old positions scaled into the new box (x_old e1^2), and
    RATTLE the second kick.  Each job carries omega_dot (B,) and its
    barostat chain (B, 3), both from zero; the barostat scalars stay on
    the device."""
    u = sys.units
    bs = state.batch_shape
    st = state.flat()
    R = sys.rebuild_every
    n_chunks = max(1, n_steps // R)
    total = n_chunks * R
    N = float(sys.n_atoms)
    minv = (u.ftm2v / sys.masses)[:, None]
    cons = sys.shake_set
    dt2 = dt / 2.0
    fv, nb = _npt_forces(sys)

    def f_omega(vel, h, p_iso, kt_t):
        ke2 = torch.sum(sys.masses[:, None] * vel * vel, (-1, -2)) / u.ftm2v
        w_b = 3.0 * (N + 1.0) * kt_t * pdamp * pdamp
        return ((p_iso - p_target) * 3.0 * B.volume(h) / u.nktv2p + ke2 / N) / w_b

    omega_dot = torch.zeros(st.pos.shape[:1], dtype=st.pos.dtype, device=st.pos.device)
    vxi_b = torch.zeros_like(st.vxi)
    for c in range(n_chunks):
        nbr = nb(st.pos, st.h)
        F, W = fv(st.pos, st.h, nbr)
        for i in range(R):
            T = T_start + (T_end - T_start) * ((c * R + i) / total)
            kt_t = u.boltz * T
            w_b = 3.0 * (N + 1.0) * kt_t * pdamp * pdamp
            vel, vxi = _nhc_half(sys, st.vel, st.vxi, T, dt)
            vxi_b, omega_dot = _baro_nhc_half(vxi_b, omega_dot, w_b, kt_t, pdamp, dt)
            omega_dot = omega_dot + dt2 * f_omega(vel, st.h, _p_iso(sys, vel, st.h, W), kt_t)
            mtk_scale = torch.exp(-dt2 * (1.0 + 1.0 / N) * omega_dot)[:, None, None]
            vel = vel * mtk_scale
            vel = vel + dt2 * F * minv
            e1 = torch.exp(dt2 * omega_dot)[:, None, None]
            pos = (st.pos * e1 + dt * vel) * e1
            h = st.h * (e1 * e1)
            if cons is not None:
                pos_c = CN.shake_positions(cons, st.pos * e1 * e1, pos, h, 1.0 / sys.masses)
                vel = vel + (pos_c - pos) / dt
                pos = pos_c
            F, W = fv(pos, h, nbr)
            vel = vel + dt2 * F * minv
            if cons is not None:
                vel = CN.rattle_velocities(cons, pos, vel, h, 1.0 / sys.masses)
            vel = vel * mtk_scale
            omega_dot = omega_dot + dt2 * f_omega(vel, h, _p_iso(sys, vel, h, W), kt_t)
            vxi_b, omega_dot = _baro_nhc_half(vxi_b, omega_dot, w_b, kt_t, pdamp, dt)
            vel, vxi = _nhc_half(sys, vel, vxi, T, dt)
            st = MDState(pos=pos, vel=vel, h=h, vxi=vxi)
    return st.unflat(bs)


def minimize_fire(sys: MDSystem, state: MDState, n_steps: int = 200,
                  dt0: float = 1.0, fmax_dt: float = 4.0) -> MDState:
    """FIRE relaxation (engine.py:627-674), batched: every box keeps its own
    dt and mixing alpha.  Velocities restart from zero every
    ``rebuild_every`` steps, as in the JAX version's chunked loop, where
    the unfused path also rebuilds its neighbor structure."""
    u = sys.units
    bs = state.batch_shape
    st = state.flat()
    Bn = st.pos.shape[0]
    dtype, dev = st.pos.dtype, st.pos.device
    pos, h = st.pos, st.h
    minv = (u.ftm2v / sys.masses)[:, None]
    dt = torch.full((Bn, 1, 1), dt0, dtype=dtype, device=dev)
    alpha = torch.full((Bn, 1, 1), 0.1, dtype=dtype, device=dev)
    R = sys.rebuild_every
    for _ in range(max(1, n_steps // R)):
        vel = torch.zeros_like(pos)
        nbr = sys.build_neighbors(pos, h) if sys.fused is None else None
        for _ in range(R):
            if sys.fused is None:
                F = forces(sys, pos, h, nbr)
            else:
                F, _ = forces_virial(sys, pos, h, want_virial=False)
            vel = vel + dt * F * minv
            fnorm = torch.sqrt(torch.sum(F * F, dim=(1, 2), keepdim=True)) + 1e-30
            vnorm = torch.sqrt(torch.sum(vel * vel, dim=(1, 2), keepdim=True))
            power = torch.sum(F * vel, dim=(1, 2), keepdim=True)
            vel = (1 - alpha) * vel + alpha * vnorm * F / fnorm
            uphill = power < 0.0
            vel = torch.where(uphill, torch.zeros_like(vel), vel)
            dt = torch.where(uphill, dt * 0.5, torch.clamp(dt * 1.1, max=fmax_dt))
            alpha = torch.where(uphill, torch.full_like(alpha, 0.1), alpha * 0.99)
            # per-step displacement cap (LAMMPS dmax analog)
            step_d = dt * vel
            dn = torch.linalg.vector_norm(step_d, dim=-1, keepdim=True)
            step_d = step_d * torch.clamp(0.1 / torch.clamp(dn, min=1e-30), max=1.0)
            pos = pos + step_d
    return st.replace(pos=pos, vel=torch.zeros_like(pos)).unflat(bs)
