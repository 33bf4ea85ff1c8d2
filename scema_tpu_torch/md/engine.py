"""The batched MD engine: velocity Verlet + Nose-Hoover chains, fix-deform
strain driving, virial pressure sampling, FIRE relaxation.

Torch twin of the fused-path subset of ``scema_tpu/md/engine.py`` (the
replacement for the LAMMPS instances the reference spawns per quadrature
point, stmd_problem.h:83-383).  Every dynamics run goes through kernel K1
(``ops/md_fused.py``), or through K3 for charged all-atom systems; FIRE and
the stiffness probe take their forces from the kernel's force + virial
entry plus, with Ewald/PME, the smooth k-space remainder.  The unfused
neighbor-list engine with autograd forces is not ported yet.

States carry any leading batch shape: pos/vel (..., N, 3), h (..., 3, 3),
vxi (..., 3).  The runs flatten the batch into K1's job axis, so B jobs
integrate in one launch.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from ..ops import md_fused as MF
from . import box as B
from .units import REAL, UnitSystem

NHC_LEN = 3  # thermostat chain length (LAMMPS default tchain=3)
# FIRE restarts its velocities every FIRE_CHUNK steps: the JAX version's
# neighbor-rebuild chunk (MaterialSpec.rebuild_every, default 10)
FIRE_CHUNK = 10


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

    ff: object  # forcefields.opls.OPLS
    masses: torch.Tensor  # (N,)
    fused: MF.FusedRunner
    units: UnitSystem = REAL
    constraints: object = None  # constraints.Constraints (SHAKE/RATTLE in K3)

    @property
    def n_atoms(self) -> int:
        return int(self.masses.shape[0])

    @property
    def ndof(self) -> int:
        # fix shake subtracts each rigid bond from the temperature DOF count
        n_cons = 0 if self.constraints is None else int(self.constraints.mask.sum())
        return 3 * self.n_atoms - 3 - n_cons


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


def forces_virial(sys: MDSystem, pos: torch.Tensor, h: torch.Tensor,
                  want_virial: bool = True):
    """(F (..., N, 3), W (..., 6)): forces and Voigt potential virial from
    the kernel's force entry (W_ab = -dE/d eps_ab, symmetric), plus the
    smooth k-space remainder's force and virial for Ewald/PME systems — so
    F is the full Ewald gradient, as the JAX package's FIRE takes it.
    ``want_virial=False`` skips the remainder's virial (W then lacks it)."""
    bs = pos.shape[:-2]
    n = pos.shape[-2]
    pf, hf = pos.reshape(-1, n, 3), h.reshape(-1, 3, 3)
    F, W = MF.md_forces_virial(sys.fused, pf.transpose(1, 2), MF.h6_of(hf))
    F = F.transpose(1, 2)
    if sys.fused.kspace is not None:
        Fk, Wk = sys.fused.kspace(pf, hf, want_virial=want_virial)
        F = F + Fk
        if want_virial:
            W = W + Wk
    return F.reshape(bs + (n, 3)), W.reshape(bs + (6,))


def pressure_tensor(sys: MDSystem, state: MDState, W6: torch.Tensor) -> torch.Tensor:
    """Instantaneous virial pressure (Voigt-6, pressure units):
    P = (sum m v x v / ftm2v + W) / V * nktv2p (engine.py:183-191)."""
    m = sys.masses[:, None]
    kin = torch.einsum("...na,...nb->...ab", m * state.vel, state.vel) / sys.units.ftm2v
    kin6 = torch.stack([kin[..., 0, 0], kin[..., 1, 1], kin[..., 2, 2],
                        kin[..., 0, 1], kin[..., 0, 2], kin[..., 1, 2]], -1)
    return (kin6 + W6) / B.volume(state.h)[..., None] * sys.units.nktv2p


def _steps(n_steps, batch: int, device) -> torch.Tensor:
    n = torch.as_tensor(n_steps, dtype=torch.int64, device=device)
    return n.expand(batch).contiguous() if n.dim() == 0 else n.reshape(batch)


def run_strain(sys: MDSystem, state: MDState, eps_eff: torch.Tensor, n_steps,
               T: float, dt: float) -> MDState:
    """NVT run with ``fix deform ... erate`` toward strain ``eps_eff``
    (in.strain.lammps), one K1 launch for the whole batch.  ``n_steps`` is a
    scalar or per-job; a job with 0 steps is returned unchanged."""
    bs = state.batch_shape
    flat = state.flat()
    Bn = flat.pos.shape[0]
    eps = eps_eff.to(flat.pos).expand(bs + (6,)).reshape(Bn, 6)
    out = MF.run_strain_fused(sys.fused, flat, eps, _steps(n_steps, Bn, flat.pos.device), T, dt)
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
    out, press = MF.sample_stress_fused(sys.fused, flat, _steps(n_steps, Bn, flat.pos.device),
                                        T, dt)
    return out.unflat(bs), press.reshape(bs + (6,))


def minimize_fire(sys: MDSystem, state: MDState, n_steps: int = 200,
                  dt0: float = 1.0, fmax_dt: float = 4.0) -> MDState:
    """FIRE relaxation (engine.py:627-674), batched: every box keeps its own
    dt and mixing alpha.  Velocities restart from zero every
    ``FIRE_CHUNK`` steps, as in the JAX version's chunked loop."""
    u = sys.units
    bs = state.batch_shape
    st = state.flat()
    Bn = st.pos.shape[0]
    dtype, dev = st.pos.dtype, st.pos.device
    pos, h = st.pos, st.h
    minv = (u.ftm2v / sys.masses)[:, None]
    dt = torch.full((Bn, 1, 1), dt0, dtype=dtype, device=dev)
    alpha = torch.full((Bn, 1, 1), 0.1, dtype=dtype, device=dev)
    for _ in range(max(1, n_steps // FIRE_CHUNK)):
        vel = torch.zeros_like(pos)
        for _ in range(FIRE_CHUNK):
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
