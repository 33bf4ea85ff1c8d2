"""Strain-driven MD jobs + stress/stiffness homogenization.

Torch twin of ``scema_tpu/md/homogenization.py``.  ``strain_and_homogenize``
is one reference MD job per batch entry (STMDProblem::lammps_straining,
stmd_problem.h:83-383):

1. requested box-length variation -> per-run strain using the *current* box
   (stmd_problem.h:221-227);
2. nts = ceil((|eps|/rate)/dt/10)*10, min 10 (stmd_problem.h:228-232);
3. NVT + fix-deform for nts steps (in.strain.lammps);
4. NVT sampling of the time-averaged virial pressure over nssample steps
   (ELASTIC/in.homogenization.lammps);
5. ATM -> Pa with the reference's -1.01325e5 factor (stmd_problem.h:335-341).

On the fused engine the whole batch of jobs runs in one kernel launch per
phase (K1, K5 for SW silicon, or K3/K4 for charged all-atom boxes: one
launch per chunk when the smooth k-space remainder and, on K4, the
neighbor list are refreshed between chunks); on the unfused engine (SW
boxes above K5's gate: the brick kernels K6c/K6d or the list route) the
chunked loops evaluate every running job's forces at once.  Inactive batch
entries get zero steps on both engines, their state left unchanged —
where the JAX package's list and unfused paths run them for their full
length (at least 10 steps) and discard them.  ``strain_and_homogenize_multi``
packs J jobs per block of K1 (K1m), the coupler's ``pack_jobs``.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..ops import md_fused as MF
from ..utils import tensors as T
from ..utils import trace
from . import box as B
from . import engine as E
from .units import ATM_TO_PA


@dataclass(frozen=True)
class MDParams:
    """Per-run MD parameters (config 'molecular dynamics parameters')."""

    temperature: float
    dt: float  # timestep (fs in real units)
    strain_rate: float  # 1/time
    nsteps_sample: int


def effective_strain(h: torch.Tensor, dlength: torch.Tensor) -> torch.Tensor:
    """Per-run strain = length variation / current box dims: diagonal j by
    L_j, Voigt [xy, xz, yz] by [lz, ly, lx] (stmd_problem.h:221-227)."""
    L, _ = B.lengths_tilts(h)
    div = torch.stack([L[..., 0], L[..., 1], L[..., 2], L[..., 2], L[..., 1], L[..., 0]], -1)
    return dlength / div


def nts_for_strain(eps_v: torch.Tensor, params: MDParams) -> torch.Tensor:
    """nts = ceil((|eps|/rate)/dt/10)*10, min 10 (stmd_problem.h:228-232)."""
    strain_time = T.voigt_norm(eps_v) / params.strain_rate
    nts = torch.ceil(strain_time / params.dt / 10.0) * 10.0
    return torch.clamp(nts, min=10.0).to(torch.int64)


def _job_steps(state: E.MDState, dlength: torch.Tensor, params: MDParams, active):
    """(eps_eff, nts, n_sample) of each job; inactive jobs get zero steps."""
    eps_eff = effective_strain(state.h, dlength)
    nts = nts_for_strain(eps_eff, params)
    n_sample = torch.full_like(nts, params.nsteps_sample)
    if active is not None:
        nts = torch.where(active, nts, torch.zeros_like(nts))
        n_sample = torch.where(active, n_sample, torch.zeros_like(n_sample))
        eps_eff = torch.where(active[..., None], eps_eff, torch.zeros_like(eps_eff))
    return eps_eff, nts, n_sample


def strain_and_homogenize(sys: E.MDSystem, state: E.MDState, dlength: torch.Tensor,
                          params: MDParams, active: torch.Tensor | None = None):
    """Batched MD jobs: strain each box, then sample its virial stress.

    ``state`` leaves and ``dlength`` (..., 6) share a leading batch shape.
    Returns (new microstates, stress in Pa (..., 6), framework Voigt order).
    Entries with ``active`` False run zero steps: their state comes back
    unchanged and their stress is zero (the caller discards it)."""
    eps_eff, nts, n_sample = _job_steps(state, dlength, params, active)
    trace.count_device("md.job_steps", nts.sum() + n_sample.sum())
    with trace.span("md.strain"):
        state = E.run_strain(sys, state, eps_eff, nts, params.temperature, params.dt)
    with trace.span("md.sample"):
        state, press = E.sample_stress(sys, state, n_sample, params.temperature, params.dt)
    return state, -press * ATM_TO_PA


def strain_and_homogenize_multi(sys: E.MDSystem, state: E.MDState, dlength: torch.Tensor,
                                params: MDParams, active: torch.Tensor | None = None):
    """:func:`strain_and_homogenize` with J jobs per kernel block (K1m,
    homogenization.py:108-133): ``state`` leaves, ``dlength`` (G, J, 6) and
    ``active`` (G, J) carry the (G, J) grouping.  Every job's result is the
    unpacked one's; inactive jobs take zero steps and come back
    bit-identical.  Only K1's runner packs (ValueError otherwise: K3, K4,
    K5 and the unfused engine)."""
    if sys.fused is None:
        raise ValueError("multi-job packing runs the fused kernel K1m; this system runs the "
                         "unfused engine")
    eps_eff, nts, n_sample = _job_steps(state, dlength, params, active)
    trace.count_device("md.job_steps", nts.sum() + n_sample.sum())
    with trace.span("md.strain"):
        state = MF.run_strain_fused_multi(sys.fused, state, eps_eff, nts, params.temperature,
                                          params.dt)
    with trace.span("md.sample"):
        state, press = MF.sample_stress_fused_multi(sys.fused, state, n_sample,
                                                    params.temperature, params.dt)
    return state, -press * ATM_TO_PA


# LAMMPS ELASTIC Voigt dir (0-based) -> framework Voigt index
# LAMMPS: 1=xx 2=yy 3=zz 4=yz 5=xz 6=xy ; framework: [xx,yy,zz,xy,xz,yz]
_LAMMPS_TO_FRAMEWORK = (0, 1, 2, 5, 4, 3)


def stiffness_probe(sys: E.MDSystem, state: E.MDState, params: MDParams,
                    up: float = 1.0e-3, thermal: bool = False,
                    relax_steps: int = 60) -> torch.Tensor:
    """6x6 stiffness (Pa) from +/- finite box deformations
    (ELASTIC/in.modulus.lammps; homogenization.py:141-193): the twelve
    deformed boxes as one batch.  ``thermal=False`` relaxes them with FIRE
    at fixed box, then one force + virial evaluation (the kernel's entry
    plus the k-space remainder's virial for Ewald/PME systems) gives each
    pressure tensor; ``thermal=True`` samples them by NVT, as the reference
    does, in one :func:`engine.sample_stress` call (the fused kernel's
    sampling run).  ``C[:, d] = -(P(+up) - P(-up)) / (2 up) * atm_to_pa``,
    symmetrized."""
    dtype, dev = state.pos.dtype, state.pos.device
    eps = torch.zeros((12, 6), dtype=dtype, device=dev)
    for d in range(6):
        fw = _LAMMPS_TO_FRAMEWORK[d]
        eps[2 * d, fw] = up
        eps[2 * d + 1, fw] = -up
    h0 = state.h.expand(12, 3, 3)
    h1 = B.deform_path(h0, eps, 1.0)
    pos1 = B.remap_affine(h0, h1, state.pos.expand(12, -1, -1))
    if thermal:
        st = E.MDState(pos=pos1, vel=state.vel.expand(12, -1, -1).clone(), h=h1,
                       vxi=state.vxi.expand(12, -1).clone())
        _, P = E.sample_stress(sys, st, params.nsteps_sample, params.temperature,
                               params.dt)
    else:
        st = E.MDState(pos=pos1, vel=torch.zeros_like(pos1), h=h1,
                       vxi=state.vxi.expand(12, -1).clone())
        if relax_steps > 0:
            st = E.minimize_fire(sys, st, n_steps=relax_steps, dt0=0.2)
        _, W = E.forces_virial(sys, st.pos, st.h)
        P = E.pressure_tensor(sys, st.replace(vel=torch.zeros_like(st.vel)), W)
    C = torch.zeros((6, 6), dtype=dtype, device=dev)
    for d in range(6):
        C[:, _LAMMPS_TO_FRAMEWORK[d]] = -(P[2 * d] - P[2 * d + 1]) / (2.0 * up) * ATM_TO_PA
    return 0.5 * (C + C.T)
