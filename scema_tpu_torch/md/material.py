"""Material initialization: build + equilibrate a replica, measure its
equilibrium length/stress/stiffness/density.

Torch twin of the OPLS subset of ``scema_tpu/md/material.py`` (the
on-device ``init_material``, init_material_problem.h:114-303): build the
united-atom alkane melt or the charged all-atom PE melt (the reference's
OPLS material: ``lj/cut/coul/long`` + ``pppm`` + ``fix shake ... m 1.0``),
relax it with FIRE, thermalize with NVT (``equilibrate``, the quick
fixed-box prep), then sample the residual stress and probe the 6x6
stiffness (``measure``).  For Ewald/PME systems ``build_kspace_split``
gives the smooth k-space remainder that kernel K3 holds frozen between
chunks.  The staged heatup/cooldown NPT prep (``equilibrate_staged``), the
other force fields and systems read from data files are not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import md_fused as MF
from ..utils.device import resolve
from . import box as B
from . import engine as E
from .homogenization import MDParams, stiffness_probe
from .units import ATM_TO_PA, REAL

# g/mol per A^3 -> kg/m^3
DENSITY_CONV = 1660.539


@dataclass(frozen=True)
class MaterialSpec:
    """One MD material box: the fields of the JAX MaterialSpec that the
    OPLS paths read, with the same defaults, except that ``force_field``
    defaults to the one ported force field."""

    name: str
    force_field: str = "opls"  # only "opls" is ported
    # 64 chains x 8 beads => L ~ 25.8 A at 0.7 g/cm^3
    n_chains: int = 64
    chain_length: int = 8
    opls_lj_cutoff: float = 10.0
    opls_coul_cutoff: float = 9.0  # real-space Coulomb cutoff (in.set.lammps)
    use_ewald: bool = False  # alkanes are uncharged
    # all-atom PE melt (data_io.build_pe_melt_allatom): charged, H-bearing
    allatom: bool = False
    pe_density: float = 0.70
    # SHAKE on bonds involving mass-1 atoms; None = auto (on for allatom)
    shake: bool | None = None
    # steps between k-space re-evaluations (the rRESPA outer level)
    kspace_every: int = 10
    # reciprocal-sum backend: 'auto' (dense Ewald below 2048 atoms, PME
    # above), 'ewald' or 'pme'
    kspace: str = "auto"
    # setup-time min-image check; disable only for test fixtures
    validate: bool = True


# The charged all-atom PE material (the JAX package's bench.py
# _allatom_spec): 56 C10H22 chains, 1792 atoms in a ~26.9 A box,
# lj/cut/coul/long 12 / 9 A with the PME k-space split refreshed every 10
# steps, SHAKE on the bonds to hydrogen
PEAA = MaterialSpec(name="peaa", force_field="opls", allatom=True, n_chains=56,
                    chain_length=10, pe_density=0.68, opls_lj_cutoff=12.0,
                    opls_coul_cutoff=9.0, use_ewald=True, kspace_every=10, kspace="pme")


@dataclass(frozen=True)
class InitData:
    """The reference's per-replica equilibration outputs
    (init.<mat>_<n>.{length,stress,stiff} + density)."""

    length: np.ndarray  # (3,)
    stress: np.ndarray  # (6,) Pa
    stiff: np.ndarray  # (6, 6) Pa
    density: float  # kg/m^3


def _validate_setup(spec: MaterialSpec, h: np.ndarray, cutoff: float,
                    skin: float = 1.0) -> None:
    """Minimum-image bound of material._validate_setup: the list range
    cutoff + skin must not exceed half the smallest box height — beyond it
    a pair could interact through more than one periodic image, and K1's
    per-pair minimum image would miss genuine copies."""
    hmin = float(np.min(np.abs(np.diag(np.asarray(h, dtype=float)))))
    r_list = cutoff + skin
    if r_list > 0.5 * hmin:
        raise ValueError(
            f"material {spec.name!r}: neighbor range {r_list:.2f} A violates the "
            f"minimum-image bound (box min height {hmin:.2f} A); enlarge the box "
            "or reduce the cutoff/skin")


def build_kspace_split(ff, n: int):
    """The smooth k-space remainder for the fused split
    (material.py:183-250).

    Kernel K3 computes the exact weighted real-space Ewald sum every step,
    so the exact Ewald/PME total differs from it by only

        e_smooth = recip(pos, h) - sum_excl (1 - wq) qq erf(a r)/r

    over the sparse excluded-pair list (self energy is position-free).
    Returns ``kspace(pos (B, N, 3), h (B, 3, 3), want_virial=False) ->
    (F (B, N, 3), W (B, 6) or None)``: the force -grad e_smooth and, on
    request, the virial W = -dE/dF for the upper-triangular deformation F
    applied to positions and cell (fractional coordinates held), both from
    one autograd pass over the batched energy."""
    ew = ff.ewald
    alpha = float(ew.alpha)
    q = ff.charges.detach().cpu().double().numpy()
    excl = np.asarray(ff.excl)
    pi, pj, pw = [], [], []
    for order in range(3):
        wfac = 1.0 - float(ff.special_coul[order])
        if wfac == 0.0:
            continue
        for i in range(n):
            for jx in excl[i, order]:
                if jx > i:  # undirected pairs once (lists are symmetric)
                    pi.append(i)
                    pj.append(int(jx))
                    pw.append(wfac)
    if not pi:  # no excluded pairs: one dead pair keeps the shapes
        pi, pj, pw = [0], [min(1, n - 1)], [0.0]
    dev = ff.charges.device
    ei = torch.as_tensor(pi, dtype=torch.int64, device=dev)
    ej = torch.as_tensor(pj, dtype=torch.int64, device=dev)
    cpair = torch.as_tensor(ew.qqr2e * np.asarray(pw) * q[pi] * q[pj], device=dev)

    def e_smooth(pos, h):
        d = B.min_image_disp(h, pos[:, ej] - pos[:, ei])
        r = torch.sqrt(torch.sum(d * d, -1) + 1e-12)
        corr = -torch.sum(cpair.to(pos.dtype) * torch.erf(alpha * r) / r, -1)
        return ew.reciprocal_energy(pos, h) + corr

    def kspace(pos, h, want_virial: bool = False):
        with torch.enable_grad():
            p = pos.detach().requires_grad_(True)
            if not want_virial:
                (g,) = torch.autograd.grad(e_smooth(p, h).sum(), p)
                return -g, None
            f6 = torch.zeros((pos.shape[0], 6), dtype=pos.dtype, device=pos.device,
                             requires_grad=True)
            z = torch.zeros_like(f6[:, 0])
            M = torch.eye(3, dtype=pos.dtype, device=pos.device) + torch.stack([
                torch.stack([f6[:, 0], f6[:, 3], f6[:, 4]], -1),
                torch.stack([z, f6[:, 1], f6[:, 5]], -1),
                torch.stack([z, z, f6[:, 2]], -1)], -2)
            e = e_smooth(p @ M.transpose(-1, -2), M @ h).sum()
            gp, gf = torch.autograd.grad(e, (p, f6))
            return -gp, -gf

    return kspace


def build_system(spec: MaterialSpec, dtype=torch.float64,
                 device=None) -> tuple[E.MDSystem, E.MDState]:
    """The OPLS branch of material._build_system (material.py:658-713): the
    built-in united-atom alkane melt (K1's chain path) or, with
    ``allatom``, the charged all-atom PE melt with SHAKE on the bonds to
    hydrogen and, with ``use_ewald``, the Ewald/PME k-space split (K3).
    ``device`` None means the current CUDA device (an error without one);
    ``device="cpu"`` runs the kernels' plain versions."""
    from . import constraints as CN
    from . import data_io

    device = resolve(device)
    if spec.force_field != "opls":
        raise NotImplementedError(
            f"material {spec.name!r}: only the OPLS force field is ported "
            "(ROADMAP queue 1)")
    if spec.allatom:
        data = data_io.build_pe_melt_allatom(spec.n_chains, spec.chain_length,
                                             density=spec.pe_density)
    else:
        data = data_io.build_alkane_melt(spec.n_chains, spec.chain_length)
    ff = data_io.to_opls(data, lj_cutoff=spec.opls_lj_cutoff,
                         coul_cutoff=spec.opls_coul_cutoff, use_ewald=spec.use_ewald,
                         dtype=dtype, device=device, kspace=spec.kspace)
    n = len(data.pos)
    # fix shake ... m 1.0 (in.strain.lammps): bonds involving mass-1 atoms
    # held rigid at the bond style's r0
    cons = None
    if spec.shake if spec.shake is not None else spec.allatom:
        mt = data.masses[data.types]
        b = np.asarray(data.bonds)
        sel = (mt[b[:, 0]] < 1.5) | (mt[b[:, 1]] < 1.5)
        if bool(sel.any()):
            d0 = np.asarray(data.bond_coeffs)[np.asarray(data.bond_types)[sel], 1]
            cons = CN.from_bonds(b[sel], d0)
    if spec.validate:
        _validate_setup(spec, data.box, ff.cutoff)
    masses = torch.as_tensor(data.masses[data.types], dtype=dtype, device=device)
    kspace = build_kspace_split(ff, n) if ff.ewald is not None else None
    fused = MF.make_runner(ff, masses, REAL, dtype=dtype, device=device, constraints=cons,
                           kspace=kspace, kspace_every=spec.kspace_every)
    sys = E.MDSystem(ff=ff, masses=masses, fused=fused, units=REAL, constraints=cons)
    st = E.init_state(torch.as_tensor(data.pos, dtype=dtype, device=device),
                      torch.as_tensor(data.box, dtype=dtype, device=device))
    return sys, st


def equilibrate(sys: E.MDSystem, state: E.MDState, params: MDParams,
                generator: torch.Generator | None = None, minimize_steps: int = 100,
                equil_steps: int = 200, velocities: torch.Tensor | None = None) -> E.MDState:
    """Minimize then thermalize (the quick in.init.lammps prep): FIRE, then
    Maxwell-Boltzmann velocities at T and NVT at T; the box stays at the
    build volume.  ``velocities`` replaces the Maxwell draw."""
    state = E.minimize_fire(sys, state, n_steps=minimize_steps, dt0=0.5)
    if velocities is None:
        velocities = E.maxwell_velocities(sys, max(params.temperature, 1e-6), generator,
                                          dtype=state.pos.dtype, device=state.pos.device)
    state = state.replace(vel=velocities.to(state.pos))
    if equil_steps > 0:
        state = E.run_nvt(sys, state, equil_steps, params.temperature, params.dt)
    return state


def measure(sys: E.MDSystem, state: E.MDState, params: MDParams) -> InitData:
    """Equilibrium box lengths, residual stress, stiffness, density
    (init_material_problem.h:192-295)."""
    L, _ = B.lengths_tilts(state.h)
    st2, press = E.sample_stress(sys, state, params.nsteps_sample,
                                 params.temperature, params.dt)
    C = stiffness_probe(sys, st2, params)
    vol = float(B.volume(state.h))
    density = float(torch.sum(sys.masses)) * DENSITY_CONV / vol
    return InitData(length=L.double().cpu().numpy(),
                    stress=(-press * ATM_TO_PA).double().cpu().numpy(),
                    stiff=C.double().cpu().numpy(), density=density)
