"""Material initialization: build + equilibrate a replica, measure its
equilibrium length/stress/stiffness/density.

Torch twin of the SW and OPLS subsets of ``scema_tpu/md/material.py`` (the
on-device ``init_material``, init_material_problem.h:114-303): build the
diamond-Si Stillinger-Weber box (the streched_polyhedron example's
material, kernel K5), the united-atom alkane melt or the charged all-atom
PE melt (the reference's OPLS material: ``lj/cut/coul/long`` + ``pppm`` +
``fix shake ... m 1.0``), relax it with FIRE, thermalize with NVT
(``equilibrate``, the quick fixed-box prep), then sample the residual
stress and probe the 6x6 stiffness (``measure``). For Ewald/PME systems
``build_kspace_split`` gives the smooth k-space remainder that kernels K3
and K4 hold frozen between chunks. A box above the TPU kernel's all-pairs
admission gate (or any with ``force_list_kernel``) runs K4's gather-list
pair loop over a neighbor list rebuilt every ``rebuild_every`` steps. SW
boxes off K5's gate run the unfused engine: on the brick kernels K6c/K6d
(``use_pallas_bricks``) or on autograd of ``SW.energy`` over a neighbor
list (the route that replaces the JAX package's one-hot structure).  The
single-type LJ fcc crystal runs K1 with no bonded terms.  With
``use_fused=False`` an OPLS or LJ box runs the unfused engine on autograd
of ``OPLS.energy`` (with the full Ewald/PME sum on a charged box) or
``LJ.energy``, and SHAKE/RATTLE on the host, as the JAX package's XLA
engine does.  Every system carries the neighbor spec ``derive_spec`` gives
its box (``MDSystem.nspec``: the dense build, or cells where 3 fit along
each axis).  ``equilibrate_staged`` is the reference's
heatup/cooldown prep (in.init.lammps): FIRE, NVT, then MTK NPT stages
(``engine.run_npt``), on every box: a fused box's NPT steps take its
kernel's force + virial entry (plus the k-space remainder), with SHAKE and
RATTLE on the host for the constrained all-atom boxes.
An OPLS system may also come from a LAMMPS data file (``data_file``); one
that no kernel runs (``md_fused.fused_refusal``) takes the unfused engine,
as the JAX package's takes its XLA engine.  ReaxFF boxes (``reax``: the
list or dense bond-order field with QEq, ``forcefields/reax.py``) run the
unfused engine.  ``spatial_shards`` x-slab shards one SW box's force calls
over ranks (``parallel.spatial_md``).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..ops import md_fused as MF
from ..ops import sw_bricks as SWB
from ..parallel import mesh_utils as MU
from ..parallel import spatial_md as SP
from ..utils.device import resolve
from . import box as B
from . import engine as E
from . import lattice
from . import neighbor as NB
from .forcefields import lj as LJmod
from .forcefields import sw as SWmod
from .homogenization import MDParams, stiffness_probe
from .units import ATM_TO_PA, REAL

# g/mol per A^3 -> kg/m^3
DENSITY_CONV = 1660.539


@dataclass(frozen=True)
class MaterialSpec:
    """One MD material box: the fields of the JAX MaterialSpec that the SW
    and OPLS paths read, with the same names and defaults."""

    name: str
    force_field: str = "sw"  # sw | lj | opls | reax
    n_cells: int = 3  # diamond lattice cells per dimension (sw)
    # non-cubic cell counts (overrides n_cells)
    n_cells_xyz: tuple | None = None
    a0: float = 5.431  # lattice parameter (A)
    mass: float = 28.0855  # g/mol
    sw: SWmod.SW = field(default_factory=lambda: SWmod.SI)
    # lj: single-type fcc crystal of n_cells^3 cells of edge a0
    lj_epsilon: float = 0.238
    lj_sigma: float = 3.405
    lj_cutoff: float = 8.0
    # neighbor-list width; None = per-force-field default (sw 20, opls
    # density-derived, at least MIN_LIST_WIDTH); an explicit value is
    # honoured as given
    neighbor_k: int | None = None
    # opls: a LAMMPS data file (read_data format), else the built-in melt
    data_file: str = ""
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
    # neighbor-list rebuild period for boxes on the list kernel K4 (the
    # list width comes from the box's density)
    rebuild_every: int = 10
    # run K4 even where the all-pairs gate would admit the box
    force_list_kernel: bool = False
    # sw: the brick kernels K6c/K6d on the unfused engine (p = 4, q = 0)
    use_pallas_bricks: bool = False
    # P4: shard ONE SW box's force work into x-slabs over this many ranks
    # (parallel.spatial_md); 0 = off
    spatial_shards: int = 0
    # None = the fused kernel (K1/K3/K4 wherever md_fused.fused_refusal
    # finds none refusing the system, or K5 for sw wherever its gate admits
    # the box: <= 640 atoms, p = 4, q = 0, no bricks), else the unfused
    # engine; False = the unfused engine (the JAX field, material.py:97,
    # whose None means fused on the TPU)
    use_fused: bool | None = None
    # setup-time checks (min image, list width, cell capacity); disable
    # only for test fixtures
    validate: bool = True
    # reax (force_field="reax"): the ffield.reax path, the pair_coeff
    # element order (in.set.lammps: `pair_coeff * * ${locf} H C N O`),
    # charge equilibration on/off, the bonded sub-list width, and the
    # field: "list" (the neighbor-list bond-order field) or "dense" (the
    # O(N^2) twin, the list field's parity anchor)
    reax_ffield: str = ""
    reax_elements: tuple = ("H", "C", "N", "O")
    qeq: bool = True
    reax_top_k: int = 8
    reax_impl: str = "list"


# The charged all-atom PE material (the JAX package's bench.py
# _allatom_spec): 56 C10H22 chains, 1792 atoms in a ~26.9 A box,
# lj/cut/coul/long 12 / 9 A with the PME k-space split refreshed every 10
# steps, SHAKE on the bonds to hydrogen
PEAA = MaterialSpec(name="peaa", force_field="opls", allatom=True, n_chains=56,
                    chain_length=10, pe_density=0.68, opls_lj_cutoff=12.0,
                    opls_coul_cutoff=9.0, use_ewald=True, kspace_every=10, kspace="pme")

# The same material in a box above the all-pairs gate (the JAX package's
# bench.py bench_md_charged_bigbox): 70 C10H22 chains, 2240 atoms in a
# ~29.0 A box, on the gather-list kernel K4 with the list rebuilt every 10
# steps; the all-pairs gate alone sends it there
PEAA2240 = MaterialSpec(name="peaa2240", force_field="opls", allatom=True, n_chains=70,
                        chain_length=10, pe_density=0.68, opls_lj_cutoff=12.0,
                        opls_coul_cutoff=9.0, use_ewald=True, kspace_every=10, kspace="pme")

# The same material in a box above K4's shared-memory cap (2509 atoms):
# 128 C10H22 chains, 4096 atoms in a ~35.4 A box, on K4's global form
# (csrc/md_k4_big.cu).  128 chains, not 125: data_io.build_pe_melt_allatom
# lays chains on an nx x ny x nz grid with nx dividing the chain count, and
# 125 chains give one chain per x row and a 1.4 A z pitch (overlapping
# chains, ~1356 neighbors per atom within 13 A against ~850 uniformly); 128
# give 2 x 8 x 8, as uniform as the 2240-atom box
PEAA4096 = MaterialSpec(name="peaa4096", force_field="opls", allatom=True, n_chains=128,
                        chain_length=10, pe_density=0.68, opls_lj_cutoff=12.0,
                        opls_coul_cutoff=9.0, use_ewald=True, kspace_every=10, kspace="pme")

# The ReaxFF box of the JAX package's bench.py bench_hmm_reax / bench_md_reax:
# 16 C3H8 chains of all-atom PE at 0.30 g/cm^3, 176 atoms in a 15.75 A box
# (the 10 A taper radius exceeds half the box, so unvalidated, as there);
# the caller adds reax_ffield
REAXPE = MaterialSpec(name="reaxpe", force_field="reax", n_chains=16, chain_length=3,
                      pe_density=0.30, validate=False)
# the dense bond-order field's box cap (material.py:730-734)
REAX_DENSE_MAX_ATOMS = 2048

# The TPU kernel's all-pairs admission budget (material.py:391-393): the
# dense parameter and image planes must fit 81 MiB
ALLPAIRS_PLANE_BYTES = 81 * 1024 * 1024
# the narrowest neighbor list (slots per atom) a box gets
MIN_LIST_WIDTH = 32
# the largest SW box on the fused all-pairs kernel K5 (material.py:645-648)
SW_ALLPAIRS_MAX_ATOMS = 640


@dataclass(frozen=True)
class InitData:
    """The reference's per-replica equilibration outputs
    (init.<mat>_<n>.{length,stress,stiff} + density)."""

    length: np.ndarray  # (3,)
    stress: np.ndarray  # (6,) Pa
    stiff: np.ndarray  # (6, 6) Pa
    density: float  # kg/m^3


def _validate_setup(spec: MaterialSpec, pos, h, nspec: NB.NeighborSpec) -> None:
    """material._validate_setup's setup-time checks:

    1. minimum image: the list range cutoff + skin must not exceed half the
       smallest box height — beyond it a pair could interact through more
       than one periodic image, which neither the all-pairs kernels'
       per-pair minimum image nor the list sees;
    2. list width: k_max must hold every neighbor within cutoff + skin/2;
    3. cell capacity: the fullest cell must fit a cell-binned list."""
    hmin = float(np.min(np.abs(np.diag(np.asarray(h, dtype=float)))))
    if nspec.r_list > 0.5 * hmin:
        raise ValueError(
            f"material {spec.name!r}: neighbor range {nspec.r_list:.2f} A violates the "
            f"minimum-image bound (box min height {hmin:.2f} A); enlarge the box "
            "or reduce the cutoff/skin")
    k_need = NB.max_in_range(pos, h, nspec.cutoff + 0.5 * nspec.skin)
    if nspec.k_max < k_need:
        raise ValueError(
            f"material {spec.name!r}: neighbor list width k_max={nspec.k_max} "
            f"< {k_need} neighbors within cutoff+skin/2 — in-cutoff pairs "
            f"would be silently dropped; reduce the list range r_list={nspec.r_list:.2f} A "
            "(cutoff + skin)")
    occ = NB.max_cell_occupancy(nspec, pos, h)
    if occ > nspec.cell_capacity:
        raise ValueError(
            f"material {spec.name!r}: fullest cell holds {occ} atoms "
            f"> cell_capacity={nspec.cell_capacity}")


def allpairs_admitted(n_atoms: int, charged: bool, force_list_kernel: bool = False) -> bool:
    """The TPU kernel's all-pairs admission rule, verbatim (material.py:
    379-393): the dense f32 planes (lj1, lj2, qq when charged, and three
    image planes) of the 128-padded box must fit 81 MiB, and the list
    kernel is not forced.  g0 (512 sites) and PEAA (1792 atoms) pass;
    PEAA2240 does not.  The port keeps it so that every box takes the
    reference's path; re-deriving it from the H100's K3/K4 crossover is
    ROADMAP item 2."""
    npad = -(-n_atoms // 128) * 128
    plane_bytes = (2 + int(charged) + 3) * npad * npad * 4
    return plane_bytes <= ALLPAIRS_PLANE_BYTES and not force_list_kernel


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
    """The SW, LJ and OPLS branches of material._build_system: the
    diamond-Si Stillinger-Weber box on K5, or above its gate on the unfused
    engine with the brick kernels K6c/K6d or a neighbor list
    (:func:`_build_sw`); the single-type LJ fcc crystal on K1
    (:func:`_build_lj`); the built-in united-atom alkane melt (K1's chain
    path) or, with ``allatom``, the charged all-atom PE melt with SHAKE on
    the bonds to hydrogen and, with ``use_ewald``, the Ewald/PME k-space
    split (K3); an OPLS box the all-pairs gate refuses, or
    ``force_list_kernel``, runs K4 (material.py:650-713).  ``data_file``
    reads the OPLS system from a LAMMPS data file instead (material.py:
    661-662).  An LJ or OPLS system that no kernel runs
    (``md_fused.fused_refusal``: impropers, irregular topologies, wide
    constraint offsets, where the JAX package's ``_build_fused_runner``
    returns None, and what the Hopper redesigns' tables and windows
    cannot hold), or any with ``use_fused=False``, runs the unfused
    engine; ``MDSystem.route`` says which route the system took.
    ``device`` None means the current CUDA device (an error without one);
    ``device="cpu"`` runs the kernels' plain versions."""
    from . import constraints as CN
    from . import data_io

    device = resolve(device)
    if spec.spatial_shards > 0 and spec.force_field != "sw":
        raise ValueError("spatial_shards: only SW boxes have a sharded force path (P4)")
    if spec.force_field == "sw":
        return _build_sw(spec, dtype, device)
    if spec.force_field == "lj":
        return _build_lj(spec, dtype, device)
    if spec.force_field == "reax":
        return _build_reax(spec, dtype, device)
    if spec.force_field != "opls":
        raise NotImplementedError(f"material {spec.name!r}: force field {spec.force_field!r} "
                                  "is not implemented")
    if spec.data_file:
        data = data_io.read_data(spec.data_file)
    elif spec.allatom:
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
    # the list width from the density, not a constant (material.py:690-696)
    k_max = max(spec.neighbor_k or MIN_LIST_WIDTH, NB.required_k(n, data.box, ff.cutoff + 1.0))
    k_max = ((k_max + 7) // 8) * 8
    nspec = NB.derive_spec(n, data.box, cutoff=ff.cutoff, skin=1.0, k_max=k_max)
    if spec.validate:
        _validate_setup(spec, data.pos, data.box, nspec)
    use_list = not allpairs_admitted(n, bool(np.any(data.charges != 0.0)),
                                     spec.force_list_kernel)
    masses = torch.as_tensor(data.masses[data.types], dtype=dtype, device=device)
    st = E.init_state(torch.as_tensor(data.pos, dtype=dtype, device=device),
                      torch.as_tensor(data.box, dtype=dtype, device=device))
    fused, route = None, _refusal(spec) or MF.fused_refusal(ff, masses, cons, use_list)
    if route is None:
        kspace = build_kspace_split(ff, n) if ff.ewald is not None else None
        fused = MF.make_runner(ff, masses, REAL, dtype=dtype, device=device, constraints=cons,
                               kspace=kspace, kspace_every=spec.kspace_every,
                               nspec=nspec if use_list else None,
                               rebuild_every=spec.rebuild_every)
    return E.MDSystem(ff=ff, masses=masses, fused=fused, units=REAL, constraints=cons,
                      nspec=nspec, rebuild_every=spec.rebuild_every,
                      route=_route(fused, route)), st


def _refusal(spec: MaterialSpec) -> str | None:
    """The reason the spec itself gives for the unfused engine."""
    return "use_fused=False" if spec.use_fused is False else None


def _route(fused, refusal: str | None) -> str:
    """``MDSystem.route``: the kernel of the runner, or the unfused engine
    and why."""
    return fused.spec.kernel if fused is not None else f"unfused: {refusal}"


def _build_lj(spec: MaterialSpec, dtype, device) -> tuple[E.MDSystem, E.MDState]:
    """The LJ branch of material._build_system (material.py:650-657,
    :805-806): a single-type fcc crystal of ``n_cells``^3 cells of edge
    ``a0`` with uniform masses, a density-derived list width, on K1 with
    the bonded terms empty (its runner, :305-307), or on the unfused engine
    with ``use_fused=False``."""
    pos, h = lattice.fcc(spec.a0, spec.n_cells, spec.n_cells, spec.n_cells)
    n = len(pos)
    ff = LJmod.single_type(spec.lj_epsilon, spec.lj_sigma, spec.lj_cutoff, n, dtype, device)
    k_max = max(spec.neighbor_k or MIN_LIST_WIDTH, NB.required_k(n, h, spec.lj_cutoff + 1.0))
    k_max = ((k_max + 7) // 8) * 8
    nspec = NB.derive_spec(n, h, cutoff=spec.lj_cutoff, skin=1.0, k_max=k_max)
    if spec.validate:
        _validate_setup(spec, pos, h, nspec)
    masses = torch.full((n,), spec.mass, dtype=dtype, device=device)
    fused, route = None, _refusal(spec) or MF.fused_refusal(ff, masses)
    if route is None:
        fused = MF.make_runner(ff, masses, REAL, dtype=dtype, device=device)
    st = E.init_state(torch.as_tensor(pos, dtype=dtype, device=device),
                      torch.as_tensor(h, dtype=dtype, device=device))
    return E.MDSystem(ff=ff, masses=masses, fused=fused, units=REAL, nspec=nspec,
                      rebuild_every=spec.rebuild_every, route=_route(fused, route)), st


def _build_reax(spec: MaterialSpec, dtype, device) -> tuple[E.MDSystem, E.MDState]:
    """The reax branch of material._build_system (material.py:714-770):
    ``pair_style reax/c`` + ``fix qeq/reax`` (lammps_scripts_reax/
    in.set.lammps:13-15) on the unfused engine, route "unfused: reax".
    The structure comes from a LAMMPS data file or the all-atom PE melt,
    element identity from the masses; the list field reads the engine's
    neighbor list, whose width covers every pair within the taper radius
    plus a 1 A skin (at most N - 1); ``validate`` checks the taper radius
    against half the smallest box height (the dense field needs no list,
    so no other check applies).  The dense field holds at most 2048
    atoms; a missing ffield path is an error."""
    from . import data_io
    from .forcefields.reax import build_reax

    if spec.data_file:
        data = data_io.read_data(spec.data_file)
    else:
        data = data_io.build_pe_melt_allatom(spec.n_chains, spec.chain_length,
                                             density=spec.pe_density)
    n = len(data.pos)
    if spec.reax_impl == "dense" and n > REAX_DENSE_MAX_ATOMS:
        raise ValueError(
            f"reax box has {n} atoms; the dense bond-order field is sized for the HMM "
            f"per-qp regime (<= {REAX_DENSE_MAX_ATOMS}) — use the default reax_impl='list'")
    if not spec.reax_ffield:
        raise ValueError("force_field='reax' needs reax_ffield (path to a ffield.reax "
                         "parameter file)")
    masses_np = data.masses[data.types]
    ff = build_reax(spec.reax_ffield, list(spec.reax_elements), masses_np, dtype=dtype,
                    device=device, top_k=spec.reax_top_k, qeq=spec.qeq, impl=spec.reax_impl)
    box = np.asarray(data.box, dtype=float)
    k_need = NB.required_k(n, box, ff.cutoff + 1.0)
    nspec = NB.derive_spec(n, box, cutoff=ff.cutoff, skin=1.0, k_max=min(k_need, max(n - 1, 1)))
    if spec.validate:
        hmin = float(np.min(np.abs(np.diag(box))))
        if ff.cutoff > 0.5 * hmin:
            raise ValueError(
                f"material {spec.name!r}: reax taper cutoff {ff.cutoff:.1f} A violates the "
                f"minimum-image bound (box min height {hmin:.2f} A)")
    st = E.init_state(torch.as_tensor(data.pos, dtype=dtype, device=device),
                      torch.as_tensor(data.box, dtype=dtype, device=device))
    return E.MDSystem(ff=ff, masses=torch.as_tensor(masses_np, dtype=dtype, device=device),
                      units=REAL, nspec=nspec, rebuild_every=spec.rebuild_every,
                      route="unfused: reax"), st


def _build_sw(spec: MaterialSpec, dtype, device) -> tuple[E.MDSystem, E.MDState]:
    """The SW branch of material._build_system (material.py:626-649,
    :776-808): a diamond lattice of ``n_cells`` (or ``n_cells_xyz``) cells
    of edge ``a0`` with uniform masses, checked by ``_validate_setup`` with
    a 20-slot list (cutoff + 1 A skin), routed as the JAX package routes it:

    * kernel K5 (the fused engine) where its gate admits the box: at most
      640 atoms, p = 4, q = 0, no brick kernels, ``use_fused`` not False;
    * with ``use_pallas_bricks``, the unfused engine on the brick kernels
      K6c/K6d (``ops.sw_bricks.SWBricksFF``), p = 4 and q = 0 only;
    * any other box, the unfused engine on autograd of ``SW.energy`` over
      a 20-slot list rebuilt every ``rebuild_every`` steps — the route that
      replaces the JAX package's one-hot structure (boxes of 512 atoms and
      more) and its XLA engine; the list comes from the cell build where
      the box holds 3 cells along each axis and more than 1024 atoms (from
      1728 atoms), else from the dense build.

    With ``spatial_shards`` = k the box runs the unfused engine on the list
    route with its force calls x-slab sharded over the first k ranks of
    the default group (``parallel.spatial_md.SpatialRunner``, material.py:
    809-826; autograd of ``SW.energy`` whatever the brick flag, as JAX's
    runner reads ``sw``); ValueError where k exceeds the group's ranks (1
    without a group) or the box has too few x-cells for k slabs."""
    cxyz = spec.n_cells_xyz or (spec.n_cells,) * 3
    pos, h = lattice.diamond(spec.a0, *cxyz)
    n = len(pos)
    ff = spec.sw
    # the SW cutoff spans the first two diamond shells; 20 slots cover
    # moderate compression (material.py:632-634)
    k_max = spec.neighbor_k if spec.neighbor_k is not None else 20
    nspec = NB.derive_spec(n, h, cutoff=ff.cutoff, skin=1.0, k_max=k_max)
    if spec.validate:
        _validate_setup(spec, pos, h, nspec)
    masses = torch.full((n,), spec.mass, dtype=dtype, device=device)
    st = E.init_state(torch.as_tensor(pos, dtype=dtype, device=device),
                      torch.as_tensor(h, dtype=dtype, device=device))
    if spec.spatial_shards > 0:
        return E.MDSystem(ff=ff, masses=masses, units=REAL, nspec=nspec,
                          rebuild_every=spec.rebuild_every,
                          route=f"unfused: spatial_shards={spec.spatial_shards}",
                          spatial=_spatial_runner(spec.spatial_shards, n, h, ff.cutoff)), st
    family = abs(float(ff.p) - 4.0) < 1e-12 and abs(float(ff.q)) < 1e-12
    if spec.use_pallas_bricks and not family:
        raise NotImplementedError(
            f"material {spec.name!r}: the SW brick kernels compute the p = 4, q = 0 family "
            f"only (got p = {ff.p}, q = {ff.q}); the TPU kernels would compute p = 4 "
            "silently — run this force field without use_pallas_bricks")
    fused = (spec.use_fused is not False and n <= SW_ALLPAIRS_MAX_ATOMS
             and not spec.use_pallas_bricks and family)
    why = (_refusal(spec) or ("brick kernels K6c/K6d" if spec.use_pallas_bricks else
                              f"{n} atoms above K5's {SW_ALLPAIRS_MAX_ATOMS}"
                              if n > SW_ALLPAIRS_MAX_ATOMS else
                              f"p = {ff.p}, q = {ff.q} outside K5's family"))
    runner = None
    if fused:
        runner = MF.make_runner_sw(ff, masses, REAL, dtype=dtype, device=device)
    elif spec.use_pallas_bricks:
        ff = SWB.SWBricksFF(ff, pos, h, device=device)
    return E.MDSystem(ff=ff, masses=masses, fused=runner, units=REAL, nspec=nspec,
                      rebuild_every=spec.rebuild_every, route=_route(runner, why)), st


def _spatial_runner(k: int, n: int, h, cutoff: float):
    """The x-slab runner of ``spatial_shards`` = k over the first k ranks of
    the default group (none without a group; material.py:809-826)."""
    w = MU.world_size()
    if w < k:
        raise ValueError(f"spatial_shards={k} but only {w} ranks")
    sg = SP.derive_sharded_grid(n, np.asarray(h), cutoff=cutoff, skin=0.5, n_shards=k)
    return SP.SpatialRunner(sg=sg, mesh=MU.make_mesh(k) if MU.is_initialized() else None)


def equilibrate(sys: E.MDSystem, state: E.MDState, params: MDParams,
                generator: torch.Generator | None = None, minimize_steps: int = 100,
                equil_steps: int = 200, velocities: torch.Tensor | None = None) -> E.MDState:
    """Minimize then thermalize (the quick in.init.lammps prep): FIRE, then
    Maxwell-Boltzmann velocities at T and NVT at T; the box stays at the
    build volume.  FIRE starts from the force field's ``fire_dt0`` (ReaxFF's
    0.05 fs), else 0.5 fs (material.py:853-856).  ``velocities`` replaces
    the Maxwell draw."""
    state = E.minimize_fire(sys, state, n_steps=minimize_steps,
                            dt0=getattr(sys.ff, "fire_dt0", 0.5))
    if velocities is None:
        velocities = E.maxwell_velocities(sys, max(params.temperature, 1e-6), generator,
                                          dtype=state.pos.dtype, device=state.pos.device)
    state = state.replace(vel=velocities.to(state.pos))
    if equil_steps > 0:
        state = E.run_nvt(sys, state, equil_steps, params.temperature, params.dt)
    return state


def equilibrate_staged(sys: E.MDSystem, state: E.MDState, params: MDParams,
                       generator: torch.Generator | None = None, ns_init: int = 100,
                       minimize_steps: int = 100,
                       velocities: torch.Tensor | None = None) -> E.MDState:
    """The reference's full heatup/cooldown prep (in.init.lammps;
    material.py:867-891): FIRE, Maxwell-Boltzmann velocities at 200 K, NVT
    at 300 K, then isotropic 1 atm MTK NPT 300 -> 500 K, at 500 K (5x),
    500 K -> T and at T (2x), each stage ``ns_init`` steps times its
    factor.  ``velocities`` replaces the Maxwell draw.  On a fused box
    FIRE and the NPT steps take the kernel's force + virial entry and the
    NVT stage its run; a constrained box (the charged all-atom PE) gets
    SHAKE/RATTLE inside K3's run and on the host in the NPT loop.  FIRE
    starts from the force field's ``fire_dt0``, as in :func:`equilibrate`."""
    T, dt = params.temperature, params.dt
    state = E.minimize_fire(sys, state, n_steps=minimize_steps,
                            dt0=getattr(sys.ff, "fire_dt0", 0.5))
    if velocities is None:
        velocities = E.maxwell_velocities(sys, 200.0, generator, dtype=state.pos.dtype,
                                          device=state.pos.device)
    state = state.replace(vel=velocities.to(state.pos))
    state = E.run_nvt(sys, state, ns_init, 300.0, dt)
    for n, t0, t1 in ((ns_init, 300.0, 500.0), (5 * ns_init, 500.0, 500.0),
                      (ns_init, 500.0, T), (2 * ns_init, T, T)):
        state = E.run_npt(sys, state, n, t0, t1, dt)
    return state


def measure(sys: E.MDSystem, state: E.MDState, params: MDParams,
            thermal_stiffness: bool = False) -> InitData:
    """Equilibrium box lengths, residual stress, stiffness, density
    (init_material_problem.h:192-295; material.py:894-933).  With
    ``thermal_stiffness`` the probe's twelve boxes are sampled by NVT as
    the reference does, else relaxed cold (:func:`stiffness_probe`)."""
    L, _ = B.lengths_tilts(state.h)
    st2, press = E.sample_stress(sys, state, params.nsteps_sample,
                                 params.temperature, params.dt)
    C = stiffness_probe(sys, st2, params, thermal=thermal_stiffness)
    vol = float(B.volume(state.h))
    density = float(torch.sum(sys.masses)) * DENSITY_CONV / vol
    return InitData(length=L.double().cpu().numpy(),
                    stress=(-press * ATM_TO_PA).double().cpu().numpy(),
                    stiff=C.double().cpu().numpy(), density=density)


def write_init_files(outdir: str, name: str, replica: int, data: InitData) -> None:
    """Reference-format init.<mat>_<n>.{length,stress,stiff} text files
    (read_write.h formats; material.py:935-947).  The density file is
    written per material by the caller (stmd_sync.h:477-487)."""
    import os

    from ..utils import io_tensors as io
    from ..utils import tensors as T

    os.makedirs(outdir, exist_ok=True)
    base = f"{outdir}/init.{name}_{replica}"
    io.write_vector(base + ".length", data.length)
    io.write_sym2(base + ".stress", T.voigt_to_sym(
        torch.as_tensor(np.asarray(data.stress, dtype=np.float64))).numpy())
    io.write_sym4(base + ".stiff", T.c66_to_rank4(
        torch.as_tensor(np.asarray(data.stiff, dtype=np.float64))).numpy())
