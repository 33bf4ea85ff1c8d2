"""Full HMM with the MD backend at the quadrature points.

Torch twin of ``scema_tpu/hmm/md_coupling.py`` — the reference's
STMDSync::update fleet step (stmd_sync.h:1070-1132) as one batched device
computation: job packing, per-(qp x replica) strain-driven MD with
persistent microstates, virial-stress homogenization, init-stress
subtraction, replica averaging, and scatter-back into the FE stress field.

Differences from the JAX version, all of form rather than result:

* All active (job, replica) pairs of a step go to ONE kernel launch per
  phase (K1 or K5, or K3/K4 per k-space or list-rebuild chunk; one thread
  block per job, or J per block of K1m with ``pack_jobs`` = J) — or, on
  the unfused engine (SW boxes above K5's gate), to one force evaluation
  per step over all running jobs (the brick kernels K6d + K6c, or autograd
  of ``SW.energy``; at 128 jobs of 4096 atoms the list route's autograd
  peaks at ~4.5 GB, so its jobs are not sliced); there is no job-chunk
  scan and its divisor rule (md_coupling.py:217-221) — the last J-tuple
  is padded with a zero-step job instead — no ``shard_map``, and no clamp
  of the job chunk for streamed list kernels (md_coupling.py:582-588, a
  TPU workaround).
* The fixed-capacity job list (``jnp.nonzero(size=K, fill_value=0)``) is
  built with explicit padding, and rows past the valid slots are masked
  out before any gather or scatter — torch's ``index_put_`` has no
  ``mode="drop"`` for the JAX version's out-of-range sentinel.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..bridging import bridge
from ..config import HMMConfig, md_spec_kwargs
from ..fem import assembly
from ..fem import fe_problem as FE
from ..fem import shapes
from ..fem.problem_types import make_problem
from ..fem.state import init_qp_state
from ..md import engine as E
from ..md import material as M
from ..md.homogenization import MDParams, strain_and_homogenize, strain_and_homogenize_multi
from ..ops import md_fused as MF
from ..utils.device import resolve
from .problem import HMMProblem, StepOutputs, assign_materials, clustering_mapping


class MicroStates(NamedTuple):
    """Persistent per-(qp, replica) MD microstates."""

    pos: torch.Tensor  # (n_qp, n_repl, N, 3)
    vel: torch.Tensor
    h: torch.Tensor  # (n_qp, n_repl, 3, 3)
    vxi: torch.Tensor  # (n_qp, n_repl, NHC_LEN)
    has_run: torch.Tensor  # (n_qp,) bool — last.<qpid>.dump exists


def broadcast_micro(state: E.MDState, n_qp: int, n_repl: int) -> MicroStates:
    """Tile one state, or a per-replica stack of states, over qps (a copy,
    so later scatters never write through a broadcast view)."""
    def bc(x, nd):
        if x.dim() == nd + 1:  # already per-replica
            return x.expand((n_qp,) + tuple(x.shape)).clone()
        return x.expand((n_qp, n_repl) + tuple(x.shape)).clone()

    return MicroStates(pos=bc(state.pos, 2), vel=bc(state.vel, 2), h=bc(state.h, 2),
                       vxi=bc(state.vxi, 1),
                       has_run=torch.zeros((n_qp,), dtype=torch.bool,
                                           device=state.pos.device))


def nonzero_padded(mask: torch.Tensor, size: int, fill_value: int = 0) -> torch.Tensor:
    """``jnp.nonzero(mask, size=size, fill_value=fill_value)[0]``: the
    first ``size`` nonzero indices, padded with ``fill_value``."""
    idx = torch.nonzero(mask).flatten()[:size]
    out = torch.full((size,), fill_value, dtype=torch.int64, device=mask.device)
    out[:idx.shape[0]] = idx
    return out


@dataclass(frozen=True)
class MDBackend:
    """Static MD-side configuration for the coupling."""

    sys: E.MDSystem
    params: MDParams
    ensemble: bridge.ReplicaEnsemble
    n_repl: int
    max_jobs: int  # job-list capacity
    initial_md_state: E.MDState  # (n_repl, ...) equilibrated replicas
    # jobs per kernel block (K1m, md_coupling.py:90): J > 1 groups the
    # step's (job, replica) pairs into J-tuples; K1 runners only
    pack_jobs: int = 1

    def __post_init__(self):
        if self.pack_jobs != 1:
            if self.sys.fused is None:
                raise ValueError(f"pack_jobs={self.pack_jobs}: the unfused engine has no "
                                 "multi-job kernel")
            MF.check_multi(self.sys.fused, self.pack_jobs)

    def _run_jobs(self, st: E.MDState, dlength: torch.Tensor):
        """Every (job, replica) MD run of the step: one batch, or with
        ``pack_jobs`` = J the flattened batch grouped into J-tuples, the
        last padded with zero-step copies of the first job whose outputs
        are dropped (md_coupling.py:158-183)."""
        J = self.pack_jobs
        n = st.pos.shape[0] * st.pos.shape[1]
        if J == 1 or n == 0:
            return strain_and_homogenize(self.sys, st, dlength, self.params)
        pad = -n % J

        def grouped(x):
            x = x.reshape((n,) + x.shape[2:])
            x = torch.cat([x, x[:1].expand((pad,) + x.shape[1:])]) if pad else x
            return x.reshape((-1, J) + x.shape[1:])

        active = grouped(torch.ones(st.pos.shape[:2], dtype=torch.bool, device=st.pos.device))
        if pad:
            active.view(-1)[n:] = False
        out, sig = strain_and_homogenize_multi(
            self.sys, E.MDState(*(grouped(getattr(st, f)) for f in ("pos", "vel", "h", "vxi"))),
            grouped(dlength), self.params, active=active)

        def back(x):
            return x.reshape((-1,) + x.shape[2:])[:n].reshape(st.pos.shape[:2] + x.shape[2:])

        return E.MDState(*(back(getattr(out, f)) for f in ("pos", "vel", "h", "vxi"))), back(sig)

    def update(self, micro: MicroStates, eps_cg, material, jobs, most_recent_id,
               timestep: int = 0):
        """-> (micro', update_stress_cg (n_qp, 6), has_result (n_qp,),
        stress_repl_cg (n_qp, n_repl, 6))."""
        n_qp = eps_cg.shape[0]
        K = self.max_jobs
        dev = eps_cg.device
        # -- job packing (write_md_updates_list + prepare_md_simulations):
        # the selection window rotates by timestep so a capacity below the
        # flagged count round-robins over qps
        offset = (int(timestep) * K) % n_qp
        rolled = torch.roll(jobs, -offset)
        idx_r = nonzero_padded(rolled, K)
        n_valid = min(int(jobs.sum()), K)
        job_idx = (idx_r[:n_valid] + offset) % n_qp  # valid slots only
        if n_valid == 0:  # no qp of this backend's material runs MD this step
            return (micro, torch.zeros((n_qp, 6), dtype=eps_cg.dtype, device=dev),
                    torch.zeros((n_qp,), dtype=torch.bool, device=dev),
                    torch.zeros((n_qp, self.n_repl, 6), dtype=eps_cg.dtype, device=dev))

        # microstate source: own if it has run, else borrowed from the
        # most-recent provider if that ran, else the fresh initial state
        mri = most_recent_id[job_idx]
        mri_c = torch.clamp(mri, 0, n_qp - 1)
        mri_ok = (mri < n_qp) & micro.has_run[mri_c]
        src = torch.where(micro.has_run[job_idx], job_idx,
                          torch.where(mri_ok, mri_c, job_idx))
        st = E.MDState(pos=micro.pos[src], vel=micro.vel[src], h=micro.h[src],
                       vxi=micro.vxi[src])  # (n_valid, n_repl, ...)

        # -- strain to replica frames and length variation
        eps_job = eps_cg[job_idx]
        mat_job = material[job_idx]
        eps_rep = bridge.replica_strains(self.ensemble, eps_job, mat_job)
        dlength = bridge.strain_to_length_variation(self.ensemble, eps_rep, mat_job)

        # -- batched MD (execute_inside_md_simulations): one kernel launch
        # per phase (per chunk with k-space or a list) for every (job,
        # replica)
        st, sigma_rep = self._run_jobs(st, dlength.to(micro.pos.dtype))
        sigma_rep = sigma_rep.to(eps_cg.dtype)

        # -- replica averaging with init-stress subtraction
        upd = bridge.average_replica_stresses(self.ensemble, sigma_rep, mat_job,
                                              subtract_init_stress=True)
        # -- scatter back over the valid slots only
        update_stress_cg = torch.zeros((n_qp, 6), dtype=eps_cg.dtype, device=dev)
        update_stress_cg[job_idx] = upd
        has_result = torch.zeros((n_qp,), dtype=torch.bool, device=dev)
        has_result[job_idx] = True
        stress_repl_cg = torch.zeros((n_qp, self.n_repl, 6), dtype=eps_cg.dtype, device=dev)
        stress_repl_cg[job_idx] = sigma_rep

        def scat(old, new):
            out = old.clone()
            out[job_idx] = new
            return out

        micro = MicroStates(pos=scat(micro.pos, st.pos), vel=scat(micro.vel, st.vel),
                            h=scat(micro.h, st.h), vxi=scat(micro.vxi, st.vxi),
                            has_run=micro.has_run | (jobs & has_result))
        return micro, update_stress_cg, has_result, stress_repl_cg


@dataclass(frozen=True)
class MDHMMProblem:
    """HMM coupled to the MD backends (one per material);
    state = (FEState, tuple[MicroStates, ...])."""

    base: HMMProblem
    backends: tuple

    @property
    def backend(self) -> MDBackend:
        return self.backends[0]

    @property
    def geom(self):
        return self.base.geom

    @property
    def cfg(self):
        return self.base.cfg

    def init_state(self):
        return self.base.init_state(), tuple(
            broadcast_micro(be.initial_md_state, self.geom.n_qp_total, be.n_repl)
            for be in self.backends)

    def step(self, carry):
        fe_state, micros = carry
        ops = self.base.ops
        fe_state = FE.begin_step(ops, fe_state)
        fe_state, out = FE.solve(ops, fe_state)
        p = self.cfg.precision
        id_to_get, saturated = clustering_mapping(
            fe_state, out.flags, p.clustering_min_steps, p.spline_points,
            p.clustering_diff_threshold)
        fe_state = fe_state.replace(
            hist=fe_state.hist.replace(id_to_get_results_from=id_to_get))
        jobs = bridge.job_mask(out.flags, id_to_get)

        n_qp = out.flags.shape[0]
        dt, dev = out.update_strain_cg.dtype, out.flags.device
        update_stress_cg = torch.zeros((n_qp, 6), dtype=dt, device=dev)
        has_result = torch.zeros((n_qp,), dtype=torch.bool, device=dev)
        n_repl = max(be.n_repl for be in self.backends)
        stress_repl = torch.zeros((n_qp, n_repl, 6), dtype=dt, device=dev)
        new_micros = []
        for m, be in enumerate(self.backends):
            micro_m, upd_m, hr_m, srepl_m = be.update(
                micros[m], out.update_strain_cg, torch.zeros_like(out.material),
                jobs & (out.material == m), out.most_recent_id,
                timestep=fe_state.timestep)
            new_micros.append(micro_m)
            update_stress_cg = update_stress_cg + upd_m
            has_result = has_result | hr_m
            stress_repl[:, :be.n_repl] += srepl_m

        # a flagged qp whose source got no MD result this step keeps the
        # tangent update
        updated = out.flags & has_result[id_to_get]
        fe_state, res1 = FE.apply_stress_update(ops, fe_state, updated,
                                                update_stress_cg, id_to_get)
        rf = assembly.reaction_force(self.geom, fe_state.qp.new_stress,
                                     fe_state.qp.rho, self.base.problem.loaded_mask)
        fe_state = FE.end_step(ops, fe_state)
        return (fe_state, tuple(new_micros)), StepOutputs(
            residual0=out.residual, residual1=res1, n_flagged=out.flags.sum(),
            n_jobs=has_result.sum(), reaction_force=rf, md_ran=has_result,
            md_strain_cg=out.update_strain_cg, md_stress_repl=stress_repl,
            cluster_saturated=saturated)


def build_md_hmm(cfg: HMMConfig, spec: M.MaterialSpec | None = None,
                 specs: list | None = None, equil_steps: int = 100, minimize_steps: int = 100,
                 staged: bool = False, ns_init: int = 100, device=None, prepared=None,
                 material: torch.Tensor | None = None, pack_jobs: int = 1) -> MDHMMProblem:
    """Assemble the MD-coupled HMM, preparing every material x replica on
    the device first — with ``staged`` the reference's heatup/cooldown NPT
    cycle (``material.equilibrate_staged``, stage lengths scaled by
    ``ns_init``), else the quick FIRE + NVT — then stress sampling and the
    stiffness probe.  ``pack_jobs`` sets :attr:`MDBackend.pack_jobs` (K1
    runners only).  Without ``spec`` each material takes the config's effective
    force field (``"force field": "sw"``, or a ``sisw`` scripts directory,
    gives the 216-atom diamond-Si SW box on K5); ``spec`` replaces the
    config's material (the charged all-atom PE melt is selected this way,
    as the JAX package does; with ``staged`` its FIRE and NPT steps take
    K3's force + virial entry with SHAKE/RATTLE on the host, its NVT stage
    K3's run); ``specs``, one per material in the config's order, gives
    each material its own (md_coupling.py:407-423).  ``device``
    None means the current CUDA device (an error without one);
    ``device="cpu"`` runs the kernels' plain versions.

    ``prepared`` skips that prep: one ``(states, init_data)`` pair per
    material, ``states`` an MDState stacked over replicas and
    ``init_data`` a list of InitData per replica.  ``material`` overrides
    the per-qp material draw.

    A replica with a LAMMPS binary restart ``init.<mat>_<n>.bin`` in the
    nanoscale input directory whose atom count is the system's starts
    from the restart's microstate (positions relative to its box origin,
    its cell and velocities; md_coupling.py:518-526), neither prepared nor
    taken from ``prepared``; without ``spec`` or ``specs``, an SW material
    first takes its lattice cell counts and constant from replica 1's
    restart box (:476-491).  The route each material's system takes
    (``MDSystem.route``: its kernel, or the unfused engine and why) is
    printed once per material."""
    device = resolve(device)
    dtype = getattr(torch, cfg.dtype)
    md_dtype = getattr(torch, cfg.md_dtype)
    n_repl = cfg.material.number_of_replicas
    materials = list(cfg.material.materials)
    specs_auto = specs is None and spec is None
    if specs is not None:
        specs = list(specs)
        if len(specs) != len(materials):
            raise ValueError(f"build_md_hmm: {len(specs)} specs for the config's "
                             f"{len(materials)} materials {materials}")
    elif spec is not None:
        specs = [M.MaterialSpec(**{**spec.__dict__, "name": name}) for name in materials] \
            if len(materials) > 1 else [spec]
    else:
        # the config's effective force field ("sw" for a sisw scripts
        # directory), as the JAX package's md_spec_kwargs gives it
        if cfg.md.force_field == "reax":
            raise NotImplementedError("the ReaxFF force field is not ported (ROADMAP item 9)")
        specs = [M.MaterialSpec(name=name, **md_spec_kwargs(cfg)) for name in materials]
    params = MDParams(temperature=cfg.md.temperature, dt=cfg.md.timestep_length,
                      strain_rate=cfg.md.strain_rate, nsteps_sample=cfg.md.nsteps_sample)
    problem = make_problem(cfg, dtype, device)
    geom = shapes.precompute_geometry(problem.mesh.nodes, problem.mesh.cells,
                                      cfg.mesh.quadrature_formula, dtype=dtype,
                                      device=device)
    max_jobs = min(cfg.resources.max_md_jobs or geom.n_qp_total, geom.n_qp_total)

    from ..bridging.replica_data import load_replica_metadata

    meta = load_replica_metadata(cfg.dirs.nanoscale_input, materials, n_repl,
                                 cg_vector=cfg.material.common_ground_vector)
    if specs_auto:
        specs = [_cells_from_restart(ms, meta[mi][0].micro) for mi, ms in enumerate(specs)]
    backends, stiff_rows, rho_rows = [], [], []
    fields = ("pos", "vel", "h", "vxi")
    for mi, mspec in enumerate(specs):
        sys, st_init = M.build_system(mspec, dtype=md_dtype, device=device)
        print(f"material {mspec.name}: {sys.n_atoms} atoms, route {sys.route}")
        seeds = [_restart_state(meta[mi][r].micro, sys, md_dtype, device)
                 for r in range(n_repl)]
        if prepared is not None:
            st_p, rep_data = prepared[mi]
            rep_states = [E.MDState(*(getattr(st_p, f)[r] for f in fields))
                          if seeds[r] is None else seeds[r] for r in range(n_repl)]
        else:
            rep_states, rep_data = [], []
            for r in range(n_repl):
                gen = torch.Generator().manual_seed(cfg.seed + 101 * mi + r)
                if seeds[r] is not None:
                    st_r = seeds[r]
                elif staged:
                    st_r = M.equilibrate_staged(sys, st_init, params, gen, ns_init=ns_init,
                                                minimize_steps=minimize_steps)
                else:
                    st_r = M.equilibrate(sys, st_init, params, gen,
                                         minimize_steps=minimize_steps,
                                         equil_steps=equil_steps)
                rep_states.append(st_r)
                mr = meta[mi][r]
                if mr.length is not None and mr.stress is not None and mr.stiff is not None:
                    rep_data.append(M.InitData(length=mr.length, stress=mr.stress,
                                               stiff=mr.stiff,
                                               density=mr.rho if mr.rho is not None else 1000.0))
                else:
                    measured = M.measure(sys, st_r, params)
                    if mr.rho is not None:
                        measured = M.InitData(length=measured.length, stress=measured.stress,
                                              stiff=measured.stiff, density=mr.rho)
                    rep_data.append(measured)
        st0 = E.MDState(*(torch.stack([getattr(s, f).to(device=device, dtype=md_dtype)
                                       for s in rep_states]) for f in fields))

        def rows(key):
            return torch.as_tensor(np.stack([np.asarray(getattr(d, key), dtype=np.float64)
                                             for d in rep_data]), dtype=dtype,
                                   device=device)[None]

        rotams = torch.as_tensor(np.stack([meta[mi][r].rotam for r in range(n_repl)]),
                                 dtype=dtype, device=device)[None]
        ens = bridge.ReplicaEnsemble(
            rotam=rotams, init_length=rows("length"), init_stress=rows("stress"),
            init_stiff=rows("stiff"),
            rho=torch.tensor([[d.density for d in rep_data]], dtype=dtype, device=device))
        backends.append(MDBackend(sys=sys, params=params, ensemble=ens, n_repl=n_repl,
                                  max_jobs=max_jobs, initial_md_state=st0,
                                  pack_jobs=pack_jobs))
        sc, rc = bridge.average_replica_data(ens)
        stiff_rows.append(sc[0])
        rho_rows.append(rc[0])

    if material is None:
        material = assign_materials(cfg, geom, device=device)
    material = material.to(device=device, dtype=torch.int64)
    qp = init_qp_state(geom.n_qp_total, material, torch.stack(rho_rows),
                       torch.stack(stiff_rows), dtype=dtype)
    ops = FE.make_ops(geom, problem, qp, cfg.time.timestep_length,
                      cfg.bridging.stress_method, False,
                      cfg.precision.min_quadrature_strain_norm)
    # every material's replica data, so that the initial FE state gives each
    # qp its own material's stiffness and density (JAX's takes the first
    # material's ensemble and clamps the index of the others into it)
    ensemble = bridge.ReplicaEnsemble(*(torch.cat([getattr(be.ensemble, f) for be in backends])
                                        for f in bridge.ReplicaEnsemble._fields))
    base = HMMProblem(cfg=cfg, problem=problem, geom=geom, ops=ops, ensemble=ensemble,
                      md_update_fn=None, dtype=dtype, material=material)
    return MDHMMProblem(base=base, backends=tuple(backends))


def _cells_from_restart(spec: M.MaterialSpec, micro) -> M.MaterialSpec:
    """An SW spec sized to a LAMMPS restart's box (md_coupling.py:476-491):
    the cell counts round(L / a0) per axis and the constant mean(L / cells)
    where they hold the restart's atom count as a diamond lattice; the spec
    as it is otherwise, or for another force field or no restart."""
    if micro is None or spec.force_field != "sw":
        return spec
    L = micro.boxhi - micro.boxlo
    cells = tuple(int(round(x / spec.a0)) for x in L)
    if min(cells) < 1 or 8 * cells[0] * cells[1] * cells[2] != micro.natoms:
        return spec
    return dataclasses.replace(spec, n_cells_xyz=cells,
                               a0=float(np.mean(L / np.asarray(cells))))


def _restart_state(micro, sys: E.MDSystem, dtype, device) -> E.MDState | None:
    """A replica's microstate from its LAMMPS restart (read_restart,
    stmd_problem.h:185-207; md_coupling.py:518-526): the positions relative
    to the restart's box origin, its cell and velocities, the thermostat at
    rest; None without a restart or where its atom count is not the
    system's."""
    if micro is None or micro.natoms != sys.n_atoms:
        return None
    return E.init_state(torch.as_tensor(micro.pos - micro.boxlo, dtype=dtype, device=device),
                        torch.as_tensor(micro.h, dtype=dtype, device=device),
                        vel=torch.as_tensor(micro.vel, dtype=dtype, device=device))
