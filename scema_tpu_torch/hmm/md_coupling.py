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
* ReaxFF boxes run all of a step's jobs in one force evaluation per MD
  step, like every unfused box: JAX's ReaxFF job-chunk budget
  (md_coupling.py:568-581), which answers a TPU fault on wide programs, is
  not ported (at the bench's 32 jobs of 176 atoms the list field's
  autograd needs well under a GB).
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
from ..parallel import mesh_utils as MU
from ..utils import trace
from ..utils.device import resolve
from .problem import HMMProblem, StepOutputs, assign_materials, clustering_mapping


_FIELDS = ("pos", "vel", "h", "vxi")


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
    # a mesh of parallel.mesh_utils: each rank runs its contiguous block of
    # the step's jobs (md_coupling.py:184-221); a spatially sharded system
    # (MDSystem.spatial) runs every job on every rank instead, each rank
    # taking its slab
    device_mesh: object = None

    def __post_init__(self):
        if self.pack_jobs != 1:
            if self.sys.fused is None:
                raise ValueError(f"pack_jobs={self.pack_jobs}: the unfused engine has no "
                                 "multi-job kernel")
            MF.check_multi(self.sys.fused, self.pack_jobs)

    def _run_jobs(self, st: E.MDState, dlength: torch.Tensor):
        """Every (job, replica) MD run of the step: one batch on this rank,
        or with ``device_mesh`` this rank's contiguous block of the jobs
        (the job count padded to a multiple of the mesh size with
        zero-step copies of the first job), then ``pos``, ``vel``, ``h``,
        ``vxi`` and the stresses all-gathered, so every rank holds every
        job's result (JAX's global arrays after its ``shard_map``)."""
        mesh = self.device_mesh
        r = None if mesh is None or self.sys.spatial is not None else MU.mesh_rank(mesh)
        if r is None:
            return self._run_local(st, dlength, None)
        w, nj = MU.mesh_size(mesh), st.pos.shape[0]
        b = -(-nj // w)
        pad = b * w - nj

        def mine(x):
            x = torch.cat([x, x[:1].expand((pad,) + x.shape[1:])]) if pad else x
            return x[r * b:(r + 1) * b]

        active = None
        if pad:  # the rank's real jobs, then zero-step padding
            real = min(max(nj - r * b, 0), b)
            active = (torch.arange(b, device=st.pos.device) < real)[:, None] \
                .expand(b, st.pos.shape[1])
        out, sig = self._run_local(E.MDState(*(mine(getattr(st, f)) for f in _FIELDS)),
                                   mine(dlength), active)
        group = MU.mesh_group(mesh)
        return (E.MDState(*(MU.all_gather(getattr(out, f), group)[:nj] for f in _FIELDS)),
                MU.all_gather(sig, group)[:nj])

    def _run_local(self, st: E.MDState, dlength: torch.Tensor, active):
        """One batch of (job, replica) runs (``active`` (B, R): False runs
        zero steps; None: all run), or with ``pack_jobs`` = J the flattened
        batch grouped into J-tuples, the last padded with zero-step copies
        of the first job whose outputs are dropped (md_coupling.py:158-183)."""
        J = self.pack_jobs
        n = st.pos.shape[0] * st.pos.shape[1]
        if J == 1 or n == 0:
            return strain_and_homogenize(self.sys, st, dlength, self.params, active=active)
        pad = -n % J

        def grouped(x):
            x = x.reshape((n,) + x.shape[2:])
            x = torch.cat([x, x[:1].expand((pad,) + x.shape[1:])]) if pad else x
            return x.reshape((-1, J) + x.shape[1:])

        if active is None:
            active = torch.ones(st.pos.shape[:2], dtype=torch.bool, device=st.pos.device)
        active = grouped(active).clone()
        if pad:
            active.view(-1)[n:] = False
        out, sig = strain_and_homogenize_multi(
            self.sys, E.MDState(*(grouped(getattr(st, f)) for f in _FIELDS)),
            grouped(dlength), self.params, active=active)

        def back(x):
            return x.reshape((-1,) + x.shape[2:])[:n].reshape(st.pos.shape[:2] + x.shape[2:])

        return E.MDState(*(back(getattr(out, f)) for f in _FIELDS)), back(sig)

    def update(self, micro: MicroStates, eps_cg, material, jobs, most_recent_id,
               timestep: int = 0):
        """-> (micro', update_stress_cg (n_qp, 6), has_result (n_qp,),
        stress_repl_cg (n_qp, n_repl, 6)).  Where this backend's runs take
        collectives (a mesh, or a spatially sharded system) and the default
        group has more than one rank, rank 0's job mask, strains and
        most-recent ids are broadcast first, as ``shard_md_update`` does
        for the Hooke backend (``mesh_utils.broadcast_job_inputs``)."""
        with trace.span("md.pack"):
            if (self.device_mesh is not None or self.sys.spatial is not None) \
                    and MU.world_size() > 1:
                jobs, eps_cg, most_recent_id = MU.broadcast_job_inputs(jobs, eps_cg,
                                                                       most_recent_id)
            n_qp = eps_cg.shape[0]
            K = self.max_jobs
            dev = eps_cg.device
            # -- job packing (write_md_updates_list + prepare_md_simulations):
            # the selection window rotates by timestep so a capacity below the
            # flagged count round-robins over qps
            offset = (int(timestep) * K) % n_qp
            rolled = torch.roll(jobs, -offset)
            with trace.sync("md.job_list"):
                idx_r = nonzero_padded(rolled, K)
            with trace.sync("md.n_valid"):
                n_valid = min(int(jobs.sum()), K)
            trace.count("md.jobs", n_valid)
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
            eps_job = eps_cg[job_idx]
            mat_job = material[job_idx]

        # -- strain to replica frames and length variation
        with trace.span("md.bridge"):
            eps_rep = bridge.replica_strains(self.ensemble, eps_job, mat_job)
            dlength = bridge.strain_to_length_variation(self.ensemble, eps_rep, mat_job)

        # -- batched MD (execute_inside_md_simulations): one kernel launch
        # per phase (per chunk with k-space or a list) for every (job,
        # replica)
        with trace.span("md.run"):
            st, sigma_rep = self._run_jobs(st, dlength.to(micro.pos.dtype))
            sigma_rep = sigma_rep.to(eps_cg.dtype)

        # -- replica averaging with init-stress subtraction
        with trace.span("md.average"):
            upd = bridge.average_replica_stresses(self.ensemble, sigma_rep, mat_job,
                                                  subtract_init_stress=True)
        # -- scatter back over the valid slots only
        with trace.span("md.scatter"):
            update_stress_cg = torch.zeros((n_qp, 6), dtype=eps_cg.dtype, device=dev)
            update_stress_cg[job_idx] = upd
            has_result = torch.zeros((n_qp,), dtype=torch.bool, device=dev)
            has_result.index_fill_(0, job_idx, True)
            stress_repl_cg = torch.zeros((n_qp, self.n_repl, 6), dtype=eps_cg.dtype,
                                         device=dev)
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
        with trace.span("hmm.step", fe_state.timestep + 1):
            return self._step(fe_state, micros)

    def _step(self, fe_state, micros):
        ops = self.base.ops
        with trace.span("fe.begin"):
            fe_state = FE.begin_step(ops, fe_state)
        with trace.span("fe.solve"):
            fe_state, out = FE.solve(ops, fe_state)
        p = self.cfg.precision
        id_to_get, saturated = clustering_mapping(
            fe_state, out.flags, p.clustering_min_steps, p.spline_points,
            p.clustering_diff_threshold, ops.layout)
        fe_state = fe_state.replace(
            hist=fe_state.hist.replace(id_to_get_results_from=ops.layout.own(id_to_get)))
        jobs = bridge.job_mask(out.flags, id_to_get)

        n_qp = out.flags.shape[0]
        dt, dev = out.update_strain_cg.dtype, out.flags.device
        update_stress_cg = torch.zeros((n_qp, 6), dtype=dt, device=dev)
        has_result = torch.zeros((n_qp,), dtype=torch.bool, device=dev)
        n_repl = max(be.n_repl for be in self.backends)
        stress_repl = torch.zeros((n_qp, n_repl, 6), dtype=dt, device=dev)
        new_micros = []
        for m, be in enumerate(self.backends):
            with trace.span("md.update", m):
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
        with trace.span("fe.stress_update"):
            updated = out.flags & has_result[id_to_get]
            fe_state, res1 = FE.apply_stress_update(ops, fe_state, updated,
                                                    update_stress_cg, id_to_get)
        with trace.span("fe.reaction"):
            rf = assembly.reaction_force(self.geom, fe_state.qp.new_stress,
                                         fe_state.qp.rho, self.base.problem.loaded_mask,
                                         ops.layout)
        with trace.span("fe.end"):
            fe_state = FE.end_step(ops, fe_state)
        return (fe_state, tuple(new_micros)), StepOutputs(
            residual0=out.residual, residual1=res1, n_flagged=out.flags.sum(),
            n_jobs=has_result.sum(), reaction_force=rf, md_ran=has_result,
            md_strain_cg=out.update_strain_cg, md_stress_repl=stress_repl,
            cluster_saturated=saturated)


def build_md_hmm(cfg: HMMConfig, spec: M.MaterialSpec | None = None,
                 specs: list | None = None, equil_steps: int = 100, minimize_steps: int = 100,
                 staged: bool = False, ns_init: int = 100, device=None, prepared=None,
                 material: torch.Tensor | None = None, pack_jobs: int = 1,
                 device_mesh=None) -> MDHMMProblem:
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
    printed once per material.

    ``device_mesh`` (a mesh of ``parallel.mesh_utils``) spreads each
    step's MD jobs over its ranks (:attr:`MDBackend.device_mesh`), the job
    capacity rounded up to a multiple of the mesh size (md_coupling.py:
    447-449).  With more than one rank in the default group, rank 0 alone
    prepares and measures the replicas and broadcasts the microstates and
    replica data, so every rank starts from the same ensemble (the
    reference's Bcast, dealammps.cc:406-415), except for a spatially
    sharded system, whose prep runs on every rank together.  Without
    ``spec`` or ``specs``, an SW material of more than 2048 atoms takes
    ``spatial_shards`` = the config's 'minimum number of cores for MD
    simulation' where the default group has that many ranks
    (:func:`auto_spatial_shards`, md_coupling.py:463-474)."""
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
        # directory, "reax" with its ffield for a reax one), as the JAX
        # package's md_spec_kwargs gives it
        specs = [M.MaterialSpec(name=name, **md_spec_kwargs(cfg)) for name in materials]
    params = MDParams(temperature=cfg.md.temperature, dt=cfg.md.timestep_length,
                      strain_rate=cfg.md.strain_rate, nsteps_sample=cfg.md.nsteps_sample)
    problem = make_problem(cfg, dtype, device)
    geom = shapes.precompute_geometry(problem.mesh.nodes, problem.mesh.cells,
                                      cfg.mesh.quadrature_formula, dtype=dtype,
                                      device=device)
    max_jobs = min(cfg.resources.max_md_jobs or geom.n_qp_total, geom.n_qp_total)
    if device_mesh is not None:
        n_dev = MU.mesh_size(device_mesh)  # the job axis spans every mesh axis
        max_jobs = -(-max_jobs // n_dev) * n_dev

    from ..bridging.replica_data import load_replica_metadata

    meta = load_replica_metadata(cfg.dirs.nanoscale_input, materials, n_repl,
                                 cg_vector=cfg.material.common_ground_vector)
    if specs_auto:
        specs = auto_spatial_shards(specs, cfg.resources.md_cores_min, MU.world_size())
        specs = [_cells_from_restart(ms, meta[mi][0].micro) for mi, ms in enumerate(specs)]
    backends, stiff_rows, rho_rows = [], [], []
    for mi, mspec in enumerate(specs):
        sys, st_init = M.build_system(mspec, dtype=md_dtype, device=device)
        if MU.rank() == 0:
            print(f"material {mspec.name}: {sys.n_atoms} atoms, route {sys.route}")
        seeds = [_restart_state(meta[mi][r].micro, sys, md_dtype, device)
                 for r in range(n_repl)]
        # prep on rank 0 alone, then broadcast (a sharded system's prep
        # takes every rank's slab)
        shared = prepared is None and MU.world_size() > 1 and sys.spatial is None
        if shared and MU.rank() != 0:
            rep_states = [st_init] * n_repl
            rep_data = [M.InitData(length=np.zeros(3), stress=np.zeros(6), stiff=np.zeros((6, 6)),
                                   density=0.0)] * n_repl
        elif prepared is not None:
            st_p, rep_data = prepared[mi]
            rep_states = [E.MDState(*(getattr(st_p, f)[r] for f in _FIELDS))
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
                                       for s in rep_states]) for f in _FIELDS))
        if shared:
            st0, rep_data = _broadcast_prep(st0, rep_data)

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
                                  pack_jobs=pack_jobs, device_mesh=device_mesh))
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


def auto_spatial_shards(specs: list, md_cores_min: int, n_ranks: int) -> list:
    """The reference's 'minimum number of cores for MD simulation'
    (set_md_procs: LAMMPS ranks per job) as P4 spatial sharding
    (md_coupling.py:463-474): an SW spec of more than 2048 atoms (8 per
    diamond cell) without ``spatial_shards`` takes ``md_cores_min`` shards
    where ``n_ranks`` (the default group's size) reaches it; small boxes
    run faster unsharded, batched, and other specs stay as they are."""
    if md_cores_min <= 1:
        return list(specs)
    out = []
    for ms in specs:
        cells = ms.n_cells_xyz or (ms.n_cells,) * 3
        n_est = 8 * int(np.prod(cells))
        if (ms.force_field == "sw" and ms.spatial_shards == 0 and n_est > 2048
                and n_ranks >= md_cores_min):
            ms = dataclasses.replace(ms, spatial_shards=md_cores_min)
        out.append(ms)
    return out


def _broadcast_prep(st0: E.MDState, rep_data: list):
    """Rank 0's prepared microstates and replica data on every rank."""
    st0 = E.MDState(*(MU.broadcast(getattr(st0, f)) for f in _FIELDS))
    rows = torch.as_tensor(np.stack([np.concatenate([
        np.asarray(d.length, dtype=np.float64).ravel(), np.asarray(d.stress, dtype=np.float64),
        np.asarray(d.stiff, dtype=np.float64).ravel(), [float(d.density)]]) for d in rep_data]),
        device=st0.pos.device)
    rows = MU.broadcast(rows).cpu().numpy()
    return st0, [M.InitData(length=r[:3], stress=r[3:9], stiff=r[9:45].reshape(6, 6),
                            density=float(r[45])) for r in rows]


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
