"""Multi-rank helpers of the tests/test_torch_*.py files that hold the
port's sharded paths (``scema_tpu_torch.parallel``, ``fem.sharded``) to
the JAX package: CPU processes on the gloo backend, one torch thread and
float64 each.

A test module spawns its ranks once, in a module fixture
(:func:`run_ranks`): every rank runs one worker function of this module,
which computes every case the module checks and returns numpy arrays to
the parent.  The ranks meet through a ``file://`` rendezvous in the test's
temporary directory, so concurrent pytest workers never share a port.
This module imports torch and the port only (never jax), so the ranks do
not import JAX; the parent computes the JAX side.
"""
import dataclasses
import os
import queue as queue_mod
import traceback

import numpy as np
import torch


def _entry(worker, rank, world, init, q, args):
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        out = worker(rank, world, *args)
        q.put((rank, "ok", out))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — reported to the parent, which fails
        q.put((rank, "error", traceback.format_exc()))


def run_ranks(worker, world: int, tmp_dir, *args, timeout: float = 600.0) -> dict:
    """Run ``worker(rank, world, *args)`` on ``world`` gloo ranks and return
    {rank: result}; raises if a rank fails, dies or exceeds ``timeout``."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    init = f"file://{os.path.join(str(tmp_dir), f'rendezvous_{world}')}"
    procs = [ctx.Process(target=_entry, args=(worker, r, world, init, q, args))
             for r in range(world)]
    for p in procs:
        p.start()
    results, errors = {}, []
    try:
        for _ in range(world):
            rank, status, out = q.get(timeout=timeout)
            if status == "ok":
                results[rank] = out
            else:
                errors.append(f"rank {rank}:\n{out}")
                break
    except queue_mod.Empty:
        errors.append(f"no result within {timeout} s (exit codes "
                      f"{[p.exitcode for p in procs]})")
    finally:
        for p in procs:
            p.join(30 if not errors else 1)
            if p.is_alive():
                p.kill()
                p.join()
    if errors:
        raise RuntimeError("\n".join(errors))
    return results


def np64(x):
    return x.detach().cpu().double().numpy() if torch.is_tensor(x) else np.asarray(x)


# -- shared configurations (each module's parent builds the same)


def hooke_cfg(cls, cells):
    """The sharding tests' Hooke configuration (tests/test_sharding.py:
    25-30) on an x x y x z-cell dogbone, float64."""
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=cells[0], y_cells=cells[1], z_cells=cells[2]),
        bridging=cfg.bridging.__class__(stress_method=0, approx_md_with_hookes_law=True),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=10),
        dtype="float64")


def sic_cfg(cls, n_repl=1):
    """The 64-atom SW sic coupled step of tests/test_sharding.py:82-97, with
    ``n_repl`` MD replicas per qp."""
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=2),
        bridging=cfg.bridging.__class__(stress_method=0, approx_md_with_hookes_law=False),
        material=cfg.material.__class__(number_of_replicas=n_repl, materials=("sic",),
                                        proportions=(1.0,)),
        md=cfg.md.__class__(temperature=0.01, timestep_length=0.05, strain_rate=1.0e-2,
                            nsteps_sample=10, force_field="sw"),
        dtype="float64", md_dtype="float64")


SIC_SPEC = dict(name="sic", force_field="sw", n_cells=2)


# -- workers (one per test module)

WORLD_OF_BCAST = 2  # mesh_utils_worker's flag pattern repeats every 2 qps


def _hooke_run(cfg, material, mesh, n_steps):
    from scema_tpu_torch.hmm.problem import build_hooke_hmm

    hmm = build_hooke_hmm(cfg, device="cpu", material=torch.as_tensor(material),
                          device_mesh=mesh)
    s = hmm.init_state()
    for _ in range(n_steps):
        s, o = hmm.step(s)
    return np64(s.qp.new_stress), int(o.n_jobs)


def mesh_utils_worker(rank, world, splines, material):
    """tests/test_torch_mesh_utils.py: the sharded pairwise L2 over 2 and
    4 ranks, the (2, 2) mesh, and the Hooke step over 2 ranks and over
    the (2, 2) mesh."""
    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.parallel import mesh_utils as MU

    out = {}
    x = torch.as_tensor(splines)
    m2, m4 = MU.make_mesh(2), MU.make_mesh()
    out["l2_2"], out["l2_4"] = (np64(MU.shard_pairwise_l2(m)(x)) for m in (m2, m4))
    out["in_m2"] = MU.mesh_rank(m2)
    ms = MU.make_multislice_mesh(2, 2)
    out["ms"] = dict(names=tuple(ms.mesh_dim_names), size=MU.mesh_size(ms),
                     shape=tuple(ms.shape), flat=MU.mesh_rank(ms),
                     md=MU.mesh_rank(ms, "md"), dcn=MU.mesh_rank(ms, "dcn"),
                     md_sum=float(MU.all_reduce(torch.tensor(float(rank)),
                                                MU.mesh_group(ms, "md"))))
    # each rank flags its own qps with its own strains: every rank must
    # work on rank 0's, as a rank whose FE sums rounded otherwise would
    n = 10
    jobs = torch.arange(n) % WORLD_OF_BCAST == rank % WORLD_OF_BCAST
    eps = torch.full((n, 6), float(rank + 1), dtype=torch.float64)
    ids = torch.arange(n) + 100 * rank

    def update(e, mat, j, mri):
        return torch.where(j[:, None], e + mri[:, None].to(e.dtype), torch.zeros_like(e))

    out["bcast"] = np64(MU.shard_md_update(update, m4)(eps, torch.zeros(n, dtype=torch.long),
                                                        jobs, ids))
    cfg = hooke_cfg(HMMConfig, (2, 2, 3))
    out["hooke_2"] = _hooke_run(cfg, material, m2, 4)
    out["hooke_ms"] = _hooke_run(cfg, material, ms, 3)
    return out


def fem_sharded_worker(rank, world, material, n_steps):
    """tests/test_torch_fem_sharded.py: the 3x3x7 dogbone's sharded FE
    step over 2 and 4 ranks."""
    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.fem import sharded as SH
    from scema_tpu_torch.hmm.problem import build_hooke_hmm
    from scema_tpu_torch.parallel import mesh_utils as MU

    hmm = build_hooke_hmm(hooke_cfg(HMMConfig, (3, 3, 7)), device="cpu",
                          material=torch.as_tensor(material))
    out = {}
    for k in (2, 4):
        mesh = MU.make_mesh(k)
        if MU.mesh_rank(mesh) is None:
            continue
        step = SH.make_sharded_step(hmm, mesh)
        s = SH.shard_fe_state(hmm.init_state(), mesh)
        outs = []
        for _ in range(n_steps):
            s, o = step(s)
            outs.append((int(o.n_jobs), int(o.n_flagged), float(o.residual0),
                         float(o.residual1), float(o.reaction_force)))
        full = SH.gather_fe_state(s, mesh, hmm)
        out[k] = dict(rows=(s.u.shape[0], s.qp.new_stress.shape[0], s.hist.buffer.shape[0]),
                      bytes=SH.fe_state_bytes(s), full_bytes=SH.fe_state_bytes(full),
                      outs=outs, u=np64(full.u),
                      stress=np64(full.qp.new_stress), v=np64(full.v))
    return out


def _sharded_sic_hmm(n_repl, prepared=None, material=None):
    """The sic coupled step with the job batch over every rank."""
    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.parallel import mesh_utils as MU

    prep = None
    if prepared is not None:
        st, rows = prepared
        prep = [(E.MDState(*(torch.as_tensor(st[f]) for f in ("pos", "vel", "h", "vxi"))),
                 [M.InitData(**r) for r in rows])]
    return build_md_hmm(sic_cfg(HMMConfig, n_repl), spec=M.MaterialSpec(**SIC_SPEC),
                        equil_steps=0, minimize_steps=10, device="cpu",
                        device_mesh=MU.make_mesh(), prepared=prep,
                        material=None if material is None else torch.as_tensor(material))


def sharded_md_worker(rank, world, prepared, material, n_steps, ensemble=False):
    """tests/test_torch_sharded_md.py: the 64-atom SW sic coupled step with
    the job batch over all ranks, prepared by the port (rank 0, broadcast)
    or from JAX's prep (``prepared`` as numpy: MDState fields and InitData
    rows).  With ``ensemble``, also the same steps at 2 MD replicas per qp
    (under ``"ensemble"``), the last one taken with the port's tracer off
    and again with it on (:func:`_steps`)."""
    from scema_tpu_torch.parallel import mesh_utils as MU

    out = _steps(_sharded_sic_hmm(1, prepared, material), n_steps)
    st, sig = packed_jobs(MU.make_mesh())
    out["packed"] = dict(pos=np64(st.pos), vel=np64(st.vel), sig=np64(sig))
    if ensemble:
        out["ensemble"] = _steps(_sharded_sic_hmm(2), n_steps, traced=True)
    return out


def _steps(hmm, n_steps, traced=False):
    """``n_steps`` coupled steps from the initial state.  With ``traced``
    the last one runs with the tracer off under a guard that refuses any
    profiler range, then again from the same carry with the tracer on
    under the CPU profiler: the counters of both, each ``coll.*`` span
    with its parent span, the shapes the step's collectives move, and
    whether the two steps agree bit for bit."""
    from torch.profiler import ProfilerActivity, profile

    from scema_tpu_torch.utils import trace
    from torch_port_util import leaves

    carry = hmm.init_state()
    init = {f: np64(getattr(hmm.backend.initial_md_state, f)) for f in ("pos", "vel", "h")}
    jobs = []
    enter = torch.autograd._record_function_with_args_enter

    def refuse(*a, **kw):
        raise AssertionError("a profiler range was entered with tracing off")

    for i in range(n_steps):
        prev = carry
        trace.reset()
        if traced and i == n_steps - 1:
            torch.autograd._record_function_with_args_enter = refuse
        try:
            carry, o = hmm.step(prev)
        finally:
            torch.autograd._record_function_with_args_enter = enter
        jobs.append(int(o.n_jobs))
    fe, (micro,) = carry
    out = dict(stress=np64(fe.qp.new_stress), u=np64(fe.u), jobs=jobs, init=init,
               pos=np64(micro.pos), max_jobs=hmm.backend.max_jobs,
               kernel=hmm.backend.sys.fused.spec.kernel)
    if not traced:
        return out
    off = trace.counters()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            again = hmm.step(prev)
    finally:
        trace.disable()
    on = trace.counters()
    trace.reset()
    spans = [(e.name, e.cpu_parent.name if e.cpu_parent is not None else None)
             for e in prof.events() if e.is_user_annotation and e.name.startswith("coll.")]
    a, b = leaves((carry, o)), leaves(again)
    same = len(a) == len(b) and all(
        torch.equal(x, y) if torch.is_tensor(x) else x == y for x, y in zip(a, b))
    m0 = prev[1][0]
    out.update(off=off, on=on, spans=spans, same=same, n_qp=int(m0.pos.shape[0]),
               atoms=int(m0.pos.shape[2]), nhc=int(m0.vxi.shape[-1]),
               md_item=m0.pos.element_size())
    return out


def packed_jobs(mesh, pack_jobs=2, n_jobs=5):
    """``MDBackend._run_jobs`` on 5 (job, replica) runs of the 256-atom LJ
    crystal (K1's plain version), the jobs' states and strains drawn from
    a fixed seed: with a mesh and K1m's J = 2, each rank's block of 3 jobs
    (one a zero-step pad) splits into J-tuples, the last padded again."""
    from scema_tpu_torch.hmm.md_coupling import MDBackend
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.md.homogenization import MDParams

    sys_, st = M.build_system(M.MaterialSpec(name="ar", force_field="lj", a0=5.26, n_cells=4,
                                             mass=39.948), device="cpu")
    gen = torch.Generator().manual_seed(18)
    pos = st.pos + 0.05 * torch.randn((n_jobs, 1) + tuple(st.pos.shape), generator=gen,
                                      dtype=st.pos.dtype)
    vel = 0.001 * torch.randn(pos.shape, generator=gen, dtype=pos.dtype)
    jobs = E.MDState(pos=pos, vel=vel, h=st.h.expand(n_jobs, 1, 3, 3).clone(),
                     vxi=torch.zeros((n_jobs, 1, 3), dtype=pos.dtype))
    dlength = 0.02 * torch.randn((n_jobs, 1, 6), generator=gen, dtype=pos.dtype)
    be = MDBackend(sys=sys_, params=MDParams(temperature=50.0, dt=2.0, strain_rate=1e-3,
                                             nsteps_sample=10),
                   ensemble=None, n_repl=1, max_jobs=n_jobs, initial_md_state=None,
                   pack_jobs=pack_jobs, device_mesh=mesh)
    return be._run_jobs(jobs, dlength)


def spatial_worker(rank, world, pos, h, vel, eps, n_strain, n_sample, T, dt):
    """tests/test_torch_spatial_md.py: the 1000-atom diamond box's energy,
    forces and virial with its force calls over 2 and 4 slabs, and the
    strain + sampling runs over 4."""
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M

    out = {}
    p, hh = torch.as_tensor(pos)[None], torch.as_tensor(h)[None]
    common = dict(name="si", force_field="sw", n_cells=5, rebuild_every=10)
    for k in (2, 4):
        sys_, st = M.build_system(M.MaterialSpec(**common, spatial_shards=k), device="cpu")
        slab = sys_.build_neighbors(p, hh)
        F, En, W = E.forces_energy_virial(sys_, p, hh, slab)
        out[k] = dict(energy=float(En[0]), forces=np64(F[0]), virial=np64(W[0]),
                      route=sys_.route, c1=sys_.spatial.sg.cells[0],
                      rows=None if slab.centres is None else int(slab.nbr.mask.any(-1).sum()))
        if k == 4:
            st = dataclasses.replace(st, vel=torch.as_tensor(vel))
            st = E.run_strain(sys_, st, torch.as_tensor(eps), n_strain, T, dt)
            st2, press = E.sample_stress(sys_, st, n_sample, T, dt)
            out["run"] = dict(pos=np64(st.pos), vel=np64(st.vel), h=np64(st.h),
                              press=np64(press), pos2=np64(st2.pos))
    return out
