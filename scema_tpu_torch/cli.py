"""Command-line entry points of the port (the reference's executables).

    python -m scema_tpu_torch.cli run <inputs.json>            # dealammps
    python -m scema_tpu_torch.cli init-material <inputs.json>  # init_material
    python -m scema_tpu_torch.cli strain-md <inputs.json>      # strain_md
    python -m scema_tpu_torch.cli analyse-md <inputs.json> <state>  # analyse_md

``run`` drives the coupled HMM time loop on one CUDA device after the staged
material prep (the reference's in.init.lammps heatup/cooldown NPT cycle,
``material.equilibrate_staged``; ``--quick-prep`` takes the short
fixed-box FIRE + NVT prep instead): FE and MD in float32,
every flagged quadrature point's MD job through the fused MD kernel of the
config's force field — K1 for the default united-atom OPLS melt, K5 for
the Stillinger-Weber diamond-Si box that ``"molecular dynamics
parameters": {"force field": "sw"}`` (or a ``sisw`` scripts directory)
selects, as in the JAX CLI; a ``reax`` scripts directory (or ``"force
field": "reax"``) selects ReaxFF with the directory's ``ffield.reax*`` on
the unfused engine — and the clustering distance matrix through kernel
K2.  ``--outdir`` writes the VTU/PVD/CSV outputs and the npz and
reference-format (lcts.*) checkpoints at the config's frequencies;
``--restart`` / ``--restart-reference`` resume from either; under
``torchrun --nproc-per-node=N`` (WORLD_SIZE > 1) ``run`` initialises the
default process group (NCCL on the cards, gloo with ``--cpu``), spreads
each step's MD jobs (or Hooke qps) over the ranks, lets the config's
'minimum number of cores for MD simulation' slab-shard SW boxes above 2048
atoms, and rank 0 alone prints and writes; a failing step
rolls back to the last good one up to ``--max-retries`` times (never for a
kernel that did not build or launch); ``--profile DIR`` turns the port's
tracer on (``utils/trace.py``: its spans around each layer of the step,
its host-sync, MD job-step and collective counters) and writes a
torch.profiler Chrome trace of the run, ``DIR/trace.json``, with the
spans on the kernels' timeline, and ``DIR/counters.json``, the counters
of each step (the operator's view of where a step's time and syncs go);
``--dump-similarity`` the final distance matrix.

The subcommands follow ``scema_tpu/cli.py`` flag for flag and print the
same lines.  ``--cpu`` runs the same paths on the CPU in float64 with the
kernels' plain versions; without it a missing CUDA device is an error
(exit 2), never a silent CPU run.  ``--hooke`` replaces MD with
sigma = C:eps (the reference's debug mode).  ``--surrogate`` loads the
reference's Keras surrogate (h5py reads it) or the port's own npz
(``bridging.surrogate.save_surrogate``) and runs stress method 2: every
qp's stress from the surrogate, no MD.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device(args):
    """The subcommand's device, or None (after printing why) when it needs
    CUDA and there is none."""
    import torch

    if args.cpu:
        return torch.device("cpu")
    if not torch.cuda.is_available():
        print("error: no CUDA device available; the port runs on one "
              "NVIDIA GPU (use --cpu for the float64 CPU reference path)",
              file=sys.stderr)
        return None
    # full float32 everywhere: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", torch.cuda.current_device())


def _torchrun_group(device):
    """Under ``torchrun`` (WORLD_SIZE > 1): the default process group (NCCL
    on the card, gloo with ``--cpu``), this rank's card (LOCAL_RANK's) and
    a mesh over every rank; (device, None) in a single process.  NCCL
    refuses two ranks on one card, and that error is not caught."""
    import torch

    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        return device, None
    import torch.distributed as dist

    from .parallel import mesh_utils as MU

    if device.type == "cuda":
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0"))
                              % torch.cuda.device_count())
        torch.cuda.set_device(device)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo")
    return device, MU.make_mesh()


def _fatal(e: BaseException) -> bool:
    """A fault no rollback can cure: a kernel that did not build or launch
    (a build error repeats), or a CUDA error (it leaves the context
    unusable)."""
    from .ops._build import KernelError

    return isinstance(e, KernelError) or "CUDA error" in str(e)


def _transient(e: BaseException) -> bool:
    """Runtime faults are retried; deterministic errors (config, shape,
    dtype) and fatal ones raise at once."""
    return isinstance(e, (OSError, RuntimeError)) and not _fatal(e)


def _md_setup(args, device):
    """(cfg, MDParams, the config's MaterialSpec keywords) of an MD
    subcommand."""
    from .config import load_config, md_spec_kwargs
    from .md.homogenization import MDParams

    cfg = load_config(args.config)
    params = MDParams(temperature=cfg.md.temperature, dt=cfg.md.timestep_length,
                      strain_rate=cfg.md.strain_rate, nsteps_sample=cfg.md.nsteps_sample)
    return cfg, params, md_spec_kwargs(cfg)


def _md_dtype(device):
    """MD in float64 on the CPU, float32 (the kernels' type) on the card,
    as the JAX CLI's subcommands run."""
    import torch

    return torch.float64 if device.type == "cpu" else torch.float32


def cmd_run(args) -> int:
    import numpy as np
    import torch

    device = _device(args)
    if device is None:
        return 2
    # under torchrun: every rank runs the loop with the step's MD jobs (or
    # Hooke qps) spread over the ranks; rank 0 alone prints and writes
    device, rank_mesh = _torchrun_group(device)
    lead = rank_mesh is None or rank_mesh.get_coordinate()[0] == 0
    if not lead:
        sys.stdout = open(os.devnull, "w")

    from .config import load_config

    if not os.path.exists(args.config):
        print(f"error: config file not found: {args.config}", file=sys.stderr)
        return 2
    # FE in float64 on the CPU, float32 on the card; MD in the config's
    # md_dtype (float32 by default), as the JAX CLI selects them
    cfg = load_config(args.config, dtype="float64" if args.cpu else "float32")
    if args.hooke:
        cfg = cfg.replace(bridging=dataclasses.replace(
            cfg.bridging, approx_md_with_hookes_law=True, use_pjm_scheduler=False))
    if args.max_jobs:
        cfg = cfg.replace(resources=dataclasses.replace(
            cfg.resources, max_md_jobs=args.max_jobs))
    n_steps = args.steps or (cfg.time.end_timestep - cfg.time.start_timestep + 1)

    surrogate_fn = None
    if args.surrogate:
        from .bridging import surrogate as S

        sp, fe_dtype = args.surrogate, getattr(torch, cfg.dtype)
        if sp.endswith(".npz"):
            # the port's own file (save_surrogate), which needs no h5py
            surrogate_fn = S.load_surrogate(sp, dtype=fe_dtype, device=device).as_update_fn()
            print(f"Loaded surrogate {sp}")
        else:
            # the reference's pretrained Keras surrogate + sklearn scaler
            # (surrogate_model/surrogate.py): the directory holding
            # model_small_uniaxial.bin + scaler.pkl, or the .bin itself
            if os.path.isdir(sp):
                model_p = os.path.join(sp, "model_small_uniaxial.bin")
                scaler_p = os.path.join(sp, "scaler.pkl")
            else:
                model_p = sp
                scaler_p = os.path.join(os.path.dirname(sp), "scaler.pkl")
            scaler_p = scaler_p if os.path.exists(scaler_p) else None
            surrogate_fn = S.load_keras_surrogate(model_p, scaler_p, dtype=fe_dtype,
                                                  device=device).as_update_fn()
            print(f"Loaded surrogate {model_p} (scaler: {scaler_p})")
        if cfg.bridging.stress_method != 2:
            # a loaded surrogate drives the constitutive update only under
            # stress method 2; running full MD instead would ignore the flag
            print("--surrogate given: overriding 'stress computation "
                  f"method' {cfg.bridging.stress_method} -> 2")
            cfg = cfg.replace(bridging=dataclasses.replace(cfg.bridging, stress_method=2))

    t_setup = time.perf_counter()
    if cfg.bridging.approx_md_with_hookes_law or cfg.bridging.stress_method != 0:
        from .hmm.problem import build_hooke_hmm

        hmm = build_hooke_hmm(cfg, device=device, surrogate_fn=surrogate_fn,
                              device_mesh=rank_mesh)
    else:
        from .hmm.md_coupling import build_md_hmm

        # production material prep = the staged heatup/cooldown NPT cycle;
        # --quick-prep takes the short fixed-box prep (debug and smoke runs)
        hmm = build_md_hmm(cfg, staged=not args.quick_prep, device=device,
                           device_mesh=rank_mesh)
    _sync(device)
    setup_s = time.perf_counter() - t_setup
    print(f"Problem: {cfg.problem.cls}  mesh {cfg.mesh.x_cells}x{cfg.mesh.y_cells}x"
          f"{cfg.mesh.z_cells}  qps {hmm.geom.n_qp_total}  dt {cfg.time.timestep_length}")
    print(f"Setup (mesh + material prep) {setup_s:.3f}s on {device}")
    state = hmm.init_state()
    mesh = hmm.base.problem.mesh if hasattr(hmm, "base") else hmm.problem.mesh

    def fe_of(s):
        # the MD-coupled carry is (FEState, MicroStates...); dispatch on the
        # field, not on tuple-ness
        return s if hasattr(s, "timestep") else s[0]

    def with_fe(s, fe):
        return fe if hasattr(s, "timestep") else (fe,) + tuple(s[1:])

    from .hmm.checkpoint import load_checkpoint, save_checkpoint

    if args.restart:
        state = load_checkpoint(args.restart, state)
        print(f"Restarted from {args.restart} at timestep {fe_of(state).timestep}")
    if args.restart_reference:
        # reference-produced lcts.* restart (FE_problem.h:540-712)
        from .fem.reference_restart import load_reference_restart

        fe = load_reference_restart(args.restart_reference, fe_of(state), hmm.geom, mesh)
        # the reference resumes the step counter from the config's 'start
        # timestep'; infer it from the restored physical time so the
        # timestep-1 load increment is not re-applied on resume
        ts0 = int(round(fe.time / cfg.time.timestep_length))
        state = with_fe(state, fe.replace(timestep=ts0))
        print(f"Restored reference restart from {args.restart_reference} "
              f"at time {fe.time:.6g} (timestep {ts0})")

    writer = None
    if args.outdir and lead:
        from .fem.output import OutputWriter

        resumed = bool(args.restart or args.restart_reference)
        writer = OutputWriter(args.outdir, mesh.nodes, mesh.cells, resume=resumed,
                              resume_timestep=fe_of(state).timestep if resumed else None)
        # mesh wireframe EPS at init (FEProblem::visualise_mesh)
        writer.write_mesh_eps()

    prof = None
    step_counters = []
    if args.profile and lead:
        from torch.profiler import ProfilerActivity, profile

        from .utils import trace

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                         if device.type == "cuda" else [])
        prof = profile(activities=acts)
        trace.reset()
        trace.enable()
        seen = trace.counters()
        prof.start()

    # fault recovery: a failing step rolls back to the last good carry and
    # retries.  hmm.step never writes into its input's tensors, so the
    # input carry is the snapshot.  Only runtime faults are retried, and
    # never a kernel that did not build or launch (_fatal): those raise.
    last_good = state
    last_good_k = 0
    retries_left = args.max_retries

    t_total = time.perf_counter()
    k = 0
    while k < n_steps:
        t0 = time.perf_counter()
        try:
            state, out = hmm.step(state)
            _sync(device)
        except Exception as e:  # noqa: BLE001 — filtered just below
            if not _transient(e) or retries_left <= 0:
                if prof is not None:
                    trace.disable()
                raise
            retries_left -= 1
            print(f"step failed ({type(e).__name__}: {e}); rolling back to "
                  f"step {last_good_k} ({retries_left} retries left)",
                  file=sys.stderr)
            state = last_good
            k = last_good_k
            continue
        last_good, last_good_k = state, k + 1
        k += 1
        wall = time.perf_counter() - t0
        fe = fe_of(state)
        ts = fe.timestep
        print(
            f"Timestep {ts} at time {fe.time:.6g}  "
            f"residual {float(out.residual0):.6g} -> {float(out.residual1):.6g}  "
            f"flagged qps {int(out.n_flagged)}  md jobs {int(out.n_jobs)}  "
            f"reaction {float(out.reaction_force):.6g}  ({wall:.3f}s)"
        )
        if prof is not None:  # this step's counts: the totals' change
            now = trace.counters()
            step_counters.append({"timestep": ts, "counters": {
                k: v - seen.get(k, 0) for k, v in now.items()}})
            seen = now
        if out.cluster_saturated is not None and bool(out.cluster_saturated):
            print("note: similarity-dedup pick cap reached this step; "
                  "unreduced qps ran their own MD", file=sys.stderr)
        if writer is not None:
            o = cfg.output

            def due(freq):  # 0 = disabled
                return freq > 0 and ts % freq == 0

            if due(o.visualisation_frequency):
                writer.write_visualisation(fe, ts, fe.time)
                # the DG-projected history VTU on the same cadence
                # (FE_problem.h output_visualisation_history :2050)
                writer.write_visualisation_history(fe, ts, fe.time)
            if due(o.loaded_boundary_force_frequency):
                writer.write_lbc_force(ts, fe.time, float(out.reaction_force))
            if due(o.analytics_frequency):
                writer.write_lhistory(fe, ts)
            if out.md_stress_repl is not None and due(o.homogenization_frequency):
                ran = np.nonzero(out.md_ran.cpu().numpy())[0]
                writer.write_mddata(ts, ran, fe.qp.material.cpu().numpy(),
                                    out.md_strain_cg, out.md_stress_repl,
                                    cfg.md.temperature, cfg.md.strain_rate,
                                    cfg.md.force_field)
            if due(o.checkpoint_frequency):
                save_checkpoint(f"{args.outdir}/checkpoint-{ts:06d}.npz", state)
                # reference-format lcts.* alongside (FE_problem.h:2278-2335)
                from .fem.reference_restart import save_reference_checkpoint

                save_reference_checkpoint(f"{args.outdir}/restart", fe, mesh)
    if prof is not None:
        prof.stop()
        trace.disable()
        os.makedirs(args.profile, exist_ok=True)
        path = os.path.join(args.profile, "trace.json")
        prof.export_chrome_trace(path)
        print(f"Profiler trace written to {path}")
        path = os.path.join(args.profile, "counters.json")
        with open(path, "w") as f:
            json.dump(step_counters, f, indent=1)
        print(f"Step counters written to {path}")

    if args.dump_similarity and lead:
        # final-state similarity network for clustering.render_network —
        # the reference's __results/ID_* edge shards
        # (strain2spline.h write_similar_histories)
        from .clustering.spline import splinify_histories
        from .ops.pairwise_l2 import pairwise_l2

        fe = fe_of(state)
        splines = splinify_histories(fe.hist.buffer, fe.hist.count,
                                     cfg.precision.spline_points)
        np.savez(args.dump_similarity, dist=pairwise_l2(splines).cpu().numpy(),
                 threshold=np.float64(cfg.precision.clustering_diff_threshold))
        print(f"Similarity network written to {args.dump_similarity}")

    u = fe_of(state).u.detach().cpu().numpy().reshape(-1, 3)
    print(f"Max displacement: {np.abs(u).max():.6g} m")
    print(f"Total wall time: {time.perf_counter() - t_total:.2f}s for {n_steps} steps")
    if rank_mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    return 0


def cmd_init_material(args) -> int:
    """On-device material preparation (init_material.cc equivalent).

    For each (material x replica): build the box, minimize + thermalize,
    measure equilibrium lengths / residual stress / 6x6 stiffness /
    density, and write the reference-format init.<mat>_<n>.* files plus
    per-material common-ground averages (stmd_sync.h:455-489).
    """
    import numpy as np
    import torch

    device = _device(args)
    if device is None:
        return 2
    from .md import material as M
    from .utils import io_tensors as io
    from .utils import tensors as T

    cfg, params, spec_kw = _md_setup(args, device)
    outdir = args.outdir or cfg.dirs.nanoscale_input
    for mi, mat in enumerate(cfg.material.materials):
        stiffs, rhos = [], []
        for repl in range(1, cfg.material.number_of_replicas + 1):
            spec = M.MaterialSpec(name=mat, n_cells=args.cells, **spec_kw)
            sys_, st = M.build_system(spec, dtype=_md_dtype(device), device=device)
            # the seed stream of build_md_hmm's inline prep (per material
            # and per replica)
            gen = torch.Generator().manual_seed(cfg.seed + 101 * mi + (repl - 1))
            if not args.quick_prep:
                # in.init.lammps heatup/cooldown NPT cycle — the production
                # default, matching `run` (these init.* files take
                # precedence over on-device measurement)
                st = M.equilibrate_staged(sys_, st, params, gen, ns_init=args.ns_init,
                                          minimize_steps=args.minimize_steps)
            else:
                st = M.equilibrate(sys_, st, params, gen,
                                   minimize_steps=args.minimize_steps,
                                   equil_steps=args.equil_steps)
            data = M.measure(sys_, st, params)
            M.write_init_files(outdir, mat, repl, data)
            print(f"{mat}_{repl}: L={data.length[0]:.4f} A  rho={data.density:.1f} "
                  f"kg/m3  C11={data.stiff[0,0]/1e9:.3f} GPa  "
                  f"C12={data.stiff[0,1]/1e9:.3f} GPa  C44={data.stiff[3,3]/1e9:.3f} GPa")
            stiffs.append(data.stiff)
            rhos.append(data.density)
        # common-ground per-material averages (identity replica orientations)
        os.makedirs(outdir, exist_ok=True)
        cavg = np.mean(np.stack(stiffs), axis=0)
        io.write_sym4(f"{outdir}/init.{mat}.stiff",
                      T.c66_to_rank4(torch.as_tensor(cavg)).numpy())
        io.write_scalar(f"{outdir}/init.{mat}.density", float(np.mean(rhos)))
        print(f"{mat}: wrote averaged init.{mat}.stiff / .density to {outdir}")
    return 0


def cmd_strain_md(args) -> int:
    """Standalone single-replica strained MD (strain_md.cc equivalent)."""
    import torch

    device = _device(args)
    if device is None:
        return 2
    from .md import box as B
    from .md import material as M
    from .md.homogenization import strain_and_homogenize

    cfg, params, spec_kw = _md_setup(args, device)
    spec = M.MaterialSpec(name=cfg.material.materials[0], n_cells=args.cells, **spec_kw)
    sys_, st = M.build_system(spec, dtype=_md_dtype(device), device=device)
    gen = torch.Generator().manual_seed(cfg.seed)
    st = M.equilibrate(sys_, st, params, gen, minimize_steps=args.minimize_steps,
                       equil_steps=args.equil_steps)
    eps = torch.tensor([float(x) for x in args.strain.split(",")], dtype=st.pos.dtype,
                       device=device)
    L, _ = B.lengths_tilts(st.h)
    dlength = eps * torch.stack([L[0], L[1], L[2], L[2], L[1], L[0]])
    st, stress = strain_and_homogenize(sys_, st, dlength, params)
    print("stress (Pa, Voigt xx yy zz xy xz yz):")
    print(" ".join(f"{float(s):.6e}" for s in stress))
    if args.save_state:
        from .hmm.checkpoint import save_checkpoint

        save_checkpoint(args.save_state, st)
        print(f"microstate saved to {args.save_state}")
    if args.dump:
        from .md.data_io import write_lammpstrj

        # the reference's microstate-dump column set (id type xs ys zs vx vy
        # vz ix iy iz, stmd_problem.h:262), re-read by analyse-md as
        # anmd_problem.h:100-179 does; atom types live on the force field
        # (single-type when it has none)
        ff_types = getattr(sys_.ff, "types", None)
        write_lammpstrj(args.dump, st.pos.cpu().numpy(), st.h.cpu().numpy(),
                        types=None if ff_types is None else ff_types.cpu().numpy(),
                        vel=st.vel.cpu().numpy(), style="custom_scaled")
        print(f"microstate dump written to {args.dump}")
    return 0


def cmd_analyse_md(args) -> int:
    """Re-homogenize a saved MD microstate (analyse_md.cc equivalent)."""
    import torch

    device = _device(args)
    if device is None:
        return 2
    from .hmm.checkpoint import load_checkpoint
    from .md import engine as E
    from .md import material as M
    from .md.units import ATM_TO_PA

    cfg, params, spec_kw = _md_setup(args, device)
    spec = M.MaterialSpec(name=cfg.material.materials[0], n_cells=args.cells, **spec_kw)
    sys_, st0 = M.build_system(spec, dtype=_md_dtype(device), device=device)
    if args.state.endswith((".dump", ".lammpstrj")):
        # reference-produced last.<qpid>.<mat>_<r>.dump text microstate
        # (stmd_problem.h:262, re-read by anmd_problem.h:100-179)
        from .md.data_io import read_lammps_dump

        frame = read_lammps_dump(args.state)
        if frame["pos"].shape[0] != st0.pos.shape[0]:
            print(f"error: dump has {frame['pos'].shape[0]} atoms but the "
                  f"config's material box has {st0.pos.shape[0]} — "
                  "match --cells / material to the dump's system",
                  file=sys.stderr)
            return 2

        def like(a, t):
            return torch.as_tensor(a).to(dtype=t.dtype, device=t.device)

        st = st0.replace(pos=like(frame["pos"], st0.pos), vel=like(frame["vel"], st0.vel),
                         h=like(frame["h"], st0.h))
    else:
        st = load_checkpoint(args.state, st0)
    _, press = E.sample_stress(sys_, st, params.nsteps_sample, params.temperature,
                               params.dt)
    stress = -press * ATM_TO_PA
    print("re-homogenized stress (Pa, Voigt xx yy zz xy xz yz):")
    print(" ".join(f"{float(s):.6e}" for s in stress))
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scema_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    pr = sub.add_parser("run", help="run the coupled HMM time loop")
    pr.add_argument("config", help="reference-format inputs.json (its 'molecular dynamics "
                                   "parameters' pick the force field: opls, sw or reax)")
    pr.add_argument("--steps", type=int, default=0, help="override number of steps")
    pr.add_argument("--hooke", action="store_true",
                    help="force 'approximate md with hookes law' debug mode")
    pr.add_argument("--cpu", action="store_true",
                    help="run on the CPU (FE in float64) with the kernels' plain versions")
    pr.add_argument("--outdir", default="", help="write VTK/CSV/checkpoints here")
    pr.add_argument("--restart", default="", help="restore from a checkpoint npz")
    pr.add_argument("--restart-reference", default="",
                    help="restore from a reference-produced lcts.* restart dir")
    pr.add_argument("--profile", default="",
                    help="turn the port's tracer on and write a torch.profiler Chrome "
                         "trace of the run with its spans (trace.json) and each step's "
                         "counters (counters.json: host syncs, MD jobs and job-steps, "
                         "collective bytes, kernel launches) into this dir")
    pr.add_argument("--max-jobs", type=int, default=0,
                    help="cap the MD job-list capacity")
    pr.add_argument("--surrogate", default="",
                    help="stress method 2: a Keras surrogate .bin, the directory "
                         "holding model_small_uniaxial.bin + scaler.pkl, or the "
                         "port's surrogate .npz (save_surrogate)")
    pr.add_argument("--max-retries", type=int, default=3,
                    help="transient-fault retries (rollback to the last good step)")
    pr.add_argument("--dump-similarity", default="",
                    help="write the final strain-history L2 distance matrix "
                         "as an npz (dist, threshold)")
    pr.add_argument("--quick-prep", action="store_true",
                    help="short fixed-box material prep (FIRE + NVT) instead of the "
                         "staged heatup/cooldown NPT prep")
    pr.set_defaults(fn=cmd_run)

    pi = sub.add_parser("init-material", help="equilibrate materials, measure stiffness")
    pi.add_argument("config")
    pi.add_argument("--cells", type=int, default=3, help="lattice cells per dim")
    pi.add_argument("--minimize-steps", type=int, default=100)
    pi.add_argument("--equil-steps", type=int, default=200)
    pi.add_argument("--quick-prep", action="store_true",
                    help="short fixed-box prep instead of the staged "
                         "heatup/cooldown NPT cycle (debug/smoke runs)")
    pi.add_argument("--ns-init", type=int, default=100,
                    help="stage length unit for staged prep (in.init nsinit)")
    pi.add_argument("--outdir", default="")
    pi.add_argument("--cpu", action="store_true")
    pi.set_defaults(fn=cmd_init_material)

    ps = sub.add_parser("strain-md", help="single strained MD run (strain_md analog)")
    ps.add_argument("config")
    ps.add_argument("--strain", default="0.002,0,0,0,0,0",
                    help="Voigt strain xx,yy,zz,xy,xz,yz")
    ps.add_argument("--cells", type=int, default=3)
    ps.add_argument("--minimize-steps", type=int, default=100)
    ps.add_argument("--equil-steps", type=int, default=100)
    ps.add_argument("--save-state", default="")
    ps.add_argument("--dump", default="", help="write a .lammpstrj frame")
    ps.add_argument("--cpu", action="store_true")
    ps.set_defaults(fn=cmd_strain_md)

    pa = sub.add_parser("analyse-md", help="re-homogenize a saved microstate")
    pa.add_argument("config")
    pa.add_argument("state", help="microstate checkpoint (npz) or text dump")
    pa.add_argument("--cells", type=int, default=3)
    pa.add_argument("--cpu", action="store_true")
    pa.set_defaults(fn=cmd_analyse_md)

    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
