"""Command-line entry point of the port (the reference's dealammps).

    python -m scema_tpu_torch.cli run <inputs.json> --quick-prep --steps N

runs the coupled HMM time loop on one CUDA device: FE and MD in float32,
every flagged quadrature point's MD job through the fused MD kernel of the
config's force field — K1 for the default united-atom OPLS melt, K5 for
the Stillinger-Weber diamond-Si box that ``"molecular dynamics
parameters": {"force field": "sw"}`` (or a ``sisw`` scripts directory)
selects, as in the JAX CLI — and the clustering distance matrix through
kernel K2.  ``--cpu`` runs the same
path on the CPU (FE in float64) with the kernels' plain versions; without
it a missing CUDA device is an error, never a silent CPU run.  ``--hooke``
replaces MD with sigma = C:eps (the reference's debug mode).

Only the ``run`` subcommand and only the quick material prep are ported
(ROADMAP queue 1 lists the rest).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys
import time


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def cmd_run(args) -> int:
    import numpy as np
    import torch

    if args.cpu:
        device = torch.device("cpu")
    else:
        if not torch.cuda.is_available():
            print("error: no CUDA device available; the port runs on one "
                  "NVIDIA GPU (use --cpu for the float64 CPU reference path)",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", torch.cuda.current_device())
        # full float32 everywhere: no TF32 in matmuls or convolutions
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False

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

    t_setup = time.perf_counter()
    if cfg.bridging.approx_md_with_hookes_law or cfg.bridging.stress_method != 0:
        from .hmm.problem import build_hooke_hmm

        hmm = build_hooke_hmm(cfg, device=device)
    else:
        from .hmm.md_coupling import build_md_hmm

        # without --quick-prep this raises NotImplementedError: the staged
        # NPT prep is the next slice
        hmm = build_md_hmm(cfg, staged=not args.quick_prep, device=device)
    _sync(device)
    setup_s = time.perf_counter() - t_setup
    print(f"Problem: {cfg.problem.cls}  mesh {cfg.mesh.x_cells}x{cfg.mesh.y_cells}x"
          f"{cfg.mesh.z_cells}  qps {hmm.geom.n_qp_total}  dt {cfg.time.timestep_length}")
    print(f"Setup (mesh + material prep) {setup_s:.3f}s on {device}")
    state = hmm.init_state()

    def fe_of(s):
        return s if hasattr(s, "timestep") else s[0]

    t_total = time.perf_counter()
    for _ in range(n_steps):
        t0 = time.perf_counter()
        state, out = hmm.step(state)
        _sync(device)
        wall = time.perf_counter() - t0
        fe = fe_of(state)
        print(
            f"Timestep {fe.timestep} at time {fe.time:.6g}  "
            f"residual {float(out.residual0):.6g} -> {float(out.residual1):.6g}  "
            f"flagged qps {int(out.n_flagged)}  md jobs {int(out.n_jobs)}  "
            f"reaction {float(out.reaction_force):.6g}  ({wall:.3f}s)"
        )
        if out.cluster_saturated is not None and bool(out.cluster_saturated):
            print("note: similarity-dedup pick cap reached this step; "
                  "unreduced qps ran their own MD", file=sys.stderr)
    u = fe_of(state).u.detach().cpu().numpy().reshape(-1, 3)
    print(f"Max displacement: {np.abs(u).max():.6g} m")
    print(f"Total wall time: {time.perf_counter() - t_total:.2f}s for {n_steps} steps")
    return 0


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="scema_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)
    pr = sub.add_parser("run", help="run the coupled HMM time loop")
    pr.add_argument("config", help="reference-format inputs.json (its 'molecular dynamics "
                                   "parameters' pick the force field: opls, or sw)")
    pr.add_argument("--steps", type=int, default=0, help="override number of steps")
    pr.add_argument("--hooke", action="store_true",
                    help="force 'approximate md with hookes law' debug mode")
    pr.add_argument("--cpu", action="store_true",
                    help="run on the CPU (FE in float64) with the kernels' plain versions")
    pr.add_argument("--max-jobs", type=int, default=0,
                    help="cap the MD job-list capacity")
    pr.add_argument("--quick-prep", action="store_true",
                    help="short fixed-box material prep (FIRE + NVT); the staged "
                         "NPT prep is not ported yet")
    pr.set_defaults(fn=cmd_run)
    args = p.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
