"""Kernel lab: the all-pairs MD variants of ``scripts/probe_allpairs.py``, timed
on one NVIDIA GPU.

    python -m scema_tpu_torch.probe_allpairs [variants...] [--jobs 576] [--steps 500]

Variants (defaults v0 v1 v2 v3 v4, as the JAX lab):

* v0   the production path: ``engine.run_strain`` over the jobs (kernel K1)
       after ``equilibrate(minimize_steps=50, equil_steps=50)``, eps_zz =
       linspace(1e-4, 5e-4); v0p the same through
       ``run_strain_fused_multi`` with J = 2 jobs per block (K1m);
* v1 ... v8, v5p, v5r, v5m, v7, v7d4, v7p  the slim all-pairs LJ runs of
       ``ops.md_slim`` (P1; the levers are listed there), eps_zz = 3e-4.

Each variant runs once untimed and three times timed; the best timed run
counts.  Per variant the lab prints its time, atom-steps/s, Gpair/s (jobs x
N^2 x steps per second), the thermostat's vxi0 and 2 KE of the first
program, and whether the state stayed finite; first the card's name and
power limit (``nvidia-smi``).

The slim variants run on the prepared g0 box, v0's own state: 512
united-atom sites of one type (eps 0.118, sigma 3.905; v4's uniform sigma
is g0's), with w4e = 4 eps w from g0's special-bond weights and no bonded
terms, as in the lab.  The JAX lab's own random box
(:func:`ops.md_slim.build_inputs`) is not timed: its overlapping atoms make
it explode within a few steps (ROADMAP §3).

The lab runs on the CUDA device and raises without one; :func:`main` takes
``device="cpu"`` for the plain PyTorch versions.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .md import engine as E
from .md import material as M
from .md.homogenization import MDParams
from .ops import md_fused as MF
from .ops import md_slim as MS
from .utils.device import card_line, resolve

DEFAULT_VARIANTS = ("v0", "v1", "v2", "v3", "v4")
PRODUCTION = ("v0", "v0p")
G0 = M.MaterialSpec(name="g0", force_field="opls")
EPS_ZZ = 3e-4  # the slim runs' strain (probe_allpairs.py:680)
V0_PACK = 2  # v0p's jobs per block


def prepared_g0(device, seed: int = 0):
    """v0's box: the g0 system in float32 after FIRE 50 and NVT 50 at 300 K
    (time_v0, probe_allpairs.py:724-730)."""
    sys_, st = M.build_system(G0, dtype=torch.float32, device=device)
    params = MDParams(temperature=MS.TEMP, dt=MS.DT, strain_rate=1e-4, nsteps_sample=100)
    st = M.equilibrate(sys_, st, params, torch.Generator().manual_seed(seed),
                       minimize_steps=50, equil_steps=50)
    return sys_, st


def g0_planes(ff) -> tuple[np.ndarray, np.ndarray]:
    """(w4e, sig2) of an OPLS box, float64: 4 eps_ij w_ij with the LJ
    special-bond weights, and sigma_ij^2."""
    types = ff.types.cpu().numpy()
    eps = ff.lj_epsilon.cpu().double().numpy()[types[:, None], types[None, :]]
    sig = ff.lj_sigma.cpu().double().numpy()[types[:, None], types[None, :]]
    return 4.0 * eps * ff.pair_weights(ff.special_lj), sig * sig


def slim_box(g0):
    """One job's (state (8, NT, 128), w4e, sig2, h6) as float32 tensors on
    the box's device: the prepared g0 box ``g0`` = (system, state)."""
    sys_, st = g0
    pos, vel = st.pos.cpu().numpy(), st.vel.cpu().numpy()
    masses = sys_.masses.cpu().numpy().astype(np.float32)
    h6 = MF.h6_of(st.h).cpu().numpy()
    w4e, sig2 = g0_planes(sys_.ff)
    state = MS.pack_state(pos, vel, masses, np.float32)
    device = st.pos.device

    def t(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=device)

    return t(state), t(w4e), t(sig2), t(h6)


def slim_inputs(variant: str, n_jobs: int, n_steps: int, box):
    """The batch the lab times for a slim variant (probe_allpairs.py:680-705):
    J copies of the box per program, n_jobs // J programs, the variant's
    planes, eps_zz = 3e-4, dt 2 fs, 300 K, a zero chain."""
    state, w4e, sig2, h6 = box
    J = MS.VARIANTS[variant].jobs
    n_prog = n_jobs // J
    st = torch.cat([state] * J, 1).expand(n_prog, -1, -1, -1).contiguous()
    w, s = MS.variant_planes(variant, w4e, sig2)
    eps = [0.0, 0.0, EPS_ZZ, 0.0, 0.0, 0.0]
    fscal = torch.as_tensor(MS.make_fscal(h6.cpu().numpy(), eps), dtype=torch.float32,
                            device=state.device).expand(n_prog, -1).contiguous()
    iscal = torch.tensor([n_steps, n_steps], dtype=torch.int32,
                         device=state.device).expand(n_prog, -1).contiguous()
    return st, w, s, iscal, fscal


def production_run(variant: str, sys_, st, n_jobs: int, n_steps: int):
    """v0 (K1 through engine.run_strain) or v0p (K1m, J = 2 per block) over
    n_jobs copies of the prepared box; returns a function of no arguments
    that runs it (time_v0, probe_allpairs.py:731-755)."""
    dev = st.pos.device
    eps = torch.zeros((n_jobs, 6), dtype=torch.float32, device=dev)
    eps[:, 2] = torch.linspace(1e-4, 5e-4, n_jobs, device=dev)
    if variant == "v0":
        batch = E.MDState(*(x.expand((n_jobs,) + x.shape).contiguous()
                            for x in (st.pos, st.vel, st.h, st.vxi)))
        return lambda: E.run_strain(sys_, batch, eps, n_steps, MS.TEMP, MS.DT)
    G = n_jobs // V0_PACK
    batch = E.MDState(*(x.expand((G, V0_PACK) + x.shape).contiguous()
                        for x in (st.pos, st.vel, st.h, st.vxi)))
    epsJ = eps[:G * V0_PACK].reshape(G, V0_PACK, 6)
    n = torch.full((G, V0_PACK), n_steps, dtype=torch.int64, device=dev)
    return lambda: MF.run_strain_fused_multi(sys_.fused, batch, epsJ, n, MS.TEMP, MS.DT)


def _timed(fn, device, repeats: int):
    """(last output, best of ``repeats`` timed calls in s, untimed first call
    in s), each call ending in a device synchronise."""

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    t0 = time.perf_counter()
    out = fn()
    sync()
    first = time.perf_counter() - t0
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        sync()
        times.append(time.perf_counter() - t0)
    return out, min(times), first


def main(variants=DEFAULT_VARIANTS, n_jobs: int = MS.N_JOBS, n_steps: int = MS.N_STEPS,
         device=None, repeats: int = 3, out=print, g0=None) -> dict:
    """Time each variant; returns {variant: {"ms", "atom_steps_per_s",
    "gpair_per_s", "first_s", "vxi0", "ke2", "finite", "jobs",
    "programs"}}.  ``device`` None means the current CUDA device (an error
    without one).  ``g0`` is the prepared box (:func:`prepared_g0` on
    ``device``), made here when None."""
    device = resolve(device)
    unknown = [v for v in variants if v not in PRODUCTION and v not in MS.VARIANTS]
    if unknown:
        raise ValueError(f"probe_allpairs: unknown variants {unknown} (known: "
                         f"{list(PRODUCTION) + list(MS.VARIANTS)})")
    out(card_line(device))
    g0 = prepared_g0(device) if g0 is None else g0
    sbox = slim_box(g0) if any(v in MS.VARIANTS for v in variants) else None
    n0 = g0[0].n_atoms
    results = {}
    for v in variants:
        if v in PRODUCTION:
            res, best, first = _timed(production_run(v, *g0, n_jobs, n_steps), device, repeats)
            n = n0
            pos, vel = res.pos.reshape(-1, n, 3), res.vel.reshape(-1, n, 3)
            vxi0 = float(res.vxi.reshape(-1, MF.NHC_LEN)[0, 0])
            ke2 = float(torch.sum((g0[0].masses / MS.FTM2V)[:, None] * vel[0] * vel[0]))
            finite = bool(torch.isfinite(pos).all() and torch.isfinite(vel).all())
            jobs, programs = (1, n_jobs) if v == "v0" else (V0_PACK, n_jobs // V0_PACK)
        else:
            args = slim_inputs(v, n_jobs, n_steps, sbox)
            (st, sacc), best, first = _timed(lambda: MS.slim_run(v, *args), device, repeats)
            vxi0, ke2 = float(sacc[0, 0]), float(sacc[0, MS.NHC_LEN])
            finite = bool(torch.isfinite(st).all() and torch.isfinite(sacc).all())
            jobs, programs = MS.VARIANTS[v].jobs, args[0].shape[0]
            n = args[0].shape[2] * MS.LANE // jobs
        done = programs * jobs
        aps = done * n * n_steps / best
        gps = done * n * n * n_steps / best / 1e9
        results[v] = {"ms": best * 1e3, "atom_steps_per_s": aps, "gpair_per_s": gps,
                      "first_s": first, "vxi0": vxi0, "ke2": ke2, "finite": finite,
                      "jobs": jobs, "programs": programs}
        out(f"{v}: {best * 1e3:.3f} ms  {aps:.4e} atom-steps/s  {gps:.2f} Gpair/s  "
            f"({programs} programs x {jobs} x {n} atoms x {n_steps} steps; first run "
            f"{first:.2f}s)  vxi0={vxi0:.6g} ke2={ke2:.6g} finite={finite}")
    return results


def cli(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m scema_tpu_torch.probe_allpairs",
                                 description="Time the all-pairs MD variants on one GPU.")
    ap.add_argument("variants", nargs="*",
                    help=f"of {list(PRODUCTION) + list(MS.VARIANTS)} (default "
                         f"{' '.join(DEFAULT_VARIANTS)})")
    ap.add_argument("--jobs", type=int, default=MS.N_JOBS, help="MD jobs (boxes) per run")
    ap.add_argument("--steps", type=int, default=MS.N_STEPS, help="MD steps per run")
    args = ap.parse_args(argv)
    main(args.variants or DEFAULT_VARIANTS, n_jobs=args.jobs, n_steps=args.steps)
    return 0


if __name__ == "__main__":
    sys.exit(cli())
