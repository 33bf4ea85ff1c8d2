#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``scema_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing its own lines; any
failure exits non-zero before the result line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernel build from the sources in the checkout (nvcc, sm_90a), timed;
3. K2 (pairwise L2) against its plain PyTorch version at n = 576 and 4608,
   d = 60: max error, kernel and plain times;
4. K1 (fused all-pairs MD) against its plain version on the prepared g0 box
   (512-site united-atom alkane melt, float32): the force + virial entry at
   the stiffness probe's batch of 12, a 576-job deform run of 10 steps, a
   576-job 20-step sampling run (each job's pressure sums against float64)
   and a 576-job 100-step sampling run (stress compared statistically);
5. the slice: ``scema_tpu_torch.cli run cfg.json --quick-prep --steps 3`` on
   an empty config (the HMMConfig() dogbone: 576 qps, a 512-site box at each
   flagged qp), with every launch counter zeroed just before and read just
   after; each kernel of the path must have launched;
6. K3 (fused all-pairs MD with the charged all-atom additions) against its
   plain version on the prepared PEAA box (56 C10H22 chains, 1792 charged
   atoms, SHAKE on C-H, PME k-space split, float32): the force + virial
   entry at the stiffness probe's 12 boxes against float32 and float64, a
   128-job 10-step deform chunk with SHAKE and the frozen k-space force, the
   SHAKE residual after it, a 128-job 20-step sampling run (each job's
   pressure sums against float64), and the PME remainder's time for 128
   jobs;
7. the charged slice: ``build_md_hmm(HMMConfig(), spec=PEAA,
   equil_steps=50, minimize_steps=100)`` with at most 128 MD jobs per step,
   float32, for 2 macro-steps, its launch counters zeroed just before and
   read just after; K2 and K3 must have launched;
8. K4 (the gather-list pair loop, which also stands for the TPU's streamed
   job-grid form K4s) against its plain version on the prepared PEAA2240
   box (70 C10H22 chains, 2240 charged atoms, K ~ 1112 list slots, SHAKE,
   PME split, float32): the force + virial entry on 12 boxes against
   float32 and float64, a 16-job 10-step deform chunk with SHAKE and the
   frozen k-space force against float32 and float64, the SHAKE residual
   after it, 20-step sampling pressure sums per job against float64, no
   list row full; the kernel's and the plain version's times on a 128-job
   10-step chunk, the neighbor build's time for 128 jobs, and K3's
   all-pairs time on the same 2240-atom box (the all-pairs/list
   crossover; measured only, no gate changes);
9. the MD-throughput path of the JAX package's ``bench_md_charged_bigbox``
   on the port: ``build_system(PEAA2240)``, FIRE 30, a Maxwell draw at
   300 K, NVT 20, then 8 jobs x 100 ``run_strain`` steps of 1 fs with
   eps_zz = linspace(1e-4, 5e-4): atom-steps/s, with the MD launch counters
   zeroed just before the two timed runs and read just after; K4 alone must
   have launched;
10. the coupled list slice: ``build_md_hmm(HMMConfig(), spec=PEAA2240,
   equil_steps=50, minimize_steps=100)`` with at most 128 MD jobs per
   step, float32, 2 macro-steps, its launch counters zeroed just before
   and read just after; K2 and K4 must have launched;
11. K5 (the Stillinger-Weber sweeps) against its plain version on the
   prepared 216-atom diamond-Si box (float32): the force + virial entry at
   the stiffness probe's 12 boxes against float32 and float64, a 576-job
   10-step deform run, each job's 20-step sampling pressure sums against
   float64; K5's and the plain version's times on 576 jobs x 10 steps at
   N = 216 and at N = 512 (the largest cubic box of the fused gate), with
   the bound; the stiffness ratios of a prepared box (0.01 K) against SW
   silicon's;
12. the SW slice: ``scema_tpu_torch.cli run`` on ``{"molecular dynamics
   parameters": {"force field": "sw"}}`` with ``--quick-prep --steps 3``
   (576 qps, a 216-atom SW box at each flagged qp), every launch counter
   zeroed just before and read just after; K5 and K2 must have launched and
   K1, K3, K4 must not have; md jobs 144, 288, 432 and 0.00048 m;
13. K6 (the SW tile kernels) against their plain versions on the prepared
   4096-atom diamond-Si box (8^3 cells, 48 bricks; float32): K6d's
   moments, K6e's energy and K6c's forces + energy + virial on the
   stiffness probe's 12 boxes, orthorhombic and tilted (xy 0.4, xz 0.2 A),
   against float32 and float64; K6a (q = 0 and 0.5) and K6b on the box's
   consecutive-atom tiles; each kernel's, its plain version's and the
   bound's time on 128 jobs, the brick force call against the list route's
   autograd force call and list build; 10 deform steps of 128 jobs through
   the unfused engine on both routes from one state;
14. the brick slice: ``build_md_hmm(HMMConfig(), spec=MaterialSpec(n_cells=8,
   use_pallas_bricks=True))`` with at most 128 MD jobs per step, float32,
   quick prep, 2 macro-steps, every launch counter zeroed just before and
   read just after; K6c, K6d and K2 must have launched and no other MD
   kernel; md jobs 128, 128 and 0.00032 m;
15. the same box on the list route (no bricks) for 1 macro-step: K2 is
   the only kernel launched;
16. K1m (K1's run with J = 2 jobs per block, the coupler's pack_jobs)
   on the prepared g0 box at 576 jobs: a 10-step deform run and a 20-step
   sampling run against K1 (bit for bit expected) and against float64 at
   phase 4's tolerances, (live, dead) pairs with the dead job
   bit-identical; K1m's (J = 2 and 4), K1's and the plain version's times,
   the bound, and both kernels' registers and spill stores;
17. the staged slice: ``scema_tpu_torch.cli run cfg.json --steps 3`` on
   an empty config without ``--quick-prep`` (the staged heatup/cooldown
   NPT prep; md jobs 144, 288, 432, 0.00048 m; K1's entries and K2 only)
   and the prepared g0 density (the band of the JAX package's prep); the
   g0 prep at ns_init 60 (450-950 kg/m^3, tests/test_opls_hmm.py:69-81);
   2 macro-steps of the same built problem with pack_jobs 1, 1 again and 2
   (K1m launched, K1's run entry not; stresses within 1e-4 relative, and
   the MD layer alone bit for bit on identical inputs), and the staged
   prep of the 216-atom SW box on K5's entry (density in the band of the
   JAX package's prep).

The second-to-last line is a JSON object with one entry per kernel (K1
and K2 launches counted on the g0 slice, K3's on the charged slice, K4's
on the coupled list slice, K5's on the SW slice, K6's on the brick slice,
K1m's on phase 17's pack_jobs=2 steps;
bounds from this run's shapes and the card's published peaks); the last
line is ``{"ok": true,
"device": {...}}``.
Imports nothing of JAX.
"""
import contextlib
import dataclasses
import gc
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
# HMMConfig's MD temperature (K) and timestep (fs), at which both slices run
T_MD, DT = 300.0, 2.0
# H100 SXM published peaks (NVIDIA data sheet): HBM bytes/s, float32 FLOP/s
# outside the tensor cores
HBM_BPS, F32_FLOPS = 3.35e12, 67e12
# floating-point operations the pair function needs per unordered pair
# i < j (counted from csrc/md_allpairs.cu, which evaluates every ordered
# pair): triclinic minimum image + r^2 for every pair, the LJ force scalar
# inside the LJ cutoff, the damped erfc Coulomb scalar inside the Coulomb
# cutoff, and, inside either, applying the pair force to both atoms and,
# when the virial is sampled, its six products
FLOP_GEOM, FLOP_LJ, FLOP_EWALD, FLOP_APPLY, FLOP_VIRIAL = 26, 8, 24, 9, 12
# K5 (csrc/md_kernel.cuh sw_forces) per live unordered SW pair, beside the
# geometry of every pair: r and 1/r 2, u 3, r - rc 1, g 2, both atoms'
# moments 38, the two-body phi2' and dg 20, w in both roles 106, both
# atoms' forces 12; with sampling, both ordered pairs' virial 24
FLOP_SW, FLOP_SW_VIRIAL = 184, 24
# K1 times of the earlier, LJ-only kernel, measured on one H100 (PERF.md):
# 576 jobs x 10 deform steps, and the force + virial entry on 12 boxes
PREV_K1_MS = {"run": 6.331, "forces": 0.130}


def fail(msg: str) -> None:
    print(f"chip_smoke FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(bytes_, flops):
    """(bound_ms, bound_by): the larger of the bytes over the HBM rate and
    the operations over the float32 rate."""
    t_b, t_f = bytes_ / HBM_BPS * 1e3, flops / F32_FLOPS * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def pair_fractions(pos, h, cut2, coul_cut2=0.0):
    """Fractions of the pairs i != j of the boxes pos (B, N, 3) inside each
    cutoff, with the kernel's minimum image."""
    from scema_tpu_torch.md import box as B

    fl = fq = 0.0
    for b in range(pos.shape[0]):
        d = B.min_image_disp(h[b], pos[b][None, :, :] - pos[b][:, None, :])
        r2 = (d * d).sum(-1)
        r2.fill_diagonal_(float("inf"))
        pairs = r2.shape[0] * (r2.shape[0] - 1)
        fl += float((r2 < cut2).double().sum()) / pairs
        fq += float((r2 < coul_cut2).double().sum()) / pairs
    n = pos.shape[0]
    return fl / n, fq / n


def pair_flops(n_atoms, jobs_steps, f_lj, f_q=0.0, virial=False):
    """Operations of ``jobs_steps`` pair-force evaluations of one box over
    its N(N-1)/2 unordered pairs (the Coulomb cutoff lies inside the LJ
    one, so max(f_lj, f_q) of the pairs carry a force)."""
    per = (FLOP_GEOM + FLOP_LJ * f_lj + FLOP_EWALD * f_q
           + (FLOP_APPLY + FLOP_VIRIAL * virial) * max(f_lj, f_q))
    return n_atoms * (n_atoms - 1) / 2.0 * jobs_steps * per


def list_pair_counts(nbr, pos, h, cut2, coul_cut2):
    """Unordered pairs per box of K4's lists at positions pos (B, N, 3) in
    boxes h (B, 3, 3): (in the list, inside the LJ cutoff, inside the
    Coulomb cutoff), each averaged over the boxes — the pairs the list
    kernel's function needs, counted from this run's lists."""
    import torch

    from scema_tpu_torch.ops import md_fused as MF

    Bn, K, n = nbr["idx"].shape
    flat = nbr["idx"].long().reshape(Bn, K * n)
    h6 = MF.h6_of(h.double())
    lx, ly, lz, xy, xz, yz = (h6[:, k, None, None] for k in range(6))
    p = pos.double()
    g = [torch.gather(p[..., a], 1, flat).reshape(Bn, K, n) for a in range(3)]
    nx, ny, nz = nbr["imx"].double(), nbr["imy"].double(), nbr["imz"].double()
    dx = g[0] + nx * lx + ny * xy + nz * xz - p[..., 0][:, None]
    dy = g[1] + ny * ly + nz * yz - p[..., 1][:, None]
    dz = g[2] + nz * lz - p[..., 2][:, None]
    r2 = dx * dx + dy * dy + dz * dz
    live = nbr["idx"] != torch.arange(n, dtype=nbr["idx"].dtype, device=pos.device)
    return tuple(float(((live & m).sum() / 2.0) / Bn)
                 for m in (live, r2 < cut2, r2 < coul_cut2))


def list_flops(jobs_steps, pairs, pairs_lj, pairs_q, virial=False):
    """Operations of ``jobs_steps`` list-force evaluations, by
    :func:`pair_flops`'s rules over the list's unordered pairs."""
    return jobs_steps * (pairs * FLOP_GEOM + pairs_lj * FLOP_LJ + pairs_q * FLOP_EWALD
                         + max(pairs_lj, pairs_q) * (FLOP_APPLY + FLOP_VIRIAL * virial))


def shake_residual(sys_, pos):
    """max |r^2 - d0^2| / d0^2 over the SHAKE bonds of positions (..., N, 3),
    in float64, by direct differences as the kernel's SHAKE takes them
    (molecules stay unwrapped)."""
    import torch

    cons = sys_.constraints
    ci = torch.as_tensor(cons.idx, device=pos.device)
    d0sq = torch.as_tensor(cons.d0, device=pos.device, dtype=torch.float64) ** 2
    p = pos.double()
    rr = p[..., ci[:, 1], :] - p[..., ci[:, 0], :]
    return float(((rr * rr).sum(-1) - d0sq).abs().div(d0sq).max())


def phase_card():
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"[1 card] torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()} "
          f"python {sys.version.split()[0]}")
    return card


def phase_build():
    from scema_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib_path = _build.build()
    nvcc_s = _build.build_seconds
    _build.library()
    wall = time.perf_counter() - t0
    regs = re.findall(r"Used (\d+) registers", _build.build_log)
    spills = re.findall(r"(\d+) bytes spill stores", _build.build_log)
    print(f"[2 build] {lib_path.name} in {wall:.2f}s (nvcc {nvcc_s}s); "
          f"registers per kernel {regs}, spill stores {spills}")


def phase_k2(dev):
    import torch

    from scema_tpu_torch.ops import pairwise_l2 as K2

    gen = torch.Generator().manual_seed(2)
    worst, row = 0.0, None
    for n in (576, 4608):
        x = torch.randn((n, 60), generator=gen, dtype=torch.float32).to(dev) * 1e-3
        d = K2.pairwise_l2(x)
        ref = K2.pairwise_l2_plain(x)
        torch.cuda.synchronize()
        err = float((d - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not torch.isfinite(d).all() or rel > 1e-5 or not torch.equal(d, d.T):
            fail(f"K2 disagrees with its plain version at n={n}: rel {rel:.3e}")
        ms = cuda_ms(lambda: K2.pairwise_l2(x), reps=20)
        plain_ms = cuda_ms(lambda: K2.pairwise_l2_plain(x), reps=5)
        # one PyTorch call computing the same direct-difference matrix
        lib_ms = cuda_ms(lambda: torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist"),
                         reps=5)
        # read x once, write the matrix once; sub + FMA per element of each
        # unordered row pair (the matrix is symmetric)
        b_ms, b_by = bound(4.0 * (n * 60 + n * n), 3.0 * n * (n - 1) / 2 * 60)
        print(f"[3 K2] n={n} d=60: max_abs_err {err:.3e} (rel {rel:.3e}, tol 1e-5)  "
              f"kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  torch.cdist {lib_ms:.4f} ms  "
              f"bound {b_ms:.4f} ms ({b_by})")
        worst = max(worst, err)
        if n == 576:  # the slice's shape
            row = {"name": "pairwise_l2", "route": "cuda",
                   "source": "scema_tpu_torch/csrc/pairwise_l2.cu",
                   "replaces": "scema_tpu/ops/pairwise_pallas.py:46",
                   "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms}
    row["max_abs_err"] = worst
    return row


def phase_k1(dev):
    import torch

    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.md.homogenization import _LAMMPS_TO_FRAMEWORK
    from scema_tpu_torch.md import box as B
    from scema_tpu_torch.ops import md_fused as MF

    t0 = time.perf_counter()
    sys_, st = M.build_system(M.MaterialSpec(name="g0", force_field="opls"),
                              dtype=torch.float32, device=dev)
    st = E.minimize_fire(sys_, st, n_steps=100, dt0=0.5)
    torch.cuda.synchronize()
    print(f"[4 K1] g0 box: {sys_.n_atoms} sites, box {float(st.h[0, 0]):.3f} A, "
          f"FIRE prep {time.perf_counter() - t0:.2f}s")
    r = sys_.fused

    # force + virial entry at the stiffness probe's 12 deformed boxes
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    pos12 = B.remap_affine(st.h.expand(12, 3, 3), h12, st.pos.expand(12, -1, -1))
    p12 = pos12.transpose(1, 2).contiguous()
    h6 = MF.h6_of(h12)
    F, W = MF.md_forces_virial(r, p12, h6)
    Fp, Wp = MF.md_forces_virial_plain(r, p12, h6)
    # float64 truth: pair forces cancel (repulsive/attractive terms of ~100x
    # the net force), so float32 results are judged against float64 and the
    # kernel must be as accurate as the plain version in float32
    F64, W64 = MF.md_forces_virial_plain(r.to(dev, torch.float64), p12.double(),
                                         h6.double())
    torch.cuda.synchronize()
    f_err = float((F - Fp).abs().max())
    fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
    ek = float((F.double() - F64).abs().max()) / fmax
    ep = float((Fp.double() - F64).abs().max()) / fmax
    wk = float((W.double() - W64).abs().max()) / wmax
    wp = float((Wp.double() - W64).abs().max()) / wmax
    if not torch.isfinite(F).all() or ek > 2 * ep + 1e-6 or wk > 2 * wp + 1e-6:
        fail(f"K1 forces: kernel error vs float64 {ek:.3e} (virial {wk:.3e}) exceeds "
             f"twice the plain float32 error {ep:.3e} (virial {wp:.3e}) + 1e-6")
    ms = cuda_ms(lambda: MF.md_forces_virial(r, p12, h6), reps=20)
    plain_ms = cuda_ms(lambda: MF.md_forces_virial_plain(r, p12, h6), reps=5)
    n = sys_.n_atoms
    f_lj, _ = pair_fractions(pos12[:2], h12[:2], r.spec.cutoff2)
    fb_ms, fb_by = bound(4.0 * (2 * n * n + 16 * n + 12 * (6 * n + 12)),
                         pair_flops(n, 12, f_lj, virial=True))
    print(f"[4 K1 forces] B=12: max_abs_err vs plain {f_err:.3e}; rel error vs float64: "
          f"kernel {ek:.3e} plain-f32 {ep:.3e} (virial {wk:.3e} / {wp:.3e}; tol 2x plain "
          f"+ 1e-6)  kernel {ms:.4f} ms (earlier: {PREV_K1_MS['forces']} ms)  plain {plain_ms:.4f} ms"
          f"  bound {fb_ms:.4f} ms ({fb_by}; {f_lj:.3f} of pairs inside the cutoff)")
    forces_row = {"name": "md_allpairs_forces_virial", "route": "cuda",
                  "source": "scema_tpu_torch/csrc/md_allpairs.cu",
                  "replaces": "scema_tpu/ops/md_fused.py:1850",
                  "max_abs_err": f_err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None}

    # 576-job deform run (nts = 10), every job its own velocities and strain
    J = 576
    gen = torch.Generator().manual_seed(4)
    vel = torch.stack([E.maxwell_velocities(sys_, T_MD, gen, torch.float32, dev)
                       for _ in range(J)])
    hJ = st.h.expand(J, 3, 3).contiguous()
    state = MF.pack_state(st.pos.expand(J, -1, -1), vel)
    vxi = torch.zeros((J, 3), device=dev)
    epsJ = (torch.rand((J, 6), generator=gen) * 2e-3 - 1e-3).to(dev)
    fscal = MF.make_fscal(DT, T_MD, hJ, epsJ)
    n10 = torch.full((J,), 10, dtype=torch.int32, device=dev)
    out, xo, _ = MF.md_run(r, state, vxi, n10, fscal, True, False)
    ref, _, _ = MF.md_run_plain(r, state, vxi, n10, fscal, True, False)
    ref64, _, _ = MF.md_run_plain(r.to(dev, torch.float64), state.double(), vxi.double(),
                                  n10, fscal.double(), True, False)
    torch.cuda.synchronize()
    p_err = float((out[:, :3] - ref[:, :3]).abs().max())
    # rounding differences grow chaotically along a trajectory: the kernel's
    # float32 run must stay as close to float64 as the plain float32 run
    pk = float((out[:, :3].double() - ref64[:, :3]).abs().max())
    pp = float((ref[:, :3].double() - ref64[:, :3]).abs().max())
    vmax = float(ref64[:, 3:].abs().max())
    vk = float((out[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    vp = float((ref[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    if not torch.isfinite(out).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4:
        fail(f"K1 run: kernel error vs float64 {pk:.3e} A (velocities rel {vk:.3e}) "
             f"exceeds 4x plain float32 {pp:.3e} A ({vp:.3e}) + 1e-4")
    run_ms = cuda_ms(lambda: MF.md_run(r, state, vxi, n10, fscal, True, False), reps=3)
    run_plain_ms = cuda_ms(lambda: MF.md_run_plain(r, state, vxi, n10, fscal, True, False),
                           reps=1, warmup=0)
    rb_ms, rb_by = bound(4.0 * (2 * n * n + 16 * n + 2 * J * (6 * n + 3) + J * 16),
                         pair_flops(n, J * 10, f_lj))
    print(f"[4 K1 run] {J} jobs x 10 deform steps: positions max_abs_err vs plain "
          f"{p_err:.3e} A; vs float64: kernel {pk:.3e} A plain-f32 {pp:.3e} A, velocities "
          f"rel {vk:.3e} / {vp:.3e} (tol 4x plain + 1e-4)  kernel {run_ms:.3f} ms "
          f"(earlier: {PREV_K1_MS['run']} ms)  plain {run_plain_ms:.3f} ms  bound {rb_ms:.3f} ms "
          f"({rb_by})")

    # sampling entry, deterministic: each job's pressure sum over a 20-step
    # sampling run against float64, per Voigt component, held to the same
    # bound as the deform run
    f_s = MF.make_fscal(DT, T_MD, hJ)
    n20 = torch.full((J,), 20, dtype=torch.int32, device=dev)
    _, _, sk = MF.md_run(r, out, xo, n20, f_s, False, True)
    _, _, sp = MF.md_run_plain(r, out, xo, n20, f_s, False, True)
    _, _, s64 = MF.md_run_plain(r.to(dev, torch.float64), out.double(), xo.double(), n20,
                                f_s.double(), False, True)
    torch.cuda.synchronize()
    smax = s64.abs().amax(0)
    sk_err = float(((sk.double() - s64).abs().amax(0) / smax).max())
    sp_err = float(((sp.double() - s64).abs().amax(0) / smax).max())
    s_err = float((sk - sp).abs().max())
    if not torch.isfinite(sk).all() or sk_err > 4 * sp_err + 1e-4:
        fail(f"K1 sampling: kernel pressure sums vs float64 rel {sk_err:.3e} exceed "
             f"4x plain float32 {sp_err:.3e} + 1e-4")
    print(f"[4 K1 sample20] {J} jobs x 20 sampling steps: per-job pressure sums max_abs_err "
          f"vs plain {s_err:.3e} atm; rel to float64 (worst component): kernel {sk_err:.3e} "
          f"plain-f32 {sp_err:.3e} (tol 4x plain + 1e-4)")

    # 576-job 100-step sampling run: job-mean pressure within 4 standard errors
    n100 = torch.full((J,), 100, dtype=torch.int32, device=dev)
    t_s = {}

    def kernel_sample():
        return MF.md_run(r, out, xo, n100, f_s, False, True)

    def plain_sample():
        return MF.md_run_plain(r, out, xo, n100, f_s, False, True)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, pk = kernel_sample()
    torch.cuda.synchronize()
    t_s["kernel"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    _, _, pp = plain_sample()
    torch.cuda.synchronize()
    t_s["plain"] = (time.perf_counter() - t0) * 1e3
    pk, pp = pk.double() / 100.0, pp.double() / 100.0
    se = pp.std(0) / J ** 0.5
    diff = (pk.mean(0) - pp.mean(0)).abs()
    if not torch.isfinite(pk).all() or not bool((diff <= 4.0 * se).all()):
        fail(f"K1 sampled stress disagrees: |mean diff| {diff.tolist()} vs 4 SE "
             f"{(4 * se).tolist()}")
    print(f"[4 K1 sample] {J} jobs x 100 steps: |mean pressure diff| (atm) "
          f"{[round(x, 3) for x in diff.tolist()]} <= 4 SE {[round(4 * x, 3) for x in se.tolist()]}"
          f"  kernel {t_s['kernel']:.3f} ms  plain {t_s['plain']:.3f} ms (host clock)")
    run_row = {"name": "md_allpairs_run", "route": "cuda",
               "source": "scema_tpu_torch/csrc/md_allpairs.cu",
               "replaces": "scema_tpu/ops/md_fused.py:1850",
               "max_abs_err": p_err, "ms": run_ms, "plain_ms": run_plain_ms,
               "bound_ms": rb_ms, "bound_by": rb_by, "library_ms": None}
    return run_row, forces_row


def phase_slice(dev):
    import torch

    from scema_tpu_torch import cli
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2

    counters = {"md_allpairs_run": (MF.md_run, "launches"),
                "md_allpairs_forces_virial": (MF.md_forces_virial, "launches"),
                "md_charged_run": (MF.md_run, "launches_k3"),
                "md_charged_forces_virial": (MF.md_forces_virial, "launches_k3"),
                "pairwise_l2": (K2.pairwise_l2, "launches")}
    n_steps = 3
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        cfg = os.path.join(tmp, "cfg.json")
        with open(cfg, "w") as f:
            json.dump({}, f)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        buf = io.StringIO()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", cfg, "--quick-prep", "--steps", str(n_steps)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"    {line}")
    if rc != 0:
        fail(f"cli run exited {rc}")
    steps = re.findall(r"residual (\S+) -> (\S+)  flagged qps (\d+)  md jobs (\d+)  "
                       r"reaction (\S+)  \((\S+)s\)", text)
    setup = re.search(r"Setup \(mesh \+ material prep\) (\S+)s", text)
    umax = re.search(r"Max displacement: (\S+) m", text)
    if len(steps) != n_steps or setup is None or umax is None:
        fail("cli output is missing per-step lines, the setup time or the displacement")
    for r0, r1, nf, nj, rf, _ in steps:
        if not all(map(lambda s: abs(float(s)) < float("inf"), (r0, r1, rf))) or int(nj) <= 0:
            fail(f"a macro-step produced no MD jobs or non-finite residuals: {r0} {r1} {nj}")
    # the documented milestone: max displacement = steps * strain rate * Lz
    expect = n_steps * 0.002 * 0.08
    if abs(float(umax.group(1)) - expect) > 1e-5 * expect:
        fail(f"max displacement {umax.group(1)} != {expect}")
    for k in ("md_allpairs_run", "md_allpairs_forces_virial", "pairwise_l2"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the main path")
    step_s = [float(s[5]) for s in steps]
    jobs = [int(s[3]) for s in steps]
    print(f"[5 slice] prep (setup) {float(setup.group(1)):.3f}s  s/macro-step {step_s}  "
          f"md jobs {jobs}  launches {launches}  peak memory {peak / 2**20:.1f} MiB  "
          f"wall {wall:.2f}s")
    return launches


def phase_k3(dev):
    import torch

    from scema_tpu_torch.md import box as B
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.md.homogenization import _LAMMPS_TO_FRAMEWORK
    from scema_tpu_torch.ops import md_fused as MF

    t0 = time.perf_counter()
    sys_, st = M.build_system(M.PEAA, dtype=torch.float32, device=dev)
    r = sys_.fused
    n = sys_.n_atoms
    st = E.minimize_fire(sys_, st, n_steps=100, dt0=0.5)
    torch.cuda.synchronize()
    print(f"[6 K3] PEAA box: {n} atoms, box {float(st.h[0, 0]):.3f} A, flags {r.spec.flags}, "
          f"{len(r.spec.bonded_pattern)} bonded patterns, SHAKE offsets "
          f"{r.spec.shake_offsets}, PME mesh {sys_.ff.ewald.mesh}, build + FIRE "
          f"{time.perf_counter() - t0:.2f}s")
    r64 = r.to(dev, torch.float64)

    # force + virial entry at the stiffness probe's 12 deformed boxes
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    pos12 = B.remap_affine(st.h.expand(12, 3, 3), h12, st.pos.expand(12, -1, -1))
    p12 = pos12.transpose(1, 2).contiguous()
    h6 = MF.h6_of(h12)
    F, W = MF.md_forces_virial(r, p12, h6)
    Fp, Wp = MF.md_forces_virial_plain(r, p12, h6)
    F64, W64 = MF.md_forces_virial_plain(r64, p12.double(), h6.double())
    torch.cuda.synchronize()
    f_err = float((F - Fp).abs().max())
    # per-atom relative error: |F_i - F64_i| / |F64_i| over atoms with a
    # force above 1% of the largest
    fn = F64.norm(dim=1)
    big = fn > 0.01 * fn.max()
    pa_k = float(((F.double() - F64).norm(dim=1)[big] / fn[big]).max())
    pa_p = float(((Fp.double() - F64).norm(dim=1)[big] / fn[big]).max())
    fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
    ek = float((F.double() - F64).abs().max()) / fmax
    ep = float((Fp.double() - F64).abs().max()) / fmax
    wk = float((W.double() - W64).abs().max()) / wmax
    wp = float((Wp.double() - W64).abs().max()) / wmax
    if (not torch.isfinite(F).all() or ek > 2 * ep + 1e-6 or wk > 2 * wp + 1e-6
            or pa_k > 2 * pa_p + 1e-5):
        fail(f"K3 forces: kernel error vs float64 {ek:.3e} (per atom {pa_k:.3e}, virial "
             f"{wk:.3e}) exceeds twice the plain float32 error {ep:.3e} ({pa_p:.3e}, "
             f"{wp:.3e}) + 1e-6 (per atom 1e-5)")
    ms = cuda_ms(lambda: MF.md_forces_virial(r, p12, h6), reps=10)
    plain_ms = cuda_ms(lambda: MF.md_forces_virial_plain(r, p12, h6), reps=2)
    f_lj, f_q = pair_fractions(pos12[:2], h12[:2], r.spec.cutoff2, r.spec.coul_cutoff2)
    planes = 3 * n * n
    fb_ms, fb_by = bound(4.0 * (planes + 16 * n + 12 * (6 * n + 12)),
                         pair_flops(n, 12, f_lj, f_q, virial=True))
    print(f"[6 K3 forces] B=12: max_abs_err vs plain {f_err:.3e}; rel error vs float64: "
          f"kernel {ek:.3e} plain-f32 {ep:.3e}, worst per-atom {pa_k:.3e} / {pa_p:.3e}, "
          f"virial {wk:.3e} / {wp:.3e} (tol 2x plain + 1e-6, per atom + 1e-5)  kernel "
          f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {fb_ms:.4f} ms ({fb_by}; pairs inside "
          f"LJ {f_lj:.3f}, Coulomb {f_q:.3f})")
    forces_row = {"name": "md_charged_forces_virial", "route": "cuda",
                  "source": "scema_tpu_torch/csrc/md_allpairs.cu",
                  "replaces": "scema_tpu/ops/md_fused.py:1850",
                  "max_abs_err": f_err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None}

    # a 128-job 10-step deform chunk with SHAKE and the frozen k-space force
    J = 128
    gen = torch.Generator().manual_seed(6)
    vel = torch.stack([E.maxwell_velocities(sys_, T_MD, gen, torch.float32, dev)
                       for _ in range(J)])
    hJ = st.h.expand(J, 3, 3).contiguous()
    state = MF.pack_state(st.pos.expand(J, -1, -1), vel)
    vxi = torch.zeros((J, 3), device=dev)
    epsJ = (torch.rand((J, 6), generator=gen) * 2e-3 - 1e-3).to(dev)
    fscal = MF.make_fscal(DT, T_MD, hJ, epsJ)
    n10 = torch.full((J,), 10, dtype=torch.int32, device=dev)
    g0 = torch.zeros_like(n10)
    n_tot = torch.full_like(n10, 40)  # the first chunk of a 40-step run
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    Fk, _ = r.kspace(st.pos.expand(J, -1, -1), hJ)
    b.record()
    fk = Fk.transpose(1, 2).contiguous()
    args = (state, vxi, n10, fscal, True, False, fk, g0, n_tot)
    out, xo, _ = MF.md_run(r, *args)
    ref, _, _ = MF.md_run_plain(r, *args)
    ref64, _, _ = MF.md_run_plain(r64, state.double(), vxi.double(), n10, fscal.double(), True,
                                  False, fk.double(), g0, n_tot)
    torch.cuda.synchronize()
    p_err = float((out[:, :3] - ref[:, :3]).abs().max())
    pk = float((out[:, :3].double() - ref64[:, :3]).abs().max())
    pp = float((ref[:, :3].double() - ref64[:, :3]).abs().max())
    vmax = float(ref64[:, 3:].abs().max())
    vk = float((out[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    vp = float((ref[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    if not torch.isfinite(out).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4:
        fail(f"K3 run: kernel error vs float64 {pk:.3e} A (velocities rel {vk:.3e}) "
             f"exceeds 4x plain float32 {pp:.3e} A ({vp:.3e}) + 1e-4")
    resid = shake_residual(sys_, out[:, :3].transpose(1, 2))
    if not resid < 1e-3:
        fail(f"K3 SHAKE residual |r^2 - d0^2| / d0^2 = {resid:.3e} >= 1e-3")
    pme_ms = a.elapsed_time(b)
    run_ms = cuda_ms(lambda: MF.md_run(r, *args), reps=3)
    run_plain_ms = cuda_ms(lambda: MF.md_run_plain(r, *args), reps=1, warmup=0)
    pme_ms = min(pme_ms, cuda_ms(lambda: r.kspace(st.pos.expand(J, -1, -1), hJ), reps=3))
    f_lj, f_q = pair_fractions(st.pos[None], st.h[None], r.spec.cutoff2, r.spec.coul_cutoff2)
    rb_ms, rb_by = bound(4.0 * (planes + 16 * n + r.pat.numel() + r.shk.numel()
                                + J * (2 * 6 * n + 3 * n + 16 + 2 * 3 + 3)),
                         pair_flops(n, J * 10, f_lj, f_q))
    print(f"[6 K3 run] {J} jobs x 10 deform steps of {DT} fs, SHAKE + fext: positions max_abs_err vs "
          f"plain {p_err:.3e} A; vs float64: kernel {pk:.3e} A plain-f32 {pp:.3e} A, "
          f"velocities rel {vk:.3e} / {vp:.3e} (tol 4x plain + 1e-4); SHAKE residual "
          f"max |r^2-d0^2|/d0^2 {resid:.3e} (tol 1e-3)  kernel {run_ms:.3f} ms  plain "
          f"{run_plain_ms:.3f} ms  bound {rb_ms:.3f} ms ({rb_by}; pairs inside LJ {f_lj:.3f}, "
          f"Coulomb {f_q:.3f})")
    print(f"[6 K3 PME] k-space remainder (force) for {J} jobs: {pme_ms:.3f} ms")

    # 20-step sampling: each job's pressure sums against float64
    n20 = torch.full((J,), 20, dtype=torch.int32, device=dev)
    f_s = MF.make_fscal(DT, T_MD, hJ)
    sargs = (out, xo, n20, f_s, False, True, fk, g0, torch.ones_like(n20))
    _, _, sk = MF.md_run(r, *sargs)
    _, _, sp = MF.md_run_plain(r, *sargs)
    _, _, s64 = MF.md_run_plain(r64, out.double(), xo.double(), n20, f_s.double(), False, True,
                                fk.double(), g0, torch.ones_like(n20))
    torch.cuda.synchronize()
    smax = s64.abs().amax(0)
    sk_err = float(((sk.double() - s64).abs().amax(0) / smax).max())
    sp_err = float(((sp.double() - s64).abs().amax(0) / smax).max())
    if not torch.isfinite(sk).all() or sk_err > 4 * sp_err + 1e-4:
        fail(f"K3 sampling: kernel pressure sums vs float64 rel {sk_err:.3e} exceed "
             f"4x plain float32 {sp_err:.3e} + 1e-4")
    print(f"[6 K3 sample20] {J} jobs x 20 sampling steps: per-job pressure sums rel to "
          f"float64 (worst component): kernel {sk_err:.3e} plain-f32 {sp_err:.3e} "
          f"(tol 4x plain + 1e-4)")
    run_row = {"name": "md_charged_run", "route": "cuda",
               "source": "scema_tpu_torch/csrc/md_allpairs.cu",
               "replaces": "scema_tpu/ops/md_fused.py:1850",
               "max_abs_err": p_err, "ms": run_ms, "plain_ms": run_plain_ms,
               "bound_ms": rb_ms, "bound_by": rb_by, "library_ms": None}
    return run_row, forces_row


def phase_charged_slice(dev):
    import torch

    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2

    counters = {"md_allpairs_run": (MF.md_run, "launches"),
                "md_allpairs_forces_virial": (MF.md_forces_virial, "launches"),
                "md_charged_run": (MF.md_run, "launches_k3"),
                "md_charged_forces_virial": (MF.md_forces_virial, "launches_k3"),
                "pairwise_l2": (K2.pairwise_l2, "launches")}
    cfg = HMMConfig()
    cfg = cfg.replace(dtype="float32", md_dtype="float32",
                      resources=dataclasses.replace(cfg.resources, max_md_jobs=128))
    n_steps = 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    hmm = build_md_hmm(cfg, spec=M.PEAA, equil_steps=50, minimize_steps=100,
                       device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # time the k-space remainder inside the steps with CUDA events
    runner = hmm.backend.sys.fused
    kspace, marks = runner.kspace, []

    def timed_kspace(*a, **kw):
        ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
        ev[0].record()
        res = kspace(*a, **kw)
        ev[1].record()
        marks.append(ev)
        return res

    object.__setattr__(runner, "kspace", timed_kspace)
    state = hmm.init_state()
    step_s, jobs, pme_share = [], [], []
    for _ in range(n_steps):
        marks.clear()
        t1 = time.perf_counter()
        state, out = hmm.step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        step_s.append(wall)
        jobs.append(int(out.n_jobs))
        pme_share.append(sum(a.elapsed_time(b) for a, b in marks) / 1e3 / wall)
        if not (torch.isfinite(out.residual0) and torch.isfinite(out.residual1)) or jobs[-1] <= 0:
            fail(f"charged slice: a macro-step produced no MD jobs or non-finite residuals")
    object.__setattr__(runner, "kspace", kspace)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    umax = float(state[0].u.abs().max())
    expect = n_steps * 0.002 * 0.08
    if abs(umax - expect) > 1e-5 * expect:
        fail(f"charged slice: max displacement {umax} != {expect}")
    if launches["md_charged_run"] <= 0 or launches["md_charged_forces_virial"] <= 0 \
            or launches["pairwise_l2"] <= 0:
        fail(f"charged slice: a kernel of the path was not launched: {launches}")
    if max(jobs) > 128:
        fail(f"charged slice: {max(jobs)} MD jobs in a step, above the 128 cap")
    micro = state[1][0]
    ran = micro.pos[micro.has_run]  # (qps that ran, replicas, N, 3)
    resid = shake_residual(hmm.backend.sys, ran)
    if ran.shape[0] == 0 or not resid < 1e-3:
        fail(f"charged slice: SHAKE residual {resid:.3e} on {ran.shape[0]} MD states "
             f"(tol 1e-3)")
    print(f"[7 charged slice] {hmm.backend.sys.n_atoms}-atom PEAA boxes, qps "
          f"{hmm.geom.n_qp_total}: setup {setup_s:.3f}s  s/macro-step "
          f"{[round(x, 4) for x in step_s]}  md jobs {jobs}  PME share of the step "
          f"{[round(x, 4) for x in pme_share]}  launches {launches}  peak memory "
          f"{peak / 2**20:.1f} MiB  max displacement {umax:.6g} m (expect {expect:.6g})  "
          f"SHAKE residual max |r^2-d0^2|/d0^2 {resid:.3e} over the {ran.shape[0]} qps' MD "
          f"states (tol 1e-3)")
    return launches


def _f64(nbr):
    return {k: v if k == "idx" else v.double() for k, v in nbr.items()}


def phase_k4(dev):
    import torch

    from scema_tpu_torch.md import box as B
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.md import neighbor as NB
    from scema_tpu_torch.md.homogenization import _LAMMPS_TO_FRAMEWORK
    from scema_tpu_torch.md.units import REAL
    from scema_tpu_torch.ops import md_fused as MF

    t0 = time.perf_counter()
    sys_, st = M.build_system(M.PEAA2240, dtype=torch.float32, device=dev)
    r = sys_.fused
    n, K = sys_.n_atoms, r.spec.k
    st = E.minimize_fire(sys_, st, n_steps=100, dt0=0.5)
    torch.cuda.synchronize()
    print(f"[8 K4] PEAA2240 box: {n} atoms, box {float(st.h[0, 0]):.3f} A, flags {r.spec.flags}, "
          f"list width K={K} (r_list {r.nspec.r_list} A, rebuilt every {r.rebuild_every} steps), "
          f"PME mesh {sys_.ff.ewald.mesh}, build + FIRE {time.perf_counter() - t0:.2f}s")
    r64 = r.to(dev, torch.float64)
    n_ch = len(r.channel_names)

    # force + virial entry at the stiffness probe's 12 deformed boxes, on
    # one list built at those positions
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    pos12 = B.remap_affine(st.h.expand(12, 3, 3), h12, st.pos.expand(12, -1, -1))
    p12 = pos12.transpose(1, 2).contiguous()
    h6 = MF.h6_of(h12)
    nbr12 = r.channels(pos12, h12)
    F, W = MF.md_forces_virial(r, p12, h6, nbr=nbr12)
    Fp, Wp = MF.md_forces_virial_plain(r, p12, h6, nbr12)
    F64, W64 = MF.md_forces_virial_plain(r64, p12.double(), h6.double(), _f64(nbr12))
    torch.cuda.synchronize()
    f_err = float((F - Fp).abs().max())
    fn = F64.norm(dim=1)
    big = fn > 0.01 * fn.max()
    pa_k = float(((F.double() - F64).norm(dim=1)[big] / fn[big]).max())
    pa_p = float(((Fp.double() - F64).norm(dim=1)[big] / fn[big]).max())
    fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
    ek = float((F.double() - F64).abs().max()) / fmax
    ep = float((Fp.double() - F64).abs().max()) / fmax
    wk = float((W.double() - W64).abs().max()) / wmax
    wp = float((Wp.double() - W64).abs().max()) / wmax
    if (not torch.isfinite(F).all() or ek > 4 * ep + 1e-6 or wk > 4 * wp + 1e-6
            or pa_k > 4 * pa_p + 1e-5):
        fail(f"K4 forces: kernel error vs float64 {ek:.3e} (per atom {pa_k:.3e}, virial "
             f"{wk:.3e}) exceeds 4x the plain float32 error {ep:.3e} ({pa_p:.3e}, "
             f"{wp:.3e}) + 1e-6 (per atom 1e-5)")
    live = nbr12["idx"] != torch.arange(n, dtype=torch.int32, device=dev)
    fullest = int(live.sum(1).max())
    if fullest >= K:
        fail(f"K4: a list row is full ({fullest} live slots of K={K}): pairs may be dropped")
    ms = cuda_ms(lambda: MF.md_forces_virial(r, p12, h6, nbr=nbr12), reps=10)
    plain_ms = cuda_ms(lambda: MF.md_forces_virial_plain(r, p12, h6, nbr12), reps=2)
    lp, lj, lq = list_pair_counts(nbr12, pos12, h12, r.spec.cutoff2, r.spec.coul_cutoff2)
    # the bytes the list function needs: each job's list (idx and the three
    # image channels) and, once, the job-independent coefficient planes
    # (lj1, lj2, qq); the kernel also streams per-slot lj1/lj2/qq gathered
    # from those planes, 7 channels in all (ch_bytes per job)
    list_bytes = 4.0 * 4 * K * n
    ch_bytes = 4.0 * n_ch * K * n
    planes = 3 * n * n
    fb_ms, fb_by = bound(12 * (list_bytes + 4.0 * (3 * n + 6 + 3 * n + 6))
                         + 4.0 * (planes + r.pat.numel() + 2 * n),
                         list_flops(12, lp, lj, lq, virial=True))
    print(f"[8 K4 forces] B=12: max_abs_err vs plain {f_err:.3e}; rel error vs float64: kernel "
          f"{ek:.3e} plain-f32 {ep:.3e}, worst per-atom {pa_k:.3e} / {pa_p:.3e}, virial "
          f"{wk:.3e} / {wp:.3e} (tol 4x plain + 1e-6, per atom + 1e-5)  kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  bound {fb_ms:.4f} ms ({fb_by}; per box {lp:.0f} list pairs, "
          f"{lj:.0f} inside LJ, {lq:.0f} inside Coulomb); fullest row {fullest} of K={K} slots")
    forces_row = {"name": "md_list_forces_virial", "route": "cuda",
                  "source": "scema_tpu_torch/csrc/md_list.cu",
                  "replaces": "scema_tpu/ops/md_fused.py:1850",
                  "note": "K4 gather-list branch (pair_tile :1261, gather3 :855); also K4s, "
                          "the streamed job-grid form (md_fused.py:1678): the same kernel",
                  "max_abs_err": f_err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None}

    # a 16-job 10-step deform chunk with SHAKE and the frozen k-space force
    # against float32 and float64
    gen = torch.Generator().manual_seed(8)
    J = 128
    vel = torch.stack([E.maxwell_velocities(sys_, T_MD, gen, torch.float32, dev)
                       for _ in range(J)])
    hJ = st.h.expand(J, 3, 3).contiguous()
    posJ = st.pos.expand(J, -1, -1).contiguous()
    state = MF.pack_state(posJ, vel)
    vxi = torch.zeros((J, 3), device=dev)
    epsJ = (torch.rand((J, 6), generator=gen) * 2e-3 - 1e-3).to(dev)
    fscal = MF.make_fscal(DT, T_MD, hJ, epsJ)
    n10 = torch.full((J,), 10, dtype=torch.int32, device=dev)
    g0 = torch.zeros_like(n10)
    n_tot = torch.full_like(n10, 40)
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    nbrJ = r.channels(posJ, hJ, reuse=True)
    b.record()
    torch.cuda.synchronize()
    nb_ms = min(a.elapsed_time(b), cuda_ms(lambda: r.channels(posJ, hJ, reuse=True), reps=2))
    list_ms = cuda_ms(lambda: NB.build(r.nspec, posJ, hJ), reps=2)
    Fk, _ = r.kspace(posJ, hJ)
    fk = Fk.transpose(1, 2).contiguous()
    S = 16
    sub = (state[:S], vxi[:S], n10[:S], fscal[:S], True, False, fk[:S], g0[:S], n_tot[:S])
    nbrS = {k: v[:S] for k, v in nbrJ.items()}
    out, xo, _ = MF.md_run(r, *sub, nbr=nbrS)
    ref, _, _ = MF.md_run_plain(r, *sub, nbr=nbrS)
    ref64, _, _ = MF.md_run_plain(r64, state[:S].double(), vxi[:S].double(), n10[:S],
                                  fscal[:S].double(), True, False, fk[:S].double(), g0[:S],
                                  n_tot[:S], nbr=_f64(nbrS))
    torch.cuda.synchronize()
    p_err = float((out[:, :3] - ref[:, :3]).abs().max())
    pk = float((out[:, :3].double() - ref64[:, :3]).abs().max())
    pp = float((ref[:, :3].double() - ref64[:, :3]).abs().max())
    vmax = float(ref64[:, 3:].abs().max())
    vk = float((out[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    vp = float((ref[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    if not torch.isfinite(out).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4:
        fail(f"K4 run: kernel error vs float64 {pk:.3e} A (velocities rel {vk:.3e}) "
             f"exceeds 4x plain float32 {pp:.3e} A ({vp:.3e}) + 1e-4")
    resid = shake_residual(sys_, out[:, :3].transpose(1, 2))
    if not resid < 1e-3:
        fail(f"K4 SHAKE residual |r^2 - d0^2| / d0^2 = {resid:.3e} >= 1e-3")
    print(f"[8 K4 run16] {S} jobs x 10 deform steps of {DT} fs, SHAKE + fext: positions "
          f"max_abs_err vs plain {p_err:.3e} A; vs float64: kernel {pk:.3e} A plain-f32 "
          f"{pp:.3e} A, velocities rel {vk:.3e} / {vp:.3e} (tol 4x plain + 1e-4); SHAKE "
          f"residual max |r^2-d0^2|/d0^2 {resid:.3e} (tol 1e-3)")

    # the main path's chunk shape: 128 jobs x 10 steps, kernel and plain
    args = (state, vxi, n10, fscal, True, False, fk, g0, n_tot)
    run_ms = cuda_ms(lambda: MF.md_run(r, *args, nbr=nbrJ), reps=3)
    run_plain_ms = cuda_ms(lambda: MF.md_run_plain(r, *args, nbr=nbrJ), reps=1, warmup=0)
    lp, lj, lq = list_pair_counts({k: v[:2] for k, v in nbrJ.items()}, posJ[:2], hJ[:2],
                                  r.spec.cutoff2, r.spec.coul_cutoff2)
    rb_ms, rb_by = bound(J * (list_bytes + 4.0 * (2 * 6 * n + 3 * n + 16 + 2 * 3 + 3))
                         + 4.0 * (planes + r.pat.numel() + r.shk.numel() + 2 * n),
                         list_flops(J * 10, lp, lj, lq))
    stream_ms = J * 10 * ch_bytes / HBM_BPS * 1e3
    print(f"[8 K4 run] {J} jobs x 10 deform steps: kernel {run_ms:.3f} ms  plain "
          f"{run_plain_ms:.3f} ms  bound {rb_ms:.3f} ms ({rb_by}; inputs read once: lists "
          f"{J * list_bytes / 1e9:.3f} GB, planes {4 * planes / 1e6:.1f} MB; per box {lp:.0f} "
          f"list pairs, {lj:.0f} inside LJ, {lq:.0f} inside Coulomb)  the kernel's {n_ch} "
          f"channels re-read every step: {J * 10 * ch_bytes / 1e9:.2f} GB = {stream_ms:.3f} ms "
          f"at 3.35 TB/s")
    print(f"[8 neighbor] {J} jobs: list build + channel packing {nb_ms:.3f} ms (build alone "
          f"{list_ms:.3f} ms), {NB.jobs_per_slice(n)} jobs per slice")

    # K3 all-pairs on the same box, shapes and inputs (the crossover)
    ap = MF.make_runner(sys_.ff, sys_.masses, REAL, dtype=torch.float32, device=dev,
                        constraints=sys_.constraints, kspace=r.kspace, kspace_every=10)
    if ap.spec.kernel != "K3":
        fail(f"the all-pairs runner of the 2240-atom box is {ap.spec.kernel}, not K3")
    k3_ms = cuda_ms(lambda: MF.md_run(ap, *args), reps=3)
    k3_out, _, _ = MF.md_run(ap, *args)
    k4_out, _, _ = MF.md_run(r, *args, nbr=nbrJ)
    torch.cuda.synchronize()
    print(f"[8 crossover] N={n}, {J} jobs x 10 deform steps: K3 all-pairs {k3_ms:.3f} ms, K4 list "
          f"{run_ms:.3f} ms (+ its list build {nb_ms:.3f} ms per rebuild): K4/K3 "
          f"{(run_ms + nb_ms) / k3_ms:.3f}; max |pos K3 - K4| after the chunk "
          f"{float((k3_out[:, :3] - k4_out[:, :3]).abs().max()):.3e} A")

    # 20-step sampling at 16 jobs: each job's pressure sums against float64
    n20 = torch.full((S,), 20, dtype=torch.int32, device=dev)
    f_s = MF.make_fscal(DT, T_MD, hJ[:S])
    one = torch.ones_like(n20)
    sargs = (out, xo, n20, f_s, False, True, fk[:S], g0[:S], one)
    _, _, sk = MF.md_run(r, *sargs, nbr=nbrS)
    _, _, sp = MF.md_run_plain(r, *sargs, nbr=nbrS)
    _, _, s64 = MF.md_run_plain(r64, out.double(), xo.double(), n20, f_s.double(), False, True,
                                fk[:S].double(), g0[:S], one, nbr=_f64(nbrS))
    torch.cuda.synchronize()
    smax = s64.abs().amax(0)
    sk_err = float(((sk.double() - s64).abs().amax(0) / smax).max())
    sp_err = float(((sp.double() - s64).abs().amax(0) / smax).max())
    if not torch.isfinite(sk).all() or sk_err > 4 * sp_err + 1e-4:
        fail(f"K4 sampling: kernel pressure sums vs float64 rel {sk_err:.3e} exceed "
             f"4x plain float32 {sp_err:.3e} + 1e-4")
    print(f"[8 K4 sample20] {S} jobs x 20 sampling steps: per-job pressure sums rel to float64 "
          f"(worst component): kernel {sk_err:.3e} plain-f32 {sp_err:.3e} (tol 4x plain + 1e-4)")
    run_row = {"name": "md_list_run", "route": "cuda",
               "source": "scema_tpu_torch/csrc/md_list.cu",
               "replaces": "scema_tpu/ops/md_fused.py:1850",
               "note": "K4 gather-list branch (pair_tile :1261, gather3 :855); also K4s, the "
                       "streamed job-grid form (md_fused.py:1678): the same kernel",
               "max_abs_err": p_err, "ms": run_ms, "plain_ms": run_plain_ms,
               "bound_ms": rb_ms, "bound_by": rb_by, "library_ms": None}
    return run_row, forces_row


def phase_bench(dev):
    """The MD-throughput path of bench_md_charged_bigbox (bench.py:244-257,
    _bench_throughput :131-171) through the port's entry points."""
    import torch

    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.ops import md_fused as MF

    n_jobs, n_steps, dt, T = 8, 100, 1.0, 300.0
    t0 = time.perf_counter()
    sys_, st0 = M.build_system(M.PEAA2240, dtype=torch.float32, device=dev)
    st0 = E.minimize_fire(sys_, st0, n_steps=30, dt0=0.5)
    st0 = st0.replace(vel=E.maxwell_velocities(sys_, T, torch.Generator().manual_seed(0),
                                               torch.float32, dev))
    eps = torch.zeros((n_jobs, 6), device=dev)
    eps[:, 2] = torch.linspace(1e-4, 5e-4, n_jobs, device=dev)
    batch = E.MDState(*(x.expand((n_jobs,) + x.shape).contiguous()
                        for x in (st0.pos, st0.vel, st0.h, st0.vxi)))
    batch = E.run_strain(sys_, batch, eps * 0.0, 20, T, dt)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    counters = {"md_allpairs_run": (MF.md_run, "launches"),
                "md_charged_run": (MF.md_run, "launches_k3"),
                "md_list_run": (MF.md_run, "launches_k4")}
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    best = float("inf")
    for _ in range(2):
        t1 = time.perf_counter()
        out = E.run_strain(sys_, batch, eps, n_steps, T, dt)
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t1)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    if not torch.isfinite(out.pos).all():
        fail("bench path: non-finite positions")
    if launches["md_list_run"] <= 0 or launches["md_allpairs_run"] or launches["md_charged_run"]:
        fail(f"bench path: the timed runs did not go through K4 alone: {launches}")
    rate = n_jobs * sys_.n_atoms * n_steps / best
    print(f"[9 bench] md_charged_bigbox path: {n_jobs} jobs x {n_steps} run_strain steps of "
          f"{dt} fs, {sys_.n_atoms} atoms: best of 2 {best:.4f}s -> {rate:.6g} atom-steps/s "
          f"(setup: build + FIRE 30 + NVT 20 {setup:.2f}s)  launches in the 2 timed runs "
          f"{launches}")
    return rate


def phase_list_slice(dev):
    import torch

    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2

    counters = {"md_allpairs_run": (MF.md_run, "launches"),
                "md_allpairs_forces_virial": (MF.md_forces_virial, "launches"),
                "md_charged_run": (MF.md_run, "launches_k3"),
                "md_charged_forces_virial": (MF.md_forces_virial, "launches_k3"),
                "md_list_run": (MF.md_run, "launches_k4"),
                "md_list_forces_virial": (MF.md_forces_virial, "launches_k4"),
                "pairwise_l2": (K2.pairwise_l2, "launches")}
    cfg = HMMConfig()
    cfg = cfg.replace(dtype="float32", md_dtype="float32",
                      resources=dataclasses.replace(cfg.resources, max_md_jobs=128))
    n_steps = 2
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    hmm = build_md_hmm(cfg, spec=M.PEAA2240, equil_steps=50, minimize_steps=100, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # time the k-space remainder and the list rebuilds inside the steps
    runner = hmm.backend.sys.fused
    marks = {"kspace": [], "channels": []}
    orig = {name: getattr(runner, name) for name in marks}

    def timed(name):
        def call(*a, **kw):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            res = orig[name](*a, **kw)
            ev[1].record()
            marks[name].append(ev)
            return res
        return call

    for name in marks:
        object.__setattr__(runner, name, timed(name))
    state = hmm.init_state()
    step_s, jobs, shares = [], [], []
    for _ in range(n_steps):
        for m in marks.values():
            m.clear()
        t1 = time.perf_counter()
        state, out = hmm.step(state)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        step_s.append(wall)
        jobs.append(int(out.n_jobs))
        shares.append({k: round(sum(a.elapsed_time(b) for a, b in m) / 1e3 / wall, 4)
                       for k, m in marks.items()})
        if not (torch.isfinite(out.residual0) and torch.isfinite(out.residual1)) or jobs[-1] <= 0:
            fail("list slice: a macro-step produced no MD jobs or non-finite residuals")
    for name, fn in orig.items():
        object.__setattr__(runner, name, fn)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    umax = float(state[0].u.abs().max())
    expect = n_steps * 0.002 * 0.08
    if abs(umax - expect) > 1e-5 * expect:
        fail(f"list slice: max displacement {umax} != {expect}")
    if launches["md_list_run"] <= 0 or launches["md_list_forces_virial"] <= 0 \
            or launches["pairwise_l2"] <= 0:
        fail(f"list slice: a kernel of the path was not launched: {launches}")
    if max(jobs) > 128:
        fail(f"list slice: {max(jobs)} MD jobs in a step, above the 128 cap")
    micro = state[1][0]
    ran = micro.pos[micro.has_run]
    resid = shake_residual(hmm.backend.sys, ran)
    if ran.shape[0] == 0 or not resid < 1e-3:
        fail(f"list slice: SHAKE residual {resid:.3e} on {ran.shape[0]} MD states (tol 1e-3)")
    print(f"[10 list slice] {hmm.backend.sys.n_atoms}-atom PEAA2240 boxes on K4 (K="
          f"{runner.spec.k}), qps {hmm.geom.n_qp_total}: setup {setup_s:.3f}s  s/macro-step "
          f"{[round(x, 4) for x in step_s]}  md jobs {jobs}  share of the step (PME remainder, "
          f"list rebuilds) {shares}  launches {launches}  peak memory {peak / 2**20:.1f} MiB  "
          f"max displacement {umax:.6g} m (expect {expect:.6g})  SHAKE residual max "
          f"|r^2-d0^2|/d0^2 {resid:.3e} over the {ran.shape[0]} qps' MD states (tol 1e-3)")
    return launches


def sw_live_pairs(pos, h, rc2):
    """Unordered pairs per box inside K5's mask (r2 < rc2, r2 > 1e-8) of
    boxes pos (B, N, 3) in h (B, 3, 3), averaged over the boxes, in
    float64 — the pairs the SW function needs arithmetic for."""
    from scema_tpu_torch.md import box as B

    tot = 0.0
    for b in range(pos.shape[0]):
        p = pos[b].double()
        d = B.min_image_disp(h[b].double(), p[None, :, :] - p[:, None, :])
        r2 = (d * d).sum(-1)
        tot += float(((r2 < rc2) & (r2 > 1e-8)).sum()) / 2.0
    return tot / pos.shape[0]


def sw_flops(n_atoms, jobs_steps, live, virial=False):
    """Operations of ``jobs_steps`` SW force calls on one box: the geometry
    of its N(N-1)/2 unordered pairs, and the SW arithmetic on its ``live``
    ones."""
    return jobs_steps * (n_atoms * (n_atoms - 1) / 2.0 * FLOP_GEOM
                         + live * (FLOP_SW + FLOP_SW_VIRIAL * virial))


def _sw_run_batch(sys_, st, J, seed, dev):
    """J jobs of one prepared box with their own Maxwell velocities and
    random strains of at most 1e-3: (state, vxi, h, fscal)."""
    import torch

    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.ops import md_fused as MF

    gen = torch.Generator().manual_seed(seed)
    vel = torch.stack([E.maxwell_velocities(sys_, T_MD, gen, torch.float32, dev)
                       for _ in range(J)])
    hJ = st.h.expand(J, 3, 3).contiguous()
    state = MF.pack_state(st.pos.expand(J, -1, -1), vel)
    eps = (torch.rand((J, 6), generator=gen) * 2e-3 - 1e-3).to(dev)
    return state, torch.zeros((J, 3), device=dev), hJ, MF.make_fscal(DT, T_MD, hJ, eps)


def phase_k5(dev):
    import torch

    from scema_tpu_torch.md import box as B
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.md.homogenization import _LAMMPS_TO_FRAMEWORK, MDParams
    from scema_tpu_torch.ops import md_fused as MF

    t0 = time.perf_counter()
    sys_, st = M.build_system(M.MaterialSpec(name="si", force_field="sw"), dtype=torch.float32,
                              device=dev)
    r = sys_.fused
    n = sys_.n_atoms
    # the slice's quick prep: FIRE 100, a Maxwell draw, NVT 100 at 300 K
    st = M.equilibrate(sys_, st, MDParams(temperature=T_MD, dt=DT, strain_rate=1e-4,
                                          nsteps_sample=100),
                       torch.Generator().manual_seed(11), minimize_steps=100, equil_steps=100)
    torch.cuda.synchronize()
    print(f"[11 K5] SW box: {n} atoms, box {float(st.h[0, 0]):.3f} A, flags {r.spec.flags}, "
          f"cutoff {r.spec.cutoff2 ** 0.5:.4f} A, prep (FIRE 100 + NVT 100 at {T_MD} K) "
          f"{time.perf_counter() - t0:.2f}s")
    r64 = r.to(dev, torch.float64)
    rc2 = MF.sw_consts(r.spec)["rc2"]

    # force + virial entry at the stiffness probe's 12 deformed boxes
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    pos12 = B.remap_affine(st.h.expand(12, 3, 3), h12, st.pos.expand(12, -1, -1))
    p12 = pos12.transpose(1, 2).contiguous()
    h6 = MF.h6_of(h12)
    F, W = MF.md_forces_virial(r, p12, h6)
    Fp, Wp = MF.md_forces_virial_plain(r, p12, h6)
    F64, W64 = MF.md_forces_virial_plain(r64, p12.double(), h6.double())
    torch.cuda.synchronize()
    f_err = float((F - Fp).abs().max())
    fn = F64.norm(dim=1)
    big = fn > 0.01 * fn.max()
    pa_k = float(((F.double() - F64).norm(dim=1)[big] / fn[big]).max())
    pa_p = float(((Fp.double() - F64).norm(dim=1)[big] / fn[big]).max())
    fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
    ek = float((F.double() - F64).abs().max()) / fmax
    ep = float((Fp.double() - F64).abs().max()) / fmax
    wk = float((W.double() - W64).abs().max()) / wmax
    wp = float((Wp.double() - W64).abs().max()) / wmax
    if (not torch.isfinite(F).all() or ek > 2 * ep + 1e-6 or wk > 2 * wp + 1e-6
            or pa_k > 2 * pa_p + 1e-5):
        fail(f"K5 forces: kernel error vs float64 {ek:.3e} (per atom {pa_k:.3e}, virial "
             f"{wk:.3e}) exceeds twice the plain float32 error {ep:.3e} ({pa_p:.3e}, "
             f"{wp:.3e}) + 1e-6 (per atom 1e-5)")
    ms = cuda_ms(lambda: MF.md_forces_virial(r, p12, h6), reps=20)
    plain_ms = cuda_ms(lambda: MF.md_forces_virial_plain(r, p12, h6), reps=5)
    live12 = sw_live_pairs(pos12[:2], h12[:2], rc2)
    fb_ms, fb_by = bound(4.0 * (2 * 12 * (3 * n + 6)), sw_flops(n, 12, live12, virial=True))
    print(f"[11 K5 forces] B=12: max_abs_err vs plain {f_err:.3e}; rel error vs float64: "
          f"kernel {ek:.3e} plain-f32 {ep:.3e}, worst per-atom {pa_k:.3e} / {pa_p:.3e}, "
          f"virial {wk:.3e} / {wp:.3e} (tol 2x plain + 1e-6, per atom + 1e-5)  kernel "
          f"{ms:.4f} ms  plain {plain_ms:.4f} ms  bound {fb_ms:.5f} ms ({fb_by}; {live12:.1f} "
          f"live of {n * (n - 1) // 2} pairs per box)")
    forces_row = {"name": "md_sw_forces", "route": "cuda",
                  "source": "scema_tpu_torch/csrc/md_sw.cu",
                  "replaces": "scema_tpu/ops/md_fused.py:1850",
                  "note": "K5: FusedSpec.sw -> forces_allpairs_sw (md_fused.py:910-1081)",
                  "max_abs_err": f_err, "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None}

    # the main path's run shape: 576 jobs x 10 deform steps
    J = 576
    state, vxi, hJ, fscal = _sw_run_batch(sys_, st, J, 12, dev)
    n10 = torch.full((J,), 10, dtype=torch.int32, device=dev)
    out, xo, _ = MF.md_run(r, state, vxi, n10, fscal, True, False)
    ref, _, _ = MF.md_run_plain(r, state, vxi, n10, fscal, True, False)
    ref64, _, _ = MF.md_run_plain(r64, state.double(), vxi.double(), n10, fscal.double(), True,
                                  False)
    torch.cuda.synchronize()
    p_err = float((out[:, :3] - ref[:, :3]).abs().max())
    pk = float((out[:, :3].double() - ref64[:, :3]).abs().max())
    pp = float((ref[:, :3].double() - ref64[:, :3]).abs().max())
    vmax = float(ref64[:, 3:].abs().max())
    vk = float((out[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    vp = float((ref[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    if not torch.isfinite(out).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4:
        fail(f"K5 run: kernel error vs float64 {pk:.3e} A (velocities rel {vk:.3e}) "
             f"exceeds 4x plain float32 {pp:.3e} A ({vp:.3e}) + 1e-4")
    print(f"[11 K5 run] {J} jobs x 10 deform steps of {DT} fs: positions max_abs_err vs plain "
          f"{p_err:.3e} A; vs float64: kernel {pk:.3e} A plain-f32 {pp:.3e} A, velocities rel "
          f"{vk:.3e} / {vp:.3e} (tol 4x plain + 1e-4)")

    # 20-step sampling: each job's pressure sums against float64
    n20 = torch.full((J,), 20, dtype=torch.int32, device=dev)
    f_s = MF.make_fscal(DT, T_MD, hJ)
    _, _, sk = MF.md_run(r, out, xo, n20, f_s, False, True)
    _, _, sp = MF.md_run_plain(r, out, xo, n20, f_s, False, True)
    _, _, s64 = MF.md_run_plain(r64, out.double(), xo.double(), n20, f_s.double(), False, True)
    torch.cuda.synchronize()
    smax = s64.abs().amax(0)
    sk_err = float(((sk.double() - s64).abs().amax(0) / smax).max())
    sp_err = float(((sp.double() - s64).abs().amax(0) / smax).max())
    if not torch.isfinite(sk).all() or sk_err > 4 * sp_err + 1e-4:
        fail(f"K5 sampling: kernel pressure sums vs float64 rel {sk_err:.3e} exceed "
             f"4x plain float32 {sp_err:.3e} + 1e-4")
    print(f"[11 K5 sample20] {J} jobs x 20 sampling steps: per-job pressure sums rel to "
          f"float64 (worst component): kernel {sk_err:.3e} plain-f32 {sp_err:.3e} "
          f"(tol 4x plain + 1e-4)")

    # times at N = 216 and at the fused gate's largest cubic box, N = 512
    times = {}
    for cells in (3, 4):
        if cells == 3:
            sys_c, st_c = sys_, st
        else:
            sys_c, st_c = M.build_system(M.MaterialSpec(name="si", n_cells=4),
                                         dtype=torch.float32, device=dev)
            st_c = M.equilibrate(sys_c, st_c, MDParams(temperature=T_MD, dt=DT,
                                                       strain_rate=1e-4, nsteps_sample=100),
                                 torch.Generator().manual_seed(13), minimize_steps=0,
                                 equil_steps=100)
        rc_ = sys_c.fused
        nc = sys_c.n_atoms
        args = _sw_run_batch(sys_c, st_c, J, 14, dev)
        a = (args[0], args[1], n10, args[3], True, False)
        k_ms = cuda_ms(lambda: MF.md_run(rc_, *a), reps=3)
        p_ms = cuda_ms(lambda: MF.md_run_plain(rc_, *a), reps=1, warmup=0)
        live = sw_live_pairs(st_c.pos[None], st_c.h[None], rc2)
        b_ms, b_by = bound(4.0 * (J * (2 * (6 * nc + 3) + 16 + 6) + 2 * nc),
                           sw_flops(nc, J * 10, live))
        times[nc] = (k_ms, p_ms, b_ms, b_by)
        print(f"[11 K5 time] N={nc}, {J} jobs x 10 deform steps: kernel {k_ms:.3f} ms  plain "
              f"{p_ms:.3f} ms  bound {b_ms:.4f} ms ({b_by}; {live:.1f} live of "
              f"{nc * (nc - 1) // 2} pairs per box)  kernel at {100 * b_ms / k_ms:.2f}% of "
              f"its bound")

    # the prepared box's elastic constants against SW silicon's ratios (the
    # CPU suite's bounds; C11 151.4, C12 76.4, C44 56.4 GPa)
    p_cold = MDParams(temperature=0.01, dt=0.002, strain_rate=1e-3, nsteps_sample=50)
    sys_s, st_s = M.build_system(M.MaterialSpec(name="si", force_field="sw"),
                                 dtype=torch.float32, device=dev)
    st_s = M.equilibrate(sys_s, st_s, p_cold, torch.Generator().manual_seed(15),
                         minimize_steps=50, equil_steps=50)
    data = M.measure(sys_s, st_s, p_cold)
    C = data.stiff
    r12, r44 = C[0, 1] / C[0, 0], C[3, 3] / C[0, 0]
    ok = (abs(data.density / 2329.0 - 1.0) <= 0.01 and abs(r12 / (76.4 / 151.4) - 1.0) <= 0.08
          and abs(r44 / (56.4 / 151.4) - 1.0) <= 0.25)
    print(f"[11 K5 elastic] 216-atom box at 0.01 K, float32: density {data.density:.2f} kg/m^3, "
          f"C11 {C[0, 0]:.4e} Pa, C12/C11 {r12:.4f} (SW Si {76.4 / 151.4:.4f}, tol 8%), "
          f"C44/C11 {r44:.4f} ({56.4 / 151.4:.4f}, tol 25%)")
    if not ok:
        fail("K5: the prepared box's density or elastic ratios are off SW silicon's")
    k216, p216, b216, by216 = times[216]
    k512, p512, b512, _ = times[512]
    run_row = {"name": "md_sw_run", "route": "cuda", "source": "scema_tpu_torch/csrc/md_sw.cu",
               "replaces": "scema_tpu/ops/md_fused.py:1850",
               "note": "K5: FusedSpec.sw -> forces_allpairs_sw (md_fused.py:910-1081); "
                       "576 jobs x 10 deform steps at N=216, and at N=512 in *_n512",
               "max_abs_err": p_err, "ms": k216, "plain_ms": p216, "bound_ms": b216,
               "bound_by": by216, "library_ms": None, "ms_n512": k512,
               "plain_ms_n512": p512, "bound_ms_n512": b512}
    return run_row, forces_row


def phase_sw_slice(dev):
    import torch

    from scema_tpu_torch import cli
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2

    counters = {"md_allpairs_run": (MF.md_run, "launches"),
                "md_allpairs_forces_virial": (MF.md_forces_virial, "launches"),
                "md_charged_run": (MF.md_run, "launches_k3"),
                "md_charged_forces_virial": (MF.md_forces_virial, "launches_k3"),
                "md_list_run": (MF.md_run, "launches_k4"),
                "md_list_forces_virial": (MF.md_forces_virial, "launches_k4"),
                "md_sw_run": (MF.md_run, "launches_k5"),
                "md_sw_forces": (MF.md_forces_virial, "launches_k5"),
                "pairwise_l2": (K2.pairwise_l2, "launches")}
    n_steps = 3
    gc.collect()  # the earlier phases' runners (the list slice's 9 GB of channels)
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        cfg = os.path.join(tmp, "cfg.json")
        with open(cfg, "w") as f:
            json.dump({"molecular dynamics parameters": {"force field": "sw"}}, f)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        buf = io.StringIO()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", cfg, "--quick-prep", "--steps", str(n_steps)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"    {line}")
    if rc != 0:
        fail(f"SW slice: cli run exited {rc}")
    steps = re.findall(r"residual (\S+) -> (\S+)  flagged qps (\d+)  md jobs (\d+)  "
                       r"reaction (\S+)  \((\S+)s\)", text)
    setup = re.search(r"Setup \(mesh \+ material prep\) (\S+)s", text)
    umax = re.search(r"Max displacement: (\S+) m", text)
    if len(steps) != n_steps or setup is None or umax is None:
        fail("SW slice: cli output is missing per-step lines, the setup time or the displacement")
    for r0, r1, _, _, rf, _ in steps:
        if not all(abs(float(x)) < float("inf") for x in (r0, r1, rf)):
            fail(f"SW slice: non-finite residuals {r0} {r1} {rf}")
    jobs = [int(s[3]) for s in steps]
    if jobs != [144, 288, 432]:
        fail(f"SW slice: md jobs {jobs}, expected [144, 288, 432]")
    expect = n_steps * 0.002 * 0.08
    if abs(float(umax.group(1)) - expect) > 1e-5 * expect:
        fail(f"SW slice: max displacement {umax.group(1)} != {expect}")
    for k in ("md_sw_run", "md_sw_forces", "pairwise_l2"):
        if launches[k] <= 0:
            fail(f"SW slice: kernel {k} was not launched by the main path")
    others = {k: v for k, v in launches.items() if not k.startswith(("md_sw", "pairwise"))}
    if any(others.values()):
        fail(f"SW slice: kernels of other paths were launched: {others}")
    step_s = [float(s[5]) for s in steps]
    print(f"[12 sw slice] prep (setup) {float(setup.group(1)):.3f}s  s/macro-step {step_s}  "
          f"md jobs {jobs}  launches {launches}  peak memory {peak / 2**20:.1f} MiB  "
          f"wall {wall:.2f}s  max displacement {umax.group(1)} m (expect {expect:.6g})")
    return launches


# K6 per live unordered pair (csrc/sw_bricks.cu), beside the geometry of
# every candidate pair of the tile lists: the moments kernel r and 1/r 2, u
# 3, r - rc 1, g 2, the two-body energy 8, both atoms' moments 38; the
# forces kernel r, u, r - rc and g 8, phi2' and dg 20, w in both roles 106,
# both atoms' forces 12, role 1's virial for both ordered pairs 24
FLOP_K6_MOM, FLOP_K6_FRC = 54, 170
# the brick slice: the smallest cubic diamond box on which the 27-stencil
# prunes (8^3 cells, 4096 atoms), at most 128 MD jobs per macro-step
SW_BIG_CELLS, SW_BIG_JOBS = 8, 128


def tile_candidates(occ, nbr, valid):
    """Unordered candidate pairs of a tile list: occupied slot pairs of
    every valid (tile, entry), less each slot with itself."""
    import torch

    cnt = occ.double().sum(-1)  # (C,) occupied slots per tile
    nb, va = nbr.long(), valid.bool()
    ordered = float((cnt[:, None] * cnt[nb] * va).sum())
    same = float((cnt * ((nb == torch.arange(nbr.shape[0], device=nbr.device)[:, None])
                         & va).sum(-1)).sum())
    return (ordered - same) / 2.0


def k6_flops(cand, live, per_live):
    """Operations of one K6 kernel call on one box: the geometry of its
    candidate pairs and ``per_live`` per live pair."""
    return cand * FLOP_GEOM + live * per_live


def _rel(a, ref):
    return float((a.double() - ref).abs().max()) / max(float(ref.abs().max()), 1e-300)


def phase_k6(dev):
    import torch

    from scema_tpu_torch.md import box as B
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.md.homogenization import _LAMMPS_TO_FRAMEWORK, MDParams
    from scema_tpu_torch.ops import sw_bricks as SWB

    t_phase = time.perf_counter()
    sys_b, st = M.build_system(M.MaterialSpec(name="si", n_cells=SW_BIG_CELLS,
                                              use_pallas_bricks=True),
                               dtype=torch.float32, device=dev)
    sys_l, _ = M.build_system(M.MaterialSpec(name="si", n_cells=SW_BIG_CELLS, use_fused=False),
                              dtype=torch.float32, device=dev)
    ff, sw = sys_b.ff, sys_b.ff.sw
    n, C = sys_b.n_atoms, ff.n_bricks
    occ = ff.slot_ids < n
    st = M.equilibrate(sys_b, st, MDParams(temperature=T_MD, dt=DT, strain_rate=1e-4,
                                           nsteps_sample=100),
                       torch.Generator().manual_seed(16), minimize_steps=100, equil_steps=100)
    torch.cuda.synchronize()
    rc2 = SWB.sw_consts(sw)["rc2"]
    cand = tile_candidates(occ, ff.nbr, ff.valid)
    print(f"[13 K6] SW box: {n} atoms, box {float(st.h[0, 0]):.3f} A, {C} bricks of "
          f"{int(occ.sum(1).min())}-{int(occ.sum(1).max())} atoms, "
          f"{int(ff.valid.sum(1).min())}-{int(ff.valid.sum(1).max())} stencil entries, "
          f"{cand:.0f} unordered candidate pairs; prep on the bricks (FIRE 100 + NVT 100 at "
          f"{T_MD} K) {time.perf_counter() - t_phase:.2f}s")

    # the stiffness probe's 12 boxes, orthorhombic and tilted (xy 0.4, xz 0.2 A)
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    sl = (ff.slot_ids, ff.nbr, ff.valid)
    worst = {"K6d": 0.0, "K6c": 0.0, "K6e": 0.0}
    for tilt in (0.0, 0.4):
        ht = h12.clone()
        ht[:, 0, 1] += tilt
        ht[:, 0, 2] += 0.5 * tilt
        p12 = B.remap_affine(st.h.expand(12, 3, 3), ht, st.pos.expand(12, -1, -1)).contiguous()
        mom = SWB.sw_moments_bricks(sw, p12, ht, *sl)
        mom_p = SWB.sw_moments_bricks(sw, p12, ht, *sl, plain=True)
        mom64 = SWB.sw_moments_bricks(sw, p12.double(), ht.double(), *sl, plain=True)
        e_k = SWB.sw_energy_bricks(sw, p12, ht, *sl)
        e64 = SWB.energy_from_moments(sw, mom64)
        F, E_, W = SWB.sw_forces_bricks(sw, p12, ht, *sl, atom_slot=ff.atom_slot)
        Fp, Ep, Wp = SWB.sw_forces_bricks(sw, p12, ht, *sl, atom_slot=ff.atom_slot, plain=True)
        F64, E64, W64 = SWB.sw_forces_bricks(sw, p12.double(), ht.double(), *sl,
                                             atom_slot=ff.atom_slot, plain=True)
        torch.cuda.synchronize()
        mk, mp = _rel(mom, mom64), _rel(mom_p, mom64)
        ek = float(((e_k.double() - e64).abs() / e64.abs()).max())
        ep = float(((SWB.energy_from_moments(sw, mom_p).double() - e64).abs() / e64.abs()).max())
        fk, fp = _rel(F, F64), _rel(Fp, F64)
        wk, wp = _rel(W, W64), _rel(Wp, W64)
        bad = (not (torch.isfinite(F).all() and torch.isfinite(mom).all())
               or mk > 2 * mp + 1e-6 or ek > 2 * ep + 1e-6 or fk > 2 * fp + 1e-6
               or wk > 2 * wp + 1e-6)
        print(f"[13 K6 check] 12 boxes, tilt xy {tilt} xz {0.5 * tilt} A: rel error vs float64 "
              f"(kernel / plain float32): K6d moments {mk:.3e} / {mp:.3e}, K6e energy {ek:.3e} / "
              f"{ep:.3e}, K6c forces {fk:.3e} / {fp:.3e}, virial {wk:.3e} / {wp:.3e} (tol 2x "
              f"plain + 1e-6); max_abs_err vs plain f32: moments "
              f"{float((mom - mom_p).abs().max()):.3e}, forces {float((F - Fp).abs().max()):.3e}")
        if bad:
            fail(f"K6 disagrees with its plain version (tilt {tilt})")
        worst["K6d"] = max(worst["K6d"], float((mom - mom_p).abs().max()))
        worst["K6c"] = max(worst["K6c"], float((F - Fp).abs().max()))
        worst["K6e"] = max(worst["K6e"], float((e_k - SWB.energy_from_moments(sw, mom_p))
                                               .abs().max()))

    # K6a (all tile pairs, general q: q = 0 and q = 0.5) and K6b (tile
    # adjacency) on the same box's consecutive-atom tiles
    import dataclasses as dc

    pos1, h1 = st.pos[None], st.h[None]
    nbr_b, val_b = SWB.tile_adjacency(st.pos.double().cpu().numpy(),
                                      st.h.double().cpu().numpy(), sw.cutoff)
    tiles1 = SWB.pack_tiles(pos1)
    hh1, ih1 = SWB.boxes(h1, (1,), torch.float32, dev)
    rows = {}
    for name, sw_x, lst in (("K6a", sw, SWB.all_tile_pairs(tiles1.shape[1])),
                            ("K6a_q", dc.replace(sw, q=0.5), SWB.all_tile_pairs(tiles1.shape[1])),
                            ("K6b", sw, (nbr_b, val_b))):
        nb = torch.as_tensor(lst[0], device=dev)
        va = torch.as_tensor(lst[1], device=dev)
        if name == "K6b":
            mk_ = SWB.sw_moments_adj(sw_x, pos1, h1, nb, va)
        else:
            mk_ = SWB.sw_moments(sw_x, pos1, h1)
        mp_ = SWB.sw_moments_plain(sw_x, tiles1, nb, va, hh1, ih1)
        m64 = SWB.sw_moments_plain(sw_x, tiles1.double(), nb, va, hh1.double(), ih1.double())
        torch.cuda.synchronize()
        e1, e2 = _rel(mk_, m64), _rel(mp_, m64)
        print(f"[13 {name}] {tiles1.shape[1]} tiles x {nb.shape[1]} entries "
              f"({int(va.sum())} valid), q = {sw_x.q}: moments rel error vs float64 kernel "
              f"{e1:.3e} plain-f32 {e2:.3e} (tol 2x plain + 1e-6)")
        if not torch.isfinite(mk_).all() or e1 > 2 * e2 + 1e-6:
            fail(f"{name} disagrees with its plain version")
        rows[name] = (float((mk_ - mp_).abs().max()), nb, va)

    # times at the slice's shape: 128 jobs of the prepared box
    J = SW_BIG_JOBS
    gen = torch.Generator().manual_seed(17)
    vel = torch.stack([E.maxwell_velocities(sys_b, T_MD, gen, torch.float32, dev)
                       for _ in range(J)])
    hJ = st.h.expand(J, 3, 3).contiguous()
    pJ = st.pos.expand(J, -1, -1).contiguous()
    live = sw_live_pairs(pJ[:2], hJ[:2], rc2)
    tilesJ = SWB.pack_bricks(pJ, ff.slot_ids)
    hhJ, ihJ = SWB.boxes(hJ, (J,), torch.float32, dev)
    momJ = SWB._launch_moments(sw, tilesJ, ff.nbr, ff.valid, hhJ, ihJ)
    adjJ = SWB.adjoints(sw, momJ)
    slot_bytes = 4.0 * J * C * 128
    t = {}
    t["K6d"] = (cuda_ms(lambda: SWB._launch_moments(sw, tilesJ, ff.nbr, ff.valid, hhJ, ihJ), 10),
                cuda_ms(lambda: SWB.sw_moments_plain(sw, tilesJ, ff.nbr, ff.valid, hhJ, ihJ), 2),
                *bound(slot_bytes * (4 + 12), J * k6_flops(cand, live, FLOP_K6_MOM)))
    t["K6c"] = (cuda_ms(lambda: SWB._launch_forces(sw, tilesJ, adjJ, ff.nbr, ff.valid, hhJ, ihJ),
                        10),
                cuda_ms(lambda: SWB.sw_forces_plain(sw, tilesJ, adjJ, ff.nbr, ff.valid, hhJ,
                                                    ihJ), 2),
                *bound(slot_bytes * (4 + 11 + 9), J * k6_flops(cand, live, FLOP_K6_FRC)))
    t["K6e"] = (cuda_ms(lambda: SWB.sw_energy_bricks(sw, pJ, hJ, *sl), 10),
                cuda_ms(lambda: SWB.sw_energy_bricks(sw, pJ, hJ, *sl, plain=True), 2),
                *bound(4.0 * J * 3 * n + 4.0 * J, J * k6_flops(cand, live, FLOP_K6_MOM)))
    for name in ("K6a", "K6b"):
        _, nb, va = rows[name]
        tl = SWB.pack_tiles(pJ)
        cand_x = tile_candidates(tl[0, :, 3] > 0.5, nb, va)
        t[name] = (cuda_ms(lambda: SWB._launch_moments(sw, tl, nb.int(), va.int(), hhJ, ihJ), 3),
                   cuda_ms(lambda: SWB.sw_moments_plain(sw, tl, nb, va, hhJ, ihJ), 1, warmup=0),
                   *bound(4.0 * J * tl.shape[1] * 128 * 16, J * k6_flops(cand_x, live,
                                                                         FLOP_K6_MOM)))
    for name, (k_ms, p_ms, b_ms, b_by) in t.items():
        print(f"[13 {name} time] {J} jobs x {n} atoms: kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms  "
              f"bound {b_ms:.4f} ms ({b_by}; {live:.1f} live pairs per box)  kernel at "
              f"{100 * b_ms / k_ms:.2f}% of its bound")
    # the force call of the unfused engine on both routes
    fc_ms = cuda_ms(lambda: SWB.sw_forces_bricks(sw, pJ, hJ, *sl, atom_slot=ff.atom_slot), 10)
    fc_plain = cuda_ms(lambda: SWB.sw_forces_bricks(sw, pJ, hJ, *sl, atom_slot=ff.atom_slot,
                                                    plain=True), 2)
    nbrJ = sys_l.build_neighbors(pJ, hJ)
    nb_ms = cuda_ms(lambda: sys_l.build_neighbors(pJ, hJ), 2)
    list_ms = cuda_ms(lambda: E.forces(sys_l, pJ, hJ, nbrJ), 5)
    print(f"[13 K6 force call] {J} jobs: bricks (K6d + adjoints + K6c + gather) {fc_ms:.3f} ms  "
          f"plain {fc_plain:.3f} ms; list route (autograd of SW.energy over the 20-slot list) "
          f"{list_ms:.3f} ms + the list build {nb_ms:.3f} ms per rebuild")
    del nbrJ

    # 10 deform steps of the 128 jobs on both routes from one state
    epsJ = (torch.rand((J, 6), generator=gen) * 2e-3 - 1e-3).to(dev)
    stJ = E.MDState(pos=pJ, vel=vel, h=hJ, vxi=torch.zeros((J, 3), device=dev))
    t0 = time.perf_counter()
    ob = E.run_strain(sys_b, stJ, epsJ, 10, T_MD, DT)
    torch.cuda.synchronize()
    tb = time.perf_counter() - t0
    t0 = time.perf_counter()
    ol = E.run_strain(sys_l, stJ, epsJ, 10, T_MD, DT)
    torch.cuda.synchronize()
    tl_ = time.perf_counter() - t0
    dpos = float((ob.pos - ol.pos).abs().max())
    dh = float((ob.h - ol.h).abs().max())
    print(f"[13 K6 routes] {J} jobs x 10 deform steps: bricks {tb:.3f}s, list {tl_:.3f}s; "
          f"positions max |bricks - list| {dpos:.3e} A (tol 1e-3), boxes {dh:.3e} A")
    if not (torch.isfinite(ob.pos).all() and dpos < 1e-3 and dh < 1e-5):
        fail(f"the brick and list routes disagree after 10 steps: {dpos:.3e} A")
    print(f"[13 K6] phase wall {time.perf_counter() - t_phase:.2f}s")

    src = "scema_tpu_torch/csrc/sw_bricks.cu"
    out = {}
    for name, fn, rep, err in (
            ("K6d", "sw_moments_bricks", "scema_tpu/ops/sw_pallas.py:674", worst["K6d"]),
            ("K6c", "sw_forces_bricks", "scema_tpu/ops/sw_pallas.py:585", worst["K6c"]),
            ("K6e", "sw_energy_bricks", "scema_tpu/ops/sw_pallas.py:707", worst["K6e"]),
            ("K6a", "sw_moments", "scema_tpu/ops/sw_pallas.py:133",
             max(rows["K6a"][0], rows["K6a_q"][0])),
            ("K6b", "sw_moments_adj", "scema_tpu/ops/sw_pallas.py:311", rows["K6b"][0])):
        k_ms, p_ms, b_ms, b_by = t[name]
        out[fn] = {"name": fn, "route": "cuda", "source": src, "replaces": rep,
                   "note": f"{name}: {J} jobs x {n} atoms", "max_abs_err": err, "ms": k_ms,
                   "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
    out["sw_forces_bricks"]["force_call_ms"] = fc_ms
    out["sw_forces_bricks"]["list_route_force_ms"] = list_ms
    return out


def _k6_counters():
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2
    from scema_tpu_torch.ops import sw_bricks as SWB

    return {"md_allpairs_run": (MF.md_run, "launches"),
            "md_allpairs_forces_virial": (MF.md_forces_virial, "launches"),
            "md_charged_run": (MF.md_run, "launches_k3"),
            "md_charged_forces_virial": (MF.md_forces_virial, "launches_k3"),
            "md_list_run": (MF.md_run, "launches_k4"),
            "md_list_forces_virial": (MF.md_forces_virial, "launches_k4"),
            "md_sw_run": (MF.md_run, "launches_k5"),
            "md_sw_forces": (MF.md_forces_virial, "launches_k5"),
            "sw_moments": (SWB.sw_moments, "launches"),
            "sw_moments_adj": (SWB.sw_moments_adj, "launches"),
            "sw_moments_bricks": (SWB.sw_moments_bricks, "launches"),
            "sw_energy_bricks": (SWB.sw_energy_bricks, "launches"),
            "sw_forces_bricks": (SWB.sw_forces_bricks, "launches"),
            "pairwise_l2": (K2.pairwise_l2, "launches")}


def phase_sw_big_slice(dev, bricks: bool, n_steps: int):
    """Phase 14 (bricks) or 15 (the list route): the 4096-atom SW box at
    every flagged qp of the HMMConfig() dogbone, float32, quick prep, at
    most 128 MD jobs per macro-step."""
    import torch

    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import material as M

    tag = "[14 sw bricks slice]" if bricks else "[15 sw list slice]"
    counters = _k6_counters()
    cfg = HMMConfig()
    cfg = cfg.replace(dtype="float32", md_dtype="float32",
                      resources=dataclasses.replace(cfg.resources, max_md_jobs=SW_BIG_JOBS))
    spec = M.MaterialSpec(name="si", n_cells=SW_BIG_CELLS, use_pallas_bricks=bricks)
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    hmm = build_md_hmm(cfg, spec=spec, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state = hmm.init_state()
    step_s, jobs = [], []
    for _ in range(n_steps):
        t1 = time.perf_counter()
        state, out = hmm.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        jobs.append(int(out.n_jobs))
        if not (torch.isfinite(out.residual0) and torch.isfinite(out.residual1)):
            fail(f"{tag} non-finite residuals")
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    umax = float(state[0].u.abs().max())
    expect = n_steps * 0.002 * 0.08
    if abs(umax - expect) > 1e-5 * expect:
        fail(f"{tag} max displacement {umax} != {expect}")
    if jobs != [SW_BIG_JOBS] * n_steps:
        fail(f"{tag} md jobs {jobs}, expected {[SW_BIG_JOBS] * n_steps}")
    micro = state[1][0]
    if not torch.isfinite(micro.pos[micro.has_run]).all():
        fail(f"{tag} non-finite MD states")
    need = ("sw_moments_bricks", "sw_forces_bricks", "pairwise_l2") if bricks else ("pairwise_l2",)
    for k in need:
        if launches[k] <= 0:
            fail(f"{tag} kernel {k} was not launched by the main path")
    others = {k: v for k, v in launches.items() if k not in need}
    if any(others.values()):
        fail(f"{tag} kernels of other paths were launched: {others}")
    print(f"{tag} {hmm.backend.sys.n_atoms}-atom Si boxes ({'bricks: K6c/K6d' if bricks else 'list route: autograd SW.energy'}), "
          f"qps {hmm.geom.n_qp_total}: setup {setup_s:.3f}s  s/macro-step "
          f"{[round(x, 4) for x in step_s]}  md jobs {jobs}  launches {launches}  peak memory "
          f"{peak / 2**20:.1f} MiB  max displacement {umax:.6g} m (expect {expect:.6g})  "
          f"phase wall {wall:.2f}s")
    return launches


def kernel_registers(name_part: str):
    """[(registers, spill store bytes)] of the compiled entries whose
    mangled name holds ``name_part``, from the build's ptxas report (empty
    when the library came from the cache)."""
    from scema_tpu_torch.ops import _build

    out, cur = [], None
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = [m.group(1), None, None]
            continue
        if cur is None or name_part not in cur[0]:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            cur[2] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[1] = int(m.group(1))
            out.append((cur[1], cur[2]))
            cur = None
    return out


# K1m's jobs per block on the coupled path (MDBackend.pack_jobs)
K1M_JOBS = 2
# K1 (every flag off; md_allpairs.cu) and K1m's (J = 2, 4; md_multi.cu) mangled kernel names
K1_KERNEL = "md_run_kernelILb0ELb0ELb0ELb0ELb0ELb0ELb0E"
K1M_KERNELS = {J: f"md_run_multi_kernelILi{J}E" for J in (2, 4)}


def phase_k1m(dev):
    """Phase 16: K1m (K1's run with J = 2 jobs per block) against K1, its
    plain version and float64 on the prepared g0 box at 576 jobs."""
    import torch

    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.ops import md_fused as MF

    t0 = time.perf_counter()
    sys_, st = M.build_system(M.MaterialSpec(name="g0", force_field="opls"),
                              dtype=torch.float32, device=dev)
    st = E.minimize_fire(sys_, st, n_steps=100, dt0=0.5)
    r, n, J = sys_.fused, sys_.n_atoms, 576
    gen = torch.Generator().manual_seed(16)
    vel = torch.stack([E.maxwell_velocities(sys_, T_MD, gen, torch.float32, dev)
                       for _ in range(J)])
    hJ = st.h.expand(J, 3, 3).contiguous()
    state = MF.pack_state(st.pos.expand(J, -1, -1), vel)
    vxi = torch.zeros((J, 3), device=dev)
    epsJ = (torch.rand((J, 6), generator=gen) * 2e-3 - 1e-3).to(dev)
    fscal = MF.make_fscal(DT, T_MD, hJ, epsJ)
    n10 = torch.full((J,), 10, dtype=torch.int32, device=dev)
    r64 = r.to(dev, torch.float64)

    # 10-step deform run: K1m against K1 (bit for bit expected) and, at
    # phase 4's tolerances, against float64
    out, xo, _ = MF.md_run_multi(r, state, vxi, n10, fscal, True, False, K1M_JOBS)
    ref, xr, _ = MF.md_run(r, state, vxi, n10, fscal, True, False)
    pl, _, _ = MF.md_run_plain(r, state, vxi, n10, fscal, True, False)
    ref64, _, _ = MF.md_run_plain(r64, state.double(), vxi.double(), n10, fscal.double(),
                                  True, False)
    torch.cuda.synchronize()
    d_run = float((out - ref).abs().max())
    p_err = float((out[:, :3] - pl[:, :3]).abs().max())
    pk = float((out[:, :3].double() - ref64[:, :3]).abs().max())
    pp = float((pl[:, :3].double() - ref64[:, :3]).abs().max())
    vmax = float(ref64[:, 3:].abs().max())
    vk = float((out[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    vp = float((pl[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    if not torch.isfinite(out).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4:
        fail(f"K1m run: kernel error vs float64 {pk:.3e} A (velocities rel {vk:.3e}) "
             f"exceeds 4x plain float32 {pp:.3e} A ({vp:.3e}) + 1e-4")
    print(f"[16 K1m run] {J} jobs x 10 deform steps, J = {K1M_JOBS} per block: max |K1m - K1| "
          f"{d_run:.3e} (state), {float((xo - xr).abs().max()):.3e} (NHC); positions max_abs_err "
          f"vs plain {p_err:.3e} A; vs float64: K1m {pk:.3e} A plain-f32 {pp:.3e} A, velocities "
          f"rel {vk:.3e} / {vp:.3e} (tol 4x plain + 1e-4)")

    # 20-step sampling run: per-job pressure sums
    f_s = MF.make_fscal(DT, T_MD, hJ)
    n20 = torch.full((J,), 20, dtype=torch.int32, device=dev)
    _, _, sk = MF.md_run_multi(r, out, xo, n20, f_s, False, True, K1M_JOBS)
    _, _, s1 = MF.md_run(r, out, xo, n20, f_s, False, True)
    _, _, sp = MF.md_run_plain(r, out, xo, n20, f_s, False, True)
    _, _, s64 = MF.md_run_plain(r64, out.double(), xo.double(), n20, f_s.double(), False, True)
    torch.cuda.synchronize()
    smax = s64.abs().amax(0)
    sk_err = float(((sk.double() - s64).abs().amax(0) / smax).max())
    sp_err = float(((sp.double() - s64).abs().amax(0) / smax).max())
    d_s = float((sk - s1).abs().max())
    if not torch.isfinite(sk).all() or sk_err > 4 * sp_err + 1e-4:
        fail(f"K1m sampling: pressure sums vs float64 rel {sk_err:.3e} exceed 4x plain "
             f"float32 {sp_err:.3e} + 1e-4")
    print(f"[16 K1m sample20] {J} jobs x 20 sampling steps: max |K1m - K1| {d_s:.3e} atm; "
          f"rel to float64 (worst component): K1m {sk_err:.3e} plain-f32 {sp_err:.3e} "
          f"(tol 4x plain + 1e-4)")

    # (live, dead) pairs: every second job runs 0 steps
    n_pair = torch.tensor([20, 0] * (J // 2), dtype=torch.int32, device=dev)
    o2, x2, p2 = MF.md_run_multi(r, out, xo, n_pair, f_s, False, True, K1M_JOBS)
    o1, _, p1 = MF.md_run(r, out, xo, n_pair, f_s, False, True)
    torch.cuda.synchronize()
    dead_ok = (torch.equal(o2[1::2], out[1::2]) and torch.equal(x2[1::2], xo[1::2])
               and not bool(p2[1::2].any()))
    d_live = float((o2[0::2] - o1[0::2]).abs().max())
    if not dead_ok or not torch.isfinite(o2).all():
        fail("K1m: a dead job of a (live, dead) pair was modified")
    print(f"[16 K1m pairs] {J // 2} (live, dead) pairs x 20 sampling steps: dead jobs "
          f"bit-identical; live jobs max |K1m - K1| {d_live:.3e} (state), "
          f"{float((p2[0::2] - p1[0::2]).abs().max()):.3e} atm")

    # times: K1m (J = 2 and 4) and K1 on the same 576-job deform run
    ms = cuda_ms(lambda: MF.md_run_multi(r, state, vxi, n10, fscal, True, False, K1M_JOBS),
                 reps=3)
    ms4 = cuda_ms(lambda: MF.md_run_multi(r, state, vxi, n10, fscal, True, False, 4), reps=3)
    k1_ms = cuda_ms(lambda: MF.md_run(r, state, vxi, n10, fscal, True, False), reps=3)
    plain_ms = cuda_ms(lambda: MF.md_run_plain(r, state, vxi, n10, fscal, True, False),
                       reps=1, warmup=0)
    f_lj, _ = pair_fractions(st.pos.expand(2, -1, -1), hJ[:2], r.spec.cutoff2)
    b_ms, b_by = bound(4.0 * (2 * n * n + 16 * n + 2 * J * (6 * n + 3) + J * 16),
                       pair_flops(n, J * 10, f_lj))
    regs = {"K1": kernel_registers(K1_KERNEL)[:1],
            **{f"K1m J={J}": kernel_registers(k) for J, k in K1M_KERNELS.items()}}
    print(f"[16 K1m] {J} jobs x 10 deform steps: K1m J=2 {ms:.3f} ms  J=4 {ms4:.3f} ms  "
          f"K1 {k1_ms:.3f} ms  plain {plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by})  "
          f"(registers, spill stores) {regs}  phase wall {time.perf_counter() - t0:.2f}s")
    return {"name": "md_allpairs_run_multi", "route": "cuda",
            "source": "scema_tpu_torch/csrc/md_multi.cu",
            "replaces": "scema_tpu/ops/md_fused.py:1850",
            "max_abs_err": max(d_run, d_s), "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}


def _all_counters():
    from scema_tpu_torch.ops import md_fused as MF

    return {**_k6_counters(), "md_allpairs_run_multi": (MF.md_run_multi, "launches_k1m")}


# Density bands (kg/m^3) after the staged prep at ns_init 100, about 10%
# around what the JAX package's own prep gives on these boxes
# (tests/torch_staged_density.py, CPU float64, keys 1-3: g0 432.3-452.3,
# SW silicon 1513.4-1595.9; the port on the same draws gives the same).
# Both boxes leave their start density: the octane melt expands while it is
# held at 500 K, and the SW box melts, because the reference reads the
# metal-units Si.sw energies as kcal/mol (scema_tpu/md/units.py).
G0_RHO_NS100 = (390.0, 950.0)
SI_RHO_NS100 = (1360.0, 1730.0)
# (job, replica) runs of phase 17's MD-layer packing check: odd, so the last
# J-tuple holds a zero-step pad job
PACK_MD_RUNS = 145


def phase_staged_slice(dev):
    """Phase 17: the g0 slice as its users launch it — ``cli run cfg.json
    --steps 3`` without ``--quick-prep`` (the staged heatup/cooldown NPT
    prep) — then 2 macro-steps of the built problem with pack_jobs 1 and
    2 (K1m), and the staged prep of the 216-atom SW box on K5's entry."""
    import torch

    from scema_tpu_torch import cli
    from scema_tpu_torch.hmm import md_coupling as MC
    from scema_tpu_torch.md import box as B
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.md.homogenization import MDParams

    counters = _all_counters()

    def zero():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    def only(launches, need, what):
        for k in need:
            if launches[k] <= 0:
                fail(f"{what}: kernel {k} was not launched")
        others = {k: v for k, v in launches.items() if k not in need}
        if any(others.values()):
            fail(f"{what}: kernels of other paths were launched: {others}")

    n_steps = 3
    built = {}
    build = MC.build_md_hmm

    def keep(*a, **kw):  # the CLI's own problem, kept for the packing runs
        built["hmm"], built["staged"] = build(*a, **kw), kw.get("staged")
        return built["hmm"]

    gc.collect()
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        cfg = os.path.join(tmp, "cfg.json")
        with open(cfg, "w") as f:
            json.dump({}, f)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        buf = io.StringIO()
        MC.build_md_hmm = keep
        zero()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = cli.main(["run", cfg, "--steps", str(n_steps)])
            torch.cuda.synchronize()
        finally:
            MC.build_md_hmm = build
        wall = time.perf_counter() - t0
        launches = read()
    peak = torch.cuda.max_memory_allocated(dev)
    text = buf.getvalue()
    for line in text.splitlines():
        print(f"    {line}")
    if rc != 0 or built.get("staged") is not True:
        fail(f"staged slice: cli run exited {rc} (staged={built.get('staged')})")
    steps = re.findall(r"residual (\S+) -> (\S+)  flagged qps (\d+)  md jobs (\d+)  "
                       r"reaction (\S+)  \((\S+)s\)", text)
    setup = re.search(r"Setup \(mesh \+ material prep\) (\S+)s", text)
    umax = re.search(r"Max displacement: (\S+) m", text)
    if len(steps) != n_steps or setup is None or umax is None:
        fail("staged slice: cli output is missing per-step lines, the setup time or the "
             "displacement")
    for r0, r1, _, _, rf, _ in steps:
        if not all(abs(float(x)) < float("inf") for x in (r0, r1, rf)):
            fail(f"staged slice: non-finite residuals {r0} {r1} {rf}")
    jobs = [int(s[3]) for s in steps]
    expect = n_steps * 0.002 * 0.08
    if jobs != [144, 288, 432] or abs(float(umax.group(1)) - expect) > 1e-5 * expect:
        fail(f"staged slice: md jobs {jobs} (expected [144, 288, 432]), max displacement "
             f"{umax.group(1)} (expected {expect})")
    only(launches, ("md_allpairs_run", "md_allpairs_forces_virial", "pairwise_l2"),
         "staged slice")
    hmm = built["hmm"]
    rho = float(hmm.backend.ensemble.rho.mean())
    if not G0_RHO_NS100[0] < rho < G0_RHO_NS100[1]:
        fail(f"staged slice: prepared g0 density {rho} kg/m^3 outside {G0_RHO_NS100}")
    print(f"[17 staged slice] prep (setup, staged NPT) {float(setup.group(1)):.3f}s  "
          f"g0 density {rho:.2f} kg/m^3  s/macro-step "
          f"{[float(s[5]) for s in steps]}  md jobs {jobs}  launches {launches}  peak memory "
          f"{peak / 2**20:.1f} MiB  wall {wall:.2f}s  max displacement {umax.group(1)} m")

    # tests/test_opls_hmm.py:69-81 on the card: the g0 box's staged prep at
    # ns_init 60 (FIRE 80) in float32 settles at 450-950 kg/m^3
    sys_, st = M.build_system(M.MaterialSpec(name="g0", force_field="opls"),
                              dtype=torch.float32, device=dev)
    params = MDParams(temperature=300.0, dt=2.0, strain_rate=1e-4, nsteps_sample=40)
    t0 = time.perf_counter()
    st = M.equilibrate_staged(sys_, st, params, torch.Generator().manual_seed(1), ns_init=60,
                              minimize_steps=80)
    torch.cuda.synchronize()
    prep60 = time.perf_counter() - t0
    rho60 = float(torch.sum(sys_.masses)) * M.DENSITY_CONV / float(B.volume(st.h))
    if not torch.isfinite(st.pos).all() or not 450.0 < rho60 < 950.0:
        fail(f"g0 staged prep at ns_init 60: density {rho60} kg/m^3 outside 450-950")
    print(f"[17 g0 density] staged prep ns_init 100 (the CLI's): {rho:.2f} kg/m^3 (band "
          f"{G0_RHO_NS100}); ns_init 60, FIRE 80 (test_opls_hmm.py:69-81): {rho60:.2f} kg/m^3 "
          f"(band 450-950) in {prep60:.3f}s")

    # the same problem and initial state, 2 macro-steps unpacked and packed
    def two_steps(problem):
        state = problem.init_state()
        step_s = []
        for _ in range(2):
            t1 = time.perf_counter()
            state, out = problem.step(state)
            torch.cuda.synchronize()
            step_s.append(round(time.perf_counter() - t1, 4))
        return state, step_s

    s1, t1 = two_steps(hmm)
    s1b, t1b = two_steps(hmm)  # the unpacked run again: its run-to-run spread
    packed = dataclasses.replace(hmm, backends=tuple(
        dataclasses.replace(be, pack_jobs=K1M_JOBS) for be in hmm.backends))
    zero()
    s2, t2 = two_steps(packed)
    launches_k1m = read()
    only(launches_k1m, ("md_allpairs_run_multi", "pairwise_l2"), "pack_jobs=2 steps")
    sig1, sig1b, sig2 = (c[0].qp.new_stress for c in (s1, s1b, s2))
    smax = max(float(sig1.abs().max()), 1e-30)
    d_rep = float((sig1b - sig1).abs().max())
    d_sig = float((sig2 - sig1).abs().max())
    if not torch.isfinite(sig2).all() or d_sig / smax > 1e-4:
        fail(f"pack_jobs=2 stresses differ from pack_jobs=1 by {d_sig:.3e} (rel "
             f"{d_sig / smax:.3e}, tol 1e-4)")
    # the MD layer alone on identical inputs: 145 (job, replica) runs, an odd
    # count, so the last pair holds a zero-step pad job; bit for bit expected
    be = hmm.backend
    st0 = be.initial_md_state
    n_md = PACK_MD_RUNS
    st_md = E.MDState(*(x.expand((n_md,) + x.shape).contiguous()
                        for x in (st0.pos, st0.vel, st0.h, st0.vxi)))
    gen = torch.Generator().manual_seed(171)
    dl = ((torch.rand((n_md, be.n_repl, 6), generator=gen) * 2 - 1) * 1e-2).to(st0.pos)
    o1, p1 = be._run_jobs(st_md, dl)
    o2, p2 = dataclasses.replace(be, pack_jobs=K1M_JOBS)._run_jobs(st_md, dl)
    torch.cuda.synchronize()
    md_equal = torch.equal(p1, p2) and all(torch.equal(getattr(o1, f), getattr(o2, f))
                                           for f in ("pos", "vel", "h", "vxi"))
    if not md_equal:
        fail(f"pack_jobs=2 MD runs differ from pack_jobs=1 on identical inputs: max |stress "
             f"diff| {float((p2 - p1).abs().max()):.3e} Pa")
    print(f"[17 pack_jobs] 2 macro-steps from the built problem: pack_jobs=1 {t1} and {t1b} "
          f"s, pack_jobs={K1M_JOBS} {t2} s per step; max |stress diff| packed {d_sig:.3e} Pa "
          f"(rel {d_sig / smax:.3e}, tol 1e-4), unpacked run-to-run {d_rep:.3e} Pa (rel "
          f"{d_rep / smax:.3e}); the MD layer alone ({n_md} runs, one pad job) bit-identical "
          f"{md_equal}  launches {launches_k1m}")

    # the SW config's staged prep: 216-atom diamond-Si box on K5's entry
    sys_, st = M.build_system(M.MaterialSpec(name="si"), dtype=torch.float32, device=dev)
    params = MDParams(temperature=T_MD, dt=DT, strain_rate=1e-4, nsteps_sample=100)
    zero()
    t0 = time.perf_counter()
    st = M.equilibrate_staged(sys_, st, params, torch.Generator().manual_seed(17),
                              ns_init=100)
    torch.cuda.synchronize()
    prep_s = time.perf_counter() - t0
    sw_launches = read()
    only(sw_launches, ("md_sw_run", "md_sw_forces"), "SW staged prep")
    rho_si = float(torch.sum(sys_.masses)) * M.DENSITY_CONV / float(B.volume(st.h))
    if not torch.isfinite(st.pos).all() or not SI_RHO_NS100[0] < rho_si < SI_RHO_NS100[1]:
        fail(f"SW staged prep: density {rho_si} kg/m^3 outside {SI_RHO_NS100}")
    print(f"[17 sw staged] 216-atom Si box, equilibrate_staged ns_init 100 (FIRE 100, NVT "
          f"100, MTK NPT 900 steps): {prep_s:.3f}s  density {rho_si:.2f} kg/m^3 (band "
          f"{SI_RHO_NS100}; the quick prep keeps 2329)  launches {sw_launches}")
    return launches_k1m


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "scema_tpu_torch")):
        fail("scema_tpu_torch/ is not beside chip_smoke.py: run it from a checkout")
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke test needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    card = phase_card()
    phase_build()
    k2 = phase_k2(dev)
    k1_run, k1_forces = phase_k1(dev)
    launches = phase_slice(dev)
    k3_run, k3_forces = phase_k3(dev)
    launches_charged = phase_charged_slice(dev)
    k4_run, k4_forces = phase_k4(dev)
    phase_bench(dev)
    launches_list = phase_list_slice(dev)
    k5_run, k5_forces = phase_k5(dev)
    launches_sw = phase_sw_slice(dev)
    k6 = phase_k6(dev)
    launches_bricks = phase_sw_big_slice(dev, bricks=True, n_steps=2)
    phase_sw_big_slice(dev, bricks=False, n_steps=1)
    k1m = phase_k1m(dev)
    k1m["launches"] = phase_staged_slice(dev)["md_allpairs_run_multi"]
    rows = [k1_run, k1_forces, k2, k3_run, k3_forces, k4_run, k4_forces, k5_run, k5_forces]
    for row in rows:
        path = (launches_charged if row["name"].startswith("md_charged") else
                launches_list if row["name"].startswith("md_list") else
                launches_sw if row["name"].startswith("md_sw") else launches)
        row["launches"] = path[row["name"]]
    for row in k6.values():  # K6's launches on the brick slice (phase 14)
        row["launches"] = launches_bricks[row["name"]]
        rows.append(row)
    rows.append(k1m)  # K1m's launches on the pack_jobs=2 steps (phase 17)
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
