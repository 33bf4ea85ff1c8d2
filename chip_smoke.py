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
   read just after; K2 and K3 must have launched.

The second-to-last line is a JSON object with one entry per kernel (K1
and K2 launches counted on the g0 slice, K3's on the charged slice; bounds
from this run's shapes and the card's published peaks); the last line is
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
"""
import contextlib
import dataclasses
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
    rows = [k1_run, k1_forces, k2, k3_run, k3_forces]
    for row in rows:
        path = launches_charged if row["name"].startswith("md_charged") else launches
        row["launches"] = path[row["name"]]
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
