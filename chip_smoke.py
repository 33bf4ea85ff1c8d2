#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``scema_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout.  Phases, each printing its own lines; any
failure exits non-zero before the result line:

1. the card (``nvidia-smi`` name and power limit) and the torch/CUDA versions;
2. the kernel build from the sources in the checkout (nvcc, sm_90a), timed;
3. K2 (pairwise L2, csrc/pairwise_l2.cu: the Hopper redesign, upper-triangle
   tile pairs with each tile written with its mirror) against its plain
   PyTorch version at n = 576 and 4608, d = 60, and against its first
   design bit for bit (also at n = 1, 33, 63, 64, 65 and d = 6, 60, 130),
   exactly symmetric; both designs in turns (first, new, new, first), time
   per call and device time, with the plain version's, torch.cdist's and
   the bound;
4. K1 (fused all-pairs MD, csrc/md_k1.cu) against its plain version on
   the prepared g0 box (512-site united-atom alkane melt, float32): the
   force + virial entry at the stiffness probe's batch of 12 and at the
   staged NPT's one box, a 576-job deform run of 10 steps, a 576-job
   20-step sampling run (each job's pressure sums against float64) and a
   576-job 100-step sampling run (stress compared statistically); K1's
   first design (md_kernel.cuh with every flag off) held to the same
   rules on the same force calls and deform run, and timed in turns with
   the redesign (old, new, new, old) at 576 and 144 jobs x 10 steps and at
   B = 12 and 1 (device time by the profiler, and time per call); the
   registers, local (spill) bytes and blocks per SM of K1's two kernels;
5. the slice: ``scema_tpu_torch.cli run cfg.json --quick-prep --steps 3`` on
   an empty config (the HMMConfig() dogbone: 576 qps, a 512-site box at each
   flagged qp), with every launch counter zeroed just before and read just
   after; each kernel of the path must have launched, and K1's first design
   not;
6. K3 (csrc/md_k3.cu: fused all-pairs MD with the charged all-atom
   additions, redesigned for Hopper) against its plain version on the
   prepared PEAA box (56 C10H22 chains, 1792 charged atoms, SHAKE on C-H,
   PME k-space split, float32): the force + virial entry at the stiffness
   probe's 12 boxes, orthorhombic and tilted, against float32 and float64,
   a 128-job 10-step deform chunk with SHAKE and the frozen k-space force,
   the SHAKE residual after it, a 128-job 20-step sampling run (each job's
   pressure sums against float64), and the PME remainder's time for 128
   jobs; K3's first design (md_kernel.cuh) on the same force calls and
   chunk to the same rules, and timed in turns with the redesign (old,
   new, new, old); the registers, local (spill) bytes and blocks per SM of
   every instance; both bounds (the tables', and the planes' in brackets);
7. the charged slice: ``build_md_hmm(HMMConfig(), spec=PEAA,
   equil_steps=50, minimize_steps=100)`` with at most 128 MD jobs per step,
   float32, for 2 macro-steps, its launch counters zeroed just before and
   read just after; K2 and K3 must have launched, no first design;
8. K4 (csrc/md_k4.cu: the compact-list pair loop, redesigned for Hopper,
   which also stands for the TPU's streamed job-grid form K4s) against its
   plain version on the prepared PEAA2240 box (70 C10H22 chains, 2240
   charged atoms, K ~ 1112 list slots, SHAKE, PME split, float32): the
   force + virial entry on 12 boxes, orthorhombic and tilted, against
   float32 and float64, a 16-job 10-step deform chunk with SHAKE and the
   frozen k-space force against float32 and float64, the SHAKE residual
   after it, 20-step sampling pressure sums per job against float64, no
   list row full; K4's first design (md_kernel.cuh over the seven
   channels) to the same rules and in turns with the redesign on a 128-job
   10-step chunk and on the force entry, the list rebuild (compact pack
   against the seven channels) in turns, K4's global form (the cluster
   form's A/B partner) on the same chunk against float64 and in turns with
   the shared form, the
   compact list's live-slot
   statistics, the instances' registers, spills and blocks per SM, both bounds
   (4 B per live slot, and the seven channels' in brackets), and K3's
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
   and read just after; K2 and K4 must have launched, no first design;
11. K5 (csrc/md_k5.cu: the Stillinger-Weber sweeps, sweep 2 over sweep
   1's live lists, redesigned for Hopper) and its first design (md_sw.cu)
   against the plain version on the prepared 216-atom diamond-Si box
   (float32): the force + virial entry at the stiffness probe's 12 boxes,
   orthorhombic and tilted, against float32 and float64, a 576-job 10-step
   deform run (the live lists' largest count and overflows), the same on 16
   jobs at live-list caps that some (8) or every (2) atom exceeds, each
   job's 20-step sampling pressure sums against float64; both designs in
   turns (old, new, new, old) on 576 jobs x 10 steps at N = 216 and at N =
   512 (the largest cubic box of the fused gate) and on the force entry,
   with the plain version's time, the bound and each kernel's registers,
   local bytes and blocks per SM; the stiffness ratios of a prepared box
   (0.01 K) against SW silicon's;
12. the SW slice: ``scema_tpu_torch.cli run`` on ``{"molecular dynamics
   parameters": {"force field": "sw"}}`` with ``--quick-prep --steps 3``
   (576 qps, a 216-atom SW box at each flagged qp), every launch counter
   zeroed just before and read just after; K5 and K2 must have launched and
   K1, K3, K4 and K5's first design must not have; md jobs 144, 288, 432
   and 0.00048 m;
13. K6 (the SW tile kernels) against their plain versions on the prepared
   4096-atom diamond-Si box (8^3 cells, 48 bricks; float32): K6d's
   moments, K6e's energy and K6c's forces + energy + virial on the
   stiffness probe's 12 boxes, orthorhombic and tilted (xy 0.4, xz 0.2 A),
   against float32 and float64; K6's first design (the stencil sweep in
   both kernels) on the same boxes to the same rule, the largest
   difference between the designs (K6c on the same adjoints), and K6c's
   overflow path (a live-list cap of 2) to the same rule; K6a (q = 0 and
   0.5) and K6b on the box's consecutive-atom tiles; at 128 jobs the live
   list's largest count and overflowing slots, the share of candidates the
   sphere test prunes (the plain model), the first design and the path's
   in turns (first, new, new, first) for K6d, K6c and the force call, each
   kernel's, its plain version's and both bounds' times (the live pairs'
   work, and the stencil candidates' work as the first design's rows
   counted it), registers, local bytes and blocks per SM, the brick force
   call against the list route's autograd force call and list build; 10
   deform steps of 128 jobs through the unfused engine on both routes from
   one state; on those 128 strained boxes the list route's neighbor builds
   in turns (dense, gather cells, structured cells, structured, gather,
   dense), each cell build's per-row sets against the dense build's (a
   pair may differ only within 1e-4 A of the list's edge: r_list, or the
   farthest kept pair of a row the width k_max truncates), and the fullest
   cell against the capacity;
14. the brick slice: ``build_md_hmm(HMMConfig(), spec=MaterialSpec(n_cells=8,
   use_pallas_bricks=True))`` with at most 128 MD jobs per step, float32,
   quick prep, 2 macro-steps, every launch counter zeroed just before and
   read just after; K6c, K6d and K2 must have launched and no other MD
   kernel, K6's first design neither; md jobs 128, 128 and 0.00032 m;
15. the same box on the list route (no bricks) for 1 macro-step: K2 is
   the only kernel launched, and the neighbor lists come from the gather
   cell build alone (its calls counted, the dense and structured builds
   never called);
16. K1m (csrc/md_k1m.cu: K1's run with J = 2 or 4 jobs per block, the
   coupler's pack_jobs, redesigned for Hopper) on the prepared g0 box at
   576 jobs: a 10-step deform run against K1 (bit for bit or not, printed)
   and against float64 at phase 4's rule, a 20-step sampling run, (live,
   dead) pairs with the dead job bit-identical; its first design
   (md_multi.cu) against K1's first design, bit for bit (checked); both
   designs in turns (old, new, new, old) at J = 2 and 4, K1's and the plain
   version's times, the bound, and the registers, spills and blocks per SM;
17. the staged slice: ``scema_tpu_torch.cli run cfg.json --steps 3`` on
   an empty config without ``--quick-prep`` (the staged heatup/cooldown
   NPT prep; md jobs 144, 288, 432, 0.00048 m; K1's entries and K2 only)
   and the prepared g0 density (the band of the JAX package's prep); the
   g0 prep at ns_init 60 (450-950 kg/m^3, tests/test_opls_hmm.py:69-81);
   2 macro-steps of the same built problem with pack_jobs 1 (K1), 1 again,
   1 on K1's first design and 2 (K1m launched, K1's run entry not;
   K1's stresses within 1e-4 relative of the first design's and the
   packed ones within 1e-4 of K1's, and the MD layer alone on identical
   inputs bit for bit with K1 where phase 16 found K1m so, else within
   1e-4 in stress), and the staged
   prep of the 216-atom SW box on K5's entry (density in the band of the
   JAX package's prep);
18. P1 (the kernel lab's slim all-pairs LJ runs, ``ops.md_slim``, variants
   v1-v8) on the prepared g0 box (float32): each variant's redesign
   (csrc/md_slim_ring.cu: float4 positions, planes and image cache through
   a shared-memory ring of TMA bulk copies) and first design (md_slim.cu)
   on a 25-step run of 576 jobs (one image-cache refresh mid-run) against
   the plain version and float64 (K1's rule: 4x plain float32 + 1e-4),
   against each other (bit for bit for v1-v4 and v5m), the redesign
   against v1, a program with n_run = 0 bit-identical, and the int8 image
   guard against the plain version's; both designs in turns (first, new,
   new, first) with the plain and bound times, the wrapper's shared bytes
   against the kernel's own, registers, spills and blocks per SM; then
   the lab itself, ``probe_allpairs.main`` over v0 (K1), v0p (K1m) and every slim
   variant at 576 jobs x 500 steps (best of 3 runs, each state finite),
   its launch counters zeroed just before and read just after (the
   redesign 4 launches per variant, the first design none, v0 on K1, never
   on its first design); then each variant at 640, 1024 and 2048 atoms per
   box and at its cap (``md_slim.n_max``: 5248, v5m 2176, J = 2 2560, J = 4
   1280), capped there, on a jittered lattice at the LJ liquid's density:
   the redesign's big-box instance on a few 25-step programs against the
   plain version and float64 (the same rule), against the first design
   where that runs (bit for bit for v1-v4), a program with n_run = 0
   bit-identical, the image guard, its block against the kernel's own,
   registers, spills and blocks per SM; both designs in turns at 1024 and
   2048 on 576 jobs beside the bound; its launch counters zeroed just
   before and read just after (every variant launched at every size);
19. K4's cluster form (csrc/md_k4_big.cu: one job on a thread-block
   cluster of C CTAs, its rows in the CTAs' shared memory, for list boxes
   above the shared form's 2509-atom cap) on the prepared 4096-atom PE box
   (``material.PEAA4096``, 128 C10H22 chains, K = 1112): the force entry on
   12 boxes, orthorhombic and tilted; against the plain version and float64
   by phase 8's rules (a 0-step job bit-identical, the SHAKE residual) a
   16-job 10-step chunk on the host's C, the same on 8 CTAs with cuts that
   split SHAKE constraints, 37 jobs (no whole wave of clusters), an
   8192-atom box near the cap (16 CTAs per job) and 20-step pressure sums,
   no list row full; every fitting C timed at 32 jobs; the cluster form and
   K4's global form (one block per job, its rows in device memory: the A/B
   partner) in turns at 32 and 128 jobs against the bound, with C, the
   clusters the card holds at once, registers, spills and shared bytes per
   CTA;
20. the coupled step on that box: ``build_md_hmm(HMMConfig(),
   spec=PEAA4096, equil_steps=50, minimize_steps=100)`` with at most 32 MD
   jobs per step, float32, 2 macro-steps, its launch counters zeroed just
   before and read just after; K4's cluster form, its force entry and K2
   must have launched, K4's shared and global forms and the first designs
   not;
21. the run surface on the g0 dogbone: ``init-material --quick-prep``
   writes the init set; ``run --quick-prep --steps 3 --outdir D
   --dump-similarity`` reads it, with every output frequency at 1 (its
   K1 and K2 launch counters zeroed just before and read just after; K2's
   first design must not launch), and its VTU, PVD, CSV, checkpoint and
   lcts.* files parse; ``run --restart D/checkpoint-000002.npz --steps 1``
   ends at the uninterrupted step 3 (equal job counts; u, v and the stress
   field within RESTART_TOL); the similarity dump equals K2's plain
   version on the final splines (1e-5); ``strain-md --save-state --dump``
   then ``analyse-md`` on both formats agree within 1e-3; no step rolled
   back;
22. the charged staged slice: ``build_md_hmm(HMMConfig(), spec=PEAA,
   staged=True, ns_init=100)`` with at most 128 MD jobs per step, float32
   (FIRE and 900 MTK NPT steps on K3's force + virial entry with the
   PME remainder and SHAKE/RATTLE on the host, the NVT stage on K3's run),
   then 2 macro-steps, the launch counters zeroed before the setup, read
   after it, zeroed and read around the steps; K3's force entry must have
   launched at least 900 times in the setup, K3's run and K2 in the steps,
   no first design; the SHAKE residual of the prepared replica and the MD
   states, the prepared density against a band from the JAX package's own
   staged prep of PEAA (tests/torch_staged_density.py), the displacement
   milestone; K3's force entry on the prepared box (the NPT loop's one
   box) against its plain version and float64, timed (device, per call,
   plain) against its bound; 20 NPT steps timed; then ``use_fused=False``
   on PEAA (the unfused engine: autograd of ``OPLS.energy`` with the PME
   sum, host SHAKE/RATTLE): its step-0 forces and virial on the prepared
   box against K3's force entry plus the remainder, in float64 (1e-5
   relative: the erfc polynomial against the exact erfc) and in float32
   (forces 1e-5; its virial within 5e-4 of its float64 one), 4 jobs x 20
   sampling steps with no kernel launched, the SHAKE residual after them;
   and the card's
   ``constraints.shake_positions`` against the same call on the CPU in
   float64 (1e-5 A);
23. data files and the build-time route: the g0 melt written as a LAMMPS
   data file (tests/torch_file_util.py) and read back through
   ``MaterialSpec(data_file=...)`` takes route K1, its state and K1's
   force + virial on 12 perturbed boxes bit for bit the built-in g0's;
   the same file with one harmonic improper per interior bead triple takes
   ``unfused: impropers``; the ``HMMConfig()`` dogbone (quick prep, at
   most 64 MD jobs) with it for 2 macro-steps, its launch counters zeroed
   before the build and read after the steps: ``build_md_hmm`` prints the
   route, the displacement milestone, finite stresses, no fused kernel
   launched (K2 only);
24. the other problems and the FE solvers: the drop-weight plate (0.08 x
   0.08 x 0.02 m, 6 x 6 x 2 cells, 576 qps; a 0.04 m weight at 1e8 m/s^2
   for 3 steps) for 3 macro-steps and a compact-tension specimen (a
   generated 72-hex GMSH mesh, calculi_B 0.01 m, a pin displacement of
   0.002 W per step, at most 128 MD jobs) for 2, g0 on K1 with the quick
   prep, float32, counters zeroed before each build and read after its
   steps: flagged qps and MD jobs, finite stresses below 1e10 Pa, a
   finite nonzero reaction, K1's run and K2 launched, no first design;
   then CG, GMRES, BiCGStab and the direct solve on the dogbone's
   consistent mass matrix in float64 on the card (each within 1e-7 of
   x_true; matvecs and time printed);
25. the restart seed: a 2 x 3 x 4-cell diamond-Si LAMMPS binary restart
   (192 atoms, the box origin off zero) as ``init.g0_1.bin`` in a
   temporary nanoscale input; the ``{"force field": "sw"}`` dogbone built
   from it (576 qps; the lattice sized from the restart) is 192 atoms on
   K5 with replica 1 the restart's pos - boxlo / vel / h (1e-6 relative,
   float32, the thermostat at rest), then 2 macro-steps with the
   displacement milestone, K5 and K2 launched and nothing else;
26. the route and the shared-memory caps: the g0 melt with its beads
   spread over 160 atom types (tests/torch_file_util.py) as a data file
   takes ``unfused: K1: 512 atoms of 160 atom types ...`` (K1's launch
   check refuses the box too), then FIRE 20 and 4 jobs x 20 strain steps on
   the unfused engine, finite and no kernel launched;
27. the surrogate (stress method 2): a reference-shaped stack (18 -> 18 ->
   36 -> 72 -> 72 -> 36 -> 18 -> 6) with a MinMaxScaler's standardizer,
   saved as the port's npz (the card has no h5py for the Keras files, whose
   loader the CPU tests hold to JAX's), ``scema_tpu_torch.cli run {}
   --surrogate surrogate.npz --steps 3`` on the HMMConfig() dogbone (576
   qps, the method overridden to 2), counters zeroed before and read after: finite
   residuals, 0.00048 m, K2 alone launched; the card's float32 forward
   pass against float64 on the CPU (1e-5 relative) and its time; the same
   dogbone through ``build_hooke_hmm(surrogate_fn=)``, a finite stress
   field; ``train_surrogate`` on 4096 synthetic linear transitions x 60
   epochs, timed, fitting the map within 10%;
28. the ReaxFF slice (no kernel of its own: the list bond-order field with
   QEq is autograd torch on the unfused engine): the synthetic H/C/N/O
   ffield (tests/torch_file_util.py) in a ``lammps_scripts_reax``
   directory, a config naming it (300 K, 0.25 fs, at most 32 MD jobs), so
   that ``load_config`` selects ReaxFF and ``md_spec_kwargs`` the ffield;
   ``build_md_hmm(cfg, spec=REAXPE, equil_steps=20, minimize_steps=60)``
   (the JAX package's bench_hmm_reax: 16 C3H8 chains, 176 atoms, list
   width 175) and 2 macro-steps, every launch counter zeroed before the
   build and read after the steps: the route printed, setup and step
   times, md jobs (1-32), peak memory, the displacement milestone after
   step 1 (after step 2 the explicit FE step grows on the stiffness the
   probe measures on the synthetic field, whose eigenvalues are printed),
   finite displacements and stresses, K2 alone launched; one force + virial call
   of the prepared box on the card against the CPU in float64 (1e-4
   relative), timed; each MD state's charges summing to 0 (1e-5 e);
29. the multi-rank paths (``scema_tpu_torch.parallel``, ``fem.sharded``),
   each run (a) in this process as world 1 on NCCL (``cuda:0``) and (b) in
   two spawned processes as world 2 on gloo, both ranks on ``cuda:0`` (NCCL
   refuses two ranks on one card; the kernels are built before the spawn),
   against the unsharded run in this process, with deterministic
   algorithms on: first each collective the port hands gloo on a CUDA
   tensor, called directly and checked; then ``build_hooke_hmm(HMMConfig(),
   device_mesh=)`` (576 qps, float32, 3 macro-steps), the same dogbone's
   FE state node- and qp-sharded through ``make_sharded_step`` (3 steps;
   each rank's state bytes against the unsharded state's), the SW slice
   of phase 12 with its job batch over the ranks (``build_md_hmm(...,
   device_mesh=)``, 216-atom boxes on K5, 4 macro-steps, the last at up to
   all 576 qps' jobs (half on each world-2 rank);
   rank 0 prepares the replica and broadcasts it, and the other runs start
   from it), and the 4096-atom Si box on the list route with
   ``spatial_shards`` 1 (world 1) or 2 (world 2): its first force +
   virial call, then 4 jobs x 20 strain steps and 10 sampling steps.
   World 1 must equal the unsharded runs bit for bit; world 2 holds the
   stresses within 1e-6 (Hooke, SW), u and stress within 1e-5 (FE), the
   first forces and virial within 1e-5, and the pressures within 2x the
   unsharded float32 route's distance from its float64 run (at least
   1e-6), both ranks holding the same results; the world-2 Hooke run
   again with deterministic algorithms off, rank 0's stress within 1e-6
   and its job counts equal (each rank's FE sums round in their own order;
   rank 0's job list is broadcast); job counts equal, the displacement
   milestone, K2 launched on each rank's Hooke and FE steps, K5's run and
   K2 on each rank's SW steps, no other kernel; the launch counters read
   inside each rank, each path's zeroed just before it and read just after;
   the times per macro-step (MD step for the spatial box) and of the setup
   at each world size.

The second-to-last line is a JSON object with one entry per kernel (K1,
K1's first design (0) and K2 launches counted on the g0 slice, K3's and
its first design's (0) on the charged slice, K4's and its first design's
(0) on the coupled list slice, K5's and its first design's (0) on the SW
slice, K6's on the brick slice, K1m's and its first design's (0) on phase
17's pack_jobs=2 steps, P1's on phase 18's lab runs (N = 512; the
``md_slim_big_<v>`` rows, P1's big-box instance, on phase 18's other sizes,
its times from the check run at 2048 atoms per box or the cap below),
K4's cluster form's
and its global form's (0) on the 4096-atom slice; K2's first design's (0)
on the g0 slice; the
K1, K2 and K5 rows add the launches of phases 23-25's, 27's and 28's paths,
and the K2 and K5 rows phase 29's, world 1's and both world-2 ranks';
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
import shutil
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
# K1 times of its first design, measured on one H100 (PERF.md): 576
# jobs x 10 deform steps, and the force + virial entry on 12 boxes
PREV_K1_MS = {"run": 6.529, "forces": 0.129}
# K1 (csrc/md_k1.cu) and its first design (md_kernel.cuh with
# every flag off, md_allpairs.cu), both replacing the same TPU kernel
K1_SOURCE = "scema_tpu_torch/csrc/md_k1.cu"
FIRST_SOURCE = "scema_tpu_torch/csrc/md_allpairs.cu"
K1_REPLACES = "scema_tpu/ops/md_fused.py:1850"
# the kernels of each K1 design's force entry, by name
K1_KERNELS = {"first": ("md_forces_kernel",), "path": ("k1_forces_kernel", "k1_virial_kernel")}
K4_NOTE = ("K4 gather-list branch (pair_tile :1269, gather3 :855); also K4s, the streamed "
           "job-grid form (md_fused.py:1678): the same kernel")


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


def pair_fractions(pos, h, cut2, coul_cut2=0.0, skip=None):
    """Fractions of the pairs i != j of the boxes pos (B, N, 3) inside each
    cutoff, with the kernel's minimum image; the pairs of the (N, N) bool
    mask ``skip`` (the excluded partners) count as outside."""
    from scema_tpu_torch.md import box as B

    fl = fq = 0.0
    for b in range(pos.shape[0]):
        d = B.min_image_disp(h[b], pos[b][None, :, :] - pos[b][:, None, :])
        r2 = (d * d).sum(-1)
        r2.fill_diagonal_(float("inf"))
        if skip is not None:
            r2[skip] = float("inf")
        pairs = r2.shape[0] * (r2.shape[0] - 1)
        fl += float((r2 < cut2).double().sum()) / pairs
        fq += float((r2 < coul_cut2).double().sum()) / pairs
    n = pos.shape[0]
    return fl / n, fq / n


def k3_excluded(r):
    """(N, N) bool: the pairs that K3's window skips (the excluded partners,
    both weights 0), from the atom codes of the K3 runner r."""
    import torch

    from scema_tpu_torch.ops import md_fused as MF

    code = r.k34_code.long()
    n, W = code.shape[0], MF.k3_window(r)
    out = torch.zeros((n, n), dtype=torch.bool, device=code.device)
    ii = torch.arange(n, device=code.device)
    for d in range(2 * W + 1):
        if d != W:
            i = ii[max(0, W - d):min(n, n + W - d)]
            out[i, i + d - W] = ((code[i] >> (MF.K34_EXCL + d)) & 1).bool()
    return out


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
    """K2's redesign and its first design: bit for bit against each other,
    exactly symmetric, within 1e-5 of the plain version; timed in turns
    (first, new, new, first) at the slice's n = 576 and at 4608."""
    import torch

    from scema_tpu_torch.ops import pairwise_l2 as K2

    gen = torch.Generator().manual_seed(2)
    for n in (1, 33, 63, 64, 65):  # the tile edge's ragged cases
        for d in (6, 60, 130):  # within and beyond one 32-column chunk
            x = torch.randn((n, d), generator=gen, dtype=torch.float32).to(dev)
            new, old = K2.pairwise_l2(x), K2._first(x)
            if not (torch.equal(new, old) and torch.equal(new, new.T)):
                fail(f"K2's redesign differs from its first design at n={n} d={d}")
    worst, row, first_row = 0.0, None, None
    for n in (576, 4608):
        x = torch.randn((n, 60), generator=gen, dtype=torch.float32).to(dev) * 1e-3
        d = K2.pairwise_l2(x)
        d1 = K2._first(x)
        ref = K2.pairwise_l2_plain(x)
        torch.cuda.synchronize()
        err = float((d - ref).abs().max())
        rel = err / float(ref.abs().max())
        if not torch.isfinite(d).all() or rel > 1e-5 or not torch.equal(d, d.T):
            fail(f"K2 disagrees with its plain version at n={n}: rel {rel:.3e}")
        if not torch.equal(d, d1):
            fail(f"K2's redesign differs from its first design at n={n} d=60")
        # in turns: time per call (CUDA events over 50 back-to-back calls;
        # host-bound where a launch outlasts the kernel) and device time
        # (the profiler's kernel durations)
        t, dt = {"first": [], "path": []}, {"first": [], "path": []}
        for which in ("first", "path", "path", "first"):
            fn = K2._first if which == "first" else K2.pairwise_l2
            t[which].append(cuda_ms(lambda: fn(x), reps=50))
            dt[which].append(device_ms(lambda: fn(x), 20, (
                "pairwise_l2_first_kernel" if which == "first" else "pairwise_l2_kernel",)))
        plain_ms = cuda_ms(lambda: K2.pairwise_l2_plain(x), reps=5)
        # one PyTorch call computing the same direct-difference matrix
        lib_ms = cuda_ms(lambda: torch.cdist(x, x, compute_mode="donot_use_mm_for_euclid_dist"),
                         reps=5)
        # read x once, write the matrix once; sub + FMA per element of each
        # unordered row pair (the matrix is symmetric)
        b_ms, b_by = bound(4.0 * (n * 60 + n * n), 3.0 * n * (n - 1) / 2 * 60)
        print(f"[3 K2] n={n} d=60: max_abs_err {err:.3e} (rel {rel:.3e}, tol 1e-5), "
              f"bit for bit with the first design, symmetric  in turns first/new/new/first "
              f"{turns(t)} ms per call, device {turns(dt)} ms  plain {plain_ms:.4f} ms  "
              f"torch.cdist {lib_ms:.4f} ms  "
              f"bound {b_ms:.6f} ms ({b_by})")
        worst = max(worst, err)
        if n == 576:  # the slice's shape
            row = {"name": "pairwise_l2", "route": "cuda",
                   "source": "scema_tpu_torch/csrc/pairwise_l2.cu",
                   "replaces": "scema_tpu/ops/pairwise_pallas.py:46",
                   "ms": min(dt["path"]), "ms_per_call": min(t["path"]),
                   "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                   "library_ms": lib_ms}
            first_row = dict(row, name="pairwise_l2_first", ms=min(dt["first"]),
                             ms_per_call=min(t["first"]))
    row["max_abs_err"] = first_row["max_abs_err"] = worst
    return row, first_row


def k1_ptxas():
    """{kernel<template arguments>: (registers, spill store bytes)} of
    md_k1.cu's kernels, from the build's ptxas report (empty when the
    library came from the cache)."""
    out = {}
    for name, regs, spills in ptxas_entries():
        kind = re.search(r"\dk1_(\w+?)_kernel", name)
        if kind:
            out[kind.group(1)] = (regs, spills)
    return out


def device_ms(fn, reps: int, names) -> float:
    """Device time per call of ``fn`` in ms: the durations of the kernels
    whose names hold one of ``names``, from the profiler, over ``reps``
    calls after one warm-up call.  A profiler window that records no such
    kernel (the card's tracer drops one now and then) is taken again, up
    to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    cuda = torch.autograd.DeviceType.CUDA
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = sum(e.time_range.end - e.time_range.start for e in prof.events()
                 if e.device_type == cuda and any(k in e.name for k in names))
        if us > 0:
            return us / reps / 1e3
    fail(f"the profiler saw no device time of kernels {names} in three windows")


def turns(t) -> str:
    """The times of an old, new, new, old sequence, in that order."""
    return " ".join(f"{x:.4f}" for x in (t["first"][0], *t["path"], t["first"][1]))


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
    r64 = r.to(dev, torch.float64)
    n = sys_.n_atoms

    # force + virial entry at the stiffness probe's 12 deformed boxes, and
    # at the staged NPT's one box
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    pos12 = B.remap_affine(st.h.expand(12, 3, 3), h12, st.pos.expand(12, -1, -1))
    f_lj, _ = pair_fractions(pos12[:2], h12[:2], r.spec.cutoff2)
    # the bounds' job-independent inputs: the type table, the codes, the
    # window and the chain rows (the first design reads two N x N planes in
    # place of the first three; the function needs no more than these)
    T = int(r.k1_tbl.shape[0])
    k1_consts = 2 * T * T + 24 * n
    # the bounds of the first design's function: it reads two N x N planes
    # in place of the table, the codes and the window
    first_consts = 2 * n * n + 16 * n
    # K1 (the path's) and its first design, on the same inputs
    forces_entry = {"path": MF.md_forces_virial, "first": MF._forces_first}
    f_ms = {}
    for Bn in (12, 1):
        p12 = pos12[:Bn].transpose(1, 2).contiguous()
        h6 = MF.h6_of(h12[:Bn])
        out_f = {d: fn(r, p12, h6) for d, fn in forces_entry.items()}
        Fp, Wp = MF.md_forces_virial_plain(r, p12, h6)
        # float64 truth: pair forces cancel (repulsive/attractive terms of
        # ~100x the net force), so float32 results are judged against
        # float64 and each kernel must be as accurate as the plain version
        F64, W64 = MF.md_forces_virial_plain(r64, p12.double(), h6.double())
        torch.cuda.synchronize()
        fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
        ep = float((Fp.double() - F64).abs().max()) / fmax
        wp = float((Wp.double() - W64).abs().max()) / wmax
        f_err, errs = {}, []
        for d, (F, W) in out_f.items():
            f_err[d] = float((F - Fp).abs().max())
            ek = float((F.double() - F64).abs().max()) / fmax
            wk = float((W.double() - W64).abs().max()) / wmax
            if not torch.isfinite(F).all() or ek > 2 * ep + 1e-6 or wk > 2 * wp + 1e-6:
                fail(f"K1 forces ({d}) B={Bn}: kernel error vs float64 {ek:.3e} (virial "
                     f"{wk:.3e}) exceeds twice the plain float32 error {ep:.3e} (virial "
                     f"{wp:.3e}) + 1e-6")
            errs.append(f"{d} {f_err[d]:.3e} vs plain, {ek:.3e} (virial {wk:.3e}) vs float64")
        # the first design and the redesign in turns (old, new, new, old): the
        # device time of their kernels (profiler), and the time per call of
        # back-to-back calls (CUDA events), which the host's launch path
        # bounds once the device time is below it
        t = {"first": [], "path": []}
        call = {"first": [], "path": []}
        for d in ("first", "path", "path", "first"):
            fn = forces_entry[d]
            t[d].append(device_ms(lambda: fn(r, p12, h6), 50, K1_KERNELS[d]))
            call[d].append(cuda_ms(lambda: fn(r, p12, h6), reps=50, warmup=3))
        f_ms[Bn] = (min(t["first"]), min(t["path"]))
        plain_ms = cuda_ms(lambda: MF.md_forces_virial_plain(r, p12, h6), reps=5)
        fb_ms, fb_by = bound(4.0 * (k1_consts + Bn * (6 * n + 12)),
                             pair_flops(n, Bn, f_lj, virial=True))
        print(f"[4 K1 forces] B={Bn}: max_abs_err and rel error: {'; '.join(errs)}; plain-f32 "
              f"{ep:.3e} (virial {wp:.3e}) vs float64 (tol 2x plain + 1e-6)  device ms (old, "
              f"new, new, old): {turns(t)}; ms per call: {turns(call)} (earlier: "
              f"{PREV_K1_MS['forces']} ms at B=12)  plain {plain_ms:.4f} ms  bound {fb_ms:.4f} "
              f"ms ({fb_by}; {f_lj:.3f} of pairs inside the cutoff)")
        if Bn == 12:  # the kernels line's shape (the probe's)
            ffb_ms, ffb_by = bound(4.0 * (first_consts + Bn * (6 * n + 12)),
                                   pair_flops(n, Bn, f_lj, virial=True))
            forces_row = {"name": "md_k1_forces_virial", "route": "cuda", "source": K1_SOURCE,
                          "replaces": K1_REPLACES, "max_abs_err": f_err["path"],
                          "ms": f_ms[Bn][1], "plain_ms": plain_ms, "bound_ms": fb_ms,
                          "bound_by": fb_by, "library_ms": None}
            first_forces_row = dict(forces_row, name="md_allpairs_forces_virial",
                                    source=FIRST_SOURCE, max_abs_err=f_err["first"],
                                    ms=f_ms[Bn][0], bound_ms=ffb_ms, bound_by=ffb_by)

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
    ref64, _, _ = MF.md_run_plain(r64, state.double(), vxi.double(), n10, fscal.double(), True,
                                  False)
    torch.cuda.synchronize()
    # rounding differences grow chaotically along a trajectory: the kernel's
    # float32 run must stay as close to float64 as the plain float32 run
    pp = float((ref[:, :3].double() - ref64[:, :3]).abs().max())
    vmax = float(ref64[:, 3:].abs().max())
    vp = float((ref[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax

    def run_errors(o, what):
        pk = float((o[:, :3].double() - ref64[:, :3]).abs().max())
        vk = float((o[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
        if not torch.isfinite(o).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4:
            fail(f"{what}: kernel error vs float64 {pk:.3e} A (velocities rel {vk:.3e}) "
                 f"exceeds 4x plain float32 {pp:.3e} A ({vp:.3e}) + 1e-4")
        return pk, vk

    p_err = float((out[:, :3] - ref[:, :3]).abs().max())
    pk, vk = run_errors(out, "K1 run")
    # the first design on the same run, to the same rule
    out1, _, _ = MF._run_first(r, state, vxi, n10, fscal, True, False)
    torch.cuda.synchronize()
    p_err1 = float((out1[:, :3] - ref[:, :3]).abs().max())
    pk1, vk1 = run_errors(out1, "K1 first design run")
    run_plain_ms = cuda_ms(lambda: MF.md_run_plain(r, state, vxi, n10, fscal, True, False),
                           reps=1, warmup=0)
    jobs_bytes = 2 * J * (6 * n + 3) + J * 16
    rb_ms, rb_by = bound(4.0 * (k1_consts + 2 * n + jobs_bytes), pair_flops(n, J * 10, f_lj))
    rb1_ms, rb1_by = bound(4.0 * (first_consts + 2 * n + jobs_bytes),
                           pair_flops(n, J * 10, f_lj))
    # the first design and the redesign in turns, at 576 jobs and at the
    # slice's first step's 144
    run_entry = {"path": MF.md_run, "first": MF._run_first}
    r_ms = {}
    for Jt in (J, 144):
        t = {"first": [], "path": []}
        for d in ("first", "path", "path", "first"):
            fn = run_entry[d]
            t[d].append(cuda_ms(lambda: fn(r, state[:Jt], vxi[:Jt], n10[:Jt], fscal[:Jt], True,
                                           False), reps=3))
        r_ms[Jt] = t
    run_ms = min(r_ms[J]["path"])
    print(f"[4 K1 run] {J} jobs x 10 deform steps: positions max_abs_err vs plain "
          f"{p_err:.3e} A (first design {p_err1:.3e}); vs float64: kernel {pk:.3e} A (first "
          f"design {pk1:.3e}) plain-f32 {pp:.3e} A, velocities rel {vk:.3e} ({vk1:.3e}) / "
          f"{vp:.3e} (tol 4x plain + 1e-4)  kernel {run_ms:.3f} ms (earlier: "
          f"{PREV_K1_MS['run']} ms)  plain {run_plain_ms:.3f} ms  bound {rb_ms:.3f} ms "
          f"({rb_by})")
    for Jt, t in r_ms.items():
        print(f"[4 K1 A/B] {Jt} jobs x 10 deform steps, ms (old, new, new, old): first design "
              f"{t['first'][0]:.3f} / {t['first'][1]:.3f}, redesign {t['path'][0]:.3f} / "
              f"{t['path'][1]:.3f}: {min(t['first']) / min(t['path']):.3f}x")
    for Bn, (old, new) in f_ms.items():
        print(f"[4 K1 A/B] force entry B={Bn}: first design {old:.4f} ms, redesign {new:.4f} ms:"
              f" {old / new:.3f}x")

    # registers, spill bytes and occupancy of K1's two kernels at the g0 box
    info = {e: MF.k1_kernel_info(e, n, T) for e in ("run", "forces")}
    print("[4 K1 kernels] " + "; ".join(
        f"{e}: {x['registers']} registers, {x['local_bytes']} B local, {x['blocks_per_sm']} "
        f"blocks per SM of {x['threads']} threads" for e, x in info.items())
        + f"; first design {kernel_registers(K1_KERNEL)[:1]} (registers, spill stores), one "
        f"block per SM; ptxas (registers, spill stores) {k1_ptxas()}")

    # sampling entry, deterministic: each job's pressure sum over a 20-step
    # sampling run against float64, per Voigt component, held to the same
    # bound as the deform run
    f_s = MF.make_fscal(DT, T_MD, hJ)
    n20 = torch.full((J,), 20, dtype=torch.int32, device=dev)
    _, _, sk = MF.md_run(r, out, xo, n20, f_s, False, True)
    _, _, sp = MF.md_run_plain(r, out, xo, n20, f_s, False, True)
    _, _, s64 = MF.md_run_plain(r64, out.double(), xo.double(), n20, f_s.double(), False, True)
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
    run_row = {"name": "md_k1_run", "route": "cuda", "source": K1_SOURCE,
               "replaces": K1_REPLACES, "max_abs_err": p_err, "ms": run_ms,
               "plain_ms": run_plain_ms, "bound_ms": rb_ms, "bound_by": rb_by,
               "library_ms": None}
    # the first design (md_kernel.cuh, every flag off): no path launches it;
    # the plain version is the same function on the same inputs
    first_rows = [dict(run_row, name="md_allpairs_run", source=FIRST_SOURCE, max_abs_err=p_err1,
                       ms=min(r_ms[J]["first"]), bound_ms=rb1_ms, bound_by=rb1_by),
                  first_forces_row]
    return [run_row, forces_row], first_rows


def phase_slice(dev):
    import torch

    from scema_tpu_torch import cli
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2

    counters = {"md_k1_run": (MF.md_run, "launches"),
                "md_k1_forces_virial": (MF.md_forces_virial, "launches"),
                "md_allpairs_run": (MF._run_first, "launches"),
                "md_allpairs_forces_virial": (MF._forces_first, "launches"),
                "md_charged_run": (MF.md_run, "launches_k3"),
                "md_charged_forces_virial": (MF.md_forces_virial, "launches_k3"),
                "pairwise_l2": (K2.pairwise_l2, "launches"),
                "pairwise_l2_first": (K2._first, "launches")}
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
    for k in ("md_k1_run", "md_k1_forces_virial", "pairwise_l2"):
        if launches[k] <= 0:
            fail(f"kernel {k} was not launched by the main path")
    for k in ("md_allpairs_run", "md_allpairs_forces_virial", "pairwise_l2_first"):
        if launches[k]:  # K1's and K2's first designs
            fail(f"the main path launched {k}, a first design ({launches[k]} times)")
    step_s = [float(s[5]) for s in steps]
    jobs = [int(s[3]) for s in steps]
    print(f"[5 slice] prep (setup) {float(setup.group(1)):.3f}s  s/macro-step {step_s}  "
          f"md jobs {jobs}  launches {launches}  peak memory {peak / 2**20:.1f} MiB  "
          f"wall {wall:.2f}s")
    return launches


def k34_ptxas(kernel: str):
    """{instance: (registers, spill store bytes)} of K3's (LIST false) or
    K4's (LIST true) kernels from the build's ptxas report, keyed by the
    kernel's name and template arguments (empty when the library came from
    the cache)."""
    flag = "Lb1E" if kernel == "K4" else "Lb0E"
    out = {}
    for name, regs, spills in ptxas_entries():
        m = re.search(r"(k34_\w+?_kernel)I" + flag + r"(\w*)", name)
        if m:
            out[f"{m.group(1)}<{m.group(2)[:40]}>"] = (regs, spills)
    return out


def k34_ab(fns, reps: int, names=None) -> dict:
    """The first design and the redesign in turns (old, new, new, old):
    {design: [time, time]}, device time of the kernels named in ``names``
    per design (profiler) or, without, CUDA events per call."""
    t = {"first": [], "path": []}
    for d in ("first", "path", "path", "first"):
        t[d].append(device_ms(fns[d], reps, names[d]) if names else cuda_ms(fns[d], reps=reps))
    return t


K34_NAMES = {"first": ("md_forces_kernel",), "path": ("k34_forces_kernel", "k34_virial_kernel")}


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
    T = int(r.k34_tbl.shape[0])
    st = E.minimize_fire(sys_, st, n_steps=100, dt0=0.5)
    torch.cuda.synchronize()
    print(f"[6 K3] PEAA box: {n} atoms, box {float(st.h[0, 0]):.3f} A, flags {r.spec.flags}, "
          f"{len(r.spec.bonded_pattern)} bonded patterns (reach {MF.pattern_reach(r.spec.bonded_pattern)}), "
          f"SHAKE offsets {r.spec.shake_offsets}, PME mesh {sys_.ff.ewald.mesh}, {T} types, "
          f"window +-{MF.k3_window(r)}, build + FIRE {time.perf_counter() - t0:.2f}s")
    r64 = r.to(dev, torch.float64)

    # force + virial entry at the stiffness probe's 12 deformed boxes, and
    # on the same boxes tilted (the deformed boxes' shear is +-1e-3 only)
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    pos12 = B.remap_affine(st.h.expand(12, 3, 3), h12, st.pos.expand(12, -1, -1))
    ht = h12.clone()
    ht[:, 0, 1], ht[:, 0, 2], ht[:, 1, 2] = 1.5, -1.0, 0.8
    post = B.remap_affine(h12, ht, pos12)
    forces_entry = {"path": MF.md_forces_virial, "first": MF._forces_first}
    f_err, errs = {}, []
    for tag, (pp_, hh) in (("orthorhombic", (pos12, h12)), ("tilted", (post, ht))):
        p12 = pp_.transpose(1, 2).contiguous()
        h6 = MF.h6_of(hh)
        Fp, Wp = MF.md_forces_virial_plain(r, p12, h6)
        F64, W64 = MF.md_forces_virial_plain(r64, p12.double(), h6.double())
        fn = F64.norm(dim=1)
        big = fn > 0.01 * fn.max()
        fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
        ep = float((Fp.double() - F64).abs().max()) / fmax
        wp = float((Wp.double() - W64).abs().max()) / wmax
        pa_p = float(((Fp.double() - F64).norm(dim=1)[big] / fn[big]).max())
        for d, fn_ in forces_entry.items():
            F, W = fn_(r, p12, h6)
            torch.cuda.synchronize()
            pa_k = float(((F.double() - F64).norm(dim=1)[big] / fn[big]).max())
            ek = float((F.double() - F64).abs().max()) / fmax
            wk = float((W.double() - W64).abs().max()) / wmax
            if (not torch.isfinite(F).all() or ek > 2 * ep + 1e-6 or wk > 2 * wp + 1e-6
                    or pa_k > 2 * pa_p + 1e-5):
                fail(f"K3 forces ({d}, {tag}): kernel error vs float64 {ek:.3e} (per atom "
                     f"{pa_k:.3e}, virial {wk:.3e}) exceeds twice the plain float32 error "
                     f"{ep:.3e} ({pa_p:.3e}, {wp:.3e}) + 1e-6 (per atom 1e-5)")
            if tag == "orthorhombic":
                f_err[d] = float((F - Fp).abs().max())
            errs.append(f"{tag} {d} {ek:.3e} (per atom {pa_k:.3e}, virial {wk:.3e})")
        errs.append(f"{tag} plain-f32 {ep:.3e} ({pa_p:.3e}, {wp:.3e})")
    p12 = pos12.transpose(1, 2).contiguous()
    h6 = MF.h6_of(h12)
    fab = k34_ab({d: (lambda fn_=fn_: fn_(r, p12, h6)) for d, fn_ in forces_entry.items()}, 20,
                 K34_NAMES)
    ms = min(fab["path"])
    plain_ms = cuda_ms(lambda: MF.md_forces_virial_plain(r, p12, h6), reps=2)
    # the pairs the function needs: the excluded partners carry no force
    excl = k3_excluded(r)
    f_lj, f_q = pair_fractions(pos12[:2], h12[:2], r.spec.cutoff2, r.spec.coul_cutoff2, excl)
    # the bytes the function needs: K3's table, charges, codes and window,
    # the pattern rows, each box's positions in and forces + virial out;
    # the first design's bound reads the three N x N planes in their place
    tables = 2 * T * T + 3 * n + r.k34_win.numel()
    planes = 3 * n * n
    fb_ms, fb_by = bound(4.0 * (tables + r.pat.numel() + 12 * (6 * n + 12)),
                         pair_flops(n, 12, f_lj, f_q, virial=True))
    ob_ms, ob_by = bound(4.0 * (planes + r.pat.numel() + 12 * (6 * n + 12)),
                         pair_flops(n, 12, f_lj, f_q, virial=True))
    print(f"[6 K3 forces] B=12: max_abs_err vs plain {f_err['path']:.3e} (first design "
          f"{f_err['first']:.3e}); rel error vs float64 (tol 2x "
          f"plain + 1e-6, per atom + 1e-5): {'; '.join(errs)}  device ms (old, new, new, old): "
          f"{turns(fab)}  plain {plain_ms:.4f} ms  bound {fb_ms:.4f} ms ({fb_by}) [the planes' "
          f"{ob_ms:.4f} ({ob_by})]; pairs inside LJ {f_lj:.3f}, Coulomb {f_q:.3f} (excluded "
          f"partners left out)")
    forces_row = {"name": "md_charged_forces_virial", "route": "cuda",
                  "source": "scema_tpu_torch/csrc/md_k3.cu",
                  "replaces": "scema_tpu/ops/md_fused.py:1850",
                  "max_abs_err": f_err["path"], "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None}
    first_forces_row = dict(forces_row, name="md_charged_first_forces_virial",
                            source=FIRST_SOURCE, max_abs_err=f_err["first"],
                            ms=min(fab["first"]), bound_ms=ob_ms, bound_by=ob_by)

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
    out1, _, _ = MF._run_first(r, *args)
    ref, _, _ = MF.md_run_plain(r, *args)
    ref64, _, _ = MF.md_run_plain(r64, state.double(), vxi.double(), n10, fscal.double(), True,
                                  False, fk.double(), g0, n_tot)
    torch.cuda.synchronize()
    p_err = float((out[:, :3] - ref[:, :3]).abs().max())
    pp = float((ref[:, :3].double() - ref64[:, :3]).abs().max())
    vmax = float(ref64[:, 3:].abs().max())
    vp = float((ref[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    res = []
    for d, o in (("path", out), ("first", out1)):
        pk = float((o[:, :3].double() - ref64[:, :3]).abs().max())
        vk = float((o[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
        if not torch.isfinite(o).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4:
            fail(f"K3 run ({d}): kernel error vs float64 {pk:.3e} A (velocities rel {vk:.3e}) "
                 f"exceeds 4x plain float32 {pp:.3e} A ({vp:.3e}) + 1e-4")
        resid = shake_residual(sys_, o[:, :3].transpose(1, 2))
        if not resid < 1e-3:
            fail(f"K3 ({d}) SHAKE residual |r^2 - d0^2| / d0^2 = {resid:.3e} >= 1e-3")
        res.append(f"{d} {pk:.3e} A, velocities rel {vk:.3e}, SHAKE residual {resid:.3e}")
    pme_ms = a.elapsed_time(b)
    rab = k34_ab({"path": lambda: MF.md_run(r, *args), "first": lambda: MF._run_first(r, *args)},
                 3)
    run_ms = min(rab["path"])
    run_plain_ms = cuda_ms(lambda: MF.md_run_plain(r, *args), reps=1, warmup=0)
    pme_ms = min(pme_ms, cuda_ms(lambda: r.kspace(st.pos.expand(J, -1, -1), hJ), reps=3))
    f_lj, f_q = pair_fractions(st.pos[None], st.h[None], r.spec.cutoff2, r.spec.coul_cutoff2,
                               excl)
    jobs_bytes = J * (2 * 6 * n + 3 * n + 16 + 2 * 3 + 3)
    rb_ms, rb_by = bound(4.0 * (tables + r.pat.numel() + r.shk.numel() + jobs_bytes),
                         pair_flops(n, J * 10, f_lj, f_q))
    ob_ms, ob_by = bound(4.0 * (planes + 16 * n + r.pat.numel() + r.shk.numel() + jobs_bytes),
                         pair_flops(n, J * 10, f_lj, f_q))
    print(f"[6 K3 run] {J} jobs x 10 deform steps of {DT} fs, SHAKE + fext: positions max_abs_err "
          f"vs plain {p_err:.3e} A; vs float64 (tol 4x plain + 1e-4, SHAKE 1e-3): "
          f"{'; '.join(res)}; plain-f32 {pp:.3e} A ({vp:.3e})  kernel {run_ms:.3f} ms  plain "
          f"{run_plain_ms:.3f} ms  bound {rb_ms:.3f} ms ({rb_by}) [the planes' {ob_ms:.3f} "
          f"({ob_by})]; pairs inside LJ {f_lj:.3f}, Coulomb {f_q:.3f} (excluded partners left "
          f"out)")
    print(f"[6 K3 A/B] {J} jobs x 10 deform steps, ms (old, new, new, old): first design "
          f"{rab['first'][0]:.3f} / {rab['first'][1]:.3f}, redesign {rab['path'][0]:.3f} / "
          f"{rab['path'][1]:.3f}: {min(rab['first']) / run_ms:.3f}x; force entry B=12 device ms "
          f"{min(fab['first']):.4f} / {ms:.4f}: {min(fab['first']) / ms:.3f}x")
    print(f"[6 K3 PME] k-space remainder (force) for {J} jobs: {pme_ms:.3f} ms")
    info = {e: MF.k34_kernel_info("K3", e, n, T) for e in ("run", "forces")}
    print("[6 K3 kernels] " + "; ".join(
        f"{e}: {x['registers']} registers, {x['local_bytes']} B local, {x['blocks_per_sm']} "
        f"blocks per SM of {x['threads']} threads" for e, x in info.items())
        + f"; ptxas (registers, spill stores) {k34_ptxas('K3')}")

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
               "source": "scema_tpu_torch/csrc/md_k3.cu",
               "replaces": "scema_tpu/ops/md_fused.py:1850",
               "max_abs_err": p_err, "ms": run_ms, "plain_ms": run_plain_ms,
               "bound_ms": rb_ms, "bound_by": rb_by, "library_ms": None}
    first_run_row = dict(run_row, name="md_charged_first_run", source=FIRST_SOURCE,
                         max_abs_err=float((out1[:, :3] - ref[:, :3]).abs().max()),
                         ms=min(rab["first"]), bound_ms=ob_ms, bound_by=ob_by)
    return [run_row, forces_row], [first_run_row, first_forces_row]


def md_counters():
    """The launch counters of the MD kernels K1, K3 and K4 (each redesign's
    and its first design's) and of K2, by the names of the kernels line."""
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2

    return {"md_k1_run": (MF.md_run, "launches"),
            "md_k1_forces_virial": (MF.md_forces_virial, "launches"),
            "md_allpairs_run": (MF._run_first, "launches"),
            "md_allpairs_forces_virial": (MF._forces_first, "launches"),
            "md_charged_run": (MF.md_run, "launches_k3"),
            "md_charged_forces_virial": (MF.md_forces_virial, "launches_k3"),
            "md_charged_first_run": (MF._run_first, "launches_k3"),
            "md_charged_first_forces_virial": (MF._forces_first, "launches_k3"),
            "md_list_run": (MF.md_run, "launches_k4"),
            "md_list_forces_virial": (MF.md_forces_virial, "launches_k4"),
            "md_list_first_run": (MF._run_first, "launches_k4"),
            "md_list_first_forces_virial": (MF._forces_first, "launches_k4"),
            "md_list_cluster_run": (MF.md_run, "launches_k4cluster"),
            "md_list_big_run": (MF.md_run, "launches_k4big"),
            "pairwise_l2": (K2.pairwise_l2, "launches")}


def first_designs_idle(launches: dict, what: str) -> None:
    """Fail unless every first design's counter reads 0."""
    ran = {k: v for k, v in launches.items()
           if (k.startswith("md_allpairs") or "_first" in k) and v}
    if ran:
        fail(f"{what}: a first design was launched on the path: {ran}")


def phase_charged_slice(dev):
    import torch

    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import material as M

    counters = md_counters()
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
    first_designs_idle(launches, "charged slice")
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
    T = int(r.k34_tbl.shape[0])
    st = E.minimize_fire(sys_, st, n_steps=100, dt0=0.5)
    torch.cuda.synchronize()
    print(f"[8 K4] PEAA2240 box: {n} atoms, box {float(st.h[0, 0]):.3f} A, flags {r.spec.flags}, "
          f"list width K={K} (r_list {r.nspec.r_list} A, rebuilt every {r.rebuild_every} steps), "
          f"PME mesh {sys_.ff.ewald.mesh}, build + FIRE {time.perf_counter() - t0:.2f}s")
    r64 = r.to(dev, torch.float64)
    n_ch = len(r.channel_names)

    # force + virial entry at the stiffness probe's 12 deformed boxes, and
    # on the same boxes tilted, each on one list built at those positions
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    pos12 = B.remap_affine(st.h.expand(12, 3, 3), h12, st.pos.expand(12, -1, -1))
    ht = h12.clone()
    ht[:, 0, 1], ht[:, 0, 2], ht[:, 1, 2] = 1.5, -1.0, 0.8
    post = B.remap_affine(h12, ht, pos12)
    forces_entry = {"path": MF.md_forces_virial, "first": MF._forces_first}
    f_err, errs = {}, []
    for tag, (pp_, hh) in (("orthorhombic", (pos12, h12)), ("tilted", (post, ht))):
        p12 = pp_.transpose(1, 2).contiguous()
        h6 = MF.h6_of(hh)
        nb = {"path": r.channels(pp_, hh), "first": r.channels_first(pp_, hh)}
        Fp, Wp = MF.md_forces_virial_plain(r, p12, h6, nb["path"])
        F64, W64 = MF.md_forces_virial_plain(r64, p12.double(), h6.double(), nb["path"])
        fn = F64.norm(dim=1)
        big = fn > 0.01 * fn.max()
        fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
        ep = float((Fp.double() - F64).abs().max()) / fmax
        wp = float((Wp.double() - W64).abs().max()) / wmax
        pa_p = float(((Fp.double() - F64).norm(dim=1)[big] / fn[big]).max())
        for d, fn_ in forces_entry.items():
            F, W = fn_(r, p12, h6, nbr=nb[d])
            torch.cuda.synchronize()
            pa_k = float(((F.double() - F64).norm(dim=1)[big] / fn[big]).max())
            ek = float((F.double() - F64).abs().max()) / fmax
            wk = float((W.double() - W64).abs().max()) / wmax
            if (not torch.isfinite(F).all() or ek > 4 * ep + 1e-6 or wk > 4 * wp + 1e-6
                    or pa_k > 4 * pa_p + 1e-5):
                fail(f"K4 forces ({d}, {tag}): kernel error vs float64 {ek:.3e} (per atom "
                     f"{pa_k:.3e}, virial {wk:.3e}) exceeds 4x the plain float32 error "
                     f"{ep:.3e} ({pa_p:.3e}, {wp:.3e}) + 1e-6 (per atom 1e-5)")
            if tag == "orthorhombic":
                f_err[d] = float((F - Fp).abs().max())
            errs.append(f"{tag} {d} {ek:.3e} (per atom {pa_k:.3e}, virial {wk:.3e})")
        errs.append(f"{tag} plain-f32 {ep:.3e} ({pa_p:.3e}, {wp:.3e})")
        if int(nb["path"]["count"].max()) >= K:
            fail(f"K4: a list row is full ({int(nb['path']['count'].max())} of K={K})")
    p12 = pos12.transpose(1, 2).contiguous()
    h6 = MF.h6_of(h12)
    nbr12 = {"path": r.channels(pos12, h12), "first": r.channels_first(pos12, h12)}
    fab = k34_ab({d: (lambda fn_=fn_, d=d: fn_(r, p12, h6, nbr=nbr12[d]))
                  for d, fn_ in forces_entry.items()}, 20, K34_NAMES)
    ms = min(fab["path"])
    plain_ms = cuda_ms(lambda: MF.md_forces_virial_plain(r, p12, h6, nbr12["path"]), reps=2)
    # the pairs the function needs: the compact list's (the excluded
    # partners dropped)
    lp, lj, lq = list_pair_counts(MF.k4_slots_to_channels(r, nbr12["path"]), pos12, h12,
                                  r.spec.cutoff2, r.spec.coul_cutoff2)
    # the bytes the function needs: each box's compact list once (4 B per
    # listed slot and its count), the type table, charges and codes, the
    # pattern rows, positions in and forces + virial out; the first design's
    # bound [in brackets] reads its list's index and image channels (4 x 4 B
    # per slot of K) and the three N x N planes
    tables = 2 * T * T + 2 * n
    live12 = float(nbr12["path"]["count"].double().sum()) / 12
    fb_ms, fb_by = bound(12 * 4.0 * (live12 + n + 6 * n + 6)
                         + 4.0 * (tables + r.pat.numel()),
                         list_flops(12, lp, lj, lq, virial=True))
    ob_ms, ob_by = bound(12 * (16.0 * K * n + 4.0 * (6 * n + 6))
                         + 4.0 * (3 * n * n + r.pat.numel() + 2 * n),
                         list_flops(12, lp, lj, lq, virial=True))
    print(f"[8 K4 forces] B=12: max_abs_err vs plain {f_err['path']:.3e} (first design "
          f"{f_err['first']:.3e}); rel error vs float64 (tol 4x "
          f"plain + 1e-6, per atom + 1e-5): {'; '.join(errs)}  device ms (old, new, new, old): "
          f"{turns(fab)}  plain {plain_ms:.4f} ms  bound {fb_ms:.4f} ms ({fb_by}) [7 channels: "
          f"{ob_ms:.4f} ({ob_by})]; per box {lp:.0f} list pairs, {lj:.0f} inside LJ, {lq:.0f} "
          f"inside Coulomb (excluded partners dropped)")
    forces_row = {"name": "md_list_forces_virial", "route": "cuda",
                  "source": "scema_tpu_torch/csrc/md_k4.cu",
                  "replaces": "scema_tpu/ops/md_fused.py:1850",
                  "note": K4_NOTE,
                  "max_abs_err": f_err["path"], "ms": ms, "plain_ms": plain_ms,
                  "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None}
    first_forces_row = dict(forces_row, name="md_list_first_forces_virial",
                            source="scema_tpu_torch/csrc/md_list.cu",
                            max_abs_err=f_err["first"], ms=min(fab["first"]), bound_ms=ob_ms,
                            bound_by=ob_by)

    # the main path's chunk shape (128 jobs x 10 steps) and a 16-job
    # subset checked against float32 and float64
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
    # the rebuild: the compact pack (the path's, into the chunk loop's
    # buffers) and the first design's seven channels, in turns
    nb_t = k34_ab({"path": lambda: r.channels(posJ, hJ, reuse=True),
                   "first": lambda: r.channels_first(posJ, hJ)}, 2)
    list_ms = cuda_ms(lambda: NB.build(r.nspec, posJ, hJ), reps=2)
    nbrJ = r.channels(posJ, hJ, reuse=True)
    chJ = r.channels_first(posJ, hJ)
    Fk, _ = r.kspace(posJ, hJ)
    fk = Fk.transpose(1, 2).contiguous()
    S = 16
    args = (state, vxi, n10, fscal, True, False, fk, g0, n_tot)
    sub = tuple(x[:S] if torch.is_tensor(x) and x.dim() else x for x in args)
    nbrS = {k: v[:S] for k, v in nbrJ.items()}
    chS = {k: v[:S] for k, v in chJ.items()}
    out, xo, _ = MF.md_run(r, *sub, nbr=nbrS)
    out1, _, _ = MF._run_first(r, *sub, nbr=chS)
    ref, _, _ = MF.md_run_plain(r, *sub, nbr=nbrS)
    ref64, _, _ = MF.md_run_plain(r64, state[:S].double(), vxi[:S].double(), n10[:S],
                                  fscal[:S].double(), True, False, fk[:S].double(), g0[:S],
                                  n_tot[:S], nbr=nbrS)
    torch.cuda.synchronize()
    p_err = float((out[:, :3] - ref[:, :3]).abs().max())
    pp = float((ref[:, :3].double() - ref64[:, :3]).abs().max())
    vmax = float(ref64[:, 3:].abs().max())
    vp = float((ref[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    res = []
    for d, o in (("path", out), ("first", out1)):
        pk = float((o[:, :3].double() - ref64[:, :3]).abs().max())
        vk = float((o[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
        if not torch.isfinite(o).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4:
            fail(f"K4 run ({d}): kernel error vs float64 {pk:.3e} A (velocities rel {vk:.3e}) "
                 f"exceeds 4x plain float32 {pp:.3e} A ({vp:.3e}) + 1e-4")
        resid = shake_residual(sys_, o[:, :3].transpose(1, 2))
        if not resid < 1e-3:
            fail(f"K4 ({d}) SHAKE residual |r^2 - d0^2| / d0^2 = {resid:.3e} >= 1e-3")
        res.append(f"{d} {pk:.3e} A, velocities rel {vk:.3e}, SHAKE residual {resid:.3e}")
    print(f"[8 K4 run16] {S} jobs x 10 deform steps of {DT} fs, SHAKE + fext: positions "
          f"max_abs_err vs plain {p_err:.3e} A; vs float64 (tol 4x plain + 1e-4, SHAKE 1e-3): "
          f"{'; '.join(res)}; plain-f32 {pp:.3e} A ({vp:.3e})")

    rab = k34_ab({"path": lambda: MF.md_run(r, *args, nbr=nbrJ),
                  "first": lambda: MF._run_first(r, *args, nbr=chJ)}, 3)
    run_ms = min(rab["path"])
    run_plain_ms = cuda_ms(lambda: MF.md_run_plain(r, *args, nbr=nbrJ), reps=1, warmup=0)
    lp, lj, lq = list_pair_counts(MF.k4_slots_to_channels(r, {k: v[:2] for k, v in nbrJ.items()}),
                                  posJ[:2], hJ[:2], r.spec.cutoff2, r.spec.coul_cutoff2)
    cnt = nbrJ["count"].double()
    listed = (chJ["idx"] != torch.arange(n, dtype=torch.int32, device=dev)).sum(1).double()
    live_mean = float(cnt.mean())
    jobs_bytes = 4.0 * (2 * 6 * n + 3 * n + 16 + 2 * 3 + 3)
    rb_ms, rb_by = bound(J * (4.0 * (live_mean * n + n) + jobs_bytes)
                         + 4.0 * (tables + r.pat.numel() + r.shk.numel() + 2 * n),
                         list_flops(J * 10, lp, lj, lq))
    ob_ms, ob_by = bound(J * (16.0 * K * n + jobs_bytes)
                         + 4.0 * (3 * n * n + r.pat.numel() + r.shk.numel() + 2 * n),
                         list_flops(J * 10, lp, lj, lq))
    stream = {"path": J * 10 * 4.0 * live_mean * n, "first": J * 10 * 4.0 * n_ch * K * n}
    print(f"[8 K4 run] {J} jobs x 10 deform steps: kernel {run_ms:.3f} ms  plain "
          f"{run_plain_ms:.3f} ms  bound {rb_ms:.3f} ms ({rb_by}; the compact lists once "
          f"{J * 4.0 * live_mean * n / 1e9:.3f} GB; per box {lp:.0f} list pairs, {lj:.0f} inside "
          f"LJ, {lq:.0f} inside Coulomb) [7 channels: {ob_ms:.3f} ({ob_by})]  slots re-read "
          f"every step: "
          f"{stream['path'] / 1e9:.2f} GB = {stream['path'] / HBM_BPS * 1e3:.3f} ms at 3.35 TB/s "
          f"(first design's {n_ch} channels {stream['first'] / 1e9:.2f} GB = "
          f"{stream['first'] / HBM_BPS * 1e3:.3f} ms)")
    print(f"[8 K4 A/B] {J} jobs x 10 deform steps, ms (old, new, new, old): first design "
          f"{rab['first'][0]:.3f} / {rab['first'][1]:.3f}, redesign {rab['path'][0]:.3f} / "
          f"{rab['path'][1]:.3f}: {min(rab['first']) / run_ms:.3f}x; force entry B=12 device ms "
          f"{min(fab['first']):.4f} / {ms:.4f}: {min(fab['first']) / ms:.3f}x")
    # K4's global form (the velocities and role/SHAKE buffer in device
    # memory) on the same box and chunk, against float64 on 16 jobs and in
    # turns with the shared form (shared, global, global, shared): what the
    # L2-resident rows cost the pattern and SHAKE/RATTLE passes
    og, _, _ = MF.k4_global_run(r, *sub, nbr=nbrS)
    torch.cuda.synchronize()
    gk, gv = _run_rule(og, ref, ref64, "K4 global form (N=2240)")
    forms = k34_ab({"first": lambda: MF.md_run(r, *args, nbr=nbrJ),
                    "path": lambda: MF.k4_global_run(r, *args, nbr=nbrJ)}, 3)
    print(f"[8 K4 forms] N={n}, {J} jobs x 10 deform steps, ms (shared, global, global, "
          f"shared): {turns(forms)}: global / shared {min(forms['path']) / min(forms['first']):.3f}; "
          f"the global form on {S} jobs vs float64 {gk:.3e} A, velocities rel {gv:.3e} (tol 4x "
          f"plain + 1e-4)")
    print(f"[8 K4 list] {J} jobs: live slots per row mean {live_mean:.1f}, min "
          f"{int(cnt.min())}, max {int(cnt.max())} of K={K}; listed (before dropping the "
          f"excluded partners) mean {float(listed.mean()):.1f}, max {int(listed.max())}; "
          f"dropped per row {float((listed - cnt).mean()):.2f}; inside LJ "
          f"{2 * lj / n:.1f}, inside Coulomb {2 * lq / n:.1f} per row")
    print(f"[8 neighbor] {J} jobs: list build + pack, ms (old, new, new, old): first design's "
          f"seven channels {nb_t['first'][0]:.3f} / {nb_t['first'][1]:.3f}, compact "
          f"{nb_t['path'][0]:.3f} / {nb_t['path'][1]:.3f} (build alone {list_ms:.3f} ms), "
          f"{NB.jobs_per_slice(r.nspec, n)} jobs per slice")
    info = {e: MF.k34_kernel_info("K4", e, n, T) for e in ("run", "forces")}
    print("[8 K4 kernels] " + "; ".join(
        f"{e}: {x['registers']} registers, {x['local_bytes']} B local, {x['blocks_per_sm']} "
        f"blocks per SM of {x['threads']} threads" for e, x in info.items())
        + f"; ptxas (registers, spill stores) {k34_ptxas('K4')}")

    # K3 all-pairs on the same box, shapes and inputs (the crossover)
    ap = MF.make_runner(sys_.ff, sys_.masses, REAL, dtype=torch.float32, device=dev,
                        constraints=sys_.constraints, kspace=r.kspace, kspace_every=10)
    if ap.spec.kernel != "K3":
        fail(f"the all-pairs runner of the 2240-atom box is {ap.spec.kernel}, not K3")
    k3_ms = cuda_ms(lambda: MF.md_run(ap, *args), reps=3)
    k3_out, _, _ = MF.md_run(ap, *args)
    k4_out, _, _ = MF.md_run(r, *args, nbr=nbrJ)
    torch.cuda.synchronize()
    nb_ms = min(nb_t["path"])
    print(f"[8 crossover] N={n}, {J} jobs x 10 deform steps: K3 all-pairs {k3_ms:.3f} ms, K4 list "
          f"{run_ms:.3f} ms (+ its list build {nb_ms:.3f} ms per rebuild): K4/K3 "
          f"{(run_ms + nb_ms) / k3_ms:.3f}; max |pos K3 - K4| after the chunk "
          f"{float((k3_out[:, :3] - k4_out[:, :3]).abs().max()):.3e} A")
    del chJ

    # 20-step sampling at 16 jobs: each job's pressure sums against float64
    n20 = torch.full((S,), 20, dtype=torch.int32, device=dev)
    f_s = MF.make_fscal(DT, T_MD, hJ[:S])
    one = torch.ones_like(n20)
    sargs = (out, xo, n20, f_s, False, True, fk[:S], g0[:S], one)
    _, _, sk = MF.md_run(r, *sargs, nbr=nbrS)
    _, _, sp = MF.md_run_plain(r, *sargs, nbr=nbrS)
    _, _, s64 = MF.md_run_plain(r64, out.double(), xo.double(), n20, f_s.double(), False, True,
                                fk[:S].double(), g0[:S], one, nbr=nbrS)
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
               "source": "scema_tpu_torch/csrc/md_k4.cu",
               "replaces": "scema_tpu/ops/md_fused.py:1850",
               "note": K4_NOTE,
               "max_abs_err": p_err, "ms": run_ms, "plain_ms": run_plain_ms,
               "bound_ms": rb_ms, "bound_by": rb_by, "library_ms": None}
    first_run_row = dict(run_row, name="md_list_first_run",
                         source="scema_tpu_torch/csrc/md_list.cu",
                         max_abs_err=float((out1[:, :3] - ref[:, :3]).abs().max()),
                         ms=min(rab["first"]), bound_ms=ob_ms, bound_by=ob_by)
    return [run_row, forces_row], [first_run_row, first_forces_row]


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
    counters = md_counters()
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
    if launches["md_list_run"] <= 0 or any(v for k, v in launches.items() if k != "md_list_run"):
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

    counters = md_counters()
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
    first_designs_idle(launches, "list slice")
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


K5_SOURCE, K5_FIRST_SOURCE = "scema_tpu_torch/csrc/md_k5.cu", "scema_tpu_torch/csrc/md_sw.cu"
K5_NOTE = "K5: FusedSpec.sw -> forces_allpairs_sw (md_fused.py:910-1081)"
# K5's first design's run kernel (md_kernel.cuh's SW instance), mangled
K5_FIRST_KERNEL = "md_run_kernelILb0ELb0ELb0ELb0ELb0ELb0ELb1E"
# the kernels of each K5 design's force entry, by name (the first design's
# SW instance of md_forces_kernel)
K5_NAMES = {"first": ("md_forces_kernel",),
            "path": ("k5_moments_kernel", "k5_forces_kernel", "k5_virial_kernel")}


def _k5_forces_check(r, r64, pos, h, tag):
    """K5's force entry (the path's and the first design's) on boxes pos (B,
    N, 3) in h (B, 3, 3) against the plain version and float64 (twice the
    plain float32 error + 1e-6, per atom + 1e-5): ({design: max |F - plain|},
    a summary)."""
    import torch

    from scema_tpu_torch.ops import md_fused as MF

    p12 = pos.transpose(1, 2).contiguous()
    h6 = MF.h6_of(h)
    Fp, Wp = MF.md_forces_virial_plain(r, p12, h6)
    F64, W64 = MF.md_forces_virial_plain(r64, p12.double(), h6.double())
    fn = F64.norm(dim=1)
    big = fn > 0.01 * fn.max()
    fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
    ep = float((Fp.double() - F64).abs().max()) / fmax
    wp = float((Wp.double() - W64).abs().max()) / wmax
    pa_p = float(((Fp.double() - F64).norm(dim=1)[big] / fn[big]).max())
    errs, out = [], {}
    for d, fn_ in (("path", MF.md_forces_virial), ("first", MF._forces_first)):
        F, W = fn_(r, p12, h6)
        torch.cuda.synchronize()
        pa_k = float(((F.double() - F64).norm(dim=1)[big] / fn[big]).max())
        ek = float((F.double() - F64).abs().max()) / fmax
        wk = float((W.double() - W64).abs().max()) / wmax
        if (not torch.isfinite(F).all() or ek > 2 * ep + 1e-6 or wk > 2 * wp + 1e-6
                or pa_k > 2 * pa_p + 1e-5):
            fail(f"K5 forces ({d}, {tag}): kernel error vs float64 {ek:.3e} (per atom "
                 f"{pa_k:.3e}, virial {wk:.3e}) exceeds twice the plain float32 error "
                 f"{ep:.3e} ({pa_p:.3e}, {wp:.3e}) + 1e-6 (per atom 1e-5)")
        out[d] = float((F - Fp).abs().max())
        errs.append(f"{tag} {d} {ek:.3e} (per atom {pa_k:.3e}, virial {wk:.3e})")
    errs.append(f"{tag} plain-f32 {ep:.3e} ({pa_p:.3e}, {wp:.3e})")
    return out, errs


def _run_rule(o, ref, ref64, what):
    """Fail unless the run o is within four times the plain float32 run's
    distance from float64 (+1e-4) in positions and velocities; returns
    (positions error, velocities relative error)."""
    import torch

    pk = float((o[:, :3].double() - ref64[:, :3]).abs().max())
    pp = float((ref[:, :3].double() - ref64[:, :3]).abs().max())
    vmax = float(ref64[:, 3:].abs().max())
    vk = float((o[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    vp = float((ref[:, 3:].double() - ref64[:, 3:]).abs().max()) / vmax
    if not torch.isfinite(o).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4:
        fail(f"{what}: kernel error vs float64 {pk:.3e} A (velocities rel {vk:.3e}) "
             f"exceeds 4x plain float32 {pp:.3e} A ({vp:.3e}) + 1e-4")
    return pk, vk


def phase_k5(dev):
    import torch

    from scema_tpu_torch.md import box as B
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
          f"cutoff {r.spec.cutoff2 ** 0.5:.4f} A, live-list cap {MF.K5_CAP}, prep (FIRE 100 + "
          f"NVT 100 at {T_MD} K) {time.perf_counter() - t0:.2f}s")
    r64 = r.to(dev, torch.float64)
    rc2 = MF.sw_consts(r.spec)["rc2"]

    # force + virial entry at the stiffness probe's 12 deformed boxes, and
    # on the same boxes tilted (xy 0.9, xz -0.6, yz 0.4 A)
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    pos12 = B.remap_affine(st.h.expand(12, 3, 3), h12, st.pos.expand(12, -1, -1))
    ht = h12.clone()
    ht[:, 0, 1], ht[:, 0, 2], ht[:, 1, 2] = 0.9, -0.6, 0.4
    post = B.remap_affine(h12, ht, pos12)
    f_err, errs = _k5_forces_check(r, r64, pos12, h12, "orthorhombic")
    errs += _k5_forces_check(r, r64, post, ht, "tilted")[1]
    p12 = pos12.transpose(1, 2).contiguous()
    h6 = MF.h6_of(h12)
    fab = k34_ab({d: (lambda fn_=fn_: fn_(r, p12, h6))
                  for d, fn_ in (("path", MF.md_forces_virial), ("first", MF._forces_first))},
                 20, K5_NAMES)
    call_ms = cuda_ms(lambda: MF.md_forces_virial(r, p12, h6), reps=20)
    plain_ms = cuda_ms(lambda: MF.md_forces_virial_plain(r, p12, h6), reps=5)
    live12 = sw_live_pairs(pos12[:2], h12[:2], rc2)
    fb_ms, fb_by = bound(4.0 * (2 * 12 * (3 * n + 6)), sw_flops(n, 12, live12, virial=True))
    print(f"[11 K5 forces] B=12: max_abs_err vs plain {f_err['path']:.3e} (first design "
          f"{f_err['first']:.3e}); rel error vs float64 (tol 2x plain + 1e-6, per atom + 1e-5): "
          f"{'; '.join(errs)}  device ms (old, new, new, old): {turns(fab)}; {call_ms:.4f} ms "
          f"per call  plain {plain_ms:.4f} ms  bound {fb_ms:.5f} ms ({fb_by}; {live12:.1f} live "
          f"of {n * (n - 1) // 2} pairs per box)")
    forces_row = {"name": "md_sw_forces", "route": "cuda", "source": K5_SOURCE,
                  "replaces": "scema_tpu/ops/md_fused.py:1850", "note": K5_NOTE,
                  "max_abs_err": f_err["path"], "ms": min(fab["path"]), "plain_ms": plain_ms,
                  "bound_ms": fb_ms, "bound_by": fb_by, "library_ms": None}
    first_forces_row = dict(forces_row, name="md_sw_first_forces", source=K5_FIRST_SOURCE,
                            max_abs_err=f_err["first"], ms=min(fab["first"]))

    # the main path's run shape: 576 jobs x 10 deform steps, both designs,
    # the path's live lists at its cap
    J = 576
    state, vxi, hJ, fscal = _sw_run_batch(sys_, st, J, 12, dev)
    n10 = torch.full((J,), 10, dtype=torch.int32, device=dev)
    out, xo, _, stats = MF.k5_run_stats(r, state, vxi, n10, fscal, True, False)
    out1, _, _ = MF._run_first(r, state, vxi, n10, fscal, True, False)
    ref, _, _ = MF.md_run_plain(r, state, vxi, n10, fscal, True, False)
    ref64, _, _ = MF.md_run_plain(r64, state.double(), vxi.double(), n10, fscal.double(), True,
                                  False)
    torch.cuda.synchronize()
    p_err = float((out[:, :3] - ref[:, :3]).abs().max())
    res = []
    for d, o in (("path", out), ("first", out1)):
        pk, vk = _run_rule(o, ref, ref64, f"K5 run ({d})")
        res.append(f"{d} {pk:.3e} A, velocities rel {vk:.3e}")
    pp = float((ref[:, :3].double() - ref64[:, :3]).abs().max())
    over, most = int(stats[:, 0].sum()), int(stats[:, 1].max())
    print(f"[11 K5 run] {J} jobs x 10 deform steps of {DT} fs: positions max_abs_err vs plain "
          f"{p_err:.3e} A; vs float64 (tol 4x plain + 1e-4): {'; '.join(res)}; plain-f32 "
          f"{pp:.3e} A; live list: most live js of an atom {most} (cap {MF.K5_CAP}), "
          f"{over} atom-calls above the cap")

    # live-list caps that some (8) or every (2) atom exceeds: those atoms
    # walk all N js in sweep 2, to the same rule, on 16 jobs
    S = 16
    sub = (state[:S], vxi[:S], n10[:S], fscal[:S], True, False)
    caps = []
    for cap in (8, 2):
        o, _, _, st_c = MF.k5_run_stats(r, *sub, cap=cap)
        torch.cuda.synchronize()
        pk, _ = _run_rule(o, ref[:S], ref64[:S], f"K5 run at cap {cap}")
        if cap == 2 and not bool((st_c[:, 0] > 0).all()):
            fail(f"K5 at cap 2: a job counted no atom above the cap: {st_c[:, 0].tolist()}")
        caps.append(f"cap {cap}: {int(st_c[:, 0].sum())} atom-calls above it, vs float64 "
                    f"{pk:.3e} A")
    print(f"[11 K5 caps] {S} jobs x 10 deform steps (tol 4x plain + 1e-4): {'; '.join(caps)}")

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

    # times at N = 216 and at the fused gate's largest cubic box, N = 512:
    # the first design and the redesign in turns (old, new, new, old)
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
        if cells == 4:  # the 512-atom run to the same rule, on 16 jobs
            sa = tuple(x[:S] if torch.is_tensor(x) and x.dim() else x for x in a)
            o4, _, _ = MF.md_run(rc_, *sa)
            _run_rule(o4, MF.md_run_plain(rc_, *sa)[0],
                      MF.md_run_plain(rc_.to(dev, torch.float64),
                                      *(x.double() if torch.is_tensor(x) and x.is_floating_point()
                                        else x for x in sa))[0], "K5 run (N=512)")
        rab = k34_ab({"path": lambda: MF.md_run(rc_, *a), "first": lambda: MF._run_first(rc_, *a)},
                     3)
        p_ms = cuda_ms(lambda: MF.md_run_plain(rc_, *a), reps=1, warmup=0)
        live = sw_live_pairs(st_c.pos[None], st_c.h[None], rc2)
        b_ms, b_by = bound(4.0 * (J * (2 * (6 * nc + 3) + 16 + 6) + 2 * nc),
                           sw_flops(nc, J * 10, live))
        k_ms = min(rab["path"])
        times[nc] = (k_ms, p_ms, b_ms, b_by, min(rab["first"]))
        info = MF.k5_kernel_info("run", nc)
        print(f"[11 K5 time] N={nc}, {J} jobs x 10 deform steps, ms (old, new, new, old): "
              f"{turns(rab)}: {min(rab['first']) / k_ms:.3f}x  plain {p_ms:.3f} ms  bound "
              f"{b_ms:.4f} ms ({b_by}; {live:.1f} live of {nc * (nc - 1) // 2} pairs per box)  "
              f"kernel at {100 * b_ms / k_ms:.2f}% of its bound; run kernel "
              f"{info['registers']} registers, {info['local_bytes']} B local, "
              f"{info['blocks_per_sm']} blocks per SM of {info['threads']} threads")
    ents = {e: MF.k5_kernel_info(e, n) for e in ("moments", "forces")}
    print("[11 K5 kernels] " + "; ".join(
        f"{e}: {x['registers']} registers, {x['local_bytes']} B local, {x['blocks_per_sm']} "
        f"blocks per SM of {x['threads']} threads" for e, x in ents.items())
        + f"; ptxas (registers, spill stores) {kernel_registers('k5_')}, the first design "
        f"{kernel_registers(K5_FIRST_KERNEL)}")

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
    k216, p216, b216, by216, f216 = times[216]
    k512, p512, b512, _, f512 = times[512]
    run_row = {"name": "md_sw_run", "route": "cuda", "source": K5_SOURCE,
               "replaces": "scema_tpu/ops/md_fused.py:1850",
               "note": K5_NOTE + "; 576 jobs x 10 deform steps at N=216, and at N=512 in *_n512",
               "max_abs_err": p_err, "ms": k216, "plain_ms": p216, "bound_ms": b216,
               "bound_by": by216, "library_ms": None, "ms_n512": k512,
               "plain_ms_n512": p512, "bound_ms_n512": b512}
    first_run_row = dict(run_row, name="md_sw_first_run", source=K5_FIRST_SOURCE,
                         max_abs_err=float((out1[:, :3] - ref[:, :3]).abs().max()), ms=f216,
                         ms_n512=f512)
    return [run_row, forces_row], [first_run_row, first_forces_row]


def phase_sw_slice(dev):
    import torch

    from scema_tpu_torch import cli
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2

    counters = {"md_k1_run": (MF.md_run, "launches"),
                "md_k1_forces_virial": (MF.md_forces_virial, "launches"),
                "md_allpairs_run": (MF._run_first, "launches"),
                "md_allpairs_forces_virial": (MF._forces_first, "launches"),
                "md_charged_run": (MF.md_run, "launches_k3"),
                "md_charged_forces_virial": (MF.md_forces_virial, "launches_k3"),
                "md_list_run": (MF.md_run, "launches_k4"),
                "md_list_forces_virial": (MF.md_forces_virial, "launches_k4"),
                "md_sw_run": (MF.md_run, "launches_k5"),
                "md_sw_forces": (MF.md_forces_virial, "launches_k5"),
                "md_sw_first_run": (MF._run_first, "launches_k5"),
                "md_sw_first_forces": (MF._forces_first, "launches_k5"),
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
    first_designs_idle(launches, "SW slice")
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


def k6_pruned_share(tiles, nbr, valid, pruned):
    """The share of the stencil's occupied candidate pairs that the sphere
    test rules out: pruned (B, C, K, 4, 4) chunk pairs of tiles (B, C, 4,
    128)."""
    from scema_tpu_torch.ops import sw_bricks as SWB

    B, C = tiles.shape[:2]
    n = (tiles[:, :, 3] > 0.5).reshape(B, C, -1, SWB.CHUNK).sum(-1).double()
    cand = (n[:, :, None, :, None] * n[:, nbr.long()][:, :, :, None, :]
            * valid.double()[None, :, :, None, None])
    return float((cand * pruned).sum() / cand.sum())


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
        # the first design on the same inputs, to the same rule, and both
        # forces kernels on the same adjoints (those of the path's moments)
        tl = SWB.pack_bricks(p12, ff.slot_ids)
        hb, ib = SWB.boxes(ht, (12,), torch.float32, dev)
        cnt = torch.empty((12, C, 128), dtype=torch.int32, device=dev)
        lst = torch.empty((12, C, SWB.LIST_CAP, 128), dtype=torch.int32, device=dev)
        sph = torch.empty((12, C, 4, 4), dtype=torch.float32, device=dev)
        mom_n = SWB._launch_moments(sw, tl, ff.nbr, ff.valid, hb, ib, (cnt, lst), sph)
        mom_f = SWB._moments_first(sw, tl, ff.nbr, ff.valid, hb, ib)
        adj = SWB.adjoints(sw, mom_n)
        ov = torch.zeros(1, dtype=torch.int32, device=dev)
        fo_n = SWB._launch_forces(sw, tl, adj, ff.nbr, ff.valid, hb, ib, cnt, lst, ov)
        fo_f = SWB._forces_first(sw, tl, adj, ff.nbr, ff.valid, hb, ib)
        fo_p = SWB.sw_forces_plain(sw, tl, adj, ff.nbr, ff.valid, hb, ib)
        fo_64 = SWB.sw_forces_plain(sw, tl.double(), adj.double(), ff.nbr, ff.valid, hb.double(),
                                    ib.double())
        # the overflow path: a list of 2 per slot sends most slots to the
        # forces kernel's stencil sweep
        cnt2 = torch.empty((12, C, 128), dtype=torch.int32, device=dev)
        lst2 = torch.empty((12, C, 2, 128), dtype=torch.int32, device=dev)
        SWB._launch_moments(sw, tl, ff.nbr, ff.valid, hb, ib, (cnt2, lst2))
        ov2 = torch.zeros(1, dtype=torch.int32, device=dev)
        fo_o = SWB._launch_forces(sw, tl, adj, ff.nbr, ff.valid, hb, ib, cnt2, lst2, ov2)
        torch.cuda.synchronize()
        n_over = int(ov2)
        # the kernel's lists and spheres against their plain models (float64
        # on the same tiles; a pair within 1e-4 of rc2 may go either way)
        l_bad, l_margin = SWB.live_list_errors(sw, tl, ff.nbr, ff.valid, hb, ib, cnt, lst)
        l2_bad, _ = SWB.live_list_errors(sw, tl, ff.nbr, ff.valid, hb, ib, cnt2, lst2)
        d_sph = float((sph.double() - SWB.chunk_spheres_plain(tl.double(), hb.double(),
                                                              ib.double())).abs().max())
        mf, ff_rel = _rel(mom_f, mom64.reshape(mom_f.shape)), _rel(fo_f, fo_64)
        fn_rel, fp_rel = _rel(fo_n, fo_64), _rel(fo_p, fo_64)
        fo_rel = _rel(fo_o, fo_64)
        d_mom = float((mom_n - mom_f).abs().max())
        d_frc = float((fo_n - fo_f).abs().max())
        print(f"[13 K6 designs] tilt {tilt}: first design rel error vs float64: moments "
              f"{mf:.3e}, forces {ff_rel:.3e} (path's {fn_rel:.3e}, plain f32 {fp_rel:.3e}); "
              f"max |path - first design|: moments {d_mom:.3e}, forces on the same adjoints "
              f"{d_frc:.3e} (bit for bit: {d_mom == 0.0 and d_frc == 0.0}); live list max "
              f"{int(cnt.max())} of cap {SWB.LIST_CAP}, {int(ov)} slots over; cap 2: {n_over} "
              f"slots swept the stencil (of {int((cnt2 > 2).sum())} past 2), forces channels "
              f"{fo_rel:.3e} vs float64")
        print(f"[13 K6 list check] tilt {tilt}: kernel's live list vs the float64 sweep: "
              f"{l_bad} violations at cap {SWB.LIST_CAP}, {l2_bad} at cap 2 ({l_margin} listed "
              f"pairs within 1e-4 of rc2); spheres vs chunk_spheres_plain max abs {d_sph:.3e} A "
              f"(tol 1e-3, the test's margin {SWB.PRUNE_MARGIN})")
        if (mf > 2 * mp + 1e-6 or ff_rel > 2 * fp_rel + 1e-6 or fn_rel > 2 * fp_rel + 1e-6
                or fo_rel > 2 * fp_rel + 1e-6 or n_over == 0 or n_over != int((cnt2 > 2).sum())
                or int(ov) != 0):
            fail(f"K6 designs or the overflow path break the rule (tilt {tilt})")
        if l_bad or l2_bad or not d_sph < 1e-3:
            fail(f"K6's live list or spheres disagree with their plain models (tilt {tilt})")

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
    cntJ = torch.empty((J, C, 128), dtype=torch.int32, device=dev)
    lstJ = torch.empty((J, C, SWB.LIST_CAP, 128), dtype=torch.int32, device=dev)
    sphJ = torch.empty((J, C, 4, 4), dtype=torch.float32, device=dev)
    momJ = SWB._launch_moments(sw, tilesJ, ff.nbr, ff.valid, hhJ, ihJ, (cntJ, lstJ), sphJ)
    adjJ = SWB.adjoints(sw, momJ)
    ovJ = torch.zeros(1, dtype=torch.int32, device=dev)
    SWB._launch_forces(sw, tilesJ, adjJ, ff.nbr, ff.valid, hhJ, ihJ, cntJ, lstJ, ovJ)
    # the share of candidates the sphere test rules out, on the kernel's spheres
    pruned = SWB.pruned_chunks_plain(sphJ[:1], ff.nbr, ff.valid, hhJ[:1], ihJ[:1],
                                     SWB.sw_consts(sw)["rc"])
    share = k6_pruned_share(tilesJ[:1], ff.nbr, ff.valid, pruned)
    lJ_bad, _ = SWB.live_list_errors(sw, tilesJ[:2], ff.nbr, ff.valid, hhJ[:2], ihJ[:2],
                                     cntJ[:2], lstJ[:2])
    tri = bool((hhJ[:, [1, 2, 2], [0, 0, 1]] == 0).all() and (ihJ[:, [1, 2, 2], [0, 0, 1]] == 0)
               .all())
    torch.cuda.synchronize()
    print(f"[13 K6 list] {J} jobs: live list max {int(cntJ.max())} (mean "
          f"{float(cntJ[tilesJ[:, :, 3] > 0.5].double().mean()):.2f}) of cap {SWB.LIST_CAP}, "
          f"{int(ovJ)} slots over, {lJ_bad} violations against the float64 sweep (2 jobs); "
          f"the sphere test on the kernel's spheres rules out {100 * share:.2f}% of the "
          f"occupied stencil candidates; upper-triangular h and h^-1 (the 6-FMA image): {tri}")
    if int(ovJ) != 0 or lJ_bad:
        fail("K6: slots of the prepared box overflowed the live list, or it missed the sweep")
    slot_bytes = 4.0 * J * C * 128
    list_bytes = 4.0 * J * (C * 128 + 2 * live)  # counts and the live pairs' slots
    t = {}
    # the first design and the path's in turns (first, new, new, first)
    ab = {}
    for name, new, first in (
            ("K6d", lambda: SWB._launch_moments(sw, tilesJ, ff.nbr, ff.valid, hhJ, ihJ,
                                                (cntJ, lstJ)),
             lambda: SWB._moments_first(sw, tilesJ, ff.nbr, ff.valid, hhJ, ihJ)),
            ("K6c", lambda: SWB._launch_forces(sw, tilesJ, adjJ, ff.nbr, ff.valid, hhJ, ihJ,
                                               cntJ, lstJ, ovJ),
             lambda: SWB._forces_first(sw, tilesJ, adjJ, ff.nbr, ff.valid, hhJ, ihJ)),
            ("call", lambda: SWB.sw_forces_bricks(sw, pJ, hJ, *sl, atom_slot=ff.atom_slot),
             lambda: k6_first_force_call(sw, ff, pJ, hJ))):
        f1 = cuda_ms(first, 10)
        n1, n2 = cuda_ms(new, 10), cuda_ms(new, 10)
        ab[name] = {"first": (f1, cuda_ms(first, 10)), "path": (n1, n2)}
        print(f"[13 K6 A/B] {name}, {J} jobs, first design / path's in turns (ms): "
              f"{turns(ab[name])}")
    t["K6d"] = (min(ab["K6d"]["path"]),
                cuda_ms(lambda: SWB.sw_moments_plain(sw, tilesJ, ff.nbr, ff.valid, hhJ, ihJ), 2),
                *bound(slot_bytes * (4 + 12) + list_bytes, J * live * FLOP_K6_MOM),
                bound(slot_bytes * (4 + 12), J * k6_flops(cand, live, FLOP_K6_MOM))[0])
    t["K6c"] = (min(ab["K6c"]["path"]),
                cuda_ms(lambda: SWB.sw_forces_list_plain(sw, tilesJ, adjJ, cntJ, lstJ, ff.nbr,
                                                         ff.valid, hhJ, ihJ), 2),
                *bound(slot_bytes * (4 + 11 + 9) + list_bytes, J * live * FLOP_K6_FRC),
                bound(slot_bytes * (4 + 11 + 9), J * k6_flops(cand, live, FLOP_K6_FRC))[0])
    t["K6e"] = (cuda_ms(lambda: SWB.sw_energy_bricks(sw, pJ, hJ, *sl), 10),
                cuda_ms(lambda: SWB.sw_energy_bricks(sw, pJ, hJ, *sl, plain=True), 2),
                *bound(4.0 * J * 3 * n + 4.0 * J, J * live * FLOP_K6_MOM),
                bound(4.0 * J * 3 * n + 4.0 * J, J * k6_flops(cand, live, FLOP_K6_MOM))[0])
    for name in ("K6a", "K6b"):
        _, nb, va = rows[name]
        tl = SWB.pack_tiles(pJ)
        cand_x = tile_candidates(tl[0, :, 3] > 0.5, nb, va)
        t[name] = (cuda_ms(lambda: SWB._launch_moments(sw, tl, nb.int(), va.int(), hhJ, ihJ), 3),
                   cuda_ms(lambda: SWB.sw_moments_plain(sw, tl, nb, va, hhJ, ihJ), 1, warmup=0),
                   *bound(4.0 * J * tl.shape[1] * 128 * 16, J * live * FLOP_K6_MOM),
                   bound(4.0 * J * tl.shape[1] * 128 * 16, J * k6_flops(cand_x, live,
                                                                       FLOP_K6_MOM))[0])
    for name, (k_ms, p_ms, b_ms, b_by, bs_ms) in t.items():
        print(f"[13 {name} time] {J} jobs x {n} atoms: kernel {k_ms:.3f} ms  plain {p_ms:.3f} ms  "
              f"bound {b_ms:.4f} ms ({b_by}; {live:.1f} live pairs per box)  kernel at "
              f"{100 * b_ms / k_ms:.2f}% of its bound; the stencil's bound {bs_ms:.4f} ms")
    info = {w: SWB.kernel_info(w) for w in ("moments", "forces", "spheres", "moments_first",
                                           "forces_first")}
    print("[13 K6 kernels] (registers, local bytes, blocks per SM) " + ", ".join(
        f"{w} {v['registers']}/{v['local_bytes']}/{v['blocks_per_sm']}" for w, v in info.items()))
    print("[13 K6 ptxas] (registers, spill stores) " + ", ".join(
        f"{m.group(1)} {regs}/{spills}" for name, regs, spills in ptxas_entries()
        for m in [re.search(r"\d(sw_[a-z_]+kernel(?:I(?:Lb[01]E)+E)?)", name)] if m))
    # the force call of the unfused engine on both routes
    fc_ms = min(ab["call"]["path"])
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
    list_builds(sys_l.nspec, ol.pos, ol.h)
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
        k_ms, p_ms, b_ms, b_by, bs_ms = t[name]
        out[fn] = {"name": fn, "route": "cuda", "source": src, "replaces": rep,
                   "note": f"{name}: {J} jobs x {n} atoms", "max_abs_err": err, "ms": k_ms,
                   "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
                   "bound_stencil_ms": bs_ms}
    out["sw_moments_bricks"]["first_design_ms"] = min(ab["K6d"]["first"])
    out["sw_forces_bricks"]["first_design_ms"] = min(ab["K6c"]["first"])
    out["sw_forces_bricks"]["force_call_ms"] = fc_ms
    out["sw_forces_bricks"]["first_design_force_call_ms"] = min(ab["call"]["first"])
    out["sw_forces_bricks"]["list_route_force_ms"] = list_ms
    return out


# a pair within this distance (A) of a list's edge may fall on either side
# of it in float32, where the dense and the cell arithmetic differ
LIST_EDGE_TOL = 1e-4


def list_mismatch(nspec, pos, h, a, b):
    """Pairs in one of the lists a, b of pos (J, N, 3) in boxes h (J, 3, 3)
    and not in the other (per-row sets), and how many of them lie farther
    than LIST_EDGE_TOL from the row's edge: r_list, or where the row holds
    k_max pairs its farthest kept pair (the width truncates the list there,
    and a tie in float32 may keep either pair)."""
    import torch

    from scema_tpu_torch.md import box as B

    J, n = pos.shape[:2]
    rows = torch.arange(n, device=pos.device)[:, None]
    differ = bad = 0
    for j in range(J):
        m = []
        for nl in (a, b):
            s = torch.zeros((n, n), dtype=torch.bool, device=pos.device)
            s[rows.expand_as(nl.idx[j])[nl.mask[j]], nl.idx[j][nl.mask[j]]] = True
            m.append(s)
        i, k = torch.nonzero(m[0] ^ m[1], as_tuple=True)
        if not i.numel():
            continue
        hj, pj = h[j].double(), pos[j].double()

        def dist(ii, kk):
            return torch.linalg.vector_norm(B.min_image_disp(hj, pj[kk] - pj[ii]), dim=-1)

        zero = torch.zeros((), dtype=hj.dtype, device=hj.device)
        kept = torch.where(a.mask[j], dist(rows.expand_as(a.idx[j]), a.idx[j]), zero)
        full = a.mask[j].sum(1) == a.idx.shape[-1]
        edge = torch.where(full, kept.max(1).values, torch.full_like(kept[:, 0], nspec.r_list))
        r = dist(i, k)
        near = ((r - nspec.r_list).abs() < LIST_EDGE_TOL) | ((r - edge[i]).abs() < LIST_EDGE_TOL)
        differ += int(i.numel())
        bad += int((~near).sum())
    return differ, bad


def list_builds(nspec, pos, h):
    """Phase 13's neighbor builds of the list route on J jobs pos (J, N, 3),
    h (J, 3, 3): the dense build and both cell builds in turns (dense,
    gather, structured, structured, gather, dense), each cell list against
    the dense one (:func:`list_mismatch`), and the fullest cell against the
    capacity."""
    from scema_tpu_torch.md import neighbor as NB

    J, n = pos.shape[:2]
    fns = {"dense": NB.build_dense, "gather": NB.build_cells,
           "structured": NB.build_cells_structured}
    t = {k: [] for k in fns}
    for k in ("dense", "gather", "structured", "structured", "gather", "dense"):
        t[k].append(cuda_ms(lambda: fns[k](nspec, pos, h), 1))
    lists = {k: fn(nspec, pos, h) for k, fn in fns.items()}
    occ = max(NB.max_cell_occupancy(nspec, p, hh) for p, hh in
              zip(pos.double().cpu().numpy(), h.double().cpu().numpy()))
    cand = {k: NB._candidates(nspec, n, k) for k in fns}
    print(f"[13 neighbor builds] {J} jobs x {n} atoms, cells {nspec.cells}, capacity "
          f"{nspec.cell_capacity}, fullest cell {occ}; candidates per job dense "
          f"{cand['dense']}, gather {cand['gather']}, structured {cand['structured']}; ms per "
          f"{J}-job build (dense, gather, structured, structured, gather, dense): "
          f"{t['dense'][0]:.2f} {t['gather'][0]:.2f} {t['structured'][0]:.2f} "
          f"{t['structured'][1]:.2f} {t['gather'][1]:.2f} {t['dense'][1]:.2f}; jobs per "
          f"slice {NB.jobs_per_slice(nspec, n)}; build() takes {NB._form(nspec, n)}")
    for k in ("gather", "structured"):
        differ, bad = list_mismatch(nspec, pos, h, lists["dense"], lists[k])
        print(f"[13 neighbor builds] {k} vs dense: {differ} pairs differ, {bad} of them "
              f"farther than {LIST_EDGE_TOL} A from the list's edge")
        if bad:
            fail(f"the {k} cell build's lists disagree with the dense build's: {bad} pairs")
    if occ > nspec.cell_capacity:
        fail(f"the fullest cell holds {occ} atoms > capacity {nspec.cell_capacity}")


def k6_first_force_call(sw, ff, pos, h):
    """The brick force call on K6's first design (the stencil sweep in both
    kernels), as sw_forces_bricks made it before the live list: (F, E, W)."""
    import torch

    from scema_tpu_torch.ops import sw_bricks as SWB

    J, C = pos.shape[0], ff.n_bricks
    tiles = SWB.pack_bricks(pos, ff.slot_ids)
    hh, ih = SWB.boxes(h, (J,), torch.float32, pos.device)
    mom = SWB._moments_first(sw, tiles, ff.nbr, ff.valid, hh, ih)
    fo = SWB._forces_first(sw, tiles, SWB.adjoints(sw, mom), ff.nbr, ff.valid, hh, ih)
    F = fo[:, :, :3, :].transpose(-1, -2).reshape(J, C * 128, 3)[:, ff.atom_slot]
    return F, SWB.energy_from_moments(sw, mom), -fo[:, :, 3:, :].sum((1, 3))


def _k6_counters():
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2
    from scema_tpu_torch.ops import sw_bricks as SWB

    return {"md_k1_run": (MF.md_run, "launches"),
            "md_k1_forces_virial": (MF.md_forces_virial, "launches"),
            "md_allpairs_run": (MF._run_first, "launches"),
            "md_allpairs_forces_virial": (MF._forces_first, "launches"),
            "md_charged_run": (MF.md_run, "launches_k3"),
            "md_charged_forces_virial": (MF.md_forces_virial, "launches_k3"),
            "md_charged_first_run": (MF._run_first, "launches_k3"),
            "md_charged_first_forces_virial": (MF._forces_first, "launches_k3"),
            "md_list_run": (MF.md_run, "launches_k4"),
            "md_list_forces_virial": (MF.md_forces_virial, "launches_k4"),
            "md_list_first_run": (MF._run_first, "launches_k4"),
            "md_list_first_forces_virial": (MF._forces_first, "launches_k4"),
            "md_list_cluster_run": (MF.md_run, "launches_k4cluster"),
            "md_list_big_run": (MF.md_run, "launches_k4big"),
            "md_sw_run": (MF.md_run, "launches_k5"),
            "md_sw_forces": (MF.md_forces_virial, "launches_k5"),
            "md_sw_first_run": (MF._run_first, "launches_k5"),
            "md_sw_first_forces": (MF._forces_first, "launches_k5"),
            "sw_moments": (SWB.sw_moments, "launches"),
            "sw_moments_adj": (SWB.sw_moments_adj, "launches"),
            "sw_moments_bricks": (SWB.sw_moments_bricks, "launches"),
            "sw_energy_bricks": (SWB.sw_energy_bricks, "launches"),
            "sw_forces_bricks": (SWB.sw_forces_bricks, "launches"),
            "sw_moments_first": (SWB._moments_first, "launches"),
            "sw_forces_first": (SWB._forces_first, "launches"),
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
    builds = {}
    with counted_builds(builds):
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
    if not bricks and (builds.get("build_cells", 0) <= 0 or builds.get("build_dense", 0)
                       or builds.get("build_cells_structured", 0)):
        fail(f"{tag} the list route's builds {builds}: the gather cell build alone expected")
    print(f"{tag} {hmm.backend.sys.n_atoms}-atom Si boxes ({'bricks: K6c/K6d' if bricks else 'list route: autograd SW.energy'}), "
          f"qps {hmm.geom.n_qp_total}: setup {setup_s:.3f}s  s/macro-step "
          f"{[round(x, 4) for x in step_s]}  md jobs {jobs}  launches {launches}  peak memory "
          f"{peak / 2**20:.1f} MiB  max displacement {umax:.6g} m (expect {expect:.6g})  "
          f"neighbor builds {builds}  phase wall {wall:.2f}s")
    return launches


@contextlib.contextmanager
def counted_builds(counts: dict):
    """Count the calls of each neighbor build (``neighbor.build_dense``,
    ``build_cells``, ``build_cells_structured``) into ``counts`` for the
    duration."""
    from scema_tpu_torch.md import neighbor as NB

    names = ("build_dense", "build_cells", "build_cells_structured")
    saved = {name: getattr(NB, name) for name in names}

    def counted(name):
        def fn(*a, **k):
            counts[name] = counts.get(name, 0) + 1
            return saved[name](*a, **k)
        return fn

    for name in names:
        setattr(NB, name, counted(name))
    try:
        yield
    finally:
        for name, fn in saved.items():
            setattr(NB, name, fn)


def ptxas_entries():
    """[(mangled name, registers, spill store bytes)] of every compiled
    entry, from the build's ptxas report (empty when the library came from
    the cache)."""
    from scema_tpu_torch.ops import _build

    out, cur = [], None
    for line in _build.build_log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            cur = [m.group(1), None, None]
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            cur[2] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur[1] = int(m.group(1))
            out.append(tuple(cur))
            cur = None
    return out


def kernel_registers(name_part: str):
    """[(registers, spill store bytes)] of the compiled entries whose
    mangled name holds ``name_part`` (empty when the library came from the
    cache)."""
    return [(regs, spills) for name, regs, spills in ptxas_entries() if name_part in name]


@contextlib.contextmanager
def k1_first_design():
    """K1 runners' runs on K1's first design for the duration: phase 17's
    unpacked steps on that design, against which K1's stresses are held."""
    from scema_tpu_torch.ops import md_fused as MF

    md_run = MF.md_run

    def first_run(runner, state, vxi, n_run, fscal, deform, sample, **kw):
        if runner.spec.kernel != "K1" or any(v is not None for v in kw.values()):
            fail(f"k1_first_design: a {runner.spec.kernel} run reached the first design")
        return MF._run_first(runner, state, vxi, n_run, fscal, deform, sample)

    MF.md_run = first_run
    try:
        yield
    finally:
        MF.md_run = md_run


# K1m's jobs per block on the coupled path (MDBackend.pack_jobs)
K1M_JOBS = 2
# K1 (every flag off; md_allpairs.cu) and K1m's first design's (J = 2, 4;
# md_multi.cu) mangled kernel names
K1_KERNEL = "md_run_kernelILb0ELb0ELb0ELb0ELb0ELb0ELb0E"
K1M_KERNELS = {J: f"md_run_multi_kernelILi{J}E" for J in (2, 4)}
K1M_SOURCE, K1M_FIRST_SOURCE = ("scema_tpu_torch/csrc/md_k1m.cu",
                                "scema_tpu_torch/csrc/md_multi.cu")


def phase_k1m(dev):
    """Phase 16: K1m (csrc/md_k1m.cu, J = 2 jobs per block) against K1, its
    plain version and float64, and its first design (md_multi.cu) against
    K1's first design, on the prepared g0 box at 576 jobs.  Returns (the
    redesign's row, the first design's row, whether K1m equals K1 bit for
    bit)."""
    import torch

    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.ops import md_fused as MF

    t0 = time.perf_counter()
    sys_, st = M.build_system(M.MaterialSpec(name="g0", force_field="opls"),
                              dtype=torch.float32, device=dev)
    st = E.minimize_fire(sys_, st, n_steps=100, dt0=0.5)
    r, n, J = sys_.fused, sys_.n_atoms, 576
    T = int(r.k1_tbl.shape[0])
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
    args = (state, vxi, n10, fscal, True, False)

    # 10-step deform run: K1m (J = 2 and 4) against K1, whose arithmetic it
    # runs per job, and against float64 at phase 4's rule; its first design
    # against K1's first design, which it copies (bit for bit, checked)
    ref, xr, _ = MF.md_run(r, *args)
    pl, _, _ = MF.md_run_plain(r, *args)
    ref64, _, _ = MF.md_run_plain(r64, state.double(), vxi.double(), n10, fscal.double(),
                                  True, False)
    f1, fx1, _ = MF._run_first(r, *args)
    torch.cuda.synchronize()
    res, same, d_run = [], {}, {}
    for jobs in (2, 4):
        out, xo, _ = MF.md_run_multi(r, *args, jobs)
        of, xf, _ = MF._run_multi_first(r, *args, jobs)
        torch.cuda.synchronize()
        if not (torch.equal(of, f1) and torch.equal(xf, fx1)):
            fail(f"K1m's first design (J={jobs}) differs from K1's first design, which it "
                 f"copies per job: {float((of - f1).abs().max()):.3e}")
        pk, vk = _run_rule(out, pl, ref64, f"K1m run (J={jobs})")
        same[jobs] = torch.equal(out, ref) and torch.equal(xo, xr)
        d_run[jobs] = float((out - ref).abs().max())
        res.append(f"J={jobs}: max |K1m - K1| {d_run[jobs]:.3e} (bit for bit {same[jobs]}), "
                   f"vs float64 {pk:.3e} A, velocities rel {vk:.3e}")
        if jobs == K1M_JOBS:
            out2, xo2 = out, xo
    pp = float((pl[:, :3].double() - ref64[:, :3]).abs().max())
    p_err = float((out2[:, :3] - pl[:, :3]).abs().max())
    print(f"[16 K1m run] {J} jobs x 10 deform steps: {'; '.join(res)}; plain-f32 {pp:.3e} A "
          f"(tol 4x plain + 1e-4); the first design equals K1's first design bit for bit")

    # 20-step sampling run: per-job pressure sums
    f_s = MF.make_fscal(DT, T_MD, hJ)
    n20 = torch.full((J,), 20, dtype=torch.int32, device=dev)
    _, _, sk = MF.md_run_multi(r, out2, xo2, n20, f_s, False, True, K1M_JOBS)
    _, _, s1 = MF.md_run(r, out2, xo2, n20, f_s, False, True)
    _, _, sp = MF.md_run_plain(r, out2, xo2, n20, f_s, False, True)
    _, _, s64 = MF.md_run_plain(r64, out2.double(), xo2.double(), n20, f_s.double(), False,
                                True)
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
    o2, x2, p2 = MF.md_run_multi(r, out2, xo2, n_pair, f_s, False, True, K1M_JOBS)
    o1, _, p1 = MF.md_run(r, out2, xo2, n_pair, f_s, False, True)
    torch.cuda.synchronize()
    dead_ok = (torch.equal(o2[1::2], out2[1::2]) and torch.equal(x2[1::2], xo2[1::2])
               and not bool(p2[1::2].any()))
    d_live = float((o2[0::2] - o1[0::2]).abs().max())
    if not dead_ok or not torch.isfinite(o2).all():
        fail("K1m: a dead job of a (live, dead) pair was modified")
    print(f"[16 K1m pairs] {J // 2} (live, dead) pairs x 20 sampling steps: dead jobs "
          f"bit-identical; live jobs max |K1m - K1| {d_live:.3e} (state), "
          f"{float((p2[0::2] - p1[0::2]).abs().max()):.3e} atm")

    # times: the first design and the redesign in turns (old, new, new, old)
    # at J = 2 and 4, K1 and the plain version on the same 576-job deform run
    ab = {jobs: k34_ab({"path": lambda jobs=jobs: MF.md_run_multi(r, *args, jobs),
                        "first": lambda jobs=jobs: MF._run_multi_first(r, *args, jobs)}, 3)
          for jobs in (2, 4)}
    k1_ms = cuda_ms(lambda: MF.md_run(r, *args), reps=3)
    plain_ms = cuda_ms(lambda: MF.md_run_plain(r, *args), reps=1, warmup=0)
    f_lj, _ = pair_fractions(st.pos.expand(2, -1, -1), hJ[:2], r.spec.cutoff2)
    # the bytes the function needs: K1's table, codes, window and chain rows
    # (K1m reads K1's), each job's state in and out, its fscal
    b_ms, b_by = bound(4.0 * (2 * T * T + 8 * n + r.topo.numel() + 2 * J * (6 * n + 3)
                              + J * 16), pair_flops(n, J * 10, f_lj))
    info = {jobs: MF.k1m_kernel_info(jobs, n, T) for jobs in (2, 4)}
    print(f"[16 K1m] {J} jobs x 10 deform steps, ms (old, new, new, old): "
          + "; ".join(f"J={jobs} {turns(t)}: {min(t['first']) / min(t['path']):.3f}x"
                      for jobs, t in ab.items())
          + f"  K1 {k1_ms:.3f} ms  plain {plain_ms:.3f} ms  bound {b_ms:.3f} ms ({b_by}); "
          + "; ".join(f"J={jobs}: {x['registers']} registers, {x['local_bytes']} B local, "
                      f"{x['blocks_per_sm']} blocks per SM of {x['threads']} threads"
                      for jobs, x in info.items())
          + f"; ptxas (registers, spill stores) K1m {kernel_registers('k1m_run_kernel')}, the "
          f"first design {[kernel_registers(k) for k in K1M_KERNELS.values()]}  phase wall "
          f"{time.perf_counter() - t0:.2f}s")
    row = {"name": "md_k1m_run", "route": "cuda", "source": K1M_SOURCE,
           "replaces": "scema_tpu/ops/md_fused.py:1850",
           "note": "K1m: FusedSpec.jobs > 1 (J = 2 jobs per block); J = 4 in *_j4",
           "max_abs_err": max(p_err, d_s), "ms": min(ab[2]["path"]), "plain_ms": plain_ms,
           "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
           "ms_j4": min(ab[4]["path"])}
    first_row = dict(row, name="md_allpairs_run_multi", source=K1M_FIRST_SOURCE,
                     max_abs_err=float((f1[:, :3] - pl[:, :3]).abs().max()),
                     ms=min(ab[2]["first"]), ms_j4=min(ab[4]["first"]))
    return row, first_row, same[K1M_JOBS]


def _all_counters():
    from scema_tpu_torch.ops import md_fused as MF

    return {**_k6_counters(), "md_k1m_run": (MF.md_run_multi, "launches_k1m"),
            "md_allpairs_run_multi": (MF._run_multi_first, "launches_k1m")}


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


def phase_staged_slice(dev, k1m_bitwise: bool):
    """Phase 17: the g0 slice as its users launch it — ``cli run cfg.json
    --steps 3`` without ``--quick-prep`` (the staged heatup/cooldown NPT
    prep) — then 2 macro-steps of the built problem with pack_jobs 1 and
    2 (K1m), and the staged prep of the 216-atom SW box on K5's entry.
    ``k1m_bitwise``: phase 16 found K1m equal to K1 bit for bit, so the MD
    layer's packed runs are held to the unpacked ones bit for bit (else to
    1e-4 relative in stress, as the macro-steps)."""
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
    only(launches, ("md_k1_run", "md_k1_forces_virial", "pairwise_l2"), "staged slice")
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

    # K1m runs K1's arithmetic per job, so the packed steps are held to the
    # unpacked steps on K1; K1's first design runs beside them
    s1, t1 = two_steps(hmm)
    s1b, t1b = two_steps(hmm)  # the unpacked run again: its run-to-run spread
    with k1_first_design():
        s0, t0 = two_steps(hmm)
    packed = dataclasses.replace(hmm, backends=tuple(
        dataclasses.replace(be, pack_jobs=K1M_JOBS) for be in hmm.backends))
    zero()
    s2, t2 = two_steps(packed)
    launches_k1m = read()
    only(launches_k1m, ("md_k1m_run", "pairwise_l2"), "pack_jobs=2 steps")
    sig1, sig1b, sig0, sig2 = (c[0].qp.new_stress for c in (s1, s1b, s0, s2))
    smax = max(float(sig0.abs().max()), 1e-30)
    d_rep = float((sig1b - sig1).abs().max())
    d_sig = float((sig2 - sig1).abs().max())
    d_new = float((sig1 - sig0).abs().max())
    if not torch.isfinite(sig2).all() or d_sig / smax > 1e-4:
        fail(f"pack_jobs=2 stresses differ from pack_jobs=1 (K1) by {d_sig:.3e} (rel "
             f"{d_sig / smax:.3e}, tol 1e-4)")
    if not torch.isfinite(sig1).all() or d_new / smax > 1e-4:
        fail(f"pack_jobs=1 stresses on K1 differ from its first design by {d_new:.3e} (rel "
             f"{d_new / smax:.3e}, tol 1e-4)")
    # the MD layer alone on identical inputs: 145 (job, replica) runs, an odd
    # count, so the last pair holds a zero-step pad job
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
    d_md = float((p2 - p1).abs().max()) / max(float(p1.abs().max()), 1e-30)
    if (not md_equal if k1m_bitwise else not d_md <= 1e-4):
        fail(f"pack_jobs=2 MD runs differ from pack_jobs=1 on identical inputs: max |stress "
             f"diff| rel {d_md:.3e} (bit for bit expected: {k1m_bitwise})")
    print(f"[17 pack_jobs] 2 macro-steps from the built problem: pack_jobs=1 {t1} and {t1b} "
          f"s on K1, {t0} s on its first design, pack_jobs={K1M_JOBS} {t2} s per step; max "
          f"|stress diff| packed vs K1 {d_sig:.3e} Pa (rel {d_sig / smax:.3e}, tol 1e-4), K1 "
          f"vs first design {d_new:.3e} Pa (rel {d_new / smax:.3e}, tol 1e-4; float32 "
          f"trajectories of two designs), K1 run-to-run {d_rep:.3e} Pa (rel "
          f"{d_rep / smax:.3e}); the MD layer alone ({n_md} runs, one pad job) bit-identical "
          f"to K1 {md_equal} (max |stress diff| rel {d_md:.3e})  launches {launches_k1m}")

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


# phase 18's check runs: the lab's 576 jobs (in programs of J jobs), each
# with its own velocities and strain, for 25 steps, so the image cache is
# refreshed once mid-run (every 20 steps, and before the first force call)
P1_JOBS, P1_STEPS = 576, 25
P1_SOURCE = "scema_tpu_torch/csrc/md_slim_ring.cu"
P1_FIRST_SOURCE = "scema_tpu_torch/csrc/md_slim.cu"
P1_REPLACES = "scripts/probe_allpairs.py:616"
# the variants whose two designs keep each thread's order of the sum over j
# (full rows, v5m's partials in warp order): bit for bit, checked
P1_BITWISE = ("v1", "v2", "v3", "v4", "v5m")


def events_ms(fn):
    """(output, device ms) of one call of ``fn``, by CUDA events."""
    import torch

    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def p1_err(a, b):
    return float((a.double() - b.double()).abs().max())


def p1_held(out, sacc, pl, spl, p64, s64, what):
    """Phase 18's rule: (positions, velocities, chain and 2 KE) errors of a
    slim run against float64, failing beyond 4x the plain float32 run's +
    1e-4, or where 1/m and m/FTM2V changed."""
    import torch

    pk, pp = p1_err(out[:, :3], p64[:, :3]), p1_err(pl[:, :3], p64[:, :3])
    vmax = float(p64[:, 3:6].abs().max())
    vk, vp = p1_err(out[:, 3:6], p64[:, 3:6]) / vmax, p1_err(pl[:, 3:6], p64[:, 3:6]) / vmax
    smax = s64[:, :4].abs().amax(0)
    sk = float(((sacc[:, :4].double() - s64[:, :4]).abs().amax(0) / smax).max())
    sp = float(((spl[:, :4].double() - s64[:, :4]).abs().amax(0) / smax).max())
    if (not torch.isfinite(out).all() or pk > 4 * pp + 1e-4 or vk > 4 * vp + 1e-4
            or sk > 4 * sp + 1e-4 or not torch.equal(out[:, 6:], pl[:, 6:])):
        fail(f"P1 {what}: vs float64 positions {pk:.3e} A, velocities rel {vk:.3e}, chain "
             f"and 2 KE rel {sk:.3e} exceed 4x plain float32 ({pp:.3e}, {vp:.3e}, {sp:.3e}) "
             f"+ 1e-4")
    return pk, pp, vk, vp, sk, sp


def phase_p1(dev, n_steps: int = 500):
    """Phase 18: P1 (the kernel lab's slim all-pairs runs, variants v1-v8)
    on the prepared g0 box, made once.  For each variant, on 25 steps of
    576 jobs (one image refresh mid-run): the redesign (``slim_run``) and
    the first design (``slim_run_first``) against the plain version and
    float64 (4x plain float32 + 1e-4), against each other (bit for bit for
    P1_BITWISE), and the redesign against v1; a program with n_run = 0
    bit-identical; the int8 image guard (an atom 200 box lengths out turns
    its program's positions NaN in kernel and plain version alike); both
    designs timed in turns (first, new, new, first) beside the plain
    version and the bound, with the wrapper's block (``ring_layout``)
    against the kernel's own, and registers, spills and blocks per SM of
    both.  Then the lab itself (``probe_allpairs.main``)
    over v0, v0p and every slim variant at 576 jobs x ``n_steps``, its
    launch counters zeroed just before and read just after: the redesign 4
    launches per variant, the first design none.  Returns the kernels' rows
    (the redesign's, then the first design's)."""
    import torch

    from scema_tpu_torch import probe_allpairs as PA
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import md_slim as MS

    t0 = time.perf_counter()
    g0 = PA.prepared_g0(dev)
    sys_, st = g0
    state1, w4e, sig2, h6 = PA.slim_box(g0)
    n, nt = sys_.n_atoms, state1.shape[1]
    gen = torch.Generator().manual_seed(18)
    jobs = state1.expand(P1_JOBS, -1, -1, -1).clone()
    for j in range(P1_JOBS):
        v = E.maxwell_velocities(sys_, T_MD, gen, torch.float32, dev)
        jobs[j, 3:6] = v.T.reshape(3, nt, MS.LANE)
    eps = (torch.rand((P1_JOBS, 6), generator=gen, dtype=torch.float64) * 2e-3 - 1e-3).numpy()
    fscal = torch.stack([torch.as_tensor(MS.make_fscal(h6.cpu().numpy(), e), dtype=torch.float32)
                         for e in eps]).to(dev)
    n_chk = torch.tensor([P1_STEPS, P1_STEPS], dtype=torch.int32, device=dev)
    n_one = torch.tensor([1, 1], dtype=torch.int32, device=dev)
    f_lj, _ = pair_fractions(st.pos[None], st.h[None], MS.CUTOFF2)
    print(f"[18 P1] g0 box: {n} sites, box {float(st.h[0, 0]):.3f} A, {f_lj:.4f} of pairs "
          f"inside the cutoff; prep {time.perf_counter() - t0:.2f}s")
    # the bound of one check run: the function's LJ pair work over this box's
    # live pairs, the state in and out, the two planes once
    b_ms, b_by = bound(4.0 * (2 * n * n + 2 * P1_JOBS * 8 * n + P1_JOBS * 30),
                       pair_flops(n, P1_JOBS * P1_STEPS, f_lj))

    def grouped(x, J):  # (B, 8, NT, 128) jobs -> (B / J, 8, J NT, 128) programs
        return x.reshape(-1, J, 8, nt, MS.LANE).transpose(1, 2).reshape(-1, 8, J * nt, MS.LANE)

    err, held = p1_err, p1_held

    rows, first_rows, v1_out = {}, {}, None
    for name, v in MS.VARIANTS.items():
        J = v.jobs
        w, s = MS.variant_planes(name, w4e, sig2)
        x, fs = grouped(jobs, J), fscal[::J].contiguous()
        out, sacc = MS.slim_run(name, x, w, s, n_chk, fs)
        fo, fsacc = MS.slim_run_first(name, x, w, s, n_chk, fs)
        (pl, spl), plain_ms = events_ms(lambda: MS.slim_run_plain(name, x, w, s, n_chk, fs))
        p64, s64 = MS.slim_run_plain(name, x.double(), w.double(), s.double(), n_chk,
                                     fs.double())
        torch.cuda.synchronize()
        pk, pp, vk, vp, sk, sp = held(out, sacc, pl, spl, p64, s64, f"{name} (redesign)")
        pkf = held(fo, fsacc, pl, spl, p64, s64, f"{name} (first design)")[0]
        # the two designs against each other
        same = torch.equal(out, fo) and torch.equal(sacc, fsacc)
        if name in P1_BITWISE and not same:
            fail(f"P1 {name}: the redesign differs from the first design by {err(out, fo):.3e} "
                 f"though both keep each thread's order of the sum over j")
        designs = ("bit for bit" if same else
                   f"|new - first| {err(out[:, :6], fo[:, :6]):.3e} (shared atomics add in a "
                   f"run-dependent order; both within the rule)")
        # a program with n_run = 0 comes back bit-identical
        n0 = n_chk.expand(x.shape[0], 2).clone()
        n0[1, 0] = 0
        o0, s0 = MS.slim_run(name, x, w, s, n0, fs)
        if not (torch.equal(o0[1], x[1]) and torch.equal(s0[1, :3], fs[1, 14:17])):
            fail(f"P1 {name}: a program with n_run = 0 changed its state")
        # against v1: the J = 1 variants against the v1 kernel on the same
        # jobs; J > 1 on programs of J copies of one job, against plain
        # float64 v1 over the same J copies under one chain
        if v1_out is None:
            v1_out, v1_err = out, pk
        if J == 1:
            oc, ref = out, v1_out
        else:
            xc = grouped(jobs[:P1_JOBS // J].repeat_interleave(J, 0), J)
            fc = fscal[:P1_JOBS // J].contiguous()
            oc, _ = MS.slim_run(name, xc, w, s, n_chk, fc)
            ref = MS.slim_run_plain("v1", xc.double(), w4e.double(), sig2.double(), n_chk,
                                    fc.double(), jobs=J)[0]
        torch.cuda.synchronize()
        d1 = err(oc[:, :6], ref[:, :6])
        if not torch.isfinite(oc).all() or d1 > 4 * pp + 4 * v1_err + 1e-4:
            fail(f"P1 {name}: differs from v1 by {d1:.3e} (tol 4x (plain f32 + v1's kernel) "
                 f"error vs float64 + 1e-4)")
        # the int8 image guard: the first atom of program 1 moved 200 box
        # lengths out (the same box for a cached image, beyond int8)
        xg = x[:2].clone()
        xg[1, 0, 0, 0] += 200.0 * float(h6[0])
        og, _ = MS.slim_run(name, xg, w, s, n_one, fs[:2])
        pg, _ = MS.slim_run_plain(name, xg, w, s, n_one, fs[:2])
        nan_k = torch.isnan(og[:, :3]).flatten(1).any(1).tolist()
        nan_p = torch.isnan(pg[:, :3]).flatten(1).any(1).tolist()
        if nan_k != nan_p or nan_k != [False, v.cache]:
            fail(f"P1 {name}: image guard: NaN programs kernel {nan_k}, plain {nan_p}, "
                 f"expected {[False, v.cache]}")
        # both designs in turns
        t = {"first": [], "new": []}
        for which in ("first", "new", "new", "first"):
            fn = MS.slim_run_first if which == "first" else MS.slim_run
            t[which].append(events_ms(lambda: fn(name, x, w, s, n_chk, fs))[1])
        ms, ms_first = sum(t["new"]) / 2, sum(t["first"]) / 2
        # the wrapper's block (threads, groups, chunks, copies, stage, ring
        # and shared bytes) against the kernel's own
        lay, info = MS.ring_layout(v, n), MS.ring_info(name, n)
        if info["layout"] != lay:
            fail(f"P1 {name}: the wrapper's block {lay} is not the kernel's {info['layout']}")
        rows[name] = {"name": f"md_slim_{name}", "route": "cuda", "source": P1_SOURCE,
                      "replaces": P1_REPLACES, "max_abs_err": err(out[:, :3], pl[:, :3]),
                      "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                      "library_ms": None}
        first_rows[name] = {**rows[name], "name": f"md_slim_first_{name}",
                            "source": P1_FIRST_SOURCE, "max_abs_err": err(fo[:, :3], pl[:, :3]),
                            "ms": ms_first}
        print(f"[18 P1 {name}] J={J}: {P1_JOBS} jobs x {P1_STEPS} steps vs float64: redesign "
              f"{pk:.3e} A, first design {pkf:.3e} A, plain-f32 {pp:.3e} A, velocities rel "
              f"{vk:.3e} / {vp:.3e}, chain and 2 KE rel {sk:.3e} / {sp:.3e} (tol 4x plain + "
              f"1e-4); max |kernel - plain| {rows[name]['max_abs_err']:.3e} A; designs "
              f"{designs}; n_run 0 bit-identical; vs v1 {d1:.3e} A; guard NaN {nan_k}")
        print(f"[18 P1 {name} A/B] first / new / new / first "
              + " / ".join(f"{a:.3f}" for a in (t["first"][0], *t["new"], t["first"][1]))
              + f" ms ({ms_first / ms:.2f}x); plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms "
              f"({b_by}); ring {lay.rows} rows x {lay.depth} stages, {lay.smem_bytes} B per "
              f"block, as the kernel's; new {info['registers']} registers, "
              f"{info['local_bytes']} local bytes, {info['blocks_per_sm']} blocks per SM "
              f"{kernel_registers(p1_kernel(v))}; first {kernel_registers(p1_kernel(v, first=True))}"
              f", {MS.occupancy_first(name, n)} blocks per SM")
    print(f"[18 P1] check runs {time.perf_counter() - t0:.2f}s")

    # the lab itself on the same prepared box: v0 (K1), v0p (K1m) and every
    # slim variant at 576 jobs
    counters = {name: (MS.slim_run, "launches_" + name) for name in MS.VARIANTS}
    counters.update({"first_" + name: (MS.slim_run_first, "launches_" + name)
                     for name in MS.VARIANTS})
    counters.update(v0=(MF.md_run, "launches"), v0p=(MF.md_run_multi, "launches_k1m"),
                    k1_first=(MF._run_first, "launches"))
    del out, pl, p64, oc, ref, fo
    gc.collect()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t_lab = time.perf_counter()
    repeats = 3
    res = PA.main(["v0", "v0p", *MS.VARIANTS], n_jobs=P1_JOBS, n_steps=n_steps, device=dev,
                  repeats=repeats, out=lambda line: print(f"    {line}"), g0=g0)
    torch.cuda.synchronize()
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    lab_b_ms = b_ms * n_steps / P1_STEPS
    bad = [k for k, r in res.items() if not r["finite"] or launches[k] <= 0]
    if launches["k1_first"]:
        fail(f"P1 lab: v0 launched K1's first design ({launches['k1_first']} times), not K1")
    if bad:
        fail(f"P1 lab: variants {bad} gave a non-finite state or launched no kernel "
             f"(launches {launches})")
    wrong = {k: launches[k] for k in MS.VARIANTS if launches[k] != 1 + repeats}
    wrong.update({k: launches[k] for k in launches if k.startswith("first_") and launches[k]})
    if wrong:
        fail(f"P1 lab: the redesign must launch {1 + repeats} times per variant and the first "
             f"design never; got {wrong}")
    print(f"[18 P1 lab] {P1_JOBS} jobs x {n} atoms x {n_steps} steps, best of {repeats}: "
          + "  ".join(f"{k} {r['ms']:.2f} ms" for k, r in res.items())
          + f"  bound {lab_b_ms:.3f} ms ({b_by}); launches {launches}; "
          f"wall {time.perf_counter() - t_lab:.2f}s, phase {time.perf_counter() - t0:.2f}s")
    for name in MS.VARIANTS:
        rows[name]["launches"] = launches[name]
        first_rows[name]["launches"] = launches["first_" + name]
    return list(rows.values()) + list(first_rows.values())


# phase 18 at other box sizes (the redesign's big-box instance above 512
# atoms per box): each variant at P1_SIZES and its cap (md_slim.n_max), on a
# jittered simple-cubic lattice at the LJ liquid's reduced density 0.8
# (sigma 3.905 A), two atom types with their own epsilon and sigma, the
# lab's chain exclusions; a few programs of P1_STEPS steps checked, and the
# two designs timed in turns at P1_TIMED on the lab's 576 jobs
P1_SIZES = (640, 1024, 2048)
P1_TIMED = (1024, 2048)
P1_RHO = 0.8 / 3.905 ** 3  # atoms per A^3
P1_TILT = (0.5, 0.3, 0.4)  # xy, xz, yz (A)
P1_CACHE_BYTES = 16e9  # a timed run's image cache at most
# full rows keep each atom's order of the sum over j in both designs at
# every size; v5m's big-box windows add by atomics (held to the rule only)
P1_BITWISE_BIG = ("v1", "v2", "v3", "v4")


def p1_lattice(N: int, J: int, programs: int, seed: int, dev):
    """Slim programs of J boxes of N atoms, float32 on ``dev``: (state (P,
    8, J N / 128, 128), w4e, sig2 (N, N), fscal (P, 20), h (3, 3) float64,
    positions of the first box (N, 3) float64).  Each box N sites of a
    simple-cubic lattice (a random choice of the smallest cube's sites that
    holds N) in a tilted box at P1_RHO, jittered by 5% of the spacing, its
    own velocities at ~300 K and strain within +-1e-3."""
    import numpy as np
    import torch

    from scema_tpu_torch.ops import md_slim as MS

    rng = np.random.default_rng(seed)
    side = round(N ** (1 / 3))
    side += side ** 3 < N
    L = (N / P1_RHO) ** (1 / 3)
    H = np.array([[L, P1_TILT[0], P1_TILT[1]], [0.0, L, P1_TILT[2]], [0.0, 0.0, L]])
    grid = np.stack(np.meshgrid(*(np.arange(side),) * 3, indexing="ij"), -1).reshape(-1, 3)
    types = rng.integers(0, 2, N)
    masses = np.where(types == 0, 14.0, 15.0)
    boxes = []
    for _ in range(programs * J):
        sites = grid[rng.choice(len(grid), N, replace=False)]
        pos = (sites + 0.5 + 0.05 * rng.standard_normal((N, 3))) / side @ H.T
        boxes.append(MS.pack_state(pos, rng.normal(0.0, 0.004, (N, 3)), masses, np.float32))
    nt = N // MS.LANE
    x = torch.as_tensor(np.stack(boxes), device=dev)
    x = x.reshape(programs, J, 8, nt, MS.LANE).transpose(1, 2).reshape(programs, 8, J * nt,
                                                                        MS.LANE).contiguous()
    t = torch.as_tensor(types, device=dev)
    eps_t = torch.tensor([0.175, 0.118], dtype=torch.float64, device=dev)[t]
    sig_t = torch.tensor([3.905, 3.6], dtype=torch.float64, device=dev)[t]
    w = 1.0 - torch.eye(N, dtype=torch.float64, device=dev)
    k = torch.arange(N - 1, device=dev)
    w[k, k + 1] = w[k + 1, k] = 0.0
    w4e = (4.0 * torch.sqrt(eps_t[:, None] * eps_t[None, :]) * w).float()
    sig2 = (0.25 * (sig_t[:, None] + sig_t[None, :]) ** 2).float()
    h6 = [L, L, L, *P1_TILT]
    fscal = torch.stack([torch.as_tensor(MS.make_fscal(h6, rng.uniform(-1e-3, 1e-3, 6)),
                                         dtype=torch.float32) for _ in range(programs)]).to(dev)
    pos0 = torch.as_tensor(boxes[0][:3].reshape(3, -1).T, dtype=torch.float64, device=dev)
    return x, w4e, sig2, fscal, torch.as_tensor(H, device=dev), pos0


def phase_p1_sizes(dev, sizes=P1_SIZES, timed=P1_TIMED):
    """Phase 18 at other box sizes: for each variant at ``sizes`` and its cap
    (``md_slim.n_max``), capped there, on a few programs of P1_STEPS steps
    of ``p1_lattice``: the redesign (its big-box instance) against the plain
    version and float64 (phase 18's rule), against the first design where
    that runs (bit for bit for P1_BITWISE_BIG, the rule for the rest), a
    program with n_run = 0 bit-identical, the int8 image guard, the
    wrapper's block against the kernel's own, registers, spills and blocks
    per SM; at ``timed`` both designs in turns (first, new, new, first) on
    the lab's 576 jobs (fewer where the image cache would pass
    P1_CACHE_BYTES) beside the bound.  The launch counters are zeroed just
    before and read just after: every variant's redesign launched at each
    size.  Returns one kernels row per variant (its big-box instance at
    2048 atoms per box, or its cap below that: the check run's kernel,
    plain and bound times, and the launches of this phase)."""
    import torch

    from scema_tpu_torch.ops import md_slim as MS

    t0 = time.perf_counter()
    for name in MS.VARIANTS:
        setattr(MS.slim_run, "launches_" + name, 0)
        setattr(MS.slim_run_first, "launches_" + name, 0)
    n_chk = torch.tensor([P1_STEPS, P1_STEPS], dtype=torch.int32, device=dev)
    n_one = torch.tensor([1, 1], dtype=torch.int32, device=dev)
    rows, ran = {}, {}
    for name, v in MS.VARIANTS.items():
        J, cap = v.jobs, MS.n_max(v)
        ns = sorted({n for n in (*sizes, cap) if n <= cap})
        ran[name] = ns
        row_n = max(n for n in ns if n <= 2048)
        for N in ns:
            t_n = time.perf_counter()
            progs = 4 if N <= 2048 else 2
            x, w4e, sig2, fs, H, pos0 = p1_lattice(N, J, progs, 1800 + N, dev)
            w, s = MS.variant_planes(name, w4e, sig2)
            out, sacc = MS.slim_run(name, x, w, s, n_chk, fs)
            ms = events_ms(lambda: MS.slim_run(name, x, w, s, n_chk, fs))[1]  # warm
            (pl, spl), plain_ms = events_ms(lambda: MS.slim_run_plain(name, x, w, s, n_chk, fs))
            p64, s64 = MS.slim_run_plain(name, x.double(), w.double(), s.double(), n_chk,
                                         fs.double())
            what = f"{name} N={N}"
            pk, pp, vk, vp, sk, sp = p1_held(out, sacc, pl, spl, p64, s64, what)
            first = MS.smem_bytes(v, N) <= MS._MAX_SMEM
            designs = "first design does not run"
            if first:
                fo, fsacc = MS.slim_run_first(name, x, w, s, n_chk, fs)
                p1_held(fo, fsacc, pl, spl, p64, s64, what + " (first design)")
                same = torch.equal(out, fo) and torch.equal(sacc, fsacc)
                if name in P1_BITWISE_BIG and not same:
                    fail(f"P1 {what}: the redesign differs from the first design by "
                         f"{p1_err(out, fo):.3e} though both keep each atom's order of the "
                         f"sum over j")
                designs = ("first design bit for bit" if same else
                           f"|new - first| {p1_err(out[:, :6], fo[:, :6]):.3e}")
            # a program with n_run = 0 bit-identical (the others one step)
            n0 = n_one.expand(progs, 2).clone()
            n0[1, 0] = 0
            o0, s0 = MS.slim_run(name, x, w, s, n0, fs)
            if not (torch.equal(o0[1], x[1]) and torch.equal(s0[1, :3], fs[1, 14:17])):
                fail(f"P1 {what}: a program with n_run = 0 changed its state")
            # the int8 image guard: program 1's first atom 200 box lengths out
            xg = x[:2].clone()
            xg[1, 0, 0, 0] += 200.0 * float(fs[0, 2])
            og, _ = MS.slim_run(name, xg, w, s, n_one, fs[:2])
            pg, _ = MS.slim_run_plain(name, xg, w, s, n_one, fs[:2])
            nan_k = torch.isnan(og[:, :3]).flatten(1).any(1).tolist()
            nan_p = torch.isnan(pg[:, :3]).flatten(1).any(1).tolist()
            if nan_k != nan_p or nan_k != [False, v.cache]:
                fail(f"P1 {what}: image guard: NaN programs kernel {nan_k}, plain {nan_p}, "
                     f"expected {[False, v.cache]}")
            lay, info = MS.ring_layout(v, N), MS.ring_info(name, N)
            if info["layout"] != lay:
                fail(f"P1 {what}: the wrapper's block {lay} is not the kernel's {info['layout']}")
            f_lj, _ = pair_fractions(pos0[None], H[None], MS.CUTOFF2)
            b_ms, b_by = bound(4.0 * (2 * N * N + 2 * progs * 8 * J * N + progs * 30),
                               pair_flops(N, progs * J * P1_STEPS, f_lj))
            max_err = p1_err(out[:, :3], pl[:, :3])
            print(f"[18 P1 {name} N={N}] {progs} programs x {J} x {N} atoms x {P1_STEPS} steps, "
                  f"{f_lj:.4f} of pairs live: vs float64 redesign {pk:.3e} A, plain-f32 "
                  f"{pp:.3e} A, velocities rel {vk:.3e} / {vp:.3e}, chain and 2 KE rel "
                  f"{sk:.3e} / {sp:.3e} (tol 4x plain + 1e-4); max |kernel - plain| "
                  f"{max_err:.3e} A; {designs}; n_run 0 bit-identical; guard NaN {nan_k}; "
                  f"kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}); "
                  f"ring {lay.rows} rows x {lay.cols} columns x {lay.depth} stages, "
                  f"{lay.tiles} tiles, {lay.smem_bytes} B per block, as the kernel's; "
                  f"{info['registers']} registers, {info['local_bytes']} local bytes, "
                  f"{info['blocks_per_sm']} blocks per SM; {time.perf_counter() - t_n:.2f}s")
            if N == row_n:
                rows[name] = {"name": f"md_slim_big_{name}", "route": "cuda",
                              "source": P1_SOURCE, "replaces": P1_REPLACES,
                              "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": b_ms, "bound_by": b_by, "library_ms": None}
            del out, pl, p64, o0, og, pg
            if first:
                del fo
            if N in timed:
                slots = MS.layout_slots(v, N) if v.cache else 0
                progs_t = min(P1_JOBS // J, int(P1_CACHE_BYTES // max(1, 4 * J * slots)))
                xt, wt, st_, ft, _, _ = p1_lattice(N, J, progs_t, 1900 + N, dev)
                wt, st_ = MS.variant_planes(name, wt, st_)
                t = {"first": [], "new": []}
                for which in ("first", "new", "new", "first"):
                    fn = MS.slim_run_first if which == "first" else MS.slim_run
                    if which == "first" and not first:
                        continue
                    t[which].append(events_ms(lambda: fn(name, xt, wt, st_, n_chk, ft))[1])
                tb_ms, tb_by = bound(4.0 * (2 * N * N + 2 * progs_t * 8 * J * N + progs_t * 30),
                                     pair_flops(N, progs_t * J * P1_STEPS, f_lj))
                ms_new = sum(t["new"]) / 2
                firsts = (" / ".join(f"{a:.3f}" for a in (t["first"][0], *t["new"], t["first"][1]))
                          + f" ms ({sum(t['first']) / 2 / ms_new:.2f}x)" if t["first"] else
                          " / ".join(f"{a:.3f}" for a in t["new"]) + " ms (new only)")
                occ = (f"; first design {MS.occupancy_first(name, N)} blocks per SM"
                       if first else "")
                print(f"[18 P1 {name} N={N} A/B] {progs_t} programs x {J} x {N} atoms x "
                      f"{P1_STEPS} steps, first / new / new / first {firsts}; bound "
                      f"{tb_ms:.4f} ms ({tb_by}){occ}")
                del xt
            torch.cuda.synchronize()
            gc.collect()
            torch.cuda.empty_cache()
    launches = {name: getattr(MS.slim_run, "launches_" + name) for name in MS.VARIANTS}
    firsts = {name: getattr(MS.slim_run_first, "launches_" + name) for name in MS.VARIANTS}
    # each size: the check run (twice), the n_run = 0 run and the guard's
    short = {k: launches[k] for k in MS.VARIANTS if launches[k] < 4 * len(ran[k])}
    if short:
        fail(f"P1 sizes: the redesign launched fewer than 4 times per size: {short}")
    print(f"[18 P1 sizes] sizes {ran}; launches {launches}; first design launches {firsts}; "
          f"{time.perf_counter() - t0:.2f}s")
    for name in MS.VARIANTS:
        rows[name]["launches"] = launches[name]
    return list(rows.values())


K4_BIG_SOURCE = "scema_tpu_torch/csrc/md_k4_big.cu"
# the 4096-atom coupled slice: at most this many MD jobs per macro-step, so
# that its dense torch list builds (N^2 = 16M candidates, ~64 MB a job per
# slice) and two steps stay well inside the run's time
BIG_JOBS = 32
# phase 19's job counts: the slice's, one that fills no whole wave of
# clusters, and the timed chunk's; the box near the cluster form's cap
# (256 chains of C10H22: above what 8 CTAs per job hold, so 16)
K4_CL_JOBS, K4_CL_ODD, K4_CL_TIMED, K4_CL_NEAR_CHAINS = 32, 37, 128, 256


def _k4_cluster_check(r, r64, sys_, sub, nbr, what, run=None):
    """Run ``sub`` (md_run's arguments, job 1 at 0 steps) on K4's cluster
    form (``run``, default md_run) and hold it to the plain version and
    float64 by phase 8's rules, the 0-step job bit-identical, the SHAKE
    residual of the jobs that ran below 1e-3; returns (max |pos - plain|,
    float64 position error, velocity error, residual)."""
    import torch

    from scema_tpu_torch.ops import md_fused as MF

    before = MF.md_run.launches_k4cluster
    out, xo, _ = (run or MF.md_run)(r, *sub, nbr=nbr)
    torch.cuda.synchronize()
    if MF.md_run.launches_k4cluster != before + 1:
        fail(f"{what}: the cluster form did not count its launch")
    if not (torch.equal(out[1], sub[0][1]) and torch.equal(xo[1], sub[1][1])):
        fail(f"{what}: a job with n_run = 0 changed")
    ref, _, _ = MF.md_run_plain(r, *sub, nbr=nbr)
    ref64, _, _ = MF.md_run_plain(r64, *(x.double() if torch.is_tensor(x)
                                         and x.is_floating_point() else x for x in sub), nbr=nbr)
    torch.cuda.synchronize()
    p_err = float((out[:, :3] - ref[:, :3]).abs().max())
    pk, vk = _run_rule(out, ref, ref64, what)
    # the jobs that ran: the 0-step job keeps FIRE's positions, which FIRE
    # does not hold to the SHAKE bond lengths
    resid = shake_residual(sys_, out[sub[2] > 0, :3].transpose(1, 2))
    if not resid < 1e-3:
        fail(f"{what}: SHAKE residual |r^2 - d0^2| / d0^2 = {resid:.3e} >= 1e-3")
    return p_err, pk, vk, resid


def _k4_chunk(sys_, st, J, dev, seed):
    """J jobs of the prepared box with Maxwell velocities and random strain
    rates: (md_run's arguments for a 10-step deform chunk of a 40-step run
    with the frozen k-space force, its compact list)."""
    import torch

    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.ops import md_fused as MF

    r = sys_.fused
    gen = torch.Generator().manual_seed(seed)
    vel = torch.stack([E.maxwell_velocities(sys_, T_MD, gen, torch.float32, dev)
                       for _ in range(J)])
    hJ = st.h.expand(J, 3, 3).contiguous()
    posJ = st.pos.expand(J, -1, -1).contiguous()
    fscal = MF.make_fscal(DT, T_MD, hJ, (torch.rand((J, 6), generator=gen) * 2e-3
                                         - 1e-3).to(dev))
    n10 = torch.full((J,), 10, dtype=torch.int32, device=dev)
    Fk, _ = r.kspace(posJ, hJ)
    args = (MF.pack_state(posJ, vel), torch.zeros((J, 3), device=dev), n10, fscal, True, False,
            Fk.transpose(1, 2).contiguous(), torch.zeros_like(n10), torch.full_like(n10, 40))
    return args, r.channels(posJ, hJ, reuse=True)


def _skip_one(args):
    """md_run's arguments with job 1 at 0 steps."""
    nr = args[2].clone()
    nr[1] = 0
    return (args[0], args[1], nr) + args[3:]


def _plan_line(plan) -> str:
    return (f"C={plan['C']} CTAs per job (cuts {list(plan['cuts'])}, cross {plan['cross']}), "
            f"{plan['clusters']} clusters at once, {plan['threads']} threads and "
            f"{plan['smem_bytes']} B shared per CTA, {plan['registers']} registers, "
            f"{plan['local_bytes']} B local")


def phase_k4_big(dev):
    """Phase 19: K4's cluster form (csrc/md_k4_big.cu: one job on a cluster
    of C CTAs, its rows in the CTAs' shared memory) on the prepared
    4096-atom PE box (``material.PEAA4096``, above the shared form's cap):
    the force entry on 12 boxes; against the plain version and float64 by
    phase 8's rules (a 0-step job bit-identical, the SHAKE residual) a
    16-job 10-step chunk on the host's cluster size, the same on 8 CTAs
    with cuts that split SHAKE constraints, 37 jobs (no whole wave), an
    8192-atom box near the cap on 16 CTAs, and 20-step pressure sums; the
    cluster sizes timed at 32 jobs; then the cluster form and the global
    form (its A/B partner) in turns at 32 and 128 jobs against the bound."""
    import torch

    from scema_tpu_torch.md import box as B
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.md.homogenization import _LAMMPS_TO_FRAMEWORK
    from scema_tpu_torch.ops import md_fused as MF

    t0 = time.perf_counter()
    gc.collect()
    sys_, st = M.build_system(M.PEAA4096, dtype=torch.float32, device=dev)
    r = sys_.fused
    n, K = sys_.n_atoms, r.spec.k
    T = int(r.k34_tbl.shape[0])
    if not MF.k4_big(r.spec, T):
        fail(f"the {n}-atom box does not take K4's cluster form")
    st = E.minimize_fire(sys_, st, n_steps=100, dt0=0.5)
    torch.cuda.synchronize()
    print(f"[19 K4 big] PEAA4096 box: {n} atoms, box {float(st.h[0, 0]):.3f} A, flags "
          f"{r.spec.flags}, list width K={K}; K4's shared form fits {MF.max_atoms(r.spec, T)} "
          f"atoms, the cluster form {MF.k4_big_max_atoms(r.spec, T)} ({T} types; cluster sizes "
          f"{MF.k4_cluster_fits(n, T)} fit this box); build + FIRE "
          f"{time.perf_counter() - t0:.2f}s")
    r64 = r.to(dev, torch.float64)

    # the force entry (one form for every box size) on the probe's 12 boxes,
    # orthorhombic and tilted, each on one list built at those positions
    eps = torch.zeros((12, 6), device=dev)
    for d in range(6):
        eps[2 * d, _LAMMPS_TO_FRAMEWORK[d]] = 1e-3
        eps[2 * d + 1, _LAMMPS_TO_FRAMEWORK[d]] = -1e-3
    h12 = B.deform_path(st.h.expand(12, 3, 3), eps, 1.0)
    pos12 = B.remap_affine(st.h.expand(12, 3, 3), h12, st.pos.expand(12, -1, -1))
    ht = h12.clone()
    ht[:, 0, 1], ht[:, 0, 2], ht[:, 1, 2] = 1.5, -1.0, 0.8
    errs = []
    for tag, (pp_, hh) in (("orthorhombic", (pos12, h12)), ("tilted", (B.remap_affine(
            h12, ht, pos12), ht))):
        p12, h6 = pp_.transpose(1, 2).contiguous(), MF.h6_of(hh)
        nb = r.channels(pp_, hh)
        F, W = MF.md_forces_virial(r, p12, h6, nbr=nb)
        Fp, Wp = MF.md_forces_virial_plain(r, p12, h6, nb)
        F64, W64 = MF.md_forces_virial_plain(r64, p12.double(), h6.double(), nb)
        torch.cuda.synchronize()
        fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
        ek = float((F.double() - F64).abs().max()) / fmax
        ep = float((Fp.double() - F64).abs().max()) / fmax
        wk = float((W.double() - W64).abs().max()) / wmax
        wp = float((Wp.double() - W64).abs().max()) / wmax
        if not torch.isfinite(F).all() or ek > 4 * ep + 1e-6 or wk > 4 * wp + 1e-6:
            fail(f"K4 forces at {n} atoms ({tag}): kernel error vs float64 {ek:.3e} (virial "
                 f"{wk:.3e}) exceeds 4x the plain float32 error {ep:.3e} ({wp:.3e}) + 1e-6")
        if int(nb["count"].max()) >= K:
            fail(f"K4 at {n} atoms: a list row is full ({int(nb['count'].max())} of K={K})")
        errs.append(f"{tag} {ek:.3e} (virial {wk:.3e}; plain-f32 {ep:.3e}, {wp:.3e})")
    p12, h6 = pos12.transpose(1, 2).contiguous(), MF.h6_of(h12)
    nb12 = r.channels(pos12, h12)
    f_ms = device_ms(lambda: MF.md_forces_virial(r, p12, h6, nbr=nb12), 10, K34_NAMES["path"])
    print(f"[19 K4 big forces] B=12: rel error vs float64 (tol 4x plain + 1e-6): "
          f"{'; '.join(errs)}  device {f_ms:.4f} ms; force kernel "
          f"{MF.k34_kernel_info('K4', 'forces', n, T)}")
    del nb, nb12

    # 16 jobs of a 128-job 10-step deform chunk with SHAKE and the frozen
    # k-space force, one at 0 steps: the host's cluster size, then 8 CTAs
    # with each cut moved onto a SHAKE constraint (the cross path)
    J, S = K4_CL_TIMED, 16
    args, nbrJ = _k4_chunk(sys_, st, J, dev, 19)
    sub = _skip_one(tuple(x[:S] if torch.is_tensor(x) and x.dim() else x for x in args))
    nbrS = {k: v[:S] for k, v in nbrJ.items()}
    plan = MF.k4_cluster_plan(r, S)
    p_err, pk, vk, resid = _k4_cluster_check(r, r64, sys_, sub, nbrS, "K4 cluster run")
    split = MF._shake_split(r)
    cross_cuts = [0] + [next(c for c in range(k * n // 8, n) if split[c]) for k in range(1, 8)] + [n]
    xplan = MF.k4_cluster_plan(r, S, cuts=cross_cuts)
    if not xplan["cross"]:
        fail(f"K4 cluster: cuts {cross_cuts} split no SHAKE constraint")
    xp_err, xpk, xvk, xres = _k4_cluster_check(
        r, r64, sys_, sub, nbrS, "K4 cluster run (cuts across constraints)",
        run=lambda *a, **kw: MF.k4_cluster_run(*a, cuts=cross_cuts, **kw))
    og, _, _ = MF.k4_global_run(r, *sub, nbr=nbrS)
    g_err = float((og[:, :3] - MF.md_run_plain(r, *sub, nbr=nbrS)[0][:, :3]).abs().max())
    print(f"[19 K4 cluster run] {S} jobs x 10 deform steps of {DT} fs, SHAKE + fext, "
          f"{_plan_line(plan)}: positions max_abs_err vs plain {p_err:.3e} A; vs float64 "
          f"{pk:.3e} A, velocities rel {vk:.3e} (tol 4x plain + 1e-4), SHAKE residual "
          f"{resid:.3e}, the 0-step job bit-identical; cuts across constraints "
          f"({_plan_line(xplan)}): vs plain {xp_err:.3e} A, vs float64 {xpk:.3e} A, velocities "
          f"rel {xvk:.3e}, SHAKE residual {xres:.3e}; the global form vs plain {g_err:.3e} A")

    # a job count that fills no whole wave of clusters
    oargs, onbr = _k4_chunk(sys_, st, K4_CL_ODD, dev, 37)
    oplan = MF.k4_cluster_plan(r, K4_CL_ODD)
    o_err, opk, ovk, ores = _k4_cluster_check(r, r64, sys_, _skip_one(oargs), onbr,
                                              f"K4 cluster run ({K4_CL_ODD} jobs)")
    print(f"[19 K4 cluster odd] {K4_CL_ODD} jobs, {_plan_line(oplan)}: vs plain {o_err:.3e} A, "
          f"vs float64 {opk:.3e} A, velocities rel {ovk:.3e}, SHAKE residual {ores:.3e}")
    del oargs, onbr

    # 20-step sampling at 16 jobs: each job's pressure sums against float64
    out, xo, _ = MF.md_run(r, *sub, nbr=nbrS)
    n20 = torch.full((S,), 20, dtype=torch.int32, device=dev)
    hS = st.h.expand(S, 3, 3).contiguous()
    f_s = MF.make_fscal(DT, T_MD, hS)
    one = torch.ones_like(n20)
    fkS, g0S = sub[6], sub[7]
    sargs = (out, xo, n20, f_s, False, True, fkS, g0S, one)
    _, _, sk = MF.md_run(r, *sargs, nbr=nbrS)
    _, _, sp = MF.md_run_plain(r, *sargs, nbr=nbrS)
    _, _, s64 = MF.md_run_plain(r64, out.double(), xo.double(), n20, f_s.double(), False, True,
                                fkS.double(), g0S, one, nbr=nbrS)
    torch.cuda.synchronize()
    smax = s64.abs().amax(0)
    sk_err = float(((sk.double() - s64).abs().amax(0) / smax).max())
    sp_err = float(((sp.double() - s64).abs().amax(0) / smax).max())
    if not torch.isfinite(sk).all() or sk_err > 4 * sp_err + 1e-4:
        fail(f"K4 cluster sampling: kernel pressure sums vs float64 rel {sk_err:.3e} exceed "
             f"4x plain float32 {sp_err:.3e} + 1e-4")
    print(f"[19 K4 big sample20] {S} jobs x 20 sampling steps: per-job pressure sums rel to "
          f"float64 (worst component): kernel {sk_err:.3e} plain-f32 {sp_err:.3e} (tol 4x "
          f"plain + 1e-4)")

    # the box near the cap: 8192 atoms hold only at 16 CTAs per job
    t1 = time.perf_counter()
    near = dataclasses.replace(M.PEAA4096, name="peaa8192", n_chains=K4_CL_NEAR_CHAINS)
    nsys, nst = M.build_system(near, dtype=torch.float32, device=dev)
    nr_, nn = nsys.fused, nsys.n_atoms
    cap = MF.k4_big_max_atoms(nr_.spec, T)
    if not (MF.k4_big(nr_.spec, T) and nn <= cap and MF.k4_cluster_fits(nn, T) == (16,)):
        fail(f"the {nn}-atom box: cap {cap}, cluster sizes {MF.k4_cluster_fits(nn, T)}")
    nst = E.minimize_fire(nsys, nst, n_steps=50, dt0=0.5)
    nargs, nnbr = _k4_chunk(nsys, nst, 4, dev, 81)
    if int(nnbr["count"].max()) >= nr_.spec.k:
        fail(f"K4 at {nn} atoms: a list row is full ({int(nnbr['count'].max())} of "
             f"K={nr_.spec.k})")
    nplan = MF.k4_cluster_plan(nr_, 4)
    n_err, npk, nvk, nres = _k4_cluster_check(nr_, nr_.to(dev, torch.float64), nsys,
                                              _skip_one(nargs), nnbr,
                                              f"K4 cluster run ({nn} atoms)")
    print(f"[19 K4 cluster near cap] {nn} atoms ({cap} fit at {T} types), 4 jobs, "
          f"{_plan_line(nplan)}: vs plain {n_err:.3e} A, vs float64 {npk:.3e} A, velocities rel "
          f"{nvk:.3e}, SHAKE residual {nres:.3e}; build + FIRE + check "
          f"{time.perf_counter() - t1:.2f}s")
    del nsys, nst, nr_, nargs, nnbr

    # the cluster sizes at the slice's 32 jobs, then the cluster form and
    # the global form in turns (global, cluster, cluster, global) at 32 and
    # 128 jobs
    a32 = tuple(x[:K4_CL_JOBS] if torch.is_tensor(x) and x.dim() else x for x in args)
    n32 = {k: v[:K4_CL_JOBS] for k, v in nbrJ.items()}
    sizes = {(jobs, C): cuda_ms(lambda C=C, aa=aa, nb=nb: MF.k4_cluster_run(r, *aa, nbr=nb,
                                                                           cluster=C), reps=3)
             for jobs, aa, nb in ((K4_CL_JOBS, a32, n32), (J, args, nbrJ))
             for C in MF.k4_cluster_fits(n, T)}
    # where a chunk's time goes at the slice's 32 jobs, in both forms: the
    # pair loop (every count 0), 36 of the 37 pattern passes (the first
    # pattern alone), the SHAKE/RATTLE sweeps (0 of each)
    spec = r.spec
    parts = {"all": (r, n32),
             "no pair loop": (r, {"slot": n32["slot"], "count": torch.zeros_like(n32["count"])}),
             "one pattern": (dataclasses.replace(r, spec=dataclasses.replace(
                 spec, bonded_pattern=spec.bonded_pattern[:1])), n32),
             "no SHAKE sweeps": (dataclasses.replace(r, spec=dataclasses.replace(
                 spec, shake_iters=0, rattle_iters=0)), n32)}
    split_ms = {(k, form): cuda_ms(lambda rr=rr, nb=nb, run=run: run(rr, *a32, nbr=nb), reps=3)
                for k, (rr, nb) in parts.items()
                for form, run in (("global", MF.k4_global_run), ("cluster", MF.md_run))}
    forms = {}
    for jobs, aa, nb in ((K4_CL_JOBS, a32, n32), (J, args, nbrJ)):
        forms[jobs] = k34_ab({"first": lambda aa=aa, nb=nb: MF.k4_global_run(r, *aa, nbr=nb),
                              "path": lambda aa=aa, nb=nb: MF.md_run(r, *aa, nbr=nb)}, 3)
    run_ms = min(forms[J]["path"])
    run_plain_ms = cuda_ms(lambda: MF.md_run_plain(r, *args, nbr=nbrJ), reps=1, warmup=0)
    lp, lj, lq = list_pair_counts(MF.k4_slots_to_channels(r, {k: v[:2] for k, v in nbrJ.items()}),
                                  args[0][:2, :3].transpose(1, 2), st.h.expand(2, 3, 3),
                                  r.spec.cutoff2, r.spec.coul_cutoff2)
    cnt = nbrJ["count"].double()
    live_mean = float(cnt.mean())
    tables = 2 * T * T + 2 * n
    jobs_bytes = 4.0 * (2 * 6 * n + 3 * n + 16 + 2 * 3 + 3)

    def run_bound(jobs):
        return bound(jobs * (4.0 * (live_mean * n + n) + jobs_bytes)
                     + 4.0 * (tables + r.pat.numel() + r.shk.numel() + 2 * n),
                     list_flops(jobs * 10, lp, lj, lq))

    rb_ms, rb_by = run_bound(J)
    rb32, _ = run_bound(K4_CL_JOBS)
    plans = {jobs: MF.k4_cluster_plan(r, jobs) for jobs in (K4_CL_JOBS, J)}
    print(f"[19 K4 cluster sizes] 10 deform steps, ms: "
          + ", ".join(f"{jobs} jobs C={C} {t:.3f}" for (jobs, C), t in sizes.items())
          + f"; the host's C={plans[K4_CL_JOBS]['C']} at {K4_CL_JOBS} jobs, "
          f"{plans[J]['C']} at {J}")
    print(f"[19 K4 time split] {K4_CL_JOBS} jobs x 10 deform steps, ms (global / cluster): "
          + ", ".join(f"{k} {split_ms[(k, 'global')]:.3f} / {split_ms[(k, 'cluster')]:.3f}"
                      for k in parts))
    for jobs in (K4_CL_JOBS, J):
        f = forms[jobs]
        print(f"[19 K4 A/B] {jobs} jobs x 10 deform steps, ms (global, cluster, cluster, "
              f"global): {turns(f)}: global / cluster {min(f['first']) / min(f['path']):.3f}x; "
              f"bound {run_bound(jobs)[0]:.3f} ms; {_plan_line(plans[jobs])}")
    ginfo = MF.k34_kernel_info("K4", "big_run", n, T)
    print(f"[19 K4 big run] {J} jobs: cluster form {run_ms:.3f} ms  plain {run_plain_ms:.3f} ms  "
          f"bound {rb_ms:.3f} ms ({rb_by}; per box {lp:.0f} list pairs, {lj:.0f} inside LJ, "
          f"{lq:.0f} inside Coulomb); live slots per row mean {live_mean:.1f}, max "
          f"{int(cnt.max())} of K={K}; the global form's run kernel {ginfo['registers']} "
          f"registers, {ginfo['local_bytes']} B local, {ginfo['blocks_per_sm']} block(s) per "
          f"SM of {ginfo['threads']} threads; ptxas (registers, spill stores) cluster form "
          f"{kernel_registers('k4_cluster_run_kernel')}, global form "
          f"{kernel_registers('Li321ELi768E')}; phase wall {time.perf_counter() - t0:.2f}s")
    note = (K4_NOTE + f"; boxes above the shared form's cap: {J} jobs x 10 deform steps at "
            f"N={n}")
    cluster_row = {"name": "md_list_cluster_run", "route": "cuda", "source": K4_BIG_SOURCE,
                   "replaces": "scema_tpu/ops/md_fused.py:1678",
                   "note": note + f", the cluster form (C={plans[J]['C']}; at {K4_CL_JOBS} jobs "
                           f"{min(forms[K4_CL_JOBS]['path']):.3f} ms, bound {rb32:.3f})",
                   "max_abs_err": p_err, "ms": run_ms, "plain_ms": run_plain_ms,
                   "bound_ms": rb_ms, "bound_by": rb_by, "library_ms": None}
    global_row = dict(cluster_row, name="md_list_big_run",
                      note=note + f", the global form (one block per job; at {K4_CL_JOBS} jobs "
                                  f"{min(forms[K4_CL_JOBS]['first']):.3f} ms)",
                      max_abs_err=g_err, ms=min(forms[J]["first"]))
    return [cluster_row, global_row]


def phase_big_slice(dev):
    """Phase 20: the coupled step on the 4096-atom PE box (K4's cluster
    form) — ``build_md_hmm(HMMConfig(), spec=PEAA4096, equil_steps=50,
    minimize_steps=100)`` with at most BIG_JOBS MD jobs per step, float32,
    2 macro-steps, the launch counters zeroed just before the build and read
    just after the steps; K4's cluster form, its force entry and K2 must
    have launched, K4's shared and global forms and the first designs not."""
    import torch

    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import material as M

    counters = md_counters()
    cfg = HMMConfig()
    cfg = cfg.replace(dtype="float32", md_dtype="float32",
                      resources=dataclasses.replace(cfg.resources, max_md_jobs=BIG_JOBS))
    n_steps = 2
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    hmm = build_md_hmm(cfg, spec=M.PEAA4096, equil_steps=50, minimize_steps=100, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state = hmm.init_state()
    step_s, jobs = [], []
    for _ in range(n_steps):
        t1 = time.perf_counter()
        state, out = hmm.step(state)
        torch.cuda.synchronize()
        step_s.append(round(time.perf_counter() - t1, 4))
        jobs.append(int(out.n_jobs))
        if not (torch.isfinite(out.residual0) and torch.isfinite(out.residual1)) or jobs[-1] <= 0:
            fail("4096-atom slice: a macro-step produced no MD jobs or non-finite residuals")
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    peak = torch.cuda.max_memory_allocated(dev)
    umax = float(state[0].u.abs().max())
    expect = n_steps * 0.002 * 0.08
    if abs(umax - expect) > 1e-5 * expect:
        fail(f"4096-atom slice: max displacement {umax} != {expect}")
    for k in ("md_list_cluster_run", "md_list_forces_virial", "pairwise_l2"):
        if launches[k] <= 0:
            fail(f"4096-atom slice: kernel {k} was not launched: {launches}")
    if launches["md_list_run"] or launches["md_list_big_run"]:
        fail(f"4096-atom slice: K4's shared or global form was launched: {launches}")
    first_designs_idle(launches, "4096-atom slice")
    if max(jobs) > BIG_JOBS:
        fail(f"4096-atom slice: {max(jobs)} MD jobs in a step, above the {BIG_JOBS} cap")
    micro = state[1][0]
    ran = micro.pos[micro.has_run]
    resid = shake_residual(hmm.backend.sys, ran)
    if ran.shape[0] == 0 or not resid < 1e-3:
        fail(f"4096-atom slice: SHAKE residual {resid:.3e} on {ran.shape[0]} MD states")
    print(f"[20 big slice] {hmm.backend.sys.n_atoms}-atom PEAA4096 boxes on K4's cluster form "
          f"(K={hmm.backend.sys.fused.spec.k}), qps {hmm.geom.n_qp_total}, at most {BIG_JOBS} "
          f"MD jobs per step: setup {setup_s:.3f}s  s/macro-step {step_s}  md jobs {jobs}  "
          f"launches {launches}  peak memory {peak / 2**20:.1f} MiB  max displacement "
          f"{umax:.6g} m (expect {expect:.6g})  SHAKE residual {resid:.3e} over the "
          f"{ran.shape[0]} qps' MD states (tol 1e-3)")
    return launches


# phase 21: a restarted step 3 against the uninterrupted one on the card.
# index_add_'s CUDA atomics reorder the FE scatter's float32 sums, so the
# restarted step differs in the last bits of u and v (~1e-7 relative), and
# the MD jobs that take those strains diverge along their chaotic
# trajectories; a wrong restore (fresh microstates, another step count)
# differs by O(1)
RESTART_TOL = {"u": 1e-5, "v": 1e-5, "new_stress": 1e-2}


def _cli(argv):
    """(exit code, stdout, stderr) of ``scema_tpu_torch.cli.main(argv)``."""
    from scema_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    for line in out.getvalue().splitlines():
        print(f"    {line}")
    return rc, out.getvalue(), err.getvalue()


def phase_run_surface(dev):
    """The run surface on the card: init-material -> run with every output
    at frequency 1 and --dump-similarity -> a restart from step 2 ->
    strain-md -> analyse-md on both microstate formats."""
    import xml.etree.ElementTree as ET

    import numpy as np
    import torch

    from scema_tpu_torch.clustering.spline import splinify_histories
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import pairwise_l2 as K2

    t_phase = time.perf_counter()
    errs = []
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        nano, out, out2 = (os.path.join(tmp, d) for d in ("nano", "out", "out2"))
        cfg = os.path.join(tmp, "cfg.json")
        freq = ("checkpoint frequency", "visualisation output frequency",
                "analytics output frequency", "loaded boundary force output frequency",
                "homogenization output frequency")
        with open(cfg, "w") as f:
            json.dump({"directory structure": {"nanoscale input": nano},
                       "output data": {k: 1 for k in freq}}, f)
        # 1. init-material writes the init set (g0, quick prep)
        rc, text, err = _cli(["init-material", cfg, "--quick-prep"])
        errs.append(err)
        if rc != 0:
            fail(f"init-material exited {rc}: {err}")
        for name in ("init.g0_1.length", "init.g0_1.stress", "init.g0_1.stiff",
                     "init.g0.stiff", "init.g0.density"):
            if not os.path.exists(os.path.join(nano, name)):
                fail(f"init-material wrote no {name}")
        # 2. run, reading that set, every output at frequency 1
        counters = {"md_k1_run": (MF.md_run, "launches"),
                    "md_k1_forces_virial": (MF.md_forces_virial, "launches"),
                    "pairwise_l2": (K2.pairwise_l2, "launches"),
                    "pairwise_l2_first": (K2._first, "launches")}
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        sim = os.path.join(tmp, "sim.npz")
        t0 = time.perf_counter()
        rc, text, err = _cli(["run", cfg, "--quick-prep", "--steps", "3", "--outdir", out,
                              "--dump-similarity", sim])
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        errs.append(err)
        if rc != 0:
            fail(f"run --outdir exited {rc}: {err}")
        jobs = [int(j) for j in re.findall(r"md jobs (\d+)", text)]
        if len(jobs) != 3 or "Max displacement: 0.00048 m" not in text:
            fail("run --outdir: missing step lines or the 0.00048 m milestone")
        for k in ("md_k1_run", "md_k1_forces_virial", "pairwise_l2"):
            if launches[k] <= 0:
                fail(f"run --outdir did not launch {k}")
        if launches["pairwise_l2_first"]:
            fail("run --outdir launched K2's first design")
        n_nodes, n_cells = 4 * 4 * 9, 72  # the 3x3x8 dogbone
        for ts in (1, 2, 3):
            for stem, pts in (("solution", n_nodes), ("history", 8 * n_cells)):
                piece = ET.parse(os.path.join(out, f"{stem}-{ts:06d}.vtu")).getroot() \
                    .find(".//Piece")
                if piece.get("NumberOfPoints") != str(pts) or \
                        piece.get("NumberOfCells") != str(n_cells):
                    fail(f"{stem}-{ts:06d}.vtu: wrong piece sizes")
            rows = open(os.path.join(out, f"lhistory-{ts:06d}.csv")).read().splitlines()
            if len(rows) != 577 or not all(np.isfinite(
                    np.array(rows[1].split(","), dtype=float))):
                fail(f"lhistory-{ts:06d}.csv: {len(rows)} rows")
        for stem in ("solution", "history"):
            pvd = ET.parse(os.path.join(out, f"{stem}.pvd")).getroot()
            if len(pvd.findall(".//DataSet")) != 3:
                fail(f"{stem}.pvd does not list 3 steps")
        lbc = np.loadtxt(os.path.join(out, "loaded_boundary_force.csv"), delimiter=",",
                         skiprows=1)
        mddata = [n for n in os.listdir(out) if n.startswith("mddata_qpid")]
        if lbc.shape != (3, 3) or not np.isfinite(lbc).all() or len(mddata) < max(jobs):
            fail(f"CSV outputs: lbc {lbc.shape}, {len(mddata)} mddata files for "
                 f"{max(jobs)} jobs")
        for name in ("lcts.solution.bin", "lcts.velocity.bin", "lcts.pr_0.lhistory.bin"):
            if not os.path.exists(os.path.join(out, "restart", name)):
                fail(f"run --outdir wrote no restart/{name}")
        # 3. restart from step 2, one step, against the uninterrupted step 3
        rc, text2, err = _cli(["run", cfg, "--quick-prep", "--steps", "1", "--outdir", out2,
                               "--restart", os.path.join(out, "checkpoint-000002.npz")])
        errs.append(err)
        if rc != 0:
            fail(f"run --restart exited {rc}: {err}")
        jobs2 = [int(j) for j in re.findall(r"md jobs (\d+)", text2)]
        if jobs2 != jobs[2:] or "Timestep 3 " not in text2:
            fail(f"the restarted step 3 ran {jobs2} jobs, the uninterrupted {jobs[2:]}")
        with np.load(os.path.join(out, "checkpoint-000003.npz")) as a, \
                np.load(os.path.join(out2, "checkpoint-000003.npz")) as b:
            if a.files != b.files:
                fail("the restarted checkpoint has other leaves")
            # FEState leaves: u 0, v 1, qp.new_stress 8, hist.buffer 15, count 16
            diffs = {k: float(np.abs(a[f"leaf_{i}"] - b[f"leaf_{i}"]).max()
                              / np.abs(a[f"leaf_{i}"]).max())
                     for k, i in (("u", 0), ("v", 1), ("new_stress", 8))}
            for k, tol in RESTART_TOL.items():
                if not diffs[k] <= tol:
                    fail(f"the restarted step 3's {k} differs by {diffs[k]:.3e} (tol {tol})")
            if int(a["leaf_19"]) != 3 or int(b["leaf_19"]) != 3:
                fail("checkpoint-000003.npz holds another timestep")
            buffer, count = a["leaf_15"], int(a["leaf_16"])
        # 5. --dump-similarity is K2 on the final splines
        with np.load(sim) as f:
            dist = torch.as_tensor(f["dist"], device=dev)
        splines = splinify_histories(torch.as_tensor(buffer, device=dev), count, 10)
        ref = K2.pairwise_l2_plain(splines)
        sim_rel = float((dist - ref).abs().max() / ref.abs().max().clamp(min=1e-30))
        if dist.shape != (576, 576) or not sim_rel <= 1e-5:
            fail(f"--dump-similarity: shape {tuple(dist.shape)}, rel {sim_rel:.3e} from "
                 "the plain version")
        # 4. strain-md -> analyse-md on both formats (g0 at 0.01 K, 20 sampling
        # steps of 0.002 fs: tests/test_cli_handshake.py's regime; a dump
        # carries no thermostat state, so longer sampling would measure the
        # chain's restart, not the format)
        cfg_md = os.path.join(tmp, "md.json")
        with open(cfg_md, "w") as f:
            json.dump({"molecular dynamics parameters": {
                "temperature": 0.01, "timestep length": 0.002, "strain rate": 1.0e-3,
                "number of sampling steps": 20}}, f)
        npz, dump = os.path.join(tmp, "micro.npz"), os.path.join(tmp, "last.1.g0_1.dump")
        rc, text, err = _cli(["strain-md", cfg_md, "--save-state", npz, "--dump", dump])
        errs.append(err)
        if rc != 0:
            fail(f"strain-md exited {rc}: {err}")
        sig = {}
        for path in (npz, dump):
            rc, text, err = _cli(["analyse-md", cfg_md, path])
            errs.append(err)
            m = re.search(r"re-homogenized stress.*\n([-+0-9.e ]+)", text)
            if rc != 0 or m is None:
                fail(f"analyse-md {os.path.basename(path)} exited {rc}: {err}")
            sig[path] = np.array(m.group(1).split(), dtype=float)
        scale = np.abs(sig[npz]).max()
        fmt_rel = float(np.abs(sig[dump] - sig[npz]).max() / scale)
        if not (np.isfinite(sig[npz]).all() and fmt_rel <= 1e-3):
            fail(f"analyse-md: the dump and the npz differ by {fmt_rel:.3e} (tol 1e-3)")
    # 6. no rollback anywhere
    if any("rolling back" in e for e in errs):
        fail("a step rolled back in the run-surface phase")
    print(f"[21 run surface] run --outdir (3 steps, every output, md jobs {jobs}) "
          f"{run_s:.2f}s, launches {launches}; restart at step 2 -> step 3 jobs {jobs2}, "
          f"max rel diff u {diffs['u']:.3e} v {diffs['v']:.3e} stress "
          f"{diffs['new_stress']:.3e}; --dump-similarity rel {sim_rel:.3e} from plain; "
          f"analyse-md dump vs npz rel {fmt_rel:.3e}; no rollback; "
          f"phase {time.perf_counter() - t_phase:.1f}s")


def p1_kernel(v, first: bool = False) -> str:
    """The mangled name of a P1 variant's instance (template flags CACHE
    TRIM UNISIG FORM NEWTON J): the redesign's in md_slim_ring.cu or the
    first design's in md_slim.cu."""
    form = {"sig": 0, "lj": 1, "rsqrt": 2}[v.form]
    newton = {"": 0, "atomic": 1, "partials": 2, "shuffle": 3}[v.newton]
    flags = (f"ILb{int(v.cache)}ELb{int(v.trim)}ELb{int(v.unisig)}ELi{form}E"
             f"Li{newton}ELi{v.jobs}E")
    return f"md_slim{'' if first else '_ring'}_kernel{flags}"


# Density band (kg/m^3) of PEAA after the staged prep at ns_init 100 (phase
# 22): about 10% around what the JAX package's own prep gives on this box
# (tests/torch_staged_density.py --materials peaa --dtype float32, CPU, keys
# 1-2: JAX 462.4-464.1, the port on the same draws 454.8-460.0).  The melt
# leaves its start density of 680: it expands while it is held at 500 K
PEAA_RHO_NS100 = (415.0, 510.0)


def phase_charged_staged_slice(dev):
    """Phase 22 (see the module docstring): the charged all-atom box with
    the staged NPT prep on K3's force entry, then the unfused engine on
    the same box."""
    import torch

    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import constraints as CN
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.ops import md_fused as MF

    counters = md_counters()

    def zero():
        for fn, attr in counters.values():
            setattr(fn, attr, 0)

    def read():
        return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}

    t_phase = time.perf_counter()
    cfg = HMMConfig()
    cfg = cfg.replace(dtype="float32", md_dtype="float32",
                      resources=dataclasses.replace(cfg.resources, max_md_jobs=128))
    n_steps = 2
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    zero()
    t0 = time.perf_counter()
    hmm = build_md_hmm(cfg, spec=M.PEAA, staged=True, ns_init=100, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup = read()
    sys_ = hmm.backend.sys
    r = sys_.fused
    if r is None or r.spec.kernel != "K3":
        fail(f"charged staged slice: PEAA is not on K3 ({r and r.spec.kernel})")
    if setup["md_charged_forces_virial"] < 900 or setup["md_charged_run"] <= 0:
        fail(f"charged staged slice: K3's force entry launched "
             f"{setup['md_charged_forces_virial']} times in the setup (>= 900 expected), its "
             f"run {setup['md_charged_run']}")
    first_designs_idle(setup, "charged staged slice setup")
    st0 = hmm.backend.initial_md_state
    resid0 = shake_residual(sys_, st0.pos)
    rho = float(hmm.backend.ensemble.rho.mean())
    if not torch.isfinite(st0.pos).all() or not resid0 < 1e-3:
        fail(f"charged staged slice: prepared state non-finite or SHAKE residual {resid0:.3e}")
    if not PEAA_RHO_NS100[0] < rho < PEAA_RHO_NS100[1]:
        fail(f"charged staged slice: prepared density {rho} kg/m^3 outside {PEAA_RHO_NS100}")

    zero()
    state = hmm.init_state()
    step_s, jobs = [], []
    for _ in range(n_steps):
        t1 = time.perf_counter()
        state, out = hmm.step(state)
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t1)
        jobs.append(int(out.n_jobs))
        if not (torch.isfinite(out.residual0) and torch.isfinite(out.residual1)) or jobs[-1] <= 0:
            fail("charged staged slice: a macro-step produced no MD jobs or non-finite residuals")
    launches = read()
    peak = torch.cuda.max_memory_allocated(dev)
    if launches["md_charged_run"] <= 0 or launches["pairwise_l2"] <= 0:
        fail(f"charged staged slice: K3's run or K2 was not launched in the steps: {launches}")
    first_designs_idle(launches, "charged staged slice")
    if max(jobs) > 128:
        fail(f"charged staged slice: {max(jobs)} MD jobs in a step, above the 128 cap")
    umax = float(state[0].u.abs().max())
    expect = n_steps * 0.002 * 0.08
    if abs(umax - expect) > 1e-5 * expect:
        fail(f"charged staged slice: max displacement {umax} != {expect}")
    micro = state[1][0]
    ran = micro.pos[micro.has_run]
    resid = shake_residual(sys_, ran)
    if ran.shape[0] == 0 or not resid < 1e-3:
        fail(f"charged staged slice: SHAKE residual {resid:.3e} on {ran.shape[0]} MD states")
    print(f"[22 charged staged slice] {sys_.n_atoms}-atom PEAA, staged prep ns_init 100 "
          f"(FIRE 100, NVT 100, 900 MTK NPT steps): setup {setup_s:.3f}s  prepared density "
          f"{rho:.2f} kg/m^3 (band {PEAA_RHO_NS100})  SHAKE residual max |r^2-d0^2|/d0^2 "
          f"prepared {resid0:.3e}, MD states {resid:.3e} over {ran.shape[0]} qps (tol 1e-3)  "
          f"s/macro-step {[round(x, 4) for x in step_s]}  md jobs {jobs}  launches in the setup "
          f"{ {k: v for k, v in setup.items() if v} }, in the steps "
          f"{ {k: v for k, v in launches.items() if v} }  peak memory {peak / 2**20:.1f} MiB  "
          f"max displacement {umax:.6g} m (expect {expect:.6g})")

    # K3's force entry on the prepared box: the staged NPT loop's one box
    pos1, h1 = st0.pos[:1], st0.h[:1]
    p1 = pos1.transpose(1, 2).contiguous()
    h6 = MF.h6_of(h1)
    r64 = r.to(dev, torch.float64)
    F, W = MF.md_forces_virial(r, p1, h6)
    Fp, Wp = MF.md_forces_virial_plain(r, p1, h6)
    F64, W64 = MF.md_forces_virial_plain(r64, p1.double(), h6.double())
    torch.cuda.synchronize()
    fmax, wmax = float(F64.abs().max()), float(W64.abs().max())
    ek = float((F.double() - F64).abs().max()) / fmax
    ep = float((Fp.double() - F64).abs().max()) / fmax
    wk = float((W.double() - W64).abs().max()) / wmax
    wp = float((Wp.double() - W64).abs().max()) / wmax
    if not torch.isfinite(F).all() or ek > 2 * ep + 1e-6 or wk > 2 * wp + 1e-6:
        fail(f"K3 forces B=1: kernel error vs float64 {ek:.3e} (virial {wk:.3e}) exceeds twice "
             f"the plain float32 error {ep:.3e} ({wp:.3e}) + 1e-6")
    f_err = float((F - Fp).abs().max())
    dev_ms = device_ms(lambda: MF.md_forces_virial(r, p1, h6), 50, K34_NAMES["path"])
    call_ms = cuda_ms(lambda: MF.md_forces_virial(r, p1, h6), reps=50, warmup=3)
    plain_ms = cuda_ms(lambda: MF.md_forces_virial_plain(r, p1, h6), reps=5)
    n, T = sys_.n_atoms, int(r.k34_tbl.shape[0])
    f_lj, f_q = pair_fractions(pos1, h1, r.spec.cutoff2, r.spec.coul_cutoff2, k3_excluded(r))
    tables = 2 * T * T + 3 * n + r.k34_win.numel()
    b_ms, b_by = bound(4.0 * (tables + r.pat.numel() + (6 * n + 12)),
                       pair_flops(n, 1, f_lj, f_q, virial=True))
    st1 = E.MDState(*(getattr(st0, f)[0] for f in ("pos", "vel", "h", "vxi")))
    E.run_npt(sys_, st1, 10, T_MD, T_MD, DT)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    E.run_npt(sys_, st1, 20, T_MD, T_MD, DT)
    torch.cuda.synchronize()
    npt_ms = (time.perf_counter() - t1) / 20 * 1e3
    print(f"[22 K3 forces B=1] the prepared box: max_abs_err vs plain {f_err:.3e}; rel error vs "
          f"float64 {ek:.3e} (virial {wk:.3e}), plain-f32 {ep:.3e} ({wp:.3e}) (tol 2x plain + "
          f"1e-6)  device {dev_ms:.4f} ms, per call {call_ms:.4f} ms, plain {plain_ms:.4f} ms, "
          f"bound {b_ms:.5f} ms ({b_by}; pairs inside LJ {f_lj:.3f}, Coulomb {f_q:.3f})  "
          f"launches in the staged setup {setup['md_charged_forces_virial']}  NPT loop "
          f"{npt_ms:.3f} ms per MTK step (20 steps, host clock)")

    # the unfused engine on the same box: use_fused=False.  Its step-0
    # forces and virial against K3's entry plus the remainder, in float64
    # (both systems built in float64 and run as plain arithmetic: only the
    # erfc polynomial against the exact erfc differs, 1e-5) and in float32
    # (the forces to 1e-5; each route's float32 virial against its float64
    # one: K3's is held above, the unfused route's autograd through the
    # energy to 5e-4, since the virial of an equilibrated box cancels to a
    # small part of its pair terms, so rounding its float32 parameters
    # alone moves it by ~1e-5)
    spec_u = dataclasses.replace(M.PEAA, use_fused=False)
    usys, _ = M.build_system(spec_u, dtype=torch.float32, device=dev)
    usys64, _ = M.build_system(spec_u, dtype=torch.float64, device=dev)
    k64 = M.build_system(M.PEAA, dtype=torch.float64, device=dev)[0].fused
    if usys.fused is not None or usys.constraints is None:
        fail("charged staged slice: use_fused=False built a fused or unconstrained system")

    def rel(a, b):
        return float((a.double() - b.double()).abs().max() / b.double().abs().max())

    Fk, Wk = E.forces_virial(sys_, pos1, h1)
    Fk64, Wk64 = MF.md_forces_virial_plain(k64, p1.double(), h6.double())
    Fr, Wr = k64.kspace(pos1.double(), h1.double(), want_virial=True)
    Fk64, Wk64 = Fk64.transpose(1, 2) + Fr, Wk64 + Wr
    Fu64, Wu64 = E.forces_virial(usys64, pos1.double(), h1.double())
    J = 4
    gen = torch.Generator().manual_seed(22)
    vel = torch.stack([E.maxwell_velocities(usys, T_MD, gen, torch.float32, dev)
                       for _ in range(J)])
    st4 = E.MDState(pos=pos1.expand(J, -1, -1).contiguous(), vel=vel,
                    h=h1.expand(J, 3, 3).contiguous(), vxi=torch.zeros((J, 3), device=dev))
    zero()
    t1 = time.perf_counter()
    Fu, Wu = E.forces_virial(usys, pos1, h1)
    out4, press = E.sample_stress(usys, st4, 20, T_MD, DT)
    torch.cuda.synchronize()
    u_s = time.perf_counter() - t1
    ulaunch = read()
    e64 = (rel(Fu64, Fk64), rel(Wu64, Wk64))
    ef32, ew32 = rel(Fu, Fk), rel(Wu, Wk)
    eu = (rel(Fu, Fu64), rel(Wu, Wu64))
    uresid = shake_residual(usys, out4.pos)
    if any(ulaunch.values()):
        fail(f"unfused PEAA: a kernel was launched: {ulaunch}")
    if not (e64[0] < 1e-5 and e64[1] < 1e-5 and ef32 < 1e-5 and eu[0] < 1e-5
            and eu[1] < 5e-4):
        fail(f"unfused PEAA: step-0 forces / virial relative to K3's entry plus the remainder "
             f"float64 {e64[0]:.3e} / {e64[1]:.3e} (tol 1e-5), float32 forces {ef32:.3e} (tol "
             f"1e-5); the float32 unfused route vs its float64 {eu[0]:.3e} / {eu[1]:.3e} (tol "
             "1e-5 / 5e-4)")
    if not torch.isfinite(press).all() or not uresid < 1e-3:
        fail(f"unfused PEAA: pressure finite {bool(torch.isfinite(press).all())}, SHAKE "
             f"residual {uresid:.3e} (tol 1e-3)")
    print(f"[22 unfused PEAA] use_fused=False: step-0 forces / virial relative to K3's entry + "
          f"the PME remainder: float64 {e64[0]:.3e} / {e64[1]:.3e} (the erfc polynomial; tol "
          f"1e-5), float32 {ef32:.3e} / {ew32:.3e} (forces tol 1e-5); the float32 unfused route "
          f"vs its float64 {eu[0]:.3e} / {eu[1]:.3e} (tol 1e-5 / 5e-4); {J} jobs x 20 sampling "
          f"steps of {DT} fs: launches {ulaunch}, SHAKE residual {uresid:.3e} (tol 1e-3); "
          f"{u_s:.3f}s with the force call")

    # the host SHAKE on the card against the CPU in float64
    noise = torch.randn(pos1.shape, generator=gen).to(dev) * 0.02
    new = pos1 + noise
    invm = 1.0 / sys_.masses
    got = CN.shake_positions(sys_.shake_set, pos1, new, h1, invm)
    ref = CN.shake_positions(sys_.constraints, pos1.double().cpu(), new.double().cpu(),
                             h1.double().cpu(), invm.double().cpu())
    s_err = float((got.double().cpu() - ref).abs().max())
    if not s_err < 1e-5:
        fail(f"shake_positions on the card vs the CPU in float64: {s_err:.3e} A (tol 1e-5)")
    print(f"[22 shake] shake_positions on the card (float32) vs the CPU (float64): "
          f"{s_err:.3e} A (tol 1e-5)  phase wall {time.perf_counter() - t_phase:.1f}s")


def _file_util():
    """tests/torch_file_util.py: the writers of LAMMPS data and restart files
    and of the compact-tension GMSH mesh (test inputs; not in the package)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_file_util

    return torch_file_util


def path_counters():
    """md_counters() and K5's (redesign and first design), by the kernels
    line's names."""
    from scema_tpu_torch.ops import md_fused as MF

    return {**md_counters(), "md_sw_run": (MF.md_run, "launches_k5"),
            "md_sw_forces": (MF.md_forces_virial, "launches_k5"),
            "md_sw_first_run": (MF._run_first, "launches_k5"),
            "md_sw_first_forces": (MF._forces_first, "launches_k5")}


def _drive(hmm, n_steps: int, what: str, on_step=None):
    """``n_steps`` macro-steps of ``hmm`` on the card: per-step host times,
    job and flagged counts, the reaction forces and the last carry; fails on
    a non-finite residual.  ``on_step(carry)`` sees each step's carry."""
    import torch

    state = hmm.init_state()
    step_s, jobs, flagged, rf = [], [], [], []
    for _ in range(n_steps):
        t1 = time.perf_counter()
        state, out = hmm.step(state)
        torch.cuda.synchronize()
        step_s.append(round(time.perf_counter() - t1, 4))
        jobs.append(int(out.n_jobs))
        flagged.append(int(out.n_flagged))
        rf.append(float(out.reaction_force))
        if not (torch.isfinite(out.residual0) and torch.isfinite(out.residual1)):
            fail(f"{what}: a macro-step gave non-finite residuals")
        if on_step is not None:
            on_step(state)
    return state, step_s, jobs, flagged, rf


def phase_data_file(dev):
    """Phase 23 (see the module docstring): MaterialSpec.data_file and the
    build-time route."""
    import torch

    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import data_io
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.ops import md_fused as MF

    fu = _file_util()
    counters = path_counters()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        data = data_io.build_alkane_melt(64, 8)
        plain, imp = os.path.join(tmp, "g0.data"), os.path.join(tmp, "g0_impropers.data")
        fu.write_data(plain, data)
        fu.write_data(imp, fu.with_impropers(data, 8))  # one per interior bead triple
        bsys, bst = M.build_system(M.MaterialSpec(name="g0", force_field="opls"),
                                   dtype=torch.float32, device=dev)
        fsys, fst = M.build_system(M.MaterialSpec(name="g0", force_field="opls",
                                                  data_file=plain),
                                   dtype=torch.float32, device=dev)
        isys, _ = M.build_system(M.MaterialSpec(name="g0", force_field="opls", data_file=imp),
                                 dtype=torch.float32, device=dev)
        gen = torch.Generator().manual_seed(23)
        pos = (bst.pos[None].cpu() + 0.05 * torch.randn((12,) + tuple(bst.pos.shape),
                                                        generator=gen)).to(dev)
        p, h6 = pos.transpose(1, 2).contiguous(), MF.h6_of(bst.h.expand(12, 3, 3))
        Fb, Wb = MF.md_forces_virial(bsys.fused, p, h6)
        Ff, Wf = MF.md_forces_virial(fsys.fused, p, h6)
        torch.cuda.synchronize()
        same = torch.equal(bst.pos, fst.pos) and torch.equal(Fb, Ff) and torch.equal(Wb, Wf)
        if fsys.route != "K1" or not same:
            fail(f"data file: the g0 file takes route {fsys.route!r} (K1 expected); state and "
                 f"K1 forces/virial bit for bit equal to the built-in g0: {same}")
        if isys.route != "unfused: impropers" or isys.fused is not None:
            fail(f"data file: the file with impropers takes route {isys.route!r}")
        print(f"[23 data file] g0 written and read back ({fsys.n_atoms} sites): route "
              f"{fsys.route}, K1 forces + virial on 12 perturbed boxes equal the built-in g0's "
              f"bit for bit; with {len(isys.ff.impropers)} impropers: route {isys.route}")

        cfg = HMMConfig()
        cfg = cfg.replace(dtype="float32", md_dtype="float32",
                          resources=dataclasses.replace(cfg.resources, max_md_jobs=64))
        spec = M.MaterialSpec(name="g0", force_field="opls", data_file=imp)
        n_steps = 2
        gc.collect()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            hmm = build_md_hmm(cfg, spec=spec, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        state, step_s, jobs, flagged, rf = _drive(hmm, n_steps, "data file")
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    printed = buf.getvalue().strip()
    umax = float(state[0].u.abs().max())
    expect = n_steps * 0.002 * 0.08
    sig = state[0].qp.new_stress
    if "route unfused: impropers" not in printed:
        fail(f"data file: build_md_hmm did not print the route: {printed!r}")
    if abs(umax - expect) > 1e-5 * expect or not torch.isfinite(sig).all() or min(jobs) <= 0:
        fail(f"data file: max displacement {umax} (expect {expect}), stresses finite "
             f"{bool(torch.isfinite(sig).all())}, md jobs {jobs}")
    fused = {k: v for k, v in launches.items() if k != "pairwise_l2" and v}
    if fused or launches["pairwise_l2"] <= 0:
        fail(f"data file: the unfused route launched fused kernels {fused} (or K2 did not run)")
    print(f"[23 data file steps] {printed}; HMMConfig() dogbone, <= 64 MD jobs on the unfused "
          f"engine: setup {setup_s:.3f}s  s/macro-step {step_s}  md jobs {jobs}  flagged "
          f"{flagged}  max displacement {umax:.6g} m (expect {expect:.6g})  launches "
          f"{ {k: v for k, v in launches.items() if v} }  phase wall "
          f"{time.perf_counter() - t_phase:.1f}s")
    return launches


# phase 24's drop-weight plate: 6 x 6 x 2 cells (576 qps, the dogbone's
# count), a 0.04 m weight accelerated at 1e8 m/s^2 for 3 steps (about
# 0.25%, 0.5% and 0.75% strain under the weight in steps 1-3 at the default
# dt); and its compact-tension specimen: W = 2 calculi_B = 0.02 m, a pin
# displacement of 0.002 W per step (the dogbone's strain scale)
DROPWEIGHT = {"problem type": {"class": "dropweight", "diameter": 0.04, "acceleration": 1.0e8,
                               "steps to accelerate": 3},
              "continuum mesh": {"input": {"style": "cuboid", "x length": 0.08,
                                           "y length": 0.08, "z length": 0.02, "x cells": 6,
                                           "y cells": 6, "z cells": 2}}}
CT_B = 0.01


def _problem_run(dev, d: dict, n_steps: int, what: str, tag: str):
    """``build_md_hmm`` of config ``d`` (g0 on K1, quick prep, float32) and
    ``n_steps`` macro-steps, counters zeroed before the build and read after
    the steps; the checks of phase 24."""
    import torch

    from scema_tpu_torch.config import config_from_dict
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm

    counters = path_counters()
    cfg = config_from_dict(d, dtype="float32")
    gc.collect()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        hmm = build_md_hmm(cfg, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    state, step_s, jobs, flagged, rf = _drive(hmm, n_steps, what)
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    sig = state[0].qp.new_stress
    smax = float(sig.abs().max())
    if hmm.backend.sys.route != "K1" or min(flagged) <= 0 or min(jobs) <= 0:
        fail(f"{what}: route {hmm.backend.sys.route}, flagged qps {flagged}, md jobs {jobs}")
    if not (torch.isfinite(sig).all() and smax < 1e10 and all(abs(r) < float("inf") for r in rf)
            and rf[-1] != 0.0):
        fail(f"{what}: stresses finite {bool(torch.isfinite(sig).all())}, max |sigma| {smax:.3e} "
             f"Pa (< 1e10), reaction forces {rf} (finite, nonzero)")
    if launches["md_k1_run"] <= 0 or launches["pairwise_l2"] <= 0:
        fail(f"{what}: K1's run or K2 was not launched: {launches}")
    first_designs_idle(launches, what)
    print(f"[{tag}] {hmm.geom.n_qp_total} qps, g0 on {hmm.backend.sys.route}, quick prep: setup "
          f"{setup_s:.3f}s  s/macro-step {step_s}  flagged {flagged}  md jobs {jobs}  max "
          f"|sigma| {smax:.4e} Pa  reaction {[f'{r:.4e}' for r in rf]}  max |u| "
          f"{float(state[0].u.abs().max()):.4e} m  launches "
          f"{ {k: v for k, v in launches.items() if v} }")
    return launches


def phase_problems(dev):
    """Phase 24 (see the module docstring): the drop-weight and
    compact-tension problems on K1, and the FE solvers on the card."""
    import numpy as np
    import torch

    from scema_tpu_torch.fem import assembly, mesh, shapes, solver

    t_phase = time.perf_counter()
    drop = _problem_run(dev, DROPWEIGHT, 3, "drop-weight", "24 dropweight")
    fu = _file_util()
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        msh = os.path.join(tmp, "ct.msh")
        n_cells = fu.write_ct_msh(msh, CT_B)
        ct = _problem_run(dev, {"problem type": {"class": "compact tension",
                                                 "velocity": 0.002 * 2.0 * CT_B},
                                "continuum mesh": {"input": {"style": "file3D", "filename": msh,
                                                             "calculi_B": CT_B}},
                                "computational resources": {"maximum md jobs": 128}},
                          2, "compact tension", f"24 compact tension ({n_cells} hexes)")

    # the consistent mass of the dogbone's mesh, float64 on the card
    m = mesh.build_cuboid(0.03, 0.03, 0.08, 3, 3, 8)
    g = shapes.precompute_geometry(m.nodes, m.cells, 2, dtype=torch.float64, device=dev)
    rho = torch.full((g.n_qp_total,), 1000.0, dtype=torch.float64, device=dev)
    cm = solver.consistent_cell_mass(g, rho)
    diag = assembly.lumped_mass_diag(g, rho)
    n = g.n_nodes * 3
    rng = np.random.default_rng(24)
    con = torch.as_tensor(rng.random(n) < 0.1, device=dev)
    x_true = torch.where(con, 0.0, torch.as_tensor(rng.standard_normal(n), device=dev))
    calls = [0]

    def mv(v):
        calls[0] += 1
        return solver.consistent_mass_matvec(g, cm, v)

    b = torch.where(con, 0.0, mv(x_true))
    rows = []
    for name, solve in (("cg", lambda: solver.cg_solve(mv, b, diag, con, tol=1e-12, maxiter=500)),
                        ("gmres", lambda: solver.gmres_solve(mv, b, diag, con, tol=1e-12,
                                                             maxiter=500)),
                        ("bicgstab", lambda: solver.bicgstab_solve(mv, b, diag, con, tol=1e-12,
                                                                   maxiter=500)),
                        ("direct", lambda: solver.direct_solve(mv, n, b, con))):
        solve()  # warm
        calls[0] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        x = solve()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        err = float(torch.linalg.vector_norm(x - x_true) / torch.linalg.vector_norm(x_true))
        if not err < 1e-7 or x.device.type != "cuda":
            fail(f"solver {name}: relative error {err:.3e} against x_true (tol 1e-7)")
        rows.append(f"{name} {err:.2e} ({calls[0]} matvecs, {ms:.2f} ms)")
    print(f"[24 solvers] consistent mass of the 3x3x8 dogbone ({n} dofs, float64, "
          f"{int(con.sum())} constrained) on the card: {'; '.join(rows)} (tol 1e-7)  phase wall "
          f"{time.perf_counter() - t_phase:.1f}s")
    return {k: drop[k] + ct[k] for k in drop}


def phase_restart_seed(dev):
    """Phase 25 (see the module docstring): an SW dogbone seeded from a
    LAMMPS binary restart, on K5."""
    import numpy as np
    import torch

    from scema_tpu_torch.config import config_from_dict
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import lattice

    fu = _file_util()
    counters = path_counters()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(25)
    pos, h = lattice.diamond(5.431, 2, 3, 4)  # 192 atoms (streched_polyhedron's shape)
    L = np.diag(h)
    boxlo = np.array([-2.0, 1.0, 0.5])
    pos = pos + boxlo + rng.normal(scale=0.03, size=pos.shape)
    image = np.floor((pos - boxlo) / L).astype(np.int64)
    image[::5] += 1
    vel = rng.normal(scale=0.003, size=pos.shape)
    n_steps = 2
    with tempfile.TemporaryDirectory(dir=HERE) as nano:
        fu.write_restart(os.path.join(nano, "init.g0_1.bin"), pos - image * L, vel, boxlo,
                         boxlo + L, image=image, timestep=50000, order=rng.permutation(len(pos)))
        cfg = config_from_dict({"molecular dynamics parameters": {"force field": "sw"},
                                "directory structure": {"nanoscale input": nano}},
                               dtype="float32")
        gc.collect()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        t0 = time.perf_counter()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            hmm = build_md_hmm(cfg, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    sys_ = hmm.backend.sys
    st0 = hmm.backend.initial_md_state
    ref = {"pos": pos - boxlo, "vel": vel, "h": h}
    errs = {f: float((getattr(st0, f)[0].double().cpu() - torch.as_tensor(r)).abs().max()
                     / max(float(np.abs(r).max()), 1e-30)) for f, r in ref.items()}
    if sys_.n_atoms != 192 or sys_.route != "K5":
        fail(f"restart seed: {sys_.n_atoms} atoms on {sys_.route} (192 on K5 expected)")
    if max(errs.values()) > 1e-6 or st0.vxi.any():
        fail(f"restart seed: replica 1 is not the restart's state: relative errors {errs} "
             "(tol 1e-6), thermostat at rest {not bool(st0.vxi.any())}")
    state, step_s, jobs, flagged, rf = _drive(hmm, n_steps, "restart seed")
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    umax = float(state[0].u.abs().max())
    expect = n_steps * 0.002 * 0.08
    if abs(umax - expect) > 1e-5 * expect or min(jobs) <= 0:
        fail(f"restart seed: max displacement {umax} (expect {expect}), md jobs {jobs}")
    for k in ("md_sw_run", "md_sw_forces", "pairwise_l2"):
        if launches[k] <= 0:
            fail(f"restart seed: kernel {k} was not launched")
    others = {k: v for k, v in launches.items() if not k.startswith(("md_sw", "pairwise")) and v}
    if others:
        fail(f"restart seed: kernels of other paths were launched: {others}")
    first_designs_idle(launches, "restart seed")
    print(f"[25 restart seed] {buf.getvalue().strip()}; a 2x3x4-cell diamond restart (192 atoms, "
          f"box origin {boxlo.tolist()}): replica 1 = the restart's pos - boxlo / vel / h, "
          f"relative {errs['pos']:.2e} / {errs['vel']:.2e} / {errs['h']:.2e} (float32, tol "
          f"1e-6), not prepared; setup (measure only) {setup_s:.3f}s  s/macro-step {step_s}  "
          f"md jobs {jobs}  max displacement {umax:.6g} m (expect {expect:.6g})  launches "
          f"{ {k: v for k, v in launches.items() if v} }  phase wall "
          f"{time.perf_counter() - t_phase:.1f}s")
    return launches


# phase 26's data file: the g0 melt with its beads spread over this many
# atom types, where K1's (T, T) table leaves room for 296 atoms
SMEM_TYPES = 160


def phase_smem_route(dev):
    """Phase 26 (see the module docstring): the route knows K1's
    shared-memory cap."""
    import torch

    from scema_tpu_torch.md import data_io
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M
    from scema_tpu_torch.ops import md_fused as MF

    fu = _file_util()
    counters = path_counters()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        path = os.path.join(tmp, "g0_types.data")
        fu.write_data(path, fu.with_types(data_io.build_alkane_melt(64, 8), SMEM_TYPES))
        sys_, st = M.build_system(M.MaterialSpec(name="g0t", force_field="opls", data_file=path),
                                  dtype=torch.float32, device=dev)
    try:
        MF.check_smem(MF._kernel_spec(sys_.n_atoms), SMEM_TYPES)
        launch = "fits"
    except ValueError as e:
        launch = str(e)
    if (not sys_.route.startswith(f"unfused: K1: {sys_.n_atoms} atoms of {SMEM_TYPES} atom types")
            or sys_.fused is not None or launch == "fits"):
        fail(f"smem route: {sys_.n_atoms} atoms of {SMEM_TYPES} types take route {sys_.route!r}; "
             f"K1's launch check: {launch}")
    gc.collect()
    for fn, attr in counters.values():
        setattr(fn, attr, 0)
    t0 = time.perf_counter()
    st = E.minimize_fire(sys_, st, n_steps=20, dt0=0.5)
    J = 4
    stJ = E.MDState(*(getattr(st, f).expand((J,) + tuple(getattr(st, f).shape)).contiguous()
                      for f in ("pos", "vel", "h", "vxi")))
    eps = torch.tensor([[1e-3, 0, 0, 0, 0, 0], [0, -1e-3, 0, 0, 0, 0], [0, 0, 0, 5e-4, 0, 0],
                        [0, 0, 0, 0, 0, 0]], dtype=torch.float32, device=dev)
    out = E.run_strain(sys_, stJ, eps, 20, T_MD, DT)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
    moved = float((out.pos - stJ.pos).abs().max())
    if not (torch.isfinite(out.pos).all() and torch.isfinite(out.vel).all() and moved > 0.0):
        fail(f"smem route: the unfused run gave non-finite or unmoved states ({moved})")
    if any(launches.values()):
        fail(f"smem route: the unfused engine launched fused kernels: {launches}")
    print(f"[26 smem route] the g0 melt over {SMEM_TYPES} atom types ({sys_.n_atoms} sites, "
          f"written as a data file): route {sys_.route}; K1's launch would refuse it: {launch}; "
          f"FIRE 20 + {J} jobs x 20 strain steps on the unfused engine {run_s:.2f}s, max "
          f"displacement {moved:.4f} A, no kernel launched; phase wall "
          f"{time.perf_counter() - t_phase:.1f}s")


# phase 27's surrogate: the reference's Keras stack widths (18 -> 18 -> 36
# -> 72 -> 72 -> 36 -> 18 -> 6) and its scaler's ranges (strains ~0.1,
# stresses ~4e8 Pa)
SURROGATE_WIDTHS = (18, 18, 36, 72, 72, 36, 18, 6)


def phase_surrogate(dev):
    """Phase 27 (see the module docstring): stress method 2 on the card."""
    import numpy as np
    import torch

    from scema_tpu_torch import cli
    from scema_tpu_torch.bridging import surrogate as S
    from scema_tpu_torch.config import HMMConfig
    from scema_tpu_torch.hmm.problem import build_hooke_hmm
    from scema_tpu_torch.utils import tensors as T

    counters = path_counters()
    t_phase = time.perf_counter()
    rng = np.random.default_rng(27)
    w = SURROGATE_WIDTHS
    kernels = [rng.standard_normal((a, b)) / np.sqrt(a) for a, b in zip(w, w[1:])]
    biases = [0.1 * rng.standard_normal(b) for b in w[1:]]
    span = np.r_[np.full(12, 0.1), np.full(6, 4e8)]
    # the Keras layers and the MinMaxScaler (scale 1/span, min 0.5) as a
    # flax-layout dict, carried into the port's surrogate and saved as its
    # npz (the card has no h5py, so the Keras loader runs in the CPU tests)
    params = {f"Dense_{i}": {"kernel": k, "bias": b}
              for i, (k, b) in enumerate(zip(kernels, biases))}
    cpu64 = S.surrogate_from_flax(params, -0.5 * span, span, np.zeros(6), np.ones(6))
    n_steps = 3
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        model_p, cfg_path = os.path.join(tmp, "surrogate.npz"), os.path.join(tmp, "cfg.json")
        S.save_surrogate(model_p, cpu64)
        with open(cfg_path, "w") as f:
            f.write("{}")
        gc.collect()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(["run", cfg_path, "--surrogate", model_p, "--steps", str(n_steps)])
        cli_s = time.perf_counter() - t0
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        card = S.load_surrogate(model_p, dtype=torch.float32, device=dev)
    printed = buf.getvalue()
    expect = n_steps * 0.002 * 0.08
    res = [float(v) for pair in re.findall(r"residual (\S+) -> (\S+)", printed) for v in pair]
    if (rc != 0 or f"Max displacement: {expect:.6g} m" not in printed or len(res) != 2 * n_steps
            or not all(np.isfinite(res)) or "overriding 'stress computation method' 0 -> 2"
            not in printed):
        fail(f"surrogate: cli run --surrogate gave rc {rc}: {printed[-2000:]!r}")
    if launches["pairwise_l2"] <= 0 or any(v for k, v in launches.items() if k != "pairwise_l2"):
        fail(f"surrogate: launches {launches} (K2 alone expected)")
    # the forward pass on the card against float64 on the CPU
    x = [torch.as_tensor(rng.normal(0, s, (576, 6))) for s in (3e-2, 3e-2, 1e8)]
    xd = [a.to(dev, torch.float32) for a in x]
    y64 = cpu64(*x)
    y = card(*xd)
    torch.cuda.synchronize()
    fwd = float((y.double().cpu() - y64).abs().max() / y64.abs().max())
    fwd_ms = cuda_ms(lambda: card(*xd), 20)
    if not fwd < 1e-5:
        fail(f"surrogate: the card's forward pass is {fwd:.3e} from float64 (tol 1e-5)")
    # the same dogbone through the Python entry, its stress field
    cfg = HMMConfig()
    cfg = cfg.replace(dtype="float32", bridging=dataclasses.replace(cfg.bridging,
                                                                    stress_method=2))
    hmm = build_hooke_hmm(cfg, device=dev, surrogate_fn=card.as_update_fn())
    state, step_s, _, _, _ = _drive(hmm, n_steps, "surrogate")
    sig = state.qp.new_stress
    if not (torch.isfinite(sig).all() and float(sig.abs().max()) > 0.0):
        fail("surrogate: the method-2 stress field is not finite and nonzero")
    # training on 4096 synthetic linear transitions on the card
    C = T.isotropic_c66(3.0e9, 0.35, dtype=torch.float32, device=dev)
    gen = torch.Generator().manual_seed(27)
    eps_old = 1e-3 * torch.randn((4096, 6), generator=gen).to(dev)
    eps_new = eps_old + 1e-4 * torch.randn((4096, 6), generator=gen).to(dev)
    data = (eps_new, eps_old, T.sym_contract_c66(C, eps_old), T.sym_contract_c66(C, eps_new))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model, loss = S.train_surrogate(torch.Generator().manual_seed(28), *data, epochs=60,
                                    lr=3e-3)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    pred = model(*data[:3])
    fit = float(torch.linalg.norm(pred - data[3]) / torch.linalg.norm(data[3]))
    if not fit < 0.1:
        fail(f"surrogate: training on the card fits the linear map to {fit:.3e} (tol 0.1)")
    print(f"[27 surrogate] cli run {{}} --surrogate surrogate.npz --steps {n_steps} (a "
          f"reference-shaped stack {'-'.join(map(str, w))} with a MinMaxScaler's "
          f"standardizer, saved by save_surrogate): rc {rc}, "
          f"{cli_s:.2f}s with setup, residuals {res}, launches "
          f"{ {k: v for k, v in launches.items() if v} }; forward at 576 qps vs float64 "
          f"{fwd:.3e} (tol 1e-5), {fwd_ms:.4f} ms per call; build_hooke_hmm(stress_method 2) "
          f"s/macro-step {step_s}, max |sigma| {float(sig.abs().max()):.4e} Pa; train_surrogate "
          f"4096 transitions x 60 epochs (480 Adam steps) {train_s:.2f}s, loss {loss:.3e}, "
          f"fit {fit:.3e}; phase wall {time.perf_counter() - t_phase:.1f}s")
    return launches


# phase 28's ReaxFF slice: the JAX package's bench_hmm_reax (bench.py:260-295)
# on the HMMConfig() dogbone, with bench_md_reax's MD timestep (0.25 fs; the
# config's 2 fs suits united-atom OPLS, not ReaxFF) at 300 K
REAX_MAX_JOBS, REAX_DT = 32, 0.25
# float32 on the card against float64 on the CPU, relative to the largest
# component: the force + virial call on the prepared box (the QEq CG floors
# near 1e-6 relative in float32), and each job's charge sum (e)
REAX_FV_TOL, REAX_Q_TOL = 1e-4, 1e-5


def phase_reax_slice(dev):
    """Phase 28 (see the module docstring): the ReaxFF slice on the card."""
    import torch

    from scema_tpu_torch.config import load_config, md_spec_kwargs
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M

    fu = _file_util()
    counters = _all_counters()
    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=HERE) as tmp:
        scripts = os.path.join(tmp, "lammps_scripts_reax")
        os.makedirs(scripts)
        fu.write_ffield(os.path.join(scripts, "ffield.reax.synthetic"))
        cfg_path = os.path.join(tmp, "cfg.json")
        with open(cfg_path, "w") as f:
            json.dump({"molecular dynamics parameters": {
                "temperature": T_MD, "timestep length": REAX_DT, "scripts directory": scripts},
                "computational resources": {"maximum md jobs": REAX_MAX_JOBS}}, f)
        cfg = load_config(cfg_path, dtype="float32")
        kw = md_spec_kwargs(cfg)
        if cfg.md.force_field != "reax" or not kw["reax_ffield"].endswith("synthetic"):
            fail(f"reax slice: the config resolved to {cfg.md.force_field!r} / {kw}")
        spec = M.MaterialSpec(**{**M.REAXPE.__dict__, **kw})
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        gc.collect()
        for fn, attr in counters.values():
            setattr(fn, attr, 0)
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            hmm = build_md_hmm(cfg, spec=spec, equil_steps=20, minimize_steps=60, device=dev)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        umax = []
        state, step_s, jobs, flagged, _ = _drive(
            hmm, 2, "reax slice", on_step=lambda c: umax.append(float(c[0].u.abs().max())))
        launches = {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}
        peak = torch.cuda.max_memory_allocated(dev)
        sys64, _ = M.build_system(spec, dtype=torch.float64, device="cpu")
    sys_ = hmm.backend.sys
    printed = buf.getvalue().strip()
    fe, micro = state[0], state[1][0]
    expect = 0.002 * 0.08
    sig = fe.qp.new_stress
    ens = hmm.backend.ensemble
    C = ens.init_stiff[0, 0].double().cpu()
    c_eig = torch.linalg.eigvalsh(0.5 * (C + C.T))
    if not printed.endswith("route unfused: reax") or sys_.route != "unfused: reax":
        fail(f"reax slice: build_md_hmm printed {printed!r}")
    # the milestone after the first step; after the second the explicit FE
    # step grows on the tangent stiffness the probe measures on this
    # synthetic field (printed), so only finiteness is checked there
    if (abs(umax[0] - expect) > 1e-5 * expect or not torch.isfinite(fe.u).all()
            or not torch.isfinite(sig).all()):
        fail(f"reax slice: max displacement after step 1 {umax[0]} (expect {expect}), finite "
             f"u {bool(torch.isfinite(fe.u).all())}, finite stresses "
             f"{bool(torch.isfinite(sig).all())}")
    if min(jobs) <= 0 or max(jobs) > REAX_MAX_JOBS:
        fail(f"reax slice: md jobs {jobs} (1 to {REAX_MAX_JOBS} a step)")
    if launches["pairwise_l2"] <= 0 or any(v for k, v in launches.items() if k != "pairwise_l2"):
        fail(f"reax slice: launches {launches} (K2 alone expected)")
    # one force + virial call of the prepared box: the card (float32)
    # against the CPU (float64) on the same state
    st0 = hmm.backend.initial_md_state
    pos, h = st0.pos[0], st0.h[0]
    F, W = E.forces_virial(sys_, pos, h)
    F64, W64 = E.forces_virial(sys64, pos.double().cpu(), h.double().cpu())
    torch.cuda.synchronize()
    f_err = float((F.double().cpu() - F64).abs().max() / F64.abs().max())
    w_err = float((W.double().cpu() - W64).abs().max() / W64.abs().max())
    t_fv = cuda_ms(lambda: E.forces_virial(sys_, pos, h), 10)
    # each job's QEq charges on the MD states after the steps
    ran = micro.has_run
    n = sys_.n_atoms
    pj, hj = micro.pos[ran].reshape(-1, n, 3), micro.h[ran].reshape(-1, 3, 3)
    with torch.no_grad():
        q = sys_.ff.energy_terms(pj, hj, sys_.build_neighbors(pj, hj))["q"]
    q_sum = float(q.double().sum(-1).abs().max())
    if not (f_err < REAX_FV_TOL and w_err < REAX_FV_TOL and q_sum < REAX_Q_TOL
            and float(q.abs().max()) > 1e-3):
        fail(f"reax slice: card vs float64 forces {f_err:.3e}, virial {w_err:.3e} (tol "
             f"{REAX_FV_TOL}); per-job charge sums {q_sum:.3e} (tol {REAX_Q_TOL}), max |q| "
             f"{float(q.abs().max()):.3e}")
    print(f"[28 reax slice] {printed}; config {os.path.basename(scripts)} -> force field "
          f"{cfg.md.force_field}, REAXPE {n} atoms (list width {sys_.nspec.k_max}), HMMConfig() "
          f"dogbone, <= {REAX_MAX_JOBS} MD jobs, {T_MD} K, {REAX_DT} fs, FIRE 60 + NVT 20: "
          f"setup {setup_s:.3f}s  s/macro-step {step_s}  md jobs {jobs}  flagged {flagged}  "
          f"peak memory {peak / 2**20:.1f} MiB  max displacement per step {umax} m (expect "
          f"{expect:.6g} after step 1)  max |sigma| {float(sig.abs().max()):.4e} Pa  launches "
          f"{launches}  phase wall {time.perf_counter() - t_phase:.1f}s")
    print(f"[28 reax material] the probe's stiffness (replica 1) eigenvalues "
          f"{[f'{x:.4e}' for x in c_eig.tolist()]} Pa, density {float(ens.rho[0, 0]):.2f} "
          f"kg/m^3, residual stress {[f'{x:.4e}' for x in ens.init_stress[0, 0].tolist()]} Pa; "
          f"prepared temperature {float(E.temperature(sys_, st0.vel[0])):.1f} K")
    print(f"[28 reax checks] force + virial of the prepared box, card float32 vs CPU float64: "
          f"forces {f_err:.3e}, virial {w_err:.3e} (tol {REAX_FV_TOL}), {t_fv:.3f} ms per call; "
          f"charges of {pj.shape[0]} MD states after the steps: max |sum q| {q_sum:.3e} e "
          f"(tol {REAX_Q_TOL}), max |q| {float(q.abs().max()):.4f} e")
    return launches


# Phase 29: the multi-rank paths.  Each runs (a) in this process as world 1
# on NCCL and (b) in two spawned processes as world 2 on gloo, both ranks
# on cuda:0 (NCCL refuses two ranks on one card).  Depth: 3 Hooke and FE
# steps; 4 SW macro-steps, so that the last runs up to all 576 qps' jobs
# (half on each world-2 rank); 20 + 10 spatial MD steps.
MR_FE_STEPS, MR_MD_STEPS = 3, 4
MR_SPATIAL_CELLS, MR_SPATIAL_JOBS, MR_STRAIN, MR_SAMPLE = 8, 4, 20, 10
# tolerances at world 2 (relative to the largest entry of the unsharded run)
MR_TOL = {"hooke": 1e-6, "fe": 1e-5, "md": 1e-6, "spatial_fv": 1e-5}
# the world-2 spatial pressures' distance from the float64 run, at most
# MR_PRESS_X times the unsharded float32 route's (both read 8.2e-6 on an
# H100 80GB HBM3 at 700 W), floored for a float32 route that lands on it
MR_PRESS_X, MR_PRESS_FLOOR = 2.0, 1e-6


def _mr_collectives(dev, world, rank):
    """Each collective the port's helper hands a CUDA tensor under gloo,
    called directly on a small float32 CUDA tensor: {name: right}."""
    import torch
    import torch.distributed as dist

    x = torch.arange(4, dtype=torch.float32, device=dev) + rank
    ok = {}
    y = x.clone()
    dist.all_reduce(y)
    ok["all_reduce"] = y.tolist() == [2.0 * i + 1.0 for i in range(4)]
    y = x.clone()
    dist.broadcast(y, 0)
    ok["broadcast"] = y.tolist() == [0.0, 1.0, 2.0, 3.0]
    y = torch.empty(4 * world, dtype=x.dtype, device=dev)
    dist.all_gather_into_tensor(y, x)
    ok["all_gather_into_tensor"] = y.tolist() == [0.0, 1.0, 2.0, 3.0, 1.0, 2.0, 3.0, 4.0]
    y = torch.empty(4 // world, dtype=x.dtype, device=dev)
    dist.reduce_scatter_tensor(y, x)
    ok["reduce_scatter_tensor"] = y.tolist() == [[1.0, 3.0], [5.0, 7.0]][rank]
    torch.cuda.synchronize()
    return ok


def _mr_cfg(sw: bool):
    from scema_tpu_torch.config import HMMConfig

    cfg = HMMConfig().replace(dtype="float32", md_dtype="float32")
    if sw:
        cfg = cfg.replace(md=dataclasses.replace(cfg.md, force_field="sw"))
    return cfg


def _mr_counts():
    counters = _all_counters()
    return {k: getattr(fn, attr) for k, (fn, attr) in counters.items()}


def _mr_zero():
    for fn, attr in _all_counters().values():
        setattr(fn, attr, 0)


def _mr_steps(step, state, n):
    import torch

    times, jobs = [], []
    for _ in range(n):
        t0 = time.perf_counter()
        state, out = step(state)
        torch.cuda.synchronize()
        times.append(round(time.perf_counter() - t0, 4))
        jobs.append(int(out.n_jobs))
        if not (torch.isfinite(out.residual0) and torch.isfinite(out.residual1)):
            fail("[29 multi-rank] a macro-step gave non-finite residuals")
    return state, times, jobs


def _mr_np(x):
    return x.detach().double().cpu().numpy()


def _mr_paths(dev, mesh, spatial_k, inputs, prepared=None):
    """The four multi-rank paths on this rank (``mesh`` None: unsharded,
    spatial_shards 0), each with the launch counters zeroed just before and
    read just after: results as numpy, times and launches."""
    import torch

    from scema_tpu_torch.fem import sharded as SH
    from scema_tpu_torch.hmm.md_coupling import build_md_hmm
    from scema_tpu_torch.hmm.problem import build_hooke_hmm
    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M

    out = {"hooke": _mr_hooke(dev, mesh)}
    # the node- and qp-sharded FE state
    _mr_zero()
    t0 = time.perf_counter()
    hmm = build_hooke_hmm(_mr_cfg(False), device=dev)
    if mesh is None:
        step, s = hmm.step, hmm.init_state()
        own = full = None
    else:
        step = SH.make_sharded_step(hmm, mesh)
        full = SH.fe_state_bytes(hmm.init_state())
        s = SH.shard_fe_state(hmm.init_state(), mesh)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    s, times, jobs = _mr_steps(step, s, MR_FE_STEPS)
    if mesh is not None:
        own = SH.fe_state_bytes(s)
        s = SH.gather_fe_state(s, mesh, hmm)
    out["fe"] = dict(stress=_mr_np(s.qp.new_stress), u=_mr_np(s.u), times=times, jobs=jobs,
                     setup=setup, own_bytes=own, full_bytes=full, launches=_mr_counts())
    # the job-sharded SW coupled step on K5 (rank 0 prepares and broadcasts
    # where no prepared replica is given)
    _mr_zero()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        hmm = build_md_hmm(_mr_cfg(True), device=dev, device_mesh=mesh, prepared=prepared)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    carry, times, jobs = _mr_steps(hmm.step, hmm.init_state(), MR_MD_STEPS)
    be = hmm.backend
    out["md"] = dict(stress=_mr_np(carry[0].qp.new_stress), umax=float(carry[0].u.abs().max()),
                     times=times, jobs=jobs, setup=setup, kernel=be.sys.route,
                     launches=_mr_counts(),
                     init={f: _mr_np(getattr(be.initial_md_state, f))
                           for f in ("pos", "vel", "h", "vxi")},
                     rows=[dict(length=_mr_np(be.ensemble.init_length[0, r]),
                                stress=_mr_np(be.ensemble.init_stress[0, r]),
                                stiff=_mr_np(be.ensemble.init_stiff[0, r]),
                                density=float(be.ensemble.rho[0, r]))
                           for r in range(be.n_repl)])
    # one 4096-atom SW box's force calls over x-slabs (the list route)
    _mr_zero()
    out["spatial"] = _mr_spatial(dev, spatial_k, inputs, torch.float32)
    out["spatial"]["launches"] = _mr_counts()
    return out


def _mr_hooke(dev, mesh):
    """The Hooke dogbone with the qp update over the ranks' blocks
    (shard_md_update), launch counters zeroed just before and read just
    after."""
    from scema_tpu_torch.hmm.problem import build_hooke_hmm

    _mr_zero()
    t0 = time.perf_counter()
    hmm = build_hooke_hmm(_mr_cfg(False), device=dev, device_mesh=mesh)
    setup = time.perf_counter() - t0
    s, times, jobs = _mr_steps(hmm.step, hmm.init_state(), MR_FE_STEPS)
    return dict(stress=_mr_np(s.qp.new_stress), times=times, jobs=jobs, setup=setup,
                launches=_mr_counts())


def _mr_spatial(dev, spatial_k, inputs, dtype):
    """The 4096-atom box's first force + virial call, then a 20-step strain
    run and a 10-step sampling run of its 4 jobs, with ``spatial_k`` slabs
    (0: the unsharded list route)."""
    import torch

    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M

    def t(x):
        return torch.as_tensor(x, dtype=dtype, device=dev)

    spec = M.MaterialSpec(name="si", n_cells=MR_SPATIAL_CELLS, spatial_shards=spatial_k)
    t0 = time.perf_counter()
    sys_, _ = M.build_system(spec, dtype=dtype, device=dev)
    setup = time.perf_counter() - t0
    pos, h = t(inputs["pos"]), t(inputs["h"])
    t0 = time.perf_counter()
    F, W = E.forces_virial(sys_, pos, h)
    torch.cuda.synchronize()
    fv_s = time.perf_counter() - t0
    st = E.MDState(pos=pos, vel=t(inputs["vel"]), h=h,
                   vxi=torch.zeros((MR_SPATIAL_JOBS, 3), dtype=dtype, device=dev))
    t0 = time.perf_counter()
    st = E.run_strain(sys_, st, t(inputs["eps"]), MR_STRAIN, T_MD, 1.0)
    st, press = E.sample_stress(sys_, st, MR_SAMPLE, T_MD, 1.0)
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    if not (torch.isfinite(st.pos).all() and torch.isfinite(press).all()):
        fail(f"[29 spatial] non-finite state or pressure ({sys_.route})")
    return dict(F=_mr_np(F), W=_mr_np(W), press=_mr_np(press), pos=_mr_np(st.pos),
                route=sys_.route, setup=setup, fv_s=fv_s,
                step_s=run_s / (MR_STRAIN + MR_SAMPLE))


def _mr_prepared(md, dev):
    """A rank's prepared SW replica as build_md_hmm's ``prepared``."""
    import torch

    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M

    st = E.MDState(*(torch.as_tensor(md["init"][f], dtype=torch.float32, device=dev)
                     for f in ("pos", "vel", "h", "vxi")))
    return [(st, [M.InitData(**r) for r in md["rows"]])]


def _mr_check(w1, w2, ref, ref64):
    """Phase 29's rules: world 1 bit for bit the unsharded run, world 2
    within MR_TOL, both world-2 ranks holding the same results, rank 0's
    Hooke stresses within MR_TOL with deterministic algorithms off too,
    the spatial pressures within MR_PRESS_X times the float32 route's
    distance from float64 (at least MR_PRESS_FLOOR), job counts equal,
    each rank's kernels launched."""
    import numpy as np

    keys = {"hooke": ("stress",), "fe": ("stress", "u"), "md": ("stress",),
            "spatial": ("F", "W", "press", "pos")}
    for name, fields in keys.items():
        for f in fields:
            a, r = w1[name][f], ref[name][f]
            if not np.array_equal(a, r):
                fail(f"[29 {name}] world 1 (NCCL) {f} differs from the unsharded run: "
                     f"{_mr_err(a, r):.3e} relative (expected bit for bit)")
            if not np.array_equal(w2[0][name][f], w2[1][name][f]):
                fail(f"[29 {name}] the two world-2 ranks hold different {f}")
        if name != "spatial":
            if not w1[name]["jobs"] == w2[0][name]["jobs"] == w2[1][name]["jobs"] \
                    == ref[name]["jobs"]:
                fail(f"[29 {name}] md jobs {ref[name]['jobs']} unsharded, {w1[name]['jobs']} "
                     f"world 1, {w2[0][name]['jobs']} world 2")
    errs = {}
    for name, f in (("hooke", "stress"), ("fe", "stress"), ("fe", "u"), ("md", "stress")):
        errs[f"{name} {f}"] = e = _mr_err(w2[0][name][f], ref[name][f])
        if e > MR_TOL[name]:
            fail(f"[29 {name}] world 2 {f} {e:.3e} from the unsharded run (tol {MR_TOL[name]})")
    for f in ("F", "W"):
        errs[f"spatial {f}"] = e = _mr_err(w2[0]["spatial"][f], ref["spatial"][f])
        if e > MR_TOL["spatial_fv"]:
            fail(f"[29 spatial] world 2 first-call {f} {e:.3e} from the unsharded list route "
                 f"(tol {MR_TOL['spatial_fv']})")
    # world 2 with deterministic algorithms off: each rank's FE sums round
    # in their own atomic order; rank 0's job list is every rank's, so rank
    # 0's stresses must still hold
    nd = [w2[r]["hooke_nondet"] for r in (0, 1)]
    errs["hooke stress, nondeterministic (rank 0 / rank 1)"] = tuple(
        _mr_err(x["stress"], ref["hooke"]["stress"]) for x in nd)
    if errs["hooke stress, nondeterministic (rank 0 / rank 1)"][0] > MR_TOL["hooke"]:
        fail(f"[29 hooke] world 2 rank 0 with deterministic algorithms off: stress "
             f"{errs['hooke stress, nondeterministic (rank 0 / rank 1)'][0]:.3e} from the "
             f"unsharded run (tol {MR_TOL['hooke']})")
    if nd[0]["jobs"] != ref["hooke"]["jobs"]:
        fail(f"[29 hooke] world 2 rank 0 with deterministic algorithms off: md jobs "
             f"{nd[0]['jobs']}, unsharded {ref['hooke']['jobs']}")
    p32 = _mr_err(ref["spatial"]["press"], ref64["press"])
    p2 = _mr_err(w2[0]["spatial"]["press"], ref64["press"])
    errs["spatial pressure vs float64 (unsharded float32 / world 2)"] = (p32, p2)
    if p2 > max(MR_PRESS_X * p32, MR_PRESS_FLOOR):
        fail(f"[29 spatial] world-2 pressures {p2:.3e} from float64, the unsharded float32 "
             f"route {p32:.3e}: beyond max({MR_PRESS_X} x, {MR_PRESS_FLOOR})")
    fe = w2[0]["fe"]
    if fe["own_bytes"] + w2[1]["fe"]["own_bytes"] != fe["full_bytes"]:
        fail(f"[29 fe] world-2 ranks hold {fe['own_bytes']} + {w2[1]['fe']['own_bytes']} bytes "
             f"of a {fe['full_bytes']}-byte state")
    expect = MR_MD_STEPS * 0.002 * 0.08
    for res, who in ((w1, "world 1"), (w2[0], "world 2 rank 0"), (w2[1], "world 2 rank 1")):
        if abs(res["md"]["umax"] - expect) > 1e-5 * expect:
            fail(f"[29 md] {who}: max displacement {res['md']['umax']} != {expect}")
        need = {"hooke": ("pairwise_l2",), "fe": ("pairwise_l2",),
                "md": ("md_sw_run", "pairwise_l2"), "spatial": (),
                "hooke_nondet": ("pairwise_l2",)}
        for name, ks in need.items():
            if name not in res:  # the nondeterministic Hooke run is world 2's
                continue
            got = res[name]["launches"]
            for k in ks:
                if got[k] <= 0:
                    fail(f"[29 {name}] {who}: kernel {k} was not launched")
            others = {k: v for k, v in got.items()
                      if v and k not in ks and not (name == "md" and k == "md_sw_forces")}
            if others:
                fail(f"[29 {name}] {who}: kernels of other paths launched: {others}")
    for r in (0, 1):
        bad = [k for k, v in w2[r]["collectives"].items() if not v]
        if bad:
            fail(f"[29 multi-rank] rank {r}: gloo gave wrong results on CUDA tensors for {bad}")
    print(f"[29 checks] world 1 (NCCL) bit for bit the unsharded runs (Hooke stress, FE u and "
          f"stress, SW stress, spatial forces/virial/pressures/positions); world 2 (gloo) "
          f"relative errors { {k: (f'{v:.3e}' if isinstance(v, float) else tuple(f'{x:.3e}' for x in v)) for k, v in errs.items()} }")


def _mr_rank(rank, world, init, q, inputs):
    """A world-2 gloo rank of phase 29 on cuda:0."""
    import traceback

    try:
        sys.path.insert(0, HERE)
        import torch
        import torch.distributed as dist

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.use_deterministic_algorithms(True, warn_only=True)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        from scema_tpu_torch.parallel import mesh_utils as MU

        dist.init_process_group("gloo", init_method=init, world_size=world, rank=rank)
        res = {"collectives": _mr_collectives(dev, world, rank)}
        mesh = MU.make_mesh()
        res.update(_mr_paths(dev, mesh, 2, inputs))
        torch.use_deterministic_algorithms(False)
        res["hooke_nondet"] = _mr_hooke(dev, mesh)
        q.put((rank, "ok", res))
        dist.destroy_process_group()
    except BaseException:  # noqa: BLE001 — the parent fails the phase on it
        q.put((rank, "error", traceback.format_exc()))


def _mr_err(a, ref):
    import numpy as np

    return float(np.abs(a - ref).max() / max(np.abs(ref).max(), 1e-30))


def _mr_inputs():
    """The spatial path's inputs: 4 jobs of the 4096-atom box, jiggled
    0.05 A, Maxwell velocities at 300 K, one strain each (seeded)."""
    import numpy as np
    import torch

    from scema_tpu_torch.md import engine as E
    from scema_tpu_torch.md import material as M

    sys_, st = M.build_system(M.MaterialSpec(name="si", n_cells=MR_SPATIAL_CELLS),
                              dtype=torch.float64, device="cpu")
    gen = torch.Generator().manual_seed(29)
    pos = st.pos.expand(MR_SPATIAL_JOBS, -1, -1) + 0.05 * torch.randn(
        (MR_SPATIAL_JOBS,) + tuple(st.pos.shape), generator=gen, dtype=torch.float64)
    vel = torch.stack([E.maxwell_velocities(sys_, T_MD, gen) for _ in range(MR_SPATIAL_JOBS)])
    eps = np.zeros((MR_SPATIAL_JOBS, 6))
    eps[:, 2] = np.linspace(1e-3, 4e-3, MR_SPATIAL_JOBS)
    eps[:, 3] = 5e-4
    return dict(pos=pos.numpy(), h=st.h.expand(MR_SPATIAL_JOBS, 3, 3).numpy().copy(),
                vel=vel.numpy(), eps=eps)


def phase_multi_rank(dev, card):
    """Phase 29 (module docstring)."""
    import multiprocessing as mp
    import queue as queue_mod

    import numpy as np
    import torch
    import torch.distributed as dist

    from scema_tpu_torch.parallel import mesh_utils as MU

    t_phase = time.perf_counter()
    inputs = {**_mr_inputs(), "dtype": torch.float32}
    tmp = tempfile.mkdtemp(dir=HERE, prefix=".phase29-")
    # (b) world 2 on gloo: the kernels are built (phase 2), so the ranks
    # load the library and never compile
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    procs = [ctx.Process(target=_mr_rank, args=(r, 2, f"file://{tmp}/gloo2", q, inputs))
             for r in range(2)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    w2, errors = {}, []
    try:
        for _ in procs:
            rank, status, res = q.get(timeout=600)
            if status != "ok":
                errors.append(f"rank {rank}: {res}")
                break
            w2[rank] = res
    except queue_mod.Empty:
        errors.append(f"no rank answered within 600 s (exit codes {[p.exitcode for p in procs]})")
    for p in procs:
        p.join(60 if not errors else 1)
        if p.is_alive():
            p.kill()
            p.join()
    if errors or any(p.exitcode != 0 for p in procs):
        fail(f"[29 multi-rank] world 2 (gloo): {' '.join(errors)} exit codes "
             f"{[p.exitcode for p in procs]}")
    w2_wall = time.perf_counter() - t0
    # every later run starts from the replica rank 0 prepared and broadcast
    for f in ("pos", "vel", "h", "vxi"):
        if not np.array_equal(w2[0]["md"]["init"][f], w2[1]["md"]["init"][f]):
            fail(f"[29 md] the world-2 ranks start from different replicas ({f})")
    prepared = _mr_prepared(w2[0]["md"], dev)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        # (a) world 1 on NCCL, in this process
        t0 = time.perf_counter()
        dist.init_process_group("nccl", init_method=f"file://{tmp}/nccl1", world_size=1,
                                rank=0, device_id=dev)
        if dist.get_backend() != "nccl":
            fail("[29 multi-rank] world 1 did not come up on NCCL")
        w1 = _mr_paths(dev, MU.make_mesh(), 1, inputs, prepared)
        dist.destroy_process_group()
        w1_wall = time.perf_counter() - t0
        # the unsharded paths (no group), and the spatial box in float64
        ref = _mr_paths(dev, None, 0, inputs, prepared)
        ref64 = _mr_spatial(dev, 0, inputs, torch.float64)
    finally:
        torch.use_deterministic_algorithms(False)
    _mr_check(w1, w2, ref, ref64)
    print(f"[29 multi-rank] collectives gloo takes on CUDA tensors (each rank): "
          f"{[w2[r]['collectives'] for r in (0, 1)]}")
    for name in ("hooke", "fe", "md"):
        print(f"[29 {name}] s/macro-step unsharded {ref[name]['times']}  world 1 (NCCL) "
              f"{w1[name]['times']}  world 2 (gloo) rank 0 {w2[0][name]['times']} rank 1 "
              f"{w2[1][name]['times']}  md jobs {w2[0][name]['jobs']}  setup s unsharded "
              f"{ref[name].get('setup', 0.0):.3f} w1 {w1[name].get('setup', 0.0):.3f} w2 "
              f"{w2[0][name].get('setup', 0.0):.3f}/{w2[1][name].get('setup', 0.0):.3f}  "
              f"({card})")
    print(f"[29 hooke] world 2 with deterministic algorithms off: s/macro-step rank 0 "
          f"{w2[0]['hooke_nondet']['times']} rank 1 {w2[1]['hooke_nondet']['times']}  md jobs "
          f"{w2[0]['hooke_nondet']['jobs']} / {w2[1]['hooke_nondet']['jobs']}  ({card})")
    print(f"[29 fe] persistent FE state bytes per rank: world 2 {w2[0]['fe']['own_bytes']} + "
          f"{w2[1]['fe']['own_bytes']} against {w2[0]['fe']['full_bytes']} unsharded")
    sp = {k: v["spatial"] for k, v in (("ref", ref), ("w1", w1), ("w2_0", w2[0]),
                                        ("w2_1", w2[1]))}
    print(f"[29 spatial] {sp['w2_0']['route']}: s/MD step unsharded "
          f"{sp['ref']['step_s']:.4f} world 1 {sp['w1']['step_s']:.4f} world 2 "
          f"{sp['w2_0']['step_s']:.4f}/{sp['w2_1']['step_s']:.4f}; first force + virial call "
          f"s {sp['ref']['fv_s']:.3f} / {sp['w1']['fv_s']:.3f} / {sp['w2_0']['fv_s']:.3f}; "
          f"setup s {sp['w2_0']['setup']:.3f}  ({card})")
    launches = {}
    for res in (w1, w2[0], w2[1]):
        for name in ("hooke", "fe", "md", "spatial", "hooke_nondet"):
            for k, v in res.get(name, {"launches": {}})["launches"].items():
                launches[k] = launches.get(k, 0) + v
    print(f"[29 multi-rank] launches (world 1 + both world-2 ranks) "
          f"{ {k: v for k, v in launches.items() if v} }  world 2 wall {w2_wall:.1f}s, "
          f"world 1 wall {w1_wall:.1f}s, phase wall {time.perf_counter() - t_phase:.1f}s")
    shutil.rmtree(tmp, ignore_errors=True)
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
    k2, k2_first = phase_k2(dev)
    k1_rows, k1_first_design_rows = phase_k1(dev)
    launches = phase_slice(dev)
    k3_rows, k3_first_rows = phase_k3(dev)
    launches_charged = phase_charged_slice(dev)
    k4_rows, k4_first_rows = phase_k4(dev)
    phase_bench(dev)
    launches_list = phase_list_slice(dev)
    k5_rows, k5_first_rows = phase_k5(dev)
    launches_sw = phase_sw_slice(dev)
    k6 = phase_k6(dev)
    launches_bricks = phase_sw_big_slice(dev, bricks=True, n_steps=2)
    phase_sw_big_slice(dev, bricks=False, n_steps=1)
    k1m, k1m_first, k1m_bitwise = phase_k1m(dev)
    launches_k1m = phase_staged_slice(dev, k1m_bitwise)
    k1m["launches"] = launches_k1m["md_k1m_run"]
    k1m_first["launches"] = launches_k1m["md_allpairs_run_multi"]
    p1 = phase_p1(dev)
    p1_big = phase_p1_sizes(dev)
    k4_big = phase_k4_big(dev)
    launches_big = phase_big_slice(dev)
    for row in k4_big:  # the cluster form's and the global form's (0) on phase 20's path
        row["launches"] = launches_big[row["name"]]
    phase_run_surface(dev)
    phase_charged_staged_slice(dev)
    # the paths of phases 23-25 and 27: the data-file material on the
    # unfused engine (K2 only), the drop-weight and compact-tension runs on
    # K1 and K2, the restart-seeded SW dogbone on K5 and K2, the surrogate
    # dogbone on K2
    later = [phase_data_file(dev), phase_problems(dev), phase_restart_seed(dev)]
    phase_smem_route(dev)
    later.append(phase_surrogate(dev))  # the surrogate's path: K2 alone
    later.append(phase_reax_slice(dev))  # the ReaxFF slice: K2 alone
    # the multi-rank paths: K2 on each rank's Hooke and FE steps, K5 and K2
    # on each rank's block of the SW jobs
    later.append(phase_multi_rank(dev, card))
    rows = [*k1_rows, k2, *k3_rows, *k4_rows, *k5_rows, *k1_first_design_rows, k2_first,
            *k3_first_rows, *k4_first_rows, *k5_first_rows]
    for row in rows:
        path = (launches_charged if row["name"].startswith("md_charged") else
                launches_list if row["name"].startswith("md_list") else
                launches_sw if row["name"].startswith("md_sw") else launches)
        row["launches"] = path[row["name"]] + sum(p.get(row["name"], 0) for p in later)
    for row in k6.values():  # K6's launches on the brick slice (phase 14)
        row["launches"] = launches_bricks[row["name"]]
        rows.append(row)
    rows += [k1m, k1m_first]  # K1m's launches on the pack_jobs=2 steps (phase 17)
    rows.extend(p1)  # P1's launches on the lab's path (phase 18)
    rows.extend(p1_big)  # P1's big-box instance's on phase 18's other sizes
    rows.extend(k4_big)  # K4's cluster and global forms' launches on the 4096-atom slice
    print(card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
