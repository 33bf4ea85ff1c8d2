"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports torch and the port only (no JAX), so it runs on a machine that has
no JAX, with the repository's conftest left out:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances, each with its reason (float32 on both sides, same inputs):
* K2: 1e-5 relative — the kernel accumulates 60 squares with FMAs in
  another association than torch's reduction; its redesign (upper-triangle
  tile pairs, each tile written with its mirror), with either tile edge (64
  or 32 rows), equals its first design bit for bit and is exactly
  symmetric, at every n around the tile edges and d within and beyond one
  staged 32-column chunk;
* K1 forces/virial: the kernel's error against a float64 evaluation is at
  most twice the plain float32 version's (+1e-6 of the largest component)
  — pair terms ~100x the net force cancel, so a fixed float32 tolerance
  would measure the cancellation, not the kernel;
* K1 runs: after 10 steps the kernel's distance from a float64 run is at
  most four times the plain float32 run's (+1e-4) — rounding differences
  grow chaotically along a trajectory; an inactive job must come back
  bit-identical;
* K1 sampling over 20 steps: each job's pressure sum, per component, is
  within four times the plain float32 run's distance from float64 (+1e-4);
* K1 sampling over 100 steps: the job-mean pressures agree within four
  standard errors of the job scatter (chaotic divergence makes individual
  long runs differ);
* K1 (csrc/md_k1.cu) at one and at twelve boxes in its force entry, to
  the same bounds; its first design (md_kernel.cuh with every flag off,
  reached through md_fused._run_first / _forces_first) to the same bounds;
* K1m (csrc/md_k1m.cu, J = 2 or 4 jobs per block, each job's arithmetic
  K1's at K1's block width, the two bodies compiled differently: the last
  float32 bits differ): held to K1's run rule against float64; its first
  design (md_multi.cu) equals K1's first design bit for bit; a dead job of
  a (live, dead) pair comes back bit-identical;
* K3 (csrc/md_k3.cu; the charged PEAA box: 1792 atoms, real-space Ewald,
  offset patterns, SHAKE, frozen k-space force) is held to the same
  relative bounds as K1: forces/virial 2x plain float32 + 1e-6 (per atom
  1e-5 on the probe's tilted boxes), a 10-step deform chunk 4x plain +
  1e-4 with inactive jobs bit-identical, 20-step pressure sums 4x plain +
  1e-4; the SHAKE residual |r^2 - d0^2| / d0^2 after the chunk stays below
  1e-3;
* the other K3 flag sets (cutoff Coulomb, SHAKE off) on a small all-atom
  box, to the same bounds;
* K4 (csrc/md_k4.cu, the compact-list pair loop) on the PEAA2240 box (2240
  charged atoms, K ~ 1112 slots, the PME split, SHAKE) and on the other
  flag sets (g0 chains, cutoff Coulomb, SHAKE off) with the same compact
  list on both sides (the plain version decodes it): the bounds of K3,
  inactive jobs bit-identical;
* the first designs of K3 and K4 (md_kernel.cuh, reached through
  md_fused._run_first / _forces_first; K4 over the seven channels of
  channels_first) to the same bounds, each design's launches counted on
  its own wrapper and the other's untouched;
* K4's cluster form (csrc/md_k4_big.cu: one job on a cluster of CTAs) on
  the 4096-atom PEAA4096 box, above the shared form's cap, on the host's
  cluster size and on 8 CTAs with cuts that split SHAKE constraints: the
  bounds of K4, inactive jobs bit-identical;
* K5 (csrc/md_k5.cu: sweep 2 over sweep 1's live lists) on the slice's
  216-atom diamond-Si box and on the gate's largest, 640 atoms, with
  perturbed positions and tilted boxes: the bounds of K1, inactive jobs
  bit-identical, and so with live-list caps (8, 2) that some or every atom
  exceeds (sweep 2 then walks all N); its first design (md_sw.cu) to the
  same bounds;
* K6d/K6e (SW brick moments, energy) and K6c (adjoint forces, energy,
  virial) on 512- and 4096-atom boxes with perturbed positions and tilted
  boxes, K6a/K6b on a 512-atom box: the K1 force bounds; K6's first design
  (the stencil sweep in both kernels) to the same bounds, and the path's
  within them of it on the same inputs; K6c's overflow path (a live-list
  cap of 2) to the same bounds; the path's K6 kernels at <= 64 registers
  and >= 8 blocks per SM; ten deform steps
  of the unfused engine on the bricks against the list route within 1e-3 A
  (float32 noise of two force orders), a 0-step job bit-identical;
* P1 (the kernel lab's slim all-pairs runs, each variant v1-v8) on the
  prepared g0 box, 576 jobs x 25 steps (one image refresh mid-run): K1's
  run bounds on positions, velocities, chain and 2 KE; a 0-step program
  bit-identical for the one-box variants (v7, v7d4 and v7p run J boxes
  under one chain, so a program has no dead job); the int8 image guard's
  NaN programs equal to the plain version's."""
import dataclasses

import numpy as np
import pytest
import torch

from scema_tpu_torch import probe_allpairs as PA
from scema_tpu_torch.md import engine as E
from scema_tpu_torch.md import material as M
from scema_tpu_torch.ops import md_fused as MF
from scema_tpu_torch.ops import md_slim as MS
from scema_tpu_torch.ops import pairwise_l2 as K2
from scema_tpu_torch.ops import sw_bricks as SWB

pytestmark = pytest.mark.requires_cuda

G0 = M.MaterialSpec(name="g0", force_field="opls")  # 64 x 8 beads, 512 sites
PEAA = M.PEAA  # 56 x C10H22, 1792 charged atoms, PME split, SHAKE
PEAA2240 = M.PEAA2240  # 70 x C10H22, 2240 charged atoms, on the list kernel K4
T_MD, DT = 300.0, 2.0  # HMMConfig's MD temperature (K) and timestep (fs)


def _device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _rel(a, b) -> float:
    a, b = a.double().cpu(), b.double().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


@pytest.fixture(scope="module")
def g0():
    dev = _device()
    sys, st = M.build_system(G0, dtype=torch.float32, device=dev)
    st = E.minimize_fire(sys, st, n_steps=100, dt0=0.5)
    gen = torch.Generator().manual_seed(0)
    B = 8
    vel = torch.stack([E.maxwell_velocities(sys, T_MD, gen, torch.float32, dev)
                       for _ in range(B)])
    batch = E.MDState(pos=st.pos.expand(B, -1, -1).contiguous(), vel=vel,
                      h=st.h.expand(B, -1, -1).contiguous(),
                      vxi=torch.zeros((B, 3), device=dev))
    return sys, batch


@pytest.mark.parametrize("n", [576, 4608, 33])
def test_k2_matches_plain(n):
    dev = _device()
    x = torch.as_tensor(np.random.default_rng(n).standard_normal((n, 60)),
                        dtype=torch.float32, device=dev)
    before = K2.pairwise_l2.launches
    d = K2.pairwise_l2(x)
    torch.cuda.synchronize()
    assert K2.pairwise_l2.launches == before + 1
    assert _rel(d, K2.pairwise_l2_plain(x)) < 1e-5
    assert torch.equal(d, d.T)


@pytest.mark.parametrize("d", [6, 60, 130])
@pytest.mark.parametrize("n", [1, 33, 63, 64, 65, 576, 4608])
def test_k2_redesign_equals_first_design(n, d):
    dev = _device()
    x = torch.as_tensor(np.random.default_rng(7 * n + d).standard_normal((n, d)),
                        dtype=torch.float32, device=dev)
    before = (K2.pairwise_l2.launches, K2._first.launches)
    new, old = K2.pairwise_l2(x), K2._first(x)
    torch.cuda.synchronize()
    assert (K2.pairwise_l2.launches, K2._first.launches) == (before[0] + 1, before[1] + 1)
    assert torch.equal(new, old)
    assert torch.equal(new, new.T)
    assert _rel(new, K2.pairwise_l2_plain(x)) < 1e-5
    for tile in (32, 64):  # both tile edges, whichever the kernel picks here
        assert torch.equal(K2._launch(x, "pairwise_l2_f32", K2.pairwise_l2, tile), old)


def test_k1_forces_virial_match_plain(g0):
    sys, batch = g0
    pos = batch.pos.transpose(1, 2).contiguous()
    h6 = MF.h6_of(batch.h)
    before = MF.md_forces_virial.launches
    F, W = MF.md_forces_virial(sys.fused, pos, h6)
    torch.cuda.synchronize()
    assert MF.md_forces_virial.launches == before + 1
    Fp, Wp = MF.md_forces_virial_plain(sys.fused, pos, h6)
    F64, W64 = MF.md_forces_virial_plain(sys.fused.to(pos.device, torch.float64),
                                         pos.double(), h6.double())
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6


@pytest.mark.parametrize("n_boxes", [1, 12])
@pytest.mark.parametrize("design", ["path", "first"])
def test_k1_force_entry_designs_match_plain(g0, n_boxes, design):
    """The force entry at the staged NPT's one box and the probe's twelve
    (perturbed, tilted): K1's tiles over (tile, box) blocks and its first
    design's one block per box, each within twice the plain float32 error
    against float64."""
    sys, batch = g0
    dev = batch.pos.device
    gen = torch.Generator().manual_seed(n_boxes)
    pos = batch.pos[:1].expand(n_boxes, -1, -1) + 0.02 * torch.randn(
        (n_boxes, sys.n_atoms, 3), generator=gen).to(dev)
    h = batch.h[:1].expand(n_boxes, 3, 3).clone()
    h[:, 0, 1] = 0.3
    p, h6 = pos.transpose(1, 2).contiguous(), MF.h6_of(h)
    entry = MF.md_forces_virial if design == "path" else MF._forces_first
    before = entry.launches
    F, W = entry(sys.fused, p, h6)
    torch.cuda.synchronize()
    assert entry.launches == before + 1
    Fp, Wp = MF.md_forces_virial_plain(sys.fused, p, h6)
    F64, W64 = MF.md_forces_virial_plain(sys.fused.to(dev, torch.float64), p.double(),
                                         h6.double())
    assert torch.isfinite(F).all()
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6


@pytest.mark.parametrize("design", ["path", "first"])
def test_k1_run_designs_match_plain(g0, design):
    """K1's run and its first design's, each within four times the plain
    float32 run's distance from float64 over 10 deform steps, inactive jobs
    bit-identical."""
    sys, batch = g0
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 0, 10, 7, 10, 0, 3, 10], dtype=torch.int32, device=st.device)
    run = MF.md_run if design == "path" else MF._run_first
    out, vxi, _ = run(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    torch.cuda.synchronize()
    for j in (1, 5):
        assert torch.equal(out[j], st[j]) and torch.equal(vxi[j], batch.vxi[j])
    ref, _, _ = MF.md_run_plain(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    ref64, _, _ = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                  batch.vxi.double(), n_run, fscal.double(), True, False)
    err = float((out[:, :3].double() - ref64[:, :3]).abs().max())
    assert err <= 4 * float((ref[:, :3].double() - ref64[:, :3]).abs().max()) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4


def test_k1_kernels_fit_two_blocks_per_sm(g0):
    """K1's run and force kernels hold 64 registers and two 512-thread
    blocks per SM at the g0 box."""
    sys, _ = g0
    for entry in ("run", "forces"):
        info = MF.k1_kernel_info(entry, sys.n_atoms, int(sys.fused.k1_tbl.shape[0]))
        assert info["registers"] <= 64 and info["blocks_per_sm"] == 2, (entry, info)


def test_k1_run_matches_plain_and_skips_inactive(g0):
    sys, batch = g0
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 0, 10, 7, 10, 0, 3, 10], dtype=torch.int32, device=st.device)
    before = MF.md_run.launches
    out, vxi, _ = MF.md_run(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    torch.cuda.synchronize()
    assert MF.md_run.launches == before + 1
    for j in (1, 5):
        assert torch.equal(out[j], st[j]) and torch.equal(vxi[j], batch.vxi[j])
    ref, vxi_ref, _ = MF.md_run_plain(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    ref64, vxi64, _ = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                      batch.vxi.double(), n_run, fscal.double(), True, False)

    def err(a, b):
        return float((a.double() - b).abs().max())

    assert err(out[:, :3], ref64[:, :3]) <= 4 * err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4
    assert _rel(vxi, vxi64) <= 4 * _rel(vxi_ref, vxi64) + 1e-4


def test_k1_sampling_pressure_sums_match_plain(g0):
    """Each job's pressure sum over 20 sampling steps, per Voigt component,
    is as close to float64 as the plain float32 run's (a swapped or
    mis-summed component fails here, not only in the mean)."""
    sys, batch = g0
    st = MF.pack_state(batch.pos, batch.vel)
    n = torch.full((st.shape[0],), 20, dtype=torch.int32, device=st.device)
    fscal = MF.make_fscal(DT, T_MD, batch.h)
    _, _, pk = MF.md_run(sys.fused, st, batch.vxi, n, fscal, False, True)
    _, _, pp = MF.md_run_plain(sys.fused, st, batch.vxi, n, fscal, False, True)
    _, _, p64 = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                batch.vxi.double(), n, fscal.double(), False, True)
    for c in range(6):
        assert _rel(pk[:, c], p64[:, c]) <= 4 * _rel(pp[:, c], p64[:, c]) + 1e-4, c


def test_k1_sampled_stress_matches_plain_statistically(g0):
    sys, batch = g0
    n = torch.full((batch.pos.shape[0],), 100, device=batch.pos.device)
    _, p = MF.sample_stress_fused(sys.fused, batch, n, T_MD, DT)
    torch.cuda.synchronize()
    st6 = MF.pack_state(batch.pos, batch.vel)
    _, _, pacc = MF.md_run_plain(sys.fused, st6, batch.vxi, n.to(torch.int32),
                                 MF.make_fscal(DT, T_MD, batch.h), False, True)
    pp = pacc / 100.0
    assert torch.isfinite(p).all()
    se = pp.double().std(0) / np.sqrt(pp.shape[0])
    diff = (p.double().mean(0) - pp.double().mean(0)).abs()
    assert bool((diff <= 4.0 * se + 1.0).all()), (diff, se)


def _k1m_case(g0):
    sys, batch = g0
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 7, 10, 3, 10, 10, 4, 10], dtype=torch.int32, device=st.device)
    return sys, batch, st, fscal, n_run


@pytest.mark.parametrize("jobs", [2, 4])
def test_k1m_equals_k1(g0, jobs):
    """K1m's redesign (J jobs per block, each job's arithmetic K1's at K1's
    block width) differs from K1 (md_k1.cu) in the last float32 bits — the
    two bodies compile differently (~4e-6 A after 10 deform steps) — so
    deform runs of different lengths and 20-step pressure sums are held to
    K1's rule against float64: four times the plain float32 run's distance
    (+1e-4); one launch counted."""
    sys, batch, st, fscal, n_run = _k1m_case(g0)
    B = st.shape[0]
    r, r64 = sys.fused, sys.fused.to(st.device, torch.float64)
    before = MF.md_run_multi.launches_k1m
    out, vxi, _ = MF.md_run_multi(r, st, batch.vxi, n_run, fscal, True, False, jobs)
    torch.cuda.synchronize()
    assert MF.md_run_multi.launches_k1m == before + 1
    ref, _, _ = MF.md_run_plain(r, st, batch.vxi, n_run, fscal, True, False)
    ref64, _, _ = MF.md_run_plain(r64, st.double(), batch.vxi.double(), n_run, fscal.double(),
                                  True, False)
    assert _err(out[:, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4
    f_s = MF.make_fscal(DT, T_MD, batch.h)
    n20 = torch.full((B,), 20, dtype=torch.int32, device=st.device)
    _, _, pk = MF.md_run_multi(r, out, vxi, n20, f_s, False, True, jobs)
    _, _, pp = MF.md_run_plain(r, out, vxi, n20, f_s, False, True)
    _, _, p64 = MF.md_run_plain(r64, out.double(), vxi.double(), n20, f_s.double(), False, True)
    for c in range(6):
        assert _rel(pk[:, c], p64[:, c]) <= 4 * _rel(pp[:, c], p64[:, c]) + 1e-4, c


@pytest.mark.parametrize("jobs", [2, 4])
def test_k1m_first_design_equals_k1_first_design(g0, jobs):
    """K1m's first design (md_multi.cu) runs each job's step body in the
    order of K1's first design at its block width: bit for bit, counted on
    its own wrapper only."""
    sys, batch, st, fscal, n_run = _k1m_case(g0)
    before, path = MF._run_multi_first.launches_k1m, MF.md_run_multi.launches_k1m
    out, vxi, _ = MF._run_multi_first(sys.fused, st, batch.vxi, n_run, fscal, True, False, jobs)
    torch.cuda.synchronize()
    assert MF._run_multi_first.launches_k1m == before + 1
    assert MF.md_run_multi.launches_k1m == path
    ref, vxi_ref, _ = MF._run_first(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    assert torch.equal(out, ref) and torch.equal(vxi, vxi_ref)


def test_k1m_dead_job_is_bit_identical(g0):
    """A (live, dead) pair: the dead job comes back untouched with zero
    pressure, the live one (sampling) to K1's run rule against float64."""
    sys, batch = g0
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    fscal = MF.make_fscal(DT, T_MD, batch.h)
    n_run = torch.tensor([20, 0] * (B // 2), dtype=torch.int32, device=st.device)
    out, vxi, p = MF.md_run_multi(sys.fused, st, batch.vxi, n_run, fscal, False, True, 2)
    torch.cuda.synchronize()
    assert torch.equal(out[1::2], st[1::2]) and torch.equal(vxi[1::2], batch.vxi[1::2])
    assert torch.equal(p[1::2], torch.zeros_like(p[1::2]))
    live = (st[0::2], batch.vxi[0::2], n_run[0::2], fscal[0::2], False, True)
    ref, _, _ = MF.md_run_plain(sys.fused, *live)
    ref64, _, _ = MF.md_run_plain(sys.fused.to(st.device, torch.float64),
                                  *(x.double() if torch.is_tensor(x) and x.is_floating_point()
                                    else x for x in live))
    assert _err(out[0::2, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4


def test_k1m_kernels_occupancy(g0):
    """K1m's J = 2 block holds K1's 64 registers and two blocks per SM; J =
    4 one block of 512 threads."""
    sys, _ = g0
    T = int(sys.fused.k1_tbl.shape[0])
    two, four = (MF.k1m_kernel_info(J, sys.n_atoms, T) for J in (2, 4))
    assert two["registers"] <= 64 and two["blocks_per_sm"] == 2, two
    assert four["threads"] == 512 and four["blocks_per_sm"] == 1, four


@pytest.fixture(scope="module")
def peaa():
    dev = _device()
    sys, st = M.build_system(PEAA, dtype=torch.float32, device=dev)
    st = E.minimize_fire(sys, st, n_steps=50, dt0=0.5)
    gen = torch.Generator().manual_seed(0)
    B = 4
    vel = torch.stack([E.maxwell_velocities(sys, T_MD, gen, torch.float32, dev)
                       for _ in range(B)])
    batch = E.MDState(pos=st.pos.expand(B, -1, -1).contiguous(), vel=vel,
                      h=st.h.expand(B, -1, -1).contiguous(),
                      vxi=torch.zeros((B, 3), device=dev))
    fk, _ = sys.fused.kspace(batch.pos, batch.h)
    return sys, batch, fk.transpose(1, 2).contiguous()


def test_k3_forces_virial_match_plain(peaa):
    sys, batch, _ = peaa
    pos = batch.pos.transpose(1, 2).contiguous()
    h6 = MF.h6_of(batch.h)
    before = MF.md_forces_virial.launches_k3
    F, W = MF.md_forces_virial(sys.fused, pos, h6)
    torch.cuda.synchronize()
    assert MF.md_forces_virial.launches_k3 == before + 1
    Fp, Wp = MF.md_forces_virial_plain(sys.fused, pos, h6)
    F64, W64 = MF.md_forces_virial_plain(sys.fused.to(pos.device, torch.float64),
                                         pos.double(), h6.double())
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6


def test_k3_run_matches_plain_and_skips_inactive(peaa):
    sys, batch, fk = peaa
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 0, 7, 10], dtype=torch.int32, device=st.device)
    g0 = torch.tensor([0, 0, 10, 20], dtype=torch.int32, device=st.device)
    n_tot = torch.full_like(n_run, 30)
    args = (batch.vxi, n_run, fscal, True, False, fk, g0, n_tot)
    before = MF.md_run.launches_k3
    out, vxi, _ = MF.md_run(sys.fused, st, *args)
    torch.cuda.synchronize()
    assert MF.md_run.launches_k3 == before + 1
    assert torch.equal(out[1], st[1]) and torch.equal(vxi[1], batch.vxi[1])
    ref, vxi_ref, _ = MF.md_run_plain(sys.fused, st, *args)
    ref64, vxi64, _ = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                      batch.vxi.double(), n_run, fscal.double(), True, False,
                                      fk.double(), g0, n_tot)

    def err(a, b):
        return float((a.double() - b).abs().max())

    assert err(out[:, :3], ref64[:, :3]) <= 4 * err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4
    assert _rel(vxi, vxi64) <= 4 * _rel(vxi_ref, vxi64) + 1e-4
    # the jobs that ran hold their constraints (the inactive one keeps the
    # unconstrained FIRE state it was given)
    cons = sys.constraints
    i, j = (torch.as_tensor(cons.idx[:, k], device=st.device) for k in (0, 1))
    d0sq = torch.as_tensor(cons.d0, device=st.device, dtype=torch.float64) ** 2
    ran = out[n_run > 0]
    rr = ran[:, :3, j].double() - ran[:, :3, i].double()
    assert float(((rr * rr).sum(1) - d0sq).abs().div(d0sq).max()) < 1e-3


def test_k3_sampling_pressure_sums_match_plain(peaa):
    sys, batch, fk = peaa
    st = MF.pack_state(batch.pos, batch.vel)
    n = torch.full((st.shape[0],), 20, dtype=torch.int32, device=st.device)
    fscal = MF.make_fscal(DT, T_MD, batch.h)
    one = torch.ones_like(n)
    _, _, pk = MF.md_run(sys.fused, st, batch.vxi, n, fscal, False, True, fk, 0 * n, one)
    _, _, pp = MF.md_run_plain(sys.fused, st, batch.vxi, n, fscal, False, True, fk, 0 * n, one)
    _, _, p64 = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                batch.vxi.double(), n, fscal.double(), False, True,
                                fk.double(), 0 * n, one)
    for c in range(6):
        assert _rel(pk[:, c], p64[:, c]) <= 4 * _rel(pp[:, c], p64[:, c]) + 1e-4, c


@pytest.mark.parametrize("use_ewald,shake", [(False, True), (False, False), (True, False)])
def test_k3_flag_sets_match_plain(use_ewald, shake):
    """Every other K3 instantiation: forces/virial and a 10-step deform run
    against float64, held to the bounds of the PEAA tests."""
    dev = _device()
    spec = dataclasses.replace(PEAA, n_chains=8, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5,
                               use_ewald=use_ewald, shake=shake, validate=False)
    sys, st = M.build_system(spec, dtype=torch.float32, device=dev)
    st = E.minimize_fire(sys, st, n_steps=50, dt0=0.5)
    r, r64 = sys.fused, sys.fused.to(dev, torch.float64)
    assert r.spec.flags == "+".join(
        ["COUL"] + ["EWALD"] * use_ewald + ["PATTERNS"] + ["SHAKE"] * shake + ["FEXT"] * use_ewald)
    B = 4
    gen = torch.Generator().manual_seed(1)
    vel = torch.stack([E.maxwell_velocities(sys, T_MD, gen, torch.float32, dev)
                       for _ in range(B)])
    pos, h = st.pos.expand(B, -1, -1).contiguous(), st.h.expand(B, -1, -1).contiguous()
    p3, h6 = pos.transpose(1, 2).contiguous(), MF.h6_of(h)
    F, W = MF.md_forces_virial(r, p3, h6)
    Fp, Wp = MF.md_forces_virial_plain(r, p3, h6)
    F64, W64 = MF.md_forces_virial_plain(r64, p3.double(), h6.double())
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6
    st6, vxi = MF.pack_state(pos, vel), torch.zeros((B, 3), device=dev)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=dev).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, h, eps)
    n_run = torch.tensor([10, 0, 7, 10], dtype=torch.int32, device=dev)
    extra = ()
    if use_ewald:
        fk, _ = r.kspace(pos, h)
        extra = (fk.transpose(1, 2).contiguous(), 0 * n_run, torch.full_like(n_run, 10))
    out, _, _ = MF.md_run(r, st6, vxi, n_run, fscal, True, False, *extra)
    ref, _, _ = MF.md_run_plain(r, st6, vxi, n_run, fscal, True, False, *extra)
    ref64, _, _ = MF.md_run_plain(r64, st6.double(), vxi.double(), n_run, fscal.double(), True,
                                  False, *(x.double() if x.is_floating_point() else x
                                           for x in extra))
    torch.cuda.synchronize()
    assert torch.equal(out[1], st6[1])

    def err(a, b):
        return float((a.double() - b).abs().max())

    assert err(out[:, :3], ref64[:, :3]) <= 4 * err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4


def _err(a, b):
    return float((a.double() - b).abs().max())


@pytest.fixture(scope="module")
def peaa2240():
    dev = _device()
    sys, st = M.build_system(PEAA2240, dtype=torch.float32, device=dev)
    assert sys.fused.spec.kernel == "K4" and sys.fused.spec.flags.endswith("+LIST")
    st = E.minimize_fire(sys, st, n_steps=30, dt0=0.5)
    gen = torch.Generator().manual_seed(0)
    B = 4
    vel = torch.stack([E.maxwell_velocities(sys, T_MD, gen, torch.float32, dev)
                       for _ in range(B)])
    batch = E.MDState(pos=st.pos.expand(B, -1, -1).contiguous(), vel=vel,
                      h=st.h.expand(B, -1, -1).contiguous(),
                      vxi=torch.zeros((B, 3), device=dev))
    fk, _ = sys.fused.kspace(batch.pos, batch.h)
    nbr = sys.fused.channels(batch.pos, batch.h)
    return sys, batch, fk.transpose(1, 2).contiguous(), nbr


def test_k4_forces_virial_match_plain(peaa2240):
    sys, batch, _, nbr = peaa2240
    pos = batch.pos.transpose(1, 2).contiguous()
    h6 = MF.h6_of(batch.h)
    before = MF.md_forces_virial.launches_k4
    F, W = MF.md_forces_virial(sys.fused, pos, h6, nbr=nbr)
    torch.cuda.synchronize()
    assert MF.md_forces_virial.launches_k4 == before + 1
    Fp, Wp = MF.md_forces_virial_plain(sys.fused, pos, h6, nbr)
    F64, W64 = MF.md_forces_virial_plain(sys.fused.to(pos.device, torch.float64), pos.double(),
                                         h6.double(), nbr)
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6
    # no list row is full: every atom keeps a dead (self-padded) slot
    assert int(nbr["count"].max()) < sys.fused.spec.k


def test_k4_run_matches_plain_and_skips_inactive(peaa2240):
    sys, batch, fk, nbr = peaa2240
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 0, 7, 10], dtype=torch.int32, device=st.device)
    g0 = torch.tensor([0, 0, 10, 20], dtype=torch.int32, device=st.device)
    n_tot = torch.full_like(n_run, 30)
    args = (batch.vxi, n_run, fscal, True, False, fk, g0, n_tot)
    before = MF.md_run.launches_k4
    out, vxi, _ = MF.md_run(sys.fused, st, *args, nbr=nbr)
    torch.cuda.synchronize()
    assert MF.md_run.launches_k4 == before + 1
    assert torch.equal(out[1], st[1]) and torch.equal(vxi[1], batch.vxi[1])
    ref, vxi_ref, _ = MF.md_run_plain(sys.fused, st, *args, nbr=nbr)
    ref64, vxi64, _ = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                      batch.vxi.double(), n_run, fscal.double(), True, False,
                                      fk.double(), g0, n_tot, nbr=nbr)
    assert _err(out[:, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4
    assert _rel(vxi, vxi64) <= 4 * _rel(vxi_ref, vxi64) + 1e-4
    cons = sys.constraints
    i, j = (torch.as_tensor(cons.idx[:, k], device=st.device) for k in (0, 1))
    d0sq = torch.as_tensor(cons.d0, device=st.device, dtype=torch.float64) ** 2
    ran = out[n_run > 0]
    rr = ran[:, :3, j].double() - ran[:, :3, i].double()
    assert float(((rr * rr).sum(1) - d0sq).abs().div(d0sq).max()) < 1e-3


def test_k4_sampling_pressure_sums_match_plain(peaa2240):
    sys, batch, fk, nbr = peaa2240
    st = MF.pack_state(batch.pos, batch.vel)
    n = torch.full((st.shape[0],), 20, dtype=torch.int32, device=st.device)
    fscal = MF.make_fscal(DT, T_MD, batch.h)
    one = torch.ones_like(n)
    _, _, pk = MF.md_run(sys.fused, st, batch.vxi, n, fscal, False, True, fk, 0 * n, one,
                         nbr=nbr)
    _, _, pp = MF.md_run_plain(sys.fused, st, batch.vxi, n, fscal, False, True, fk, 0 * n, one,
                               nbr=nbr)
    _, _, p64 = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                batch.vxi.double(), n, fscal.double(), False, True,
                                fk.double(), 0 * n, one, nbr=nbr)
    for c in range(6):
        assert _rel(pk[:, c], p64[:, c]) <= 4 * _rel(pp[:, c], p64[:, c]) + 1e-4, c


@pytest.mark.parametrize("case", ["g0", "cut_shake", "cut", "ewald"])
def test_k4_flag_sets_match_plain(case):
    """Every other K4 instantiation: forces/virial and a 10-step deform run
    against float64 on small boxes, held to the bounds of the PEAA2240
    tests."""
    dev = _device()
    if case == "g0":
        spec = dataclasses.replace(G0, force_list_kernel=True)
    else:
        spec = dataclasses.replace(PEAA, n_chains=8, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5,
                                   use_ewald=case == "ewald", shake=case == "cut_shake",
                                   validate=False, force_list_kernel=True)
    sys, st = M.build_system(spec, dtype=torch.float32, device=dev)
    st = E.minimize_fire(sys, st, n_steps=50, dt0=0.5)
    r, r64 = sys.fused, sys.fused.to(dev, torch.float64)
    assert r.spec.kernel == "K4"
    B = 4
    gen = torch.Generator().manual_seed(1)
    vel = torch.stack([E.maxwell_velocities(sys, T_MD, gen, torch.float32, dev)
                       for _ in range(B)])
    pos, h = st.pos.expand(B, -1, -1).contiguous(), st.h.expand(B, -1, -1).contiguous()
    nbr = nbr64 = r.channels(pos, h)
    p3, h6 = pos.transpose(1, 2).contiguous(), MF.h6_of(h)
    F, W = MF.md_forces_virial(r, p3, h6, nbr=nbr)
    Fp, Wp = MF.md_forces_virial_plain(r, p3, h6, nbr)
    F64, W64 = MF.md_forces_virial_plain(r64, p3.double(), h6.double(), nbr64)
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6
    st6, vxi = MF.pack_state(pos, vel), torch.zeros((B, 3), device=dev)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=dev).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, h, eps)
    n_run = torch.tensor([10, 0, 7, 10], dtype=torch.int32, device=dev)
    fk = None
    if case == "ewald":
        fk = r.kspace(pos, h)[0].transpose(1, 2).contiguous()
    g0, n_tot = 0 * n_run, torch.full_like(n_run, 10)
    out, _, _ = MF.md_run(r, st6, vxi, n_run, fscal, True, False, fk, g0, n_tot, nbr=nbr)
    ref, _, _ = MF.md_run_plain(r, st6, vxi, n_run, fscal, True, False, fk, g0, n_tot, nbr=nbr)
    ref64, _, _ = MF.md_run_plain(r64, st6.double(), vxi.double(), n_run, fscal.double(), True,
                                  False, None if fk is None else fk.double(), g0, n_tot,
                                  nbr=nbr64)
    torch.cuda.synchronize()
    assert torch.equal(out[1], st6[1])
    assert _err(out[:, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4


@pytest.fixture(scope="module")
def peaa4096():
    """The 4096-atom charged PE box on K4's cluster form (above the shared
    form's 2509-atom cap), 4 jobs after FIRE 100."""
    dev = _device()
    sys, st = M.build_system(M.PEAA4096, dtype=torch.float32, device=dev)
    r = sys.fused
    assert r.spec.kernel == "K4" and MF.k4_big(r.spec, int(r.k34_tbl.shape[0]))
    st = E.minimize_fire(sys, st, n_steps=100, dt0=0.5)
    gen = torch.Generator().manual_seed(40)
    B = 4
    vel = torch.stack([E.maxwell_velocities(sys, T_MD, gen, torch.float32, dev)
                       for _ in range(B)])
    batch = E.MDState(pos=st.pos.expand(B, -1, -1).contiguous(), vel=vel,
                      h=st.h.expand(B, -1, -1).contiguous(),
                      vxi=torch.zeros((B, 3), device=dev))
    fk, _ = r.kspace(batch.pos, batch.h)
    return sys, batch, fk.transpose(1, 2).contiguous(), r.channels(batch.pos, batch.h)


@pytest.mark.parametrize("cuts", ["host", "across"])
def test_k4_big_run_matches_plain_and_skips_inactive(peaa4096, cuts):
    """K4's cluster form on a 10-step deform chunk with SHAKE and the frozen
    k-space force — on the host's cluster size (counted in
    launches_k4cluster only) and on 8 CTAs whose cuts split SHAKE
    constraints: the K3/K4 run bounds, a job with n_run = 0 bit-identical,
    the SHAKE residual below 1e-3."""
    sys, batch, fk, nbr = peaa4096
    B = batch.pos.shape[0]
    r = sys.fused
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 0, 7, 10], dtype=torch.int32, device=st.device)
    g0 = torch.tensor([0, 0, 10, 20], dtype=torch.int32, device=st.device)
    n_tot = torch.full_like(n_run, 30)
    args = (batch.vxi, n_run, fscal, True, False, fk, g0, n_tot)
    before = {k: getattr(MF.md_run, k) for k in ("launches_k4cluster", "launches_k4big",
                                                   "launches_k4")}
    if cuts == "host":
        out, vxi, _ = MF.md_run(r, st, *args, nbr=nbr)
    else:
        n = sys.n_atoms
        split = MF._shake_split(r)
        cut = [0] + [next(c for c in range(k * n // 8, n) if split[c]) for k in range(1, 8)] + [n]
        assert MF.k4_cluster_cuts(r, 8, cut)[1]
        out, vxi, _ = MF.k4_cluster_run(r, st, *args, nbr=nbr, cuts=cut)
    torch.cuda.synchronize()
    after = {k: getattr(MF.md_run, k) for k in before}
    assert after == {**before, "launches_k4cluster": before["launches_k4cluster"] + 1}
    assert torch.equal(out[1], st[1]) and torch.equal(vxi[1], batch.vxi[1])
    ref, _, _ = MF.md_run_plain(r, st, *args, nbr=nbr)
    ref64, _, _ = MF.md_run_plain(r.to(st.device, torch.float64), st.double(),
                                  batch.vxi.double(), n_run, fscal.double(), True, False,
                                  fk.double(), g0, n_tot, nbr=nbr)
    assert _err(out[:, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4
    cons = sys.constraints
    i, j = (torch.as_tensor(cons.idx[:, k], device=st.device) for k in (0, 1))
    d0sq = torch.as_tensor(cons.d0, device=st.device, dtype=torch.float64) ** 2
    ran = out[n_run > 0]
    rr = ran[:, :3, j].double() - ran[:, :3, i].double()
    assert float(((rr * rr).sum(1) - d0sq).abs().div(d0sq).max()) < 1e-3
    assert int(nbr["count"].max()) < r.spec.k


def test_k4_big_sampling_and_forces_match_plain(peaa4096):
    """On the 4096-atom box: 20-step pressure sums of K4's cluster form and
    the force entry (one form for both box sizes), to the K4 bounds."""
    sys, batch, fk, nbr = peaa4096
    st = MF.pack_state(batch.pos, batch.vel)
    n = torch.full((st.shape[0],), 20, dtype=torch.int32, device=st.device)
    fscal = MF.make_fscal(DT, T_MD, batch.h)
    one = torch.ones_like(n)
    r64 = sys.fused.to(st.device, torch.float64)
    _, _, pk = MF.md_run(sys.fused, st, batch.vxi, n, fscal, False, True, fk, 0 * n, one,
                         nbr=nbr)
    _, _, pp = MF.md_run_plain(sys.fused, st, batch.vxi, n, fscal, False, True, fk, 0 * n, one,
                               nbr=nbr)
    _, _, p64 = MF.md_run_plain(r64, st.double(), batch.vxi.double(), n, fscal.double(), False,
                                True, fk.double(), 0 * n, one, nbr=nbr)
    for c in range(6):
        assert _rel(pk[:, c], p64[:, c]) <= 4 * _rel(pp[:, c], p64[:, c]) + 1e-4, c
    pos = batch.pos.transpose(1, 2).contiguous()
    h6 = MF.h6_of(batch.h)
    F, W = MF.md_forces_virial(sys.fused, pos, h6, nbr=nbr)
    Fp, Wp = MF.md_forces_virial_plain(sys.fused, pos, h6, nbr)
    F64, W64 = MF.md_forces_virial_plain(r64, pos.double(), h6.double(), nbr)
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6
    plan = MF.k4_cluster_plan(sys.fused, st.shape[0])
    assert plan["clusters"] >= 1 and plan["smem_bytes"] <= 232448, plan
    assert plan["threads"] == min(1024, -(-plan["rows"] // 32) * 32), plan


def _charged(kernel, peaa, peaa2240):
    """(system, batch, frozen k-space force, the design's list: None for K3,
    K4's compact list for the path and its seven channels for the first
    design) of the PEAA (K3) or PEAA2240 (K4) fixture."""
    if kernel == "K3":
        sys, batch, fk = peaa
        return sys, batch, fk, {"path": None, "first": None}
    sys, batch, fk, nbr = peaa2240
    return sys, batch, fk, {"path": nbr, "first": sys.fused.channels_first(batch.pos, batch.h)}


_K34_COUNTER = {"K3": "launches_k3", "K4": "launches_k4"}


@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("design", ["path", "first"])
def test_k34_force_entry_designs_match_plain(peaa, peaa2240, kernel, design):
    """The force entry on the probe's twelve perturbed, tilted boxes: the
    redesign's tiles over (tile, box) blocks and the first design's one
    block per box, each within twice the plain float32 error against
    float64 (per atom 1e-5); each design counts its own launch only."""
    sys, batch, _, nbrs = _charged(kernel, peaa, peaa2240)
    dev = batch.pos.device
    gen = torch.Generator().manual_seed(12)
    pos = batch.pos[:1].expand(12, -1, -1) + 0.02 * torch.randn(
        (12, sys.n_atoms, 3), generator=gen).to(dev)
    h = batch.h[:1].expand(12, 3, 3).clone()
    h[:, 0, 1], h[6:, 0, 2] = 0.3, -0.2
    p, h6 = pos.transpose(1, 2).contiguous(), MF.h6_of(h)
    r = sys.fused
    nbr = r.channels(pos, h) if kernel == "K4" else None
    if kernel == "K4" and design == "first":
        nbr = r.channels_first(pos, h)
    entry, other = ((MF.md_forces_virial, MF._forces_first) if design == "path"
                    else (MF._forces_first, MF.md_forces_virial))
    attr = _K34_COUNTER[kernel]
    before, other_before = getattr(entry, attr), getattr(other, attr)
    F, W = entry(r, p, h6, nbr=nbr)
    torch.cuda.synchronize()
    assert getattr(entry, attr) == before + 1 and getattr(other, attr) == other_before
    Fp, Wp = MF.md_forces_virial_plain(r, p, h6, nbr)
    F64, W64 = MF.md_forces_virial_plain(r.to(dev, torch.float64), p.double(), h6.double(), nbr)
    assert torch.isfinite(F).all()
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6
    fn = F64.norm(dim=1)
    big = fn > 0.01 * fn.max()
    pa = float(((F.double() - F64).norm(dim=1)[big] / fn[big]).max())
    pp = float(((Fp.double() - F64).norm(dim=1)[big] / fn[big]).max())
    assert pa <= 2 * pp + 1e-5


@pytest.mark.parametrize("kernel", ["K3", "K4"])
@pytest.mark.parametrize("design", ["path", "first"])
def test_k34_run_designs_match_plain(peaa, peaa2240, kernel, design):
    """A 10-step deform chunk with SHAKE and the frozen k-space force on
    each design: within four times the plain float32 run's distance from
    float64, inactive jobs bit-identical, each design counting its own
    launch only."""
    sys, batch, fk, nbrs = _charged(kernel, peaa, peaa2240)
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 0, 7, 10], dtype=torch.int32, device=st.device)
    g0 = torch.tensor([0, 0, 10, 20], dtype=torch.int32, device=st.device)
    n_tot = torch.full_like(n_run, 30)
    args = (batch.vxi, n_run, fscal, True, False, fk, g0, n_tot)
    run, other = (MF.md_run, MF._run_first) if design == "path" else (MF._run_first, MF.md_run)
    attr = _K34_COUNTER[kernel]
    before, other_before = getattr(run, attr), getattr(other, attr)
    out, vxi, _ = run(sys.fused, st, *args, nbr=nbrs[design])
    torch.cuda.synchronize()
    assert getattr(run, attr) == before + 1 and getattr(other, attr) == other_before
    assert torch.equal(out[1], st[1]) and torch.equal(vxi[1], batch.vxi[1])
    ref, _, _ = MF.md_run_plain(sys.fused, st, *args, nbr=nbrs["path"])
    ref64, _, _ = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                  batch.vxi.double(), n_run, fscal.double(), True, False,
                                  fk.double(), g0, n_tot, nbr=nbrs["path"])
    assert _err(out[:, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_k34_special_weights_match_plain(peaa, peaa2240, kernel):
    """With OPLS's usual special_lj = special_coul = (0, 0, 0.5) the 1-4
    pairs are computed at half weight: K3 reads the weight from its window,
    K4 from the order in the slot word.  The force entry on twelve tilted
    boxes and a 10-step deform chunk (an inactive job bit-identical) are
    held to the rules of the zero-weight tests against float64."""
    sys, batch, fk, _ = _charged(kernel, peaa, peaa2240)
    dev = batch.pos.device
    half = (0.0, 0.0, 0.5)
    ff = dataclasses.replace(sys.ff, special_lj=half, special_coul=half)
    r0 = sys.fused
    r = MF.make_runner(ff, sys.masses, sys.units, dtype=torch.float32, device=dev,
                       constraints=sys.constraints, kspace=r0.kspace,
                       kspace_every=r0.kspace_every, nspec=r0.nspec,
                       rebuild_every=r0.rebuild_every)
    r64 = r.to(dev, torch.float64)
    assert r.spec.kernel == kernel and r.spec.special_lj == half
    gen = torch.Generator().manual_seed(14)
    pos = batch.pos[:1].expand(12, -1, -1) + 0.02 * torch.randn(
        (12, sys.n_atoms, 3), generator=gen).to(dev)
    h = batch.h[:1].expand(12, 3, 3).clone()
    h[:, 0, 1], h[6:, 0, 2] = 0.3, -0.2
    p, h6 = pos.transpose(1, 2).contiguous(), MF.h6_of(h)
    nbr = r.channels(pos, h) if kernel == "K4" else None
    if kernel == "K4":  # the 1-4 partners are kept, with order 3
        assert bool((((nbr["slot"] >> 28) & 3) == 3).any())
    F, W = MF.md_forces_virial(r, p, h6, nbr=nbr)
    Fp, Wp = MF.md_forces_virial_plain(r, p, h6, nbr)
    F64, W64 = MF.md_forces_virial_plain(r64, p.double(), h6.double(), nbr)
    torch.cuda.synchronize()
    assert torch.isfinite(F).all()
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6
    fn = F64.norm(dim=1)
    big = fn > 0.01 * fn.max()
    pa = float(((F.double() - F64).norm(dim=1)[big] / fn[big]).max())
    pp = float(((Fp.double() - F64).norm(dim=1)[big] / fn[big]).max())
    assert pa <= 2 * pp + 1e-5
    # the weights matter: the zero-weight runner's forces differ
    F0, _ = MF.md_forces_virial_plain(r0, p, h6, r0.channels(pos, h) if kernel == "K4" else None)
    assert _rel(F0, F64) > 100 * _rel(Fp, F64)
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=dev).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 0, 7, 10], dtype=torch.int32, device=dev)
    g0, n_tot = torch.tensor([0, 0, 10, 20], dtype=torch.int32, device=dev), 30 + 0 * n_run
    args = (batch.vxi, n_run, fscal, True, False, fk, g0, n_tot)
    nbr = r.channels(batch.pos, batch.h) if kernel == "K4" else None
    out, vxi, _ = MF.md_run(r, st, *args, nbr=nbr)
    ref, _, _ = MF.md_run_plain(r, st, *args, nbr=nbr)
    ref64, _, _ = MF.md_run_plain(r64, st.double(), batch.vxi.double(), n_run, fscal.double(),
                                  True, False, fk.double(), g0, n_tot, nbr=nbr)
    torch.cuda.synchronize()
    assert torch.equal(out[1], st[1]) and torch.equal(vxi[1], batch.vxi[1])
    assert _err(out[:, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4


@pytest.mark.parametrize("kernel", ["K3", "K4"])
def test_k34_kernels_occupancy(peaa, peaa2240, kernel):
    """The run kernel holds one block of a job per SM at its pinned width
    (K3 896 threads of two rows, K4 768) with no more local memory per
    thread than it was built with (K3 112 B, K4 80 B: the bonded pattern
    pass's role arrays, the per-step virial sums and K3's spills at its 72
    pinned registers, none inside the pair loops), the force kernel at
    least two blocks of 512 threads without spills."""
    sys = (peaa if kernel == "K3" else peaa2240)[0]
    T = int(sys.fused.k34_tbl.shape[0])
    run = MF.k34_kernel_info(kernel, "run", sys.n_atoms, T)
    forces = MF.k34_kernel_info(kernel, "forces", sys.n_atoms, T)
    assert run["blocks_per_sm"] == 1 and run["threads"] == {"K3": 896, "K4": 768}[kernel], run
    assert run["local_bytes"] <= {"K3": 112, "K4": 80}[kernel], run
    assert forces["blocks_per_sm"] >= 2 and forces["local_bytes"] == 0, forces


SI = M.MaterialSpec(name="si", force_field="sw")  # 3^3 diamond cells, 216 atoms


@pytest.fixture(scope="module", params=[(3, 3, 3), (4, 4, 5)], ids=["216", "640"])
def si(request):
    """SW boxes on K5: the slice's 216-atom box (one round of 224 threads)
    and the gate's largest, 640 atoms (two rounds of 512 threads), each
    batch with seeded displacements of 0.1 A, Maxwell velocities at 300 K
    and tilted boxes."""
    dev = _device()
    sys, st = M.build_system(dataclasses.replace(SI, n_cells_xyz=request.param),
                             dtype=torch.float32, device=dev)
    B = 6
    rng = np.random.default_rng(5)
    pos = st.pos + torch.as_tensor(rng.normal(scale=0.1, size=(B,) + tuple(st.pos.shape)),
                                   dtype=torch.float32, device=dev)
    h = st.h.expand(B, -1, -1).clone()
    h[:, 0, 1] = torch.linspace(-0.8, 0.8, B)
    h[:, 1, 2] = 0.3
    gen = torch.Generator().manual_seed(5)
    vel = torch.stack([E.maxwell_velocities(sys, T_MD, gen, torch.float32, dev)
                       for _ in range(B)])
    return sys, E.MDState(pos=pos, vel=vel, h=h, vxi=torch.zeros((B, 3), device=dev))


def test_k5_forces_virial_match_plain(si):
    """K5 is held to the K1 bounds: forces and virial within twice the plain
    float32 version's error against float64 (+1e-6)."""
    sys, batch = si
    assert sys.fused.spec.kernel == "K5"
    pos = batch.pos.transpose(1, 2).contiguous()
    h6 = MF.h6_of(batch.h)
    before = MF.md_forces_virial.launches_k5
    F, W = MF.md_forces_virial(sys.fused, pos, h6)
    torch.cuda.synchronize()
    assert MF.md_forces_virial.launches_k5 == before + 1
    Fp, Wp = MF.md_forces_virial_plain(sys.fused, pos, h6)
    F64, W64 = MF.md_forces_virial_plain(sys.fused.to(pos.device, torch.float64),
                                         pos.double(), h6.double())
    assert torch.isfinite(F).all() and torch.isfinite(W).all()
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6


def test_k5_run_matches_plain_and_skips_inactive(si):
    """A 10-step deform run: within four times the plain float32 run's
    distance from float64 (+1e-4); inactive jobs bit-identical."""
    sys, batch = si
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 0, 10, 7, 0, 3], dtype=torch.int32, device=st.device)
    before = MF.md_run.launches_k5
    out, vxi, _ = MF.md_run(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    torch.cuda.synchronize()
    assert MF.md_run.launches_k5 == before + 1
    for j in (1, 4):
        assert torch.equal(out[j], st[j]) and torch.equal(vxi[j], batch.vxi[j])
    ref, vxi_ref, _ = MF.md_run_plain(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    ref64, vxi64, _ = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                      batch.vxi.double(), n_run, fscal.double(), True, False)
    assert torch.isfinite(out).all()
    assert _err(out[:, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4
    assert _rel(vxi, vxi64) <= 4 * _rel(vxi_ref, vxi64) + 1e-4


def test_k5_sampling_pressure_sums_match_plain(si):
    """Each job's pressure sum over 20 sampling steps, per component, within
    four times the plain float32 run's distance from float64 (+1e-4)."""
    sys, batch = si
    st = MF.pack_state(batch.pos, batch.vel)
    n = torch.full((st.shape[0],), 20, dtype=torch.int32, device=st.device)
    fscal = MF.make_fscal(DT, T_MD, batch.h)
    _, _, pk = MF.md_run(sys.fused, st, batch.vxi, n, fscal, False, True)
    _, _, pp = MF.md_run_plain(sys.fused, st, batch.vxi, n, fscal, False, True)
    _, _, p64 = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                batch.vxi.double(), n, fscal.double(), False, True)
    for c in range(6):
        assert _rel(pk[:, c], p64[:, c]) <= 4 * _rel(pp[:, c], p64[:, c]) + 1e-4, c


@pytest.mark.parametrize("cap", [2, 8])
def test_k5_list_overflow_matches_plain(si, cap):
    """K5 with a live-list cap below some (8) or every (2) atom's live js:
    those atoms walk all N js in sweep 2, counted in the run's stats, and the
    run keeps the K1 bounds; at the path's cap no atom of these boxes
    overflows and the stats hold the most live js of an atom."""
    sys, batch = si
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 0, 10, 7, 0, 3], dtype=torch.int32, device=st.device)
    out, vxi, _, stats = MF.k5_run_stats(sys.fused, st, batch.vxi, n_run, fscal, True, False,
                                         cap=cap)
    _, _, _, s16 = MF.k5_run_stats(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    torch.cuda.synchronize()
    live = n_run > 0
    _, cnt = MF.k5_live_lists(sys.fused, batch.pos.transpose(1, 2).contiguous(),
                              MF.h6_of(batch.h), MF.K5_CAP)
    assert bool((stats[live, 0] > 0).all()) and bool((stats[~live] == 0).all())
    assert bool((s16[live, 0] == 0).all()) and bool((s16[:, 1] <= MF.K5_CAP).all())
    assert bool((s16[live, 1] >= cnt[live].amax(1).to(s16.dtype)).all())
    for j in (1, 4):
        assert torch.equal(out[j], st[j]) and torch.equal(vxi[j], batch.vxi[j])
    ref, _, _ = MF.md_run_plain(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    ref64, _, _ = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                  batch.vxi.double(), n_run, fscal.double(), True, False)
    assert _err(out[:, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4
    assert _rel(out[:, 3:], ref64[:, 3:]) <= 4 * _rel(ref[:, 3:], ref64[:, 3:]) + 1e-4


def test_k5_first_design_matches_plain(si):
    """K5's first design (md_sw.cu: both sweeps over all N js, one block per
    box in the force entry) to the K1 bounds, counted on its own wrappers."""
    sys, batch = si
    B = batch.pos.shape[0]
    pos = batch.pos.transpose(1, 2).contiguous()
    h6 = MF.h6_of(batch.h)
    before, path = MF._forces_first.launches_k5, MF.md_forces_virial.launches_k5
    F, W = MF._forces_first(sys.fused, pos, h6)
    torch.cuda.synchronize()
    assert MF._forces_first.launches_k5 == before + 1
    assert MF.md_forces_virial.launches_k5 == path
    Fp, Wp = MF.md_forces_virial_plain(sys.fused, pos, h6)
    r64 = sys.fused.to(pos.device, torch.float64)
    F64, W64 = MF.md_forces_virial_plain(r64, pos.double(), h6.double())
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6
    st = MF.pack_state(batch.pos, batch.vel)
    fscal = MF.make_fscal(DT, T_MD, batch.h, torch.full((B, 6), 5e-4, device=st.device))
    n_run = torch.tensor([10, 0, 10, 7, 0, 3], dtype=torch.int32, device=st.device)
    out, _, _ = MF._run_first(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    ref, _, _ = MF.md_run_plain(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    ref64, _, _ = MF.md_run_plain(r64, st.double(), batch.vxi.double(), n_run, fscal.double(),
                                  True, False)
    assert torch.equal(out[1], st[1])
    assert _err(out[:, :3], ref64[:, :3]) <= 4 * _err(ref[:, :3], ref64[:, :3]) + 1e-4


def test_k5_kernels_occupancy(si):
    """K5's run block is one thread per atom rounded to a warp (up to 512)
    at <= 64 registers: four blocks per SM at 216 atoms, two at 640; the
    force entry's kernels one warp per j slice."""
    sys, _ = si
    n = sys.n_atoms
    run = MF.k5_kernel_info("run", n)
    assert run["registers"] <= 64 and run["threads"] == min(-(-n // 32) * 32, 512), run
    assert run["blocks_per_sm"] >= (4 if n <= 256 else 2), run
    for entry in ("moments", "forces"):
        info = MF.k5_kernel_info(entry, n)
        assert info["threads"] == 32 * min(-(-n // 32), 16) and info["blocks_per_sm"] >= 1


@pytest.fixture(scope="module", params=[4, 8], ids=["512", "4096"])
def si_big(request):
    """SW boxes on the brick kernels (K6c/K6d/K6e): 512 atoms (8 bricks of
    the 96-atom target) and the brick slice's 4096 atoms (48 bricks, the
    full 27-stencil), each batch with seeded displacements of 0.1 A and
    tilted boxes."""
    dev = _device()
    sys, st = M.build_system(dataclasses.replace(SI, n_cells=request.param,
                                                 use_pallas_bricks=True),
                             dtype=torch.float32, device=dev)
    B = 4
    rng = np.random.default_rng(7)
    pos = st.pos + torch.as_tensor(rng.normal(scale=0.1, size=(B,) + tuple(st.pos.shape)),
                                   dtype=torch.float32, device=dev)
    h = st.h.expand(B, -1, -1).clone()
    h[:, 0, 1] = torch.linspace(-0.6, 0.6, B)
    h[:, 0, 2] = 0.2
    return sys, pos, h


def test_k6_moments_and_energy_match_plain(si_big):
    """K6d's channels and K6e's energy within twice the plain float32
    version's error against float64 (+1e-6)."""
    sys, pos, h = si_big
    ff = sys.ff
    sl = (ff.slot_ids, ff.nbr, ff.valid)
    before = (SWB.sw_moments_bricks.launches, SWB.sw_energy_bricks.launches)
    mom = SWB.sw_moments_bricks(ff.sw, pos, h, *sl)
    e = SWB.sw_energy_bricks(ff.sw, pos, h, *sl)
    torch.cuda.synchronize()
    assert (SWB.sw_moments_bricks.launches, SWB.sw_energy_bricks.launches) == (
        before[0] + 1, before[1] + 1)
    mp = SWB.sw_moments_bricks(ff.sw, pos, h, *sl, plain=True)
    m64 = SWB.sw_moments_bricks(ff.sw, pos.double(), h.double(), *sl, plain=True)
    e64 = SWB.energy_from_moments(ff.sw, m64)
    assert torch.isfinite(mom).all()
    assert _rel(mom, m64) <= 2 * _rel(mp, m64) + 1e-6
    assert _rel(e, e64) <= 2 * _rel(SWB.energy_from_moments(ff.sw, mp), e64) + 1e-6


def test_k6c_forces_energy_virial_match_plain(si_big):
    """K6c (after K6d and the adjoints): forces, energy and virial within
    twice the plain float32 version's error against float64 (+1e-6)."""
    sys, pos, h = si_big
    ff = sys.ff
    before = SWB.sw_forces_bricks.launches
    F, e, W = ff.forces_energy_virial(pos, h)
    torch.cuda.synchronize()
    assert SWB.sw_forces_bricks.launches == before + 1
    args = (ff.sw, ff.slot_ids, ff.nbr, ff.valid)
    Fp, ep, Wp = SWB.sw_forces_bricks(args[0], pos, h, *args[1:], plain=True)
    F64, e64, W64 = SWB.sw_forces_bricks(args[0], pos.double(), h.double(), *args[1:],
                                         plain=True)
    assert torch.isfinite(F).all() and torch.isfinite(W).all()
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(e, e64) <= 2 * _rel(ep, e64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6


def test_k6_first_design_matches_plain_and_path(si_big):
    """K6's first design (reached through _moments_first / _forces_first)
    and the path's kernels on the same tiles and adjoints: each within
    twice the plain float32 version's error against float64, and the two
    within that of each other."""
    sys, pos, h = si_big
    ff = sys.ff
    B, C = pos.shape[0], ff.n_bricks
    tiles = SWB.pack_bricks(pos, ff.slot_ids)
    hh, ih = SWB.boxes(h, (B,), torch.float32, pos.device)
    cnt = torch.empty((B, C, SWB.TILE), dtype=torch.int32, device=pos.device)
    lst = torch.empty((B, C, SWB.LIST_CAP, SWB.TILE), dtype=torch.int32, device=pos.device)
    sph = torch.empty((B, C, SWB.TILE // SWB.CHUNK, 4), dtype=torch.float32, device=pos.device)
    mom = SWB._launch_moments(ff.sw, tiles, ff.nbr, ff.valid, hh, ih, (cnt, lst), sph)
    before = (SWB._moments_first.launches, SWB._forces_first.launches)
    mom_f = SWB._moments_first(ff.sw, tiles, ff.nbr, ff.valid, hh, ih)
    adj = SWB.adjoints(ff.sw, mom)
    ov = torch.zeros(1, dtype=torch.int32, device=pos.device)
    fo = SWB._launch_forces(ff.sw, tiles, adj, ff.nbr, ff.valid, hh, ih, cnt, lst, ov)
    fo_f = SWB._forces_first(ff.sw, tiles, adj, ff.nbr, ff.valid, hh, ih)
    torch.cuda.synchronize()
    assert (SWB._moments_first.launches, SWB._forces_first.launches) == (before[0] + 1,
                                                                         before[1] + 1)
    assert int(ov) == 0 and int(cnt.max()) <= SWB.LIST_CAP
    # the kernel's live list and spheres against their plain models
    assert SWB.live_list_errors(ff.sw, tiles, ff.nbr, ff.valid, hh, ih, cnt, lst)[0] == 0
    sph_p = SWB.chunk_spheres_plain(tiles.double(), hh.double(), ih.double())
    assert float((sph.double() - sph_p).abs().max()) < 1e-3
    m64 = SWB.sw_moments_plain(ff.sw, tiles.double(), ff.nbr, ff.valid, hh.double(), ih.double())
    mp = SWB.sw_moments_plain(ff.sw, tiles, ff.nbr, ff.valid, hh, ih)
    f64 = SWB.sw_forces_plain(ff.sw, tiles.double(), adj.double(), ff.nbr, ff.valid,
                              hh.double(), ih.double())
    fp = SWB.sw_forces_plain(ff.sw, tiles, adj, ff.nbr, ff.valid, hh, ih)
    for k, kf, p_, r64 in ((mom, mom_f, mp, m64), (fo, fo_f, fp, f64)):
        tol = 2 * _rel(p_, r64) + 1e-6
        assert _rel(k, r64) <= tol and _rel(kf, r64) <= tol and _rel(k, kf) <= tol


def test_k6c_overflow_path_matches_plain(si_big):
    """A live-list cap of 2 sends most slots through the forces kernel's
    stencil sweep: counted in the overflow count, the list held to the
    sweep, and the forces channels within twice the plain float32
    version's error against float64 (+1e-6)."""
    sys, pos, h = si_big
    ff = sys.ff
    B, C = pos.shape[0], ff.n_bricks
    tiles = SWB.pack_bricks(pos, ff.slot_ids)
    hh, ih = SWB.boxes(h, (B,), torch.float32, pos.device)
    cnt = torch.empty((B, C, SWB.TILE), dtype=torch.int32, device=pos.device)
    lst = torch.empty((B, C, 2, SWB.TILE), dtype=torch.int32, device=pos.device)
    mom = SWB._launch_moments(ff.sw, tiles, ff.nbr, ff.valid, hh, ih, (cnt, lst))
    adj = SWB.adjoints(ff.sw, mom)
    ov = torch.zeros(1, dtype=torch.int32, device=pos.device)
    fo = SWB._launch_forces(ff.sw, tiles, adj, ff.nbr, ff.valid, hh, ih, cnt, lst, ov)
    torch.cuda.synchronize()
    assert int(ov) == int((cnt > 2).sum()) > 0
    assert SWB.live_list_errors(ff.sw, tiles, ff.nbr, ff.valid, hh, ih, cnt, lst)[0] == 0
    fp = SWB.sw_forces_plain(ff.sw, tiles, adj, ff.nbr, ff.valid, hh, ih)
    f64 = SWB.sw_forces_plain(ff.sw, tiles.double(), adj.double(), ff.nbr, ff.valid,
                              hh.double(), ih.double())
    assert torch.isfinite(fo).all()
    assert _rel(fo, f64) <= 2 * _rel(fp, f64) + 1e-6


def test_k6_kernels_fit_eight_blocks_per_sm():
    """The path's K6 moments and forces kernels hold <= 64 registers and at
    least eight 128-thread blocks per SM (__launch_bounds__(128, 8))."""
    _device()
    for which in ("moments", "forces"):
        info = SWB.kernel_info(which)
        assert info["registers"] <= 64 and info["blocks_per_sm"] >= 8, (which, info)


@pytest.mark.parametrize("q", [0.0, 0.5])
def test_k6a_k6b_match_plain(q):
    """K6a (all tile pairs, general q) and K6b (tile adjacency, q = 0) on a
    perturbed 512-atom box: channels within twice the plain float32
    version's error against float64 (+1e-6)."""
    dev = _device()
    sys, st = M.build_system(dataclasses.replace(SI, n_cells=4), dtype=torch.float32,
                             device=dev)
    sw = dataclasses.replace(SI.sw, q=q)
    pos = st.pos + torch.as_tensor(np.random.default_rng(8).normal(scale=0.1, size=st.pos.shape),
                                   dtype=torch.float32, device=dev)
    h = st.h.clone()
    h[0, 1] = 0.3
    tiles = SWB.pack_tiles(pos[None])
    hh, ih = SWB.boxes(h[None], (1,), torch.float32, dev)
    lists = [("K6a", SWB.all_tile_pairs(tiles.shape[1]))]
    if q == 0.0:
        lists.append(("K6b", SWB.tile_adjacency(pos.double().cpu().numpy(),
                                                h.double().cpu().numpy(), SI.sw.cutoff)))
    for name, (nbr, valid) in lists:
        nb, va = torch.as_tensor(nbr, device=dev), torch.as_tensor(valid, device=dev)
        fn = SWB.sw_moments if name == "K6a" else SWB.sw_moments_adj
        before = fn.launches
        mk = (SWB.sw_moments(sw, pos[None], h[None]) if name == "K6a"
              else SWB.sw_moments_adj(sw, pos[None], h[None], nb, va))
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        mp = SWB.sw_moments_plain(sw, tiles, nb, va, hh, ih)
        m64 = SWB.sw_moments_plain(sw, tiles.double(), nb, va, hh.double(), ih.double())
        assert torch.isfinite(mk).all()
        assert _rel(mk, m64) <= 2 * _rel(mp, m64) + 1e-6, name


def test_k6_unfused_run_matches_list_route(si_big):
    """Ten deform steps through the unfused engine on the brick kernels and
    on the list route (autograd of SW.energy) from one state agree to the
    float32 noise; a job with 0 steps comes back bit-identical."""
    sys, pos, h = si_big
    dev = pos.device
    n = sys.n_atoms
    sys_l, _ = M.build_system(dataclasses.replace(SI, n_cells=round((n / 8) ** (1 / 3)),
                                                  use_fused=False),
                              dtype=torch.float32, device=dev)
    B = pos.shape[0]
    gen = torch.Generator().manual_seed(9)
    vel = torch.stack([E.maxwell_velocities(sys, T_MD, gen, torch.float32, dev)
                       for _ in range(B)])
    st = E.MDState(pos=pos, vel=vel, h=h, vxi=torch.zeros((B, 3), device=dev))
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=dev).expand(B, 6)
    steps = torch.tensor([10, 0, 10, 20][:B], device=dev)
    ob = E.run_strain(sys, st, eps, steps, T_MD, DT)
    ol = E.run_strain(sys_l, st, eps, steps, T_MD, DT)
    assert torch.equal(ob.pos[1], pos[1]) and torch.equal(ob.vel[1], vel[1])
    assert torch.isfinite(ob.pos).all()
    assert float((ob.pos - ol.pos).abs().max()) < 1e-3


# P1's check runs: the lab's 576 jobs for 25 steps, so the image cache is
# refreshed once mid-run (every 20 steps, and before the first force call)
P1_JOBS, P1_STEPS = 576, 25


@pytest.fixture(scope="module")
def g0_slim():
    """P1's inputs: the prepared g0 box (the lab's v0 state), 576 jobs with
    their own Maxwell velocities and strains."""
    dev = _device()
    g0 = PA.prepared_g0(dev)
    state1, w4e, sig2, h6 = PA.slim_box(g0)
    nt = state1.shape[1]
    gen = torch.Generator().manual_seed(7)
    jobs = state1.expand(P1_JOBS, -1, -1, -1).clone()
    fscal = []
    for j in range(P1_JOBS):
        vel = E.maxwell_velocities(g0[0], T_MD, gen, torch.float32, dev)
        jobs[j, 3:6] = vel.T.reshape(3, nt, MS.LANE)
        eps = torch.rand(6, generator=gen, dtype=torch.float64).numpy() * 2e-3 - 1e-3
        fscal.append(torch.as_tensor(MS.make_fscal(h6.cpu().numpy(), eps), dtype=torch.float32))
    return jobs, w4e, sig2, torch.stack(fscal).to(dev), float(h6[0])


def _p1_programs(jobs, fscal, J):
    """(B, 8, NT, 128) jobs -> (B / J, 8, J NT, 128) programs and their fscal."""
    nt = jobs.shape[2]
    x = jobs.reshape(-1, J, 8, nt, MS.LANE).transpose(1, 2).reshape(-1, 8, J * nt, MS.LANE)
    return x, fscal[::J].contiguous()


@pytest.mark.parametrize("variant", list(MS.VARIANTS))
def test_p1_variant_matches_plain(g0_slim, variant):
    """P1 (ops.md_slim, the kernel lab's slim all-pairs runs): 25 steps of
    the lab's 576 jobs on the prepared g0 box, so the cached variants
    refresh their images mid-run; the kernel within four times the plain
    float32 run's distance from float64 (+1e-4) in positions, velocities,
    chain and 2 KE.  A program with n_run = 0 comes back bit-identical for
    the one-box variants; v7, v7d4 and v7p have no dead-job check, because
    their J boxes share one chain (a program runs all of them or none)."""
    jobs, w4e, sig2, fscal, _ = g0_slim
    v = MS.VARIANTS[variant]
    J = v.jobs
    x, fs = _p1_programs(jobs, fscal, J)
    P = x.shape[0]
    n_run = torch.full((P, 2), P1_STEPS, dtype=torch.int32, device=x.device)
    if J == 1:
        n_run[1, 0] = 0
    w, s = MS.variant_planes(variant, w4e, sig2)
    name = "launches_" + variant
    before = getattr(MS.slim_run, name)
    out, sacc = MS.slim_run(variant, x, w, s, n_run, fs)
    torch.cuda.synchronize()
    assert getattr(MS.slim_run, name) == before + 1
    if J == 1:
        assert torch.equal(out[1], x[1]) and torch.equal(sacc[1, :3], fs[1, 14:17])
    ref, sref = MS.slim_run_plain(variant, x, w, s, n_run, fs)
    r64, s64 = MS.slim_run_plain(variant, x.double(), w.double(), s.double(), n_run, fs.double())
    assert torch.isfinite(out).all() and torch.isfinite(sacc).all()
    for rows in (slice(0, 3), slice(3, 6)):  # positions, velocities
        assert _err(out[:, rows], r64[:, rows]) <= 4 * _err(ref[:, rows], r64[:, rows]) + 1e-4
    assert _rel(sacc[:, :4], s64[:, :4]) <= 4 * _rel(sref[:, :4], s64[:, :4]) + 1e-4
    assert torch.equal(out[:, 6:], x[:, 6:])


@pytest.mark.parametrize("variant", list(MS.VARIANTS))
def test_p1_image_guard_matches_plain(g0_slim, variant):
    """P1's int8 image cache: an atom 200 box lengths out (the same box, an
    image beyond int8) turns its program's positions NaN in the kernel and
    the plain version alike, and leaves the other program finite; v1 keeps
    no cache and stays finite."""
    jobs, w4e, sig2, fscal, lx = g0_slim
    v = MS.VARIANTS[variant]
    x, fs = _p1_programs(jobs[:2 * v.jobs], fscal[:2 * v.jobs], v.jobs)
    x = x.clone()
    x[1, 0, 0, 0] += 200.0 * lx
    n_run = torch.tensor([1, 1], dtype=torch.int32, device=x.device)
    w, s = MS.variant_planes(variant, w4e, sig2)
    out, _ = MS.slim_run(variant, x, w, s, n_run, fs)
    ref, _ = MS.slim_run_plain(variant, x, w, s, n_run, fs)
    for o in (out, ref):
        assert torch.isnan(o[:, :3]).flatten(1).any(1).tolist() == [False, v.cache]
        assert torch.isfinite(o[0]).all()
