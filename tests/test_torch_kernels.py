"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA GPU and skips without one.  The file
imports torch and the port only (no JAX), so it runs on a machine that has
no JAX, with the repository's conftest left out:

    python -m pytest --noconftest tests/test_torch_kernels.py -q

Tolerances, each with its reason (float32 on both sides, same inputs):
* K2: 1e-5 relative — the kernel accumulates 60 squares with FMAs in
  another association than torch's reduction;
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
* K1m (K1 with J = 2 or 4 jobs per block): equal to K1 bit for bit, each
  job's step body being K1's code at K1's block width; a dead job of a
  (live, dead) pair comes back bit-identical;
* K3 (the charged PEAA box: 1792 atoms, real-space Ewald, offset patterns,
  SHAKE, frozen k-space force) is held to the same relative bounds as K1:
  forces/virial 2x plain float32 + 1e-6, a 10-step deform chunk 4x plain +
  1e-4 with inactive jobs bit-identical, 20-step pressure sums 4x plain +
  1e-4; the SHAKE residual |r^2 - d0^2| / d0^2 after the chunk stays below
  1e-3;
* the other K3 flag sets (cutoff Coulomb, SHAKE off) on a small all-atom
  box, to the same bounds;
* K4 (the gather-list pair loop) on the PEAA2240 box (2240 charged atoms,
  K ~ 1112 slots, the PME split, SHAKE) and on the other flag sets (g0
  chains, cutoff Coulomb, SHAKE off) with the same channels on both sides:
  the bounds of K3, inactive jobs bit-identical;
* K5 (the Stillinger-Weber sweeps) on the slice's 216-atom diamond-Si box
  and on the gate's largest, 640 atoms (two rounds of the block), with
  perturbed positions and tilted boxes: the bounds of K1, inactive jobs
  bit-identical;
* K6d/K6e (SW brick moments, energy) and K6c (adjoint forces, energy,
  virial) on 512- and 4096-atom boxes with perturbed positions and tilted
  boxes, K6a/K6b on a 512-atom box: the K1 force bounds; ten deform steps
  of the unfused engine on the bricks against the list route within 1e-3 A
  (float32 noise of two force orders), a 0-step job bit-identical."""
import dataclasses

import numpy as np
import pytest
import torch

from scema_tpu_torch.md import engine as E
from scema_tpu_torch.md import material as M
from scema_tpu_torch.ops import md_fused as MF
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


@pytest.mark.parametrize("jobs", [2, 4])
def test_k1m_equals_k1(g0, jobs):
    """K1m (J jobs per block) runs each job's step body in K1's order at
    K1's block width: deform and sampling runs equal K1's bit for bit,
    jobs of different lengths included."""
    sys, batch = g0
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], device=st.device).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 7, 10, 3, 10, 10, 4, 10], dtype=torch.int32, device=st.device)
    before = MF.md_run_multi.launches_k1m
    out, vxi, _ = MF.md_run_multi(sys.fused, st, batch.vxi, n_run, fscal, True, False, jobs)
    torch.cuda.synchronize()
    assert MF.md_run_multi.launches_k1m == before + 1
    ref, vxi_ref, _ = MF.md_run(sys.fused, st, batch.vxi, n_run, fscal, True, False)
    assert torch.equal(out, ref) and torch.equal(vxi, vxi_ref)
    f_s = MF.make_fscal(DT, T_MD, batch.h)
    n20 = torch.full((B,), 20, dtype=torch.int32, device=st.device)
    _, _, pk = MF.md_run_multi(sys.fused, out, vxi, n20, f_s, False, True, jobs)
    _, _, pr = MF.md_run(sys.fused, out, vxi, n20, f_s, False, True)
    assert torch.equal(pk, pr)


def test_k1m_dead_job_is_bit_identical(g0):
    """A (live, dead) pair: the dead job comes back untouched with zero
    pressure, the live one as K1 runs it alone."""
    sys, batch = g0
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    fscal = MF.make_fscal(DT, T_MD, batch.h)
    n_run = torch.tensor([20, 0] * (B // 2), dtype=torch.int32, device=st.device)
    out, vxi, p = MF.md_run_multi(sys.fused, st, batch.vxi, n_run, fscal, False, True, 2)
    ref, _, pr = MF.md_run(sys.fused, st[0::2], batch.vxi[0::2], n_run[0::2], fscal[0::2],
                           False, True)
    torch.cuda.synchronize()
    assert torch.equal(out[1::2], st[1::2]) and torch.equal(vxi[1::2], batch.vxi[1::2])
    assert torch.equal(p[1::2], torch.zeros_like(p[1::2]))
    assert torch.equal(out[0::2], ref) and torch.equal(p[0::2], pr)


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
    nbr64 = {k: v if k == "idx" else v.double() for k, v in nbr.items()}
    F64, W64 = MF.md_forces_virial_plain(sys.fused.to(pos.device, torch.float64), pos.double(),
                                         h6.double(), nbr64)
    assert _rel(F, F64) <= 2 * _rel(Fp, F64) + 1e-6
    assert _rel(W, W64) <= 2 * _rel(Wp, W64) + 1e-6
    # no list row is full: every atom keeps a dead (self-padded) slot
    n = sys.n_atoms
    live = nbr["idx"] != torch.arange(n, dtype=torch.int32, device=pos.device)
    assert int(live.sum(1).max()) < sys.fused.spec.k


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
    nbr64 = {k: v if k == "idx" else v.double() for k, v in nbr.items()}
    ref64, vxi64, _ = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                      batch.vxi.double(), n_run, fscal.double(), True, False,
                                      fk.double(), g0, n_tot, nbr=nbr64)
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
    nbr64 = {k: v if k == "idx" else v.double() for k, v in nbr.items()}
    _, _, p64 = MF.md_run_plain(sys.fused.to(st.device, torch.float64), st.double(),
                                batch.vxi.double(), n, fscal.double(), False, True,
                                fk.double(), 0 * n, one, nbr=nbr64)
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
    nbr = r.channels(pos, h)
    nbr64 = {k: v if k == "idx" else v.double() for k, v in nbr.items()}
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
