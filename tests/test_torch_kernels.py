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
* K3 (the charged PEAA box: 1792 atoms, real-space Ewald, offset patterns,
  SHAKE, frozen k-space force) is held to the same relative bounds as K1:
  forces/virial 2x plain float32 + 1e-6, a 10-step deform chunk 4x plain +
  1e-4 with inactive jobs bit-identical, 20-step pressure sums 4x plain +
  1e-4; the SHAKE residual |r^2 - d0^2| / d0^2 after the chunk stays below
  1e-3;
* the other K3 flag sets (cutoff Coulomb, SHAKE off) on a small all-atom
  box, to the same bounds."""
import dataclasses

import numpy as np
import pytest
import torch

from scema_tpu_torch.md import engine as E
from scema_tpu_torch.md import material as M
from scema_tpu_torch.ops import md_fused as MF
from scema_tpu_torch.ops import pairwise_l2 as K2

pytestmark = pytest.mark.requires_cuda

G0 = M.MaterialSpec(name="g0", force_field="opls")  # 64 x 8 beads, 512 sites
PEAA = M.PEAA  # 56 x C10H22, 1792 charged atoms, PME split, SHAKE
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
