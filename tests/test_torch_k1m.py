"""K1m's redesign (csrc/md_k1m.cu: K1's run with J jobs per block, each
job's arithmetic K1's) takes K1's own operands: the host side of its launch
on the CPU, float64.

* The launch operands are K1's: the type table, codes, window and chain
  rows of the runner, with only the batch split in (G, J) blocks; the
  shared memory of a J-job block (J x 22 N floats + one table) lets two
  blocks of J = 2 share an SM on the g0 box and J = 4 fit one block.
* The (G, J) grouping: ``md_run_multi`` (on the CPU, K1's plain version
  over the grouped batch) equals ``md_run`` job by job, bit for bit, jobs of
  different lengths and zero-step pad jobs included, and a batch that is
  not a multiple of J is refused; ``run_strain_fused_multi`` and
  ``sample_stress_fused_multi`` over a (G, J) batch equal the unpacked
  runs job by job."""
import numpy as np
import pytest
import torch

from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.ops import md_fused as MF

from torch_port_util import one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(name="m", force_field="opls", n_chains=8, chain_length=6, opls_lj_cutoff=5.0,
             opls_coul_cutoff=5.0, validate=False)
T_MD, DT = 80.0, 1.0


@pytest.fixture(scope="module")
def melt():
    sys_, st = TM.build_system(TM.MaterialSpec(**SMALL), device="cpu")
    st = TE.minimize_fire(sys_, st, n_steps=20, dt0=0.5)
    gen = torch.Generator().manual_seed(3)
    B = 8
    vel = torch.stack([TE.maxwell_velocities(sys_, T_MD, gen) for _ in range(B)])
    batch = TE.MDState(pos=st.pos.expand(B, -1, -1).contiguous(), vel=vel,
                       h=st.h.expand(B, -1, -1).contiguous(),
                       vxi=torch.zeros((B, 3), dtype=torch.float64))
    return sys_, batch


def test_launch_operands_are_k1s():
    sys_, _ = TM.build_system(TM.MaterialSpec(name="g0", force_field="opls"), device="cpu")
    r = sys_.fused
    assert r.spec.kernel == "K1"
    a = MF._k1_args(r, 8)
    assert (a.tbl, a.code, a.win, a.topo) == (r.k1_tbl.data_ptr(), r.k1_code.data_ptr(),
                                              r.k1_win.data_ptr(), r.topo.data_ptr())
    T, n = int(r.k1_tbl.shape[0]), r.spec.n_atoms
    one = MF.k1_smem_bytes(r.spec, T)
    for J in MF.MULTI_JOBS:
        b = MF.k1m_smem_bytes(r.spec, J, T)
        assert b == 4 * (J * (22 * n + 32 * 12 + 4) + 2 * T * T)
        assert J * (one - 8 * T * T) < b < J * one  # one table for the block
    # two J = 2 blocks per SM (228 KB, 1 KB reserved per block); J = 4 fits one
    assert 2 * (MF.k1m_smem_bytes(r.spec, 2, T) + 1024) <= 228 * 1024
    assert MF.k1m_smem_bytes(r.spec, 4, T) <= MF._MAX_SMEM


@pytest.mark.parametrize("jobs", MF.MULTI_JOBS)
def test_grouping_equals_k1_per_job(melt, jobs):
    sys_, batch = melt
    r = sys_.fused
    B = batch.pos.shape[0]
    st = MF.pack_state(batch.pos, batch.vel)
    eps = torch.tensor([1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4], dtype=torch.float64).expand(B, 6)
    fscal = MF.make_fscal(DT, T_MD, batch.h, eps)
    n_run = torch.tensor([10, 7, 0, 3, 10, 0, 4, 10])
    out, vxi, _ = MF.md_run_multi(r, st, batch.vxi, n_run, fscal, True, False, jobs)
    for b in range(B):
        ref, xr, _ = MF.md_run(r, st[b:b + 1], batch.vxi[b:b + 1], n_run[b:b + 1],
                               fscal[b:b + 1], True, False)
        assert torch.equal(out[b], ref[0]) and torch.equal(vxi[b], xr[0]), b
    assert torch.equal(out[2], st[2]) and torch.equal(out[5], st[5])
    with pytest.raises(ValueError, match="not a multiple"):
        MF.md_run_multi(r, st[:B - 1], batch.vxi[:B - 1], n_run[:B - 1], fscal[:B - 1], True,
                        False, jobs)


@pytest.mark.parametrize("jobs", MF.MULTI_JOBS)
def test_grouped_runs_equal_unpacked(melt, jobs):
    sys_, batch = melt
    r = sys_.fused
    B = batch.pos.shape[0]
    G = B // jobs
    grouped = TE.MDState(*(x.reshape((G, jobs) + x.shape[1:])
                           for x in (batch.pos, batch.vel, batch.h, batch.vxi)))
    eps = torch.as_tensor(np.random.default_rng(4).uniform(-1e-3, 1e-3, (B, 6)))
    n = torch.tensor([10, 10, 0, 10, 10, 10, 10, 0])
    out = MF.run_strain_fused_multi(r, grouped, eps.reshape(G, jobs, 6), n.reshape(G, jobs),
                                    T_MD, DT)
    ref = MF.run_strain_fused(r, batch, eps, n, T_MD, DT)
    for f in ("pos", "vel", "h", "vxi"):
        assert torch.equal(getattr(out, f).reshape(getattr(ref, f).shape), getattr(ref, f)), f
    out_s, press = MF.sample_stress_fused_multi(r, grouped, n.reshape(G, jobs), T_MD, DT)
    ref_s, pref = MF.sample_stress_fused(r, batch, n, T_MD, DT)
    assert torch.equal(press.reshape(B, 6), pref)
    assert torch.equal(out_s.pos.reshape(ref_s.pos.shape), ref_s.pos)
