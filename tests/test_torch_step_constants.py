"""The constants the coupled step needs on the device, made there without a
copy from host memory (which would make the host wait for the device), on
the CPU: the kept Voigt weights, each MD run's scalar rows
(``ops/md_fused.make_fscal``) and ``MDBackend.update``'s result mask, each
equal to the value the host copy gave.  The card's count of the step's
synchronising calls is ``tests/test_torch_trace.py``'s card test."""
import dataclasses

import pytest
import torch

from scema_tpu_torch.config import HMMConfig
from scema_tpu_torch.hmm.md_coupling import build_md_hmm
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.ops import md_fused as MF
from scema_tpu_torch.utils import tensors as T

# the tiny cells: a 48-site united-atom melt (K1) and the 64-atom diamond-Si
# box (K5) at each of a 1x1x2-cell dogbone's 16 qps, float64
SPECS = {"K1": dict(name="g0", force_field="opls", n_chains=8, chain_length=6,
                    opls_lj_cutoff=5.0, opls_coul_cutoff=5.0, validate=False),
         "K5": dict(name="sic", force_field="sw", n_cells=2)}


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_voigt_weights_are_kept(dtype):
    w = T.voigt_weights(dtype, torch.device("cpu"))
    assert w.dtype == dtype
    assert torch.equal(w, torch.tensor(T.VOIGT_WEIGHTS, dtype=dtype))
    assert T.voigt_weights(dtype, torch.device("cpu")) is w
    assert T.voigt_weights(dtype, "cpu") is w
    v = torch.arange(12, dtype=dtype).reshape(2, 6)
    T.voigt_norm(v)
    T.sym_contract_c66(torch.eye(6, dtype=dtype), v)
    assert torch.equal(w, torch.tensor(T.VOIGT_WEIGHTS, dtype=dtype))  # read, not written


def _by_hand(dt, T_, h, eps):
    """The scalar rows written one entry at a time from Python numbers."""
    f = torch.zeros((h.shape[0], MF.FSCAL), dtype=h.dtype)
    for b in range(h.shape[0]):
        f[b, MF.F_DT] = float(dt[b]) if torch.is_tensor(dt) else dt
        f[b, MF.F_T] = float(T_[b]) if torch.is_tensor(T_) else T_
        for k, (i, j) in enumerate(((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))):
            f[b, MF.F_H0 + k] = h[b, i, j]
        if eps is not None:
            for k in range(6):
                f[b, MF.F_EPS + k] = eps[b, k]
    return f


@pytest.mark.parametrize("with_eps", [False, True])
@pytest.mark.parametrize("batched", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_make_fscal_rows_bit_for_bit(dtype, batched, with_eps):
    gen = torch.Generator().manual_seed(3)
    B = 5
    h = torch.triu(torch.rand((B, 3, 3), generator=gen, dtype=torch.float64) + 20.0).to(dtype)
    eps = (torch.rand((B, 6), generator=gen, dtype=torch.float64) * 1e-3).to(dtype) \
        if with_eps else None
    # dt and T that float32 cannot hold exactly, so a second rounding would show
    dt, T_ = 2.0 / 3.0, 300.1
    if batched:
        dt = torch.full((B,), dt, dtype=dtype) * torch.linspace(1.0, 1.5, B, dtype=dtype)
        T_ = torch.full((B,), T_, dtype=dtype) + torch.arange(B, dtype=dtype)
    f = MF.make_fscal(dt, T_, h, eps)
    assert f.dtype == dtype and f.shape == (B, MF.FSCAL)
    assert torch.equal(f, _by_hand(dt, T_, h, eps))
    if not batched:  # a number and a (B,) tensor of it give the same rows
        assert torch.equal(f, MF.make_fscal(torch.full((B,), dt, dtype=dtype),
                                            torch.full((B,), T_, dtype=dtype), h, eps))


def _cfg(force_field):
    cfg = HMMConfig()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        md=cfg.md.__class__(temperature=300.0, timestep_length=2.0, strain_rate=1.0e-3,
                            nsteps_sample=20, force_field=force_field),
        md_dtype="float64")


@pytest.fixture(scope="module", params=sorted(SPECS))
def backend(request):
    spec = TM.MaterialSpec(**SPECS[request.param])
    hmm = build_md_hmm(_cfg(spec.force_field), spec=spec, device="cpu", equil_steps=10,
                       minimize_steps=20)
    be = hmm.backend
    assert be.sys.fused.spec.kernel == request.param
    return hmm, be


def _old_mask(jobs, K, timestep):
    """The job slots the update runs, scattered into a mask by a host
    ``True`` as the step did before: the flagged qps of the window rotated
    by ``timestep * K``, at most K."""
    n_qp = jobs.shape[0]
    offset = (timestep * K) % n_qp
    idx = torch.nonzero(torch.roll(jobs, -offset)).flatten()[:K]
    mask = torch.zeros((n_qp,), dtype=torch.bool)
    mask[(idx + offset) % n_qp] = True
    return mask


@pytest.mark.parametrize("K, timestep", [(16, 0), (3, 2)])
def test_update_masks_are_the_job_slots(backend, K, timestep):
    hmm, be = backend
    be = dataclasses.replace(be, max_jobs=K)
    micro = hmm.init_state()[1][0]
    n_qp = micro.has_run.shape[0]
    gen = torch.Generator().manual_seed(K)
    jobs = torch.zeros((n_qp,), dtype=torch.bool)
    jobs[torch.randperm(n_qp, generator=gen)[:7]] = True
    had_run = torch.zeros((n_qp,), dtype=torch.bool)
    had_run[:2] = True
    micro = micro._replace(has_run=had_run)
    eps = torch.rand((n_qp, 6), generator=gen, dtype=torch.float64) * 1e-4
    _, _, has_result, _ = out = be.update(
        micro, eps, torch.zeros((n_qp,), dtype=torch.long), jobs,
        torch.full((n_qp,), n_qp, dtype=torch.long), timestep=timestep)
    want = _old_mask(jobs, K, timestep)
    assert int(want.sum()) == min(K, 7)
    assert torch.equal(has_result, want)
    assert torch.equal(out[0].has_run, had_run | want)
