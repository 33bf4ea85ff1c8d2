"""Shared helpers of the tests/test_torch_*.py files (the PyTorch port held
against the JAX package on the same inputs)."""
import dataclasses

import numpy as np
import pytest
import torch


def cuda_device():
    """The CUDA device for a kernel-vs-plain test, or skip.  Called inside
    tests, never at import, so every pytest worker collects the same tests."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def rel_err(a, b) -> float:
    """max |a - b| / max |b|."""
    a = np.asarray(a, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def leaves(x) -> list:
    """Every tensor and plain value of a carry or StepOutputs."""
    if dataclasses.is_dataclass(x):
        return [v for f in dataclasses.fields(x) for v in leaves(getattr(x, f.name))]
    if isinstance(x, (tuple, list)):
        return [v for y in x for v in leaves(y)]
    return [x]


def np64(x) -> np.ndarray:
    if torch.is_tensor(x):
        return x.detach().cpu().double().numpy()
    return np.asarray(x, dtype=np.float64)


@pytest.fixture(scope="module")
def one_torch_thread():
    """One intra-op thread for a module whose float64 tolerances are
    ~1e-12: on some hosts multi-threaded CPU elementwise kernels spread
    more than that from run to run."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def fixed_replica_data(monkeypatch, jax_coupling):
    """Make the JAX package's ``build_md_hmm`` (its module ``jax_coupling``)
    measure no replica: each gets the same replica data (its box lengths, a
    residual stress of 1e6 Pa in xx and yy, silicon's cubic stiffness,
    2330 kg/m^3).  For tests of the coupled step, which hand JAX's replica
    data to the port through ``prepared``: the stress sampling and the
    stiffness probe, and their compile, are held to JAX elsewhere
    (tests/test_torch_material.py)."""
    C = np.zeros((6, 6))
    C[:3, :3] = 64.0e9
    C[range(3), range(3)] = 166.0e9
    C[range(3, 6), range(3, 6)] = 80.0e9
    M = jax_coupling.M

    def measure(sys, state, params, **kw):
        return M.InitData(length=np.diag(np.asarray(state.h)).copy(),
                          stress=np.array([1.0e6, 1.0e6, 0.0, 0.0, 0.0, 0.0]), stiff=C.copy(),
                          density=2330.0)

    monkeypatch.setattr(M, "make_measure_fn", lambda *a, **k: None)
    monkeypatch.setattr(M, "measure", measure)
