"""Shared helpers of the tests/test_torch_*.py files (the PyTorch port held
against the JAX package on the same inputs)."""
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
