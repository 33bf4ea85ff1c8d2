"""Where the port's entry points put their tensors."""
from __future__ import annotations

import torch


def resolve(device=None) -> torch.device:
    """``device``, or the current CUDA device when it is None.

    The port runs on one NVIDIA GPU: a caller that wants the CPU path (the
    float64 reference the tests use) asks for it with ``device="cpu"``.
    With no device given and no CUDA device present this raises, rather
    than running on the CPU unasked."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available: the port runs on one NVIDIA GPU; pass "
            "device='cpu' for the CPU reference path")
    return torch.device("cuda", torch.cuda.current_device())
