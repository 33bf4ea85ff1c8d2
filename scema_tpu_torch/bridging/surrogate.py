"""Learned surrogate constitutive model: sigma_new = f(eps_new, eps_pre,
sigma_pre) — stress computation method 2.

Torch twin of ``scema_tpu/bridging/surrogate.py`` (reference: a Keras MLP +
sklearn scaler called per quadrature point, surrogate_model/surrogate.py,
FE_problem.h:1489-1629 ``compute_stress_with_surrogate``; 18 floats in, 6
out): a small ``torch.nn`` MLP with a built-in input standardizer,
evaluated over every qp in one call on the FE device.  The 18 -> 64 -> 64
-> 6 products are plain ``nn.Linear`` layers, as the JAX package computes
them outside any Pallas kernel.

Weights come from :func:`train_surrogate`, from the reference's Keras files
(:func:`load_keras_surrogate`), from the JAX package's flax parameters
(:func:`surrogate_from_flax`) or from the port's own npz file
(:func:`save_surrogate` / :func:`load_surrogate`; the JAX package's pickle
holds a jax tree definition, which needs jax to read).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

N_IN, N_OUT = 18, 6


class SurrogateMLP(nn.Module):
    """18 -> 6 MLP of the reference interface: ReLU layers of widths
    ``hidden``, then a linear 6-wide output (flax ``nn.Dense`` computes x @
    kernel + bias; ``nn.Linear`` x @ weight.T + bias)."""

    def __init__(self, hidden: tuple = (64, 64), dtype=torch.float64, device=None):
        super().__init__()
        self.hidden = tuple(int(w) for w in hidden)
        widths = (N_IN,) + self.hidden + (N_OUT,)
        self.layers = nn.ModuleList(nn.Linear(a, b, dtype=dtype, device=device)
                                    for a, b in zip(widths[:-1], widths[1:]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for layer in self.layers[:-1]:
            x = torch.relu(layer(x))
        return self.layers[-1](x)


@dataclass(frozen=True)
class Surrogate:
    module: SurrogateMLP
    x_mean: torch.Tensor  # (18,) input standardizer (the sklearn scaler analog)
    x_std: torch.Tensor
    y_mean: torch.Tensor  # (6,)
    y_std: torch.Tensor

    def __call__(self, eps_new: torch.Tensor, eps_old: torch.Tensor,
                 sigma_old: torch.Tensor) -> torch.Tensor:
        """Batched prediction: (n_qp, 6) x3 -> (n_qp, 6) new stress, the
        input packed as the reference packs it (FE_problem.h:42-44):
        [strain_cur, strain_pre, stress_pre]."""
        x = torch.cat([eps_new, eps_old, sigma_old], dim=-1)
        with torch.no_grad():
            y = self.module((x - self.x_mean) / self.x_std)
        return y * self.y_std + self.y_mean

    def as_update_fn(self) -> Callable:
        """Adapter for ``fe_problem.apply_stress_update``'s surrogate_fn."""

        def fn(eps_old, eps_new, sigma_old):
            return self(eps_new, eps_old, sigma_old)

        return fn


def _lecun_normal_(layer: nn.Linear, generator: torch.Generator) -> None:
    """flax ``nn.Dense``'s default init: a normal of variance 1 / fan_in
    truncated at two standard deviations (rescaled so that the truncated
    draw keeps that variance), zero bias."""
    std = (1.0 / layer.in_features) ** 0.5 / 0.87962566103423978
    with torch.no_grad():
        w = torch.empty(layer.weight.shape, dtype=torch.float64)
        nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=generator)
        layer.weight.copy_(w)
        layer.bias.zero_()


def _standardizer(n: int, dtype, device) -> tuple:
    return (torch.zeros(n, dtype=dtype, device=device),
            torch.ones(n, dtype=dtype, device=device))


def init_surrogate(generator: torch.Generator | None = None, hidden=(64, 64),
                   dtype=torch.float64, device=None) -> Surrogate:
    """A fresh surrogate (flax's default init drawn from ``generator``) with
    the identity standardizer."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    module = SurrogateMLP(hidden, dtype=dtype, device=device)
    for layer in module.layers:
        _lecun_normal_(layer, generator)
    return Surrogate(module, *_standardizer(N_IN, dtype, device),
                     *_standardizer(N_OUT, dtype, device))


def train_surrogate(generator: torch.Generator | None, eps_new: torch.Tensor,
                    eps_old: torch.Tensor, sigma_old: torch.Tensor, sigma_new: torch.Tensor,
                    hidden=(64, 64), epochs: int = 500, lr: float = 1e-3, batch: int = 512,
                    module: SurrogateMLP | None = None) -> tuple[Surrogate, float]:
    """Fit the surrogate to harvested transitions (n, 6) x4 on their
    device and dtype; returns (model, the last batch's loss).  Adam with
    optax's defaults (beta 0.9 / 0.999, eps 1e-8) on the mean squared error
    of the standardized outputs, ``max(1, n // batch)`` batches per epoch
    from a permutation drawn from ``generator`` (CPU) every epoch, as the
    JAX trainer runs.  ``module`` starts from those weights (trained in
    place) instead of a fresh init from ``generator``."""
    generator = generator if generator is not None else torch.Generator().manual_seed(0)
    x = torch.cat([eps_new, eps_old, sigma_old], dim=-1)
    y = sigma_new
    x_mean, x_std = x.mean(0), x.std(0, correction=0) + 1e-12
    y_mean, y_std = y.mean(0), y.std(0, correction=0) + 1e-12
    xs, ys = (x - x_mean) / x_std, (y - y_mean) / y_std
    if module is None:
        module = init_surrogate(generator, hidden, x.dtype, x.device).module
    opt = torch.optim.Adam(module.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    n = xs.shape[0]
    steps_per_epoch = max(1, n // batch)
    loss = torch.tensor(float("inf"))
    for _ in range(epochs):
        perm = torch.randperm(n, generator=generator).to(x.device)
        for k in range(steps_per_epoch):
            sl = perm[k * batch:(k + 1) * batch]
            opt.zero_grad()
            loss = torch.mean((module(xs[sl]) - ys[sl]) ** 2)
            loss.backward()
            opt.step()
    return Surrogate(module, x_mean, x_std, y_mean, y_std), float(loss.detach())


def _from_dense(kernels, biases, x_mean, x_std, y_mean, y_std, dtype, device) -> Surrogate:
    """A surrogate from (in, out) dense kernels and their biases (flax and
    Keras layout), transposed into ``nn.Linear``'s (out, in) weights."""
    module = SurrogateMLP(tuple(int(k.shape[1]) for k in kernels[:-1]), dtype=dtype,
                          device=device)
    with torch.no_grad():
        for layer, k, b in zip(module.layers, kernels, biases, strict=True):
            layer.weight.copy_(torch.tensor(np.asarray(k, np.float64).T))
            layer.bias.copy_(torch.tensor(np.asarray(b, np.float64)))

    def t(v):
        return torch.as_tensor(np.asarray(v, np.float64), dtype=dtype, device=device)

    return Surrogate(module, t(x_mean), t(x_std), t(y_mean), t(y_std))


def surrogate_from_flax(params: dict, x_mean, x_std, y_mean, y_std, dtype=torch.float64,
                        device=None) -> Surrogate:
    """The JAX package's surrogate carried across: its flax parameters
    (``{"params": {"Dense_i": {"kernel", "bias"}}}``, or the inner dict) as
    numpy arrays and its standardizer."""
    p = params.get("params", params)
    names = sorted(p, key=lambda name: int(name.split("_")[-1]))
    return _from_dense([p[k]["kernel"] for k in names], [p[k]["bias"] for k in names],
                       x_mean, x_std, y_mean, y_std, dtype, device)


def save_surrogate(path: str, model: Surrogate) -> None:
    """The port's surrogate file: an npz of the layer widths, each layer's
    (out, in) weight and bias, and the standardizer."""
    arrays = {"hidden": np.asarray(model.module.hidden, np.int64)}
    for i, layer in enumerate(model.module.layers):
        arrays[f"weight_{i}"] = layer.weight.detach().cpu().numpy()
        arrays[f"bias_{i}"] = layer.bias.detach().cpu().numpy()
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        arrays[name] = getattr(model, name).detach().cpu().numpy()
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_surrogate(path: str, dtype=torch.float64, device=None) -> Surrogate:
    """A surrogate saved by :func:`save_surrogate`."""
    with np.load(path, allow_pickle=False) as z:
        n = len(z["hidden"]) + 1
        return _from_dense([z[f"weight_{i}"].T for i in range(n)],
                           [z[f"bias_{i}"] for i in range(n)], z["x_mean"], z["x_std"],
                           z["y_mean"], z["y_std"], dtype, device)


def load_keras_surrogate(model_path: str, scaler_path: str | None = None,
                         dtype=torch.float64, device=None) -> Surrogate:
    """The reference's pretrained Keras surrogate + sklearn scaler.

    reference: surrogate_model/model_small_uniaxial.bin is a Keras-2 HDF5
    save of a Sequential relu-Dense stack (18->18->36->72->72->36->18->6,
    linear output) and scaler.pkl a pickled sklearn MinMaxScaler fitted on
    the 18 inputs only (surrogate_model/surrogate.py:7-29 applies
    ``scaler.transform`` to the input, then ``model.predict``; the output is
    unscaled).  Keras ``Dense`` computes x @ kernel + bias with kernel (in,
    out), so each layer maps onto one ``nn.Linear`` with the kernel
    transposed.

    The scaler transform is xs = x * scale_ + min_; the standardizer form
    ``(x - x_mean) / x_std`` absorbs it with x_std = 1/scale_ and x_mean =
    -min_/scale_.  The pickle is parsed structurally (no sklearn import),
    so version skew in the pickled estimator is harmless."""
    import h5py

    with h5py.File(model_path, "r") as f:
        g = f["model_weights"]
        layer_names = [n.decode() if isinstance(n, bytes) else str(n)
                       for n in g.attrs["layer_names"]]
        kernels, biases = [], []
        for ln in layer_names:
            lg = g[ln]
            wnames = [w.decode() if isinstance(w, bytes) else str(w)
                      for w in lg.attrs["weight_names"]]
            kernels.append(np.array(lg[next(w for w in wnames if "kernel" in w)]))
            biases.append(np.array(lg[next(w for w in wnames if "bias" in w)]))
    x_mean, x_std = np.zeros(kernels[0].shape[0]), np.ones(kernels[0].shape[0])
    if scaler_path is not None:
        scale, mini = _read_minmax_scaler(scaler_path)
        x_std, x_mean = 1.0 / scale, -mini / scale
    n_out = biases[-1].shape[0]
    return _from_dense(kernels, biases, x_mean, x_std, np.zeros(n_out), np.ones(n_out),
                       dtype, device)


def _read_minmax_scaler(path: str):
    """(scale_, min_) of a pickled sklearn MinMaxScaler, without importing
    sklearn (the reference pickle predates current sklearn; a structural
    unpickler sidesteps the version check)."""
    import pickle

    class _Shell:
        def __init__(self, *a, **k):
            pass

        def __setstate__(self, state):
            self.__dict__.update(state if isinstance(state, dict) else {})

    # allowlist: only the numpy reconstruction globals the scaler payload
    # needs resolve to real callables; sklearn classes become inert shells
    # and anything else raises, so a hostile pickle cannot reach arbitrary
    # callables through __reduce__
    _NUMPY_ALLOWED = {
        ("numpy.core.multiarray", "_reconstruct"),
        ("numpy._core.multiarray", "_reconstruct"),
        ("numpy", "ndarray"),
        ("numpy", "dtype"),
    }

    class _Unpickler(pickle.Unpickler):
        def find_class(self, module, name):
            if module.startswith("sklearn"):
                return type(name, (_Shell,), {"__module__": module})
            if (module, name) in _NUMPY_ALLOWED:
                return super().find_class(module, name)
            raise pickle.UnpicklingError(
                f"scaler pickle requested disallowed global {module}.{name}")

    with open(path, "rb") as f:
        obj = _Unpickler(f).load()
    return (np.asarray(obj.scale_, dtype=np.float64), np.asarray(obj.min_, dtype=np.float64))
