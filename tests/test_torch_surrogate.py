"""The port's surrogate constitutive model (``bridging/surrogate.py``,
stress computation method 2) against ``scema_tpu.bridging.surrogate``,
float64 on the CPU.  Tolerances, each with its reason:

* the forward pass with the flax weights carried across: 1e-12 relative
  (the same products in another summation order);
* training: from the same carried initial weights with all n <= batch rows
  in one batch per epoch (so both sides take the same batches, whatever
  their permutations), 40 epochs of Adam (optax's defaults) give weights
  within 1e-8 of JAX's.  Flax's ``Dense`` keeps float32 parameters even
  under x64, which would train JAX's weights in float32; the test gives
  JAX's trainer a float64-parameter copy of its MLP, so both sides train in
  float64;
* mirrors of tests/test_surrogate.py's train/predict (10% relative) and
  save/load (exact) cases;
* the Keras loader on an h5 file and a MinMaxScaler pickle written by the
  test (tests/torch_file_util.py): the same forward as JAX's loader on the
  same files to 1e-12;
* method 2 on a 1x1x2 Hooke dogbone (16 qps) for 3 steps: the stress field
  equals JAX's to 1e-10 relative (the small form of JAX's slow
  ``test_method2_hmm_runs_with_surrogate``);
* ``cli run --cpu --surrogate DIR --steps 2`` runs, and so does the same
  surrogate from the port's npz."""
import dataclasses
import json

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.bridging import surrogate as JS
from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.hmm.problem import build_hooke_hmm as j_build_hooke_hmm

from scema_tpu_torch import cli
from scema_tpu_torch.bridging import surrogate as TS
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.hmm.problem import build_hooke_hmm as t_build_hooke_hmm
from scema_tpu_torch.utils import tensors as T

from torch_file_util import write_keras_surrogate
from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

E_MOD, NU = 3.0e9, 0.35


def _harvest(n, seed=0):
    """Synthetic linear-elastic transitions sigma_new = sigma_old + C deps
    (tests/test_surrogate.py's, drawn with numpy)."""
    C = T.isotropic_c66(E_MOD, NU, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    eps_old = torch.as_tensor(1e-3 * rng.standard_normal((n, 6)))
    eps_new = eps_old + torch.as_tensor(1e-4 * rng.standard_normal((n, 6)))
    return (eps_new, eps_old, T.sym_contract_c66(C, eps_old), T.sym_contract_c66(C, eps_new))


def _np_params(params):
    return jax.tree_util.tree_map(np.asarray, params)


def test_forward_with_carried_flax_weights_matches_jax():
    rng = np.random.default_rng(1)
    jm = JS.init_surrogate(jax.random.PRNGKey(0))
    std = dict(x_mean=rng.standard_normal(18), x_std=rng.uniform(0.5, 2.0, 18),
               y_mean=rng.standard_normal(6), y_std=rng.uniform(0.5, 2.0, 6))
    jm = dataclasses.replace(jm, **{k: jnp.asarray(v) for k, v in std.items()})
    tm = TS.surrogate_from_flax(_np_params(jm.params), **std)
    assert tm.module.hidden == (64, 64) and tm.module.layers[0].weight.shape == (64, 18)
    x = [rng.standard_normal((32, 6)) for _ in range(3)]
    want = np.asarray(jm(*(jnp.asarray(a) for a in x)))
    got = tm(*(torch.as_tensor(a) for a in x))
    assert got.dtype == torch.float64 and rel_err(got, want) < 1e-12
    fn = tm.as_update_fn()  # (eps_old, eps_new, sigma_old)
    assert torch.equal(fn(*(torch.as_tensor(a) for a in (x[1], x[0], x[2]))), got)


class _MLP64(JS.SurrogateMLP):
    """JAX's SurrogateMLP with float64 parameters."""

    @nn.compact
    def __call__(self, x):
        for h in self.hidden:
            x = nn.relu(nn.Dense(h, param_dtype=jnp.float64)(x))
        return nn.Dense(6, param_dtype=jnp.float64)(x)


@pytest.fixture(scope="module")
def trained():
    """40 epochs on 256 transitions (one batch of 512 holds them all) on
    both sides from JAX's initial weights."""
    data = _harvest(256)
    key = jax.random.PRNGKey(2)
    mp = pytest.MonkeyPatch()
    mp.setattr(JS, "SurrogateMLP", _MLP64)
    try:
        params0 = _MLP64(hidden=(64, 64)).init(key, jnp.zeros((1, 18)))
        jm, jloss = JS.train_surrogate(key, *(jnp.asarray(np64(a)) for a in data), epochs=40,
                                       lr=3e-3)
    finally:
        mp.undo()
    one = np.ones(18)
    start = TS.surrogate_from_flax(_np_params(params0), 0 * one, one, 0 * one[:6], one[:6])
    tm, tloss = TS.train_surrogate(torch.Generator().manual_seed(2), *data, epochs=40, lr=3e-3,
                                   module=start.module)
    return jm, jloss, tm, tloss, params0


def test_training_matches_jax(trained):
    jm, jloss, tm, tloss, params0 = trained
    p, p0 = _np_params(jm.params)["params"], _np_params(params0)["params"]
    moved = 0.0
    for i, layer in enumerate(tm.module.layers):
        k = p[f"Dense_{i}"]
        assert np.abs(np64(layer.weight).T - k["kernel"]).max() < 1e-8
        assert np.abs(np64(layer.bias) - k["bias"]).max() < 1e-8
        moved = max(moved, float(np.abs(k["kernel"] - p0[f"Dense_{i}"]["kernel"]).max()))
    assert moved > 1e-2  # 40 Adam steps of 3e-3 moved the weights
    for name in ("x_mean", "x_std", "y_mean", "y_std"):
        assert rel_err(getattr(tm, name), np.asarray(getattr(jm, name))) < 1e-14
    assert abs(tloss - jloss) <= 1e-8 * jloss


def test_train_and_predict_linear_map():
    eps_new, eps_old, sigma_old, sigma_new = _harvest(4096)
    model, loss = TS.train_surrogate(torch.Generator().manual_seed(0), eps_new, eps_old,
                                     sigma_old, sigma_new, epochs=60, lr=3e-3)
    pred = model(eps_new[:256], eps_old[:256], sigma_old[:256])
    rel = float(torch.linalg.norm(pred - sigma_new[:256]) / torch.linalg.norm(sigma_new[:256]))
    assert rel < 0.1 and np.isfinite(loss)  # an MLP learns a linear map easily


def test_save_load_roundtrip(tmp_path):
    model = TS.init_surrogate(torch.Generator().manual_seed(1))
    x = torch.randn((5, 6), generator=torch.Generator().manual_seed(3), dtype=torch.float64)
    p = str(tmp_path / "surrogate.npz")
    TS.save_surrogate(p, model)
    model2 = TS.load_surrogate(p)
    assert model2.module.hidden == (64, 64)
    assert torch.equal(model(x, x, x), model2(x, x, x))


def _keras_files(directory, seed=0):
    """A reference-shaped Keras stack (18 -> 18 -> 36 -> 72 -> 72 -> 36 -> 18
    -> 6) and a MinMaxScaler for strains ~1e-2 and stresses ~1e8 Pa."""
    rng = np.random.default_rng(seed)
    widths = (18, 18, 36, 72, 72, 36, 18, 6)
    kernels = [rng.standard_normal((a, b)) / np.sqrt(a) for a, b in zip(widths, widths[1:])]
    biases = [0.1 * rng.standard_normal(b) for b in widths[1:]]
    span = np.r_[np.full(12, 0.1), np.full(6, 4e8)]
    write_keras_surrogate(directory, kernels, biases, scale=1.0 / span, min_=np.full(18, 0.5))
    return kernels, biases


def test_keras_loader_matches_jax(tmp_path):
    _keras_files(tmp_path)
    model, scaler = str(tmp_path / "model_small_uniaxial.bin"), str(tmp_path / "scaler.pkl")
    jm = JS.load_keras_surrogate(model, scaler)
    tm = TS.load_keras_surrogate(model, scaler)
    assert tm.module.hidden == jm.module.hidden == (18, 36, 72, 72, 36, 18)
    for name in ("x_mean", "x_std"):
        assert np.array_equal(np64(getattr(tm, name)), np.asarray(getattr(jm, name)))
    rng = np.random.default_rng(0)
    x = [rng.normal(0, 3e-2, (16, 6)), rng.normal(0, 3e-2, (16, 6)), rng.normal(0, 1e8, (16, 6))]
    want = np.asarray(jm(*(jnp.asarray(a) for a in x)))
    assert rel_err(tm(*(torch.as_tensor(a) for a in x)), want) < 1e-12


def _method2_cfg(cls):
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=5),
        bridging=cfg.bridging.__class__(stress_method=2, approx_md_with_hookes_law=False))


def test_method2_hooke_steps_match_jax(trained):
    jm, _, tm, _, _ = trained
    jh = j_build_hooke_hmm(_method2_cfg(JCfg), surrogate_fn=jm.as_update_fn())
    th = t_build_hooke_hmm(_method2_cfg(TCfg), device="cpu", surrogate_fn=tm.as_update_fn())
    assert th.ops.stress_method == 2
    js, ts, step = jh.init_state(), th.init_state(), jax.jit(jh.step)
    for _ in range(3):
        js, _ = step(js)
        ts, _ = th.step(ts)
    sig = np64(ts.qp.new_stress)
    assert np.isfinite(sig).all() and np.abs(sig).max() > 0.0
    assert rel_err(sig, np.asarray(js.qp.new_stress)) < 1e-10
    assert rel_err(np64(ts.u), np.asarray(js.u)) < 1e-10
    with pytest.raises(ValueError, match="requires a surrogate_fn"):
        t_build_hooke_hmm(_method2_cfg(TCfg), device="cpu").step(th.init_state())


@pytest.mark.parametrize("form", ["keras", "npz"])
def test_cli_run_with_surrogate(tmp_path, capsys, form):
    """``run --surrogate`` on the reference's Keras files (a directory) or
    on the port's npz of the same surrogate (which needs no h5py)."""
    _keras_files(tmp_path)
    path = tmp_path
    if form == "npz":
        path = tmp_path / "surrogate.npz"
        TS.save_surrogate(str(path), TS.load_keras_surrogate(
            str(tmp_path / "model_small_uniaxial.bin"), str(tmp_path / "scaler.pkl")))
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"continuum mesh": {"input": {
        "style": "cuboid", "x length": 0.03, "y length": 0.03, "z length": 0.08,
        "x cells": 1, "y cells": 1, "z cells": 2}}}))
    assert cli.main(["run", str(cfg), "--cpu", "--surrogate", str(path), "--steps", "2"]) == 0
    out = capsys.readouterr().out
    loaded = tmp_path / "model_small_uniaxial.bin" if form == "keras" else path
    assert f"Loaded surrogate {loaded}" in out
    assert "overriding 'stress computation method' 0 -> 2" in out
    assert "Max displacement: 0.00032 m" in out
