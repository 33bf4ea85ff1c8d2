"""The port's list path end to end against the JAX package's fused list
path in interpret mode: ``run_strain`` of 10 steps with the list and the
k-space remainder refreshed every 5 steps (two chunks, each JAX chunk its
own ``fused_chunk`` call on its own rebuilt channels, the port's its own
list): 1e-10 A (measured ~3e-14; ~50 s)."""
import jax.numpy as jnp
import numpy as np
import torch

from scema_tpu.ops import md_fused as JMF

from scema_tpu_torch.md import engine as TE

from torch_list_util import DT, EPS, T_MD, systems


def test_run_strain_matches_fused_list_path():
    jsys, jst, tsys, tst = systems(kspace_every=5, rebuild_every=5)
    jr = JMF.run_strain_fused(jsys.fused, jst, jnp.asarray(EPS), jnp.asarray(10), T_MD, DT)
    tr = TE.run_strain(tsys, tst, torch.tensor(EPS, dtype=torch.float64), 10, T_MD, DT)
    assert np.abs(tr.pos.numpy() - np.asarray(jr.pos)).max() < 1e-10
    assert np.abs(tr.vel.numpy() - np.asarray(jr.vel)).max() < 1e-10
    assert np.abs(tr.h.numpy() - np.asarray(jr.h)).max() < 1e-12
    assert np.abs(tr.vxi.numpy() - np.asarray(jr.vxi)).max() < 1e-10
