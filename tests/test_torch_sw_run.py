"""K5's plain run entry against the JAX package's fused SW kernel in
interpret mode, float64, on the 64-atom diamond box (n_cells = 2): one
fix-deform run and one 10-step sampling run, as
tests/test_md_fused.py::test_sw_allpairs_fused_matches_xla drives them
(50 K, dt 0.5 fs, the same strain), from JAX's Maxwell draw.

Tolerances: positions and velocities 1e-9 (A, A/fs), thermostat 1e-9
relative, stress 1e-8 relative (measured on a CPU: positions within 2e-17
A, stress 2e-15 relative — the plain version repeats the TPU kernel's
arithmetic, so only the summation order differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import homogenization as JH
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import homogenization as TH
from scema_tpu_torch.md import material as TM

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

PARAMS = dict(temperature=50.0, dt=0.5, strain_rate=1e-3, nsteps_sample=10)
DL = [0.02, 0.0, -0.01, 0.0, 0.003, 0.0]


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def runs():
    jsys, jst = JM.build_system(JM.MaterialSpec(name="sic", force_field="sw", n_cells=2,
                                                use_fused=True))
    assert jsys.fused is not None and jsys.fused.spec.sw
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(4), 50.0))
    jp = JH.MDParams(**PARAMS)
    dl = jnp.asarray(DL)
    eps = JH.effective_strain(jst.h, dl)
    nts = JH.nts_for_strain(eps, jp)
    j1 = JE.run_strain(jsys, jst, eps, nts, jp.temperature, jp.dt)
    j2, jpress = JE.sample_stress(jsys, j1, jp.nsteps_sample, jp.temperature, jp.dt)

    tsys, _ = TM.build_system(TM.MaterialSpec(name="sic", force_field="sw", n_cells=2),
                              device="cpu")
    tst = interop.md_state(jst)
    tp = TH.MDParams(**PARAMS)
    teps = TH.effective_strain(tst.h, torch.as_tensor(DL, dtype=torch.float64))
    tnts = TH.nts_for_strain(teps, tp)
    t1 = TE.run_strain(tsys, tst, teps, tnts, tp.temperature, tp.dt)
    t2, tpress = TE.sample_stress(tsys, t1, tp.nsteps_sample, tp.temperature, tp.dt)
    return (int(nts), j1, j2, np.asarray(jpress)), (int(tnts), t1, t2, np64(tpress))


def test_deform_run_matches_pallas_interpret(runs):
    (jn, j1, _, _), (tn, t1, _, _) = runs
    assert tn == jn >= 10
    assert np.abs(np64(t1.pos) - np.asarray(j1.pos)).max() < 1e-9
    assert np.abs(np64(t1.vel) - np.asarray(j1.vel)).max() < 1e-9
    assert np.abs(np64(t1.h) - np.asarray(j1.h)).max() < 1e-12
    assert rel_err(np64(t1.vxi), np.asarray(j1.vxi)) < 1e-9


def test_sampling_run_matches_pallas_interpret(runs):
    (_, _, j2, jp), (_, _, t2, tp) = runs
    assert np.abs(np64(t2.pos) - np.asarray(j2.pos)).max() < 1e-9
    assert np.abs(np64(t2.vel) - np.asarray(j2.vel)).max() < 1e-9
    assert np.isfinite(tp).all() and rel_err(tp, jp) < 1e-8
