"""The port's quick material prep of the Stillinger-Weber silicon box
against the JAX package's XLA engine (``use_fused=False``), float64, on the
64-atom diamond box (n_cells = 2) at the JAX suite's settings
(tests/test_md_hmm.py: 0.01 K, dt 0.002 fs, 50 sampling steps, FIRE 50
+ NVT 50): ``equilibrate`` with JAX's Maxwell draw injected, then
``measure`` (stress sampling + the 12-box stiffness probe).  The port's
FIRE and probe take K5's force entry (its plain version here).

Tolerances: K5's forces against the XLA engine's autograd forces on a
perturbed box 1e-10 relative, virial 1e-9; FIRE on that box and the
prep's positions 1e-8 A, velocities and thermostat 1e-8 relative;
length, stress, stiffness and density 1e-8 relative (only the summation
order differs).  The JAX suite's physics checks hold on the port's
numbers: density 2329 kg/m^3 within 1%, C12/C11 = 76.4/151.4 within 8%,
C44/C11 = 56.4/151.4 within 25% (SW Si, E.R. Cowley 1988; the reference's
eV-as-kcal/mol unit quirk scales every constant alike).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import homogenization as JH
from scema_tpu.md import material as JM
from scema_tpu.md import neighbor as JNB

from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import homogenization as TH
from scema_tpu_torch.md import material as TM

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

SPEC = dict(name="sic", force_field="sw", n_cells=2)
PARAMS = dict(temperature=0.01, dt=0.002, strain_rate=1.0e-3, nsteps_sample=50)
MIN_STEPS, EQUIL_STEPS = 50, 50


pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def prep():
    jsys, jst0 = JM.build_system(JM.MaterialSpec(**SPEC, use_fused=False))
    assert jsys.fused is None
    jp = JH.MDParams(**PARAMS)
    key = jax.random.PRNGKey(0)
    jeq = JM.equilibrate(jsys, jst0, jp, key, minimize_steps=MIN_STEPS, equil_steps=EQUIL_STEPS)
    jdata = JM.measure(jsys, jeq, jp)
    jvel = JE.maxwell_velocities(jsys, key, max(PARAMS["temperature"], 1e-6),
                                 dtype=jeq.pos.dtype)

    tsys, tst0 = TM.build_system(TM.MaterialSpec(**SPEC), device="cpu")
    tp = TH.MDParams(**PARAMS)
    teq = TM.equilibrate(tsys, tst0, tp, minimize_steps=MIN_STEPS, equil_steps=EQUIL_STEPS,
                         velocities=torch.as_tensor(np.array(jvel)))
    tdata = TM.measure(tsys, teq, tp)
    return (jsys, jeq, jdata), (tsys, teq, tdata)


def test_forces_and_fire_match_xla_engine(prep):
    """On a perturbed box, where FIRE has work to do."""
    (jsys, _, _), (tsys, _, _) = prep
    _, jst0 = JM.build_system(JM.MaterialSpec(**SPEC, use_fused=False))
    pos = np.asarray(jst0.pos) + np.random.default_rng(3).normal(scale=0.05,
                                                                  size=jst0.pos.shape)
    h = np.array(jst0.h)
    jpos = jnp.asarray(pos)
    jF, _, jW = JE.forces_energy_virial(jsys, jpos, jst0.h, JNB.build(jsys.nspec, jpos, jst0.h))
    tF, tW = TE.forces_virial(tsys, torch.as_tensor(pos), torch.as_tensor(h))
    jW = np.asarray(jW)
    assert rel_err(np64(tF), np.asarray(jF)) < 1e-10
    jW6 = np.array([jW[0, 0], jW[1, 1], jW[2, 2], jW[0, 1], jW[0, 2], jW[1, 2]])
    assert rel_err(np64(tW), jW6) < 1e-9
    jmin = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=30, dt0=0.5))(
        jst0._replace(pos=jpos))
    tmin = TE.minimize_fire(tsys, TE.init_state(torch.as_tensor(pos), torch.as_tensor(h)),
                            n_steps=30, dt0=0.5)
    assert np.abs(np64(tmin.pos) - np.asarray(jmin.pos)).max() < 1e-8
    assert np.abs(np.asarray(jmin.pos) - pos).max() > 1e-3


def test_equilibrate_matches_jax(prep):
    (_, jeq, _), (_, teq, _) = prep
    assert np.abs(np64(teq.pos) - np.asarray(jeq.pos)).max() < 1e-8
    assert rel_err(np64(teq.vel), np.asarray(jeq.vel)) < 1e-8
    assert rel_err(np64(teq.vxi), np.asarray(jeq.vxi)) < 1e-8


@pytest.mark.parametrize("field", ["length", "stress", "stiff", "density"])
def test_measure_matches_jax(prep, field):
    jd, td = prep[0][2], prep[1][2]
    j, t = np.asarray(getattr(jd, field)), np.asarray(getattr(td, field))
    assert t.shape == j.shape and np.isfinite(t).all()
    assert rel_err(t, j) < 1e-8


def test_silicon_physics(prep):
    data = prep[1][2]
    assert np.allclose(data.length, 2 * 5.431, rtol=1e-3)
    assert np.isclose(data.density, 2329.0, rtol=0.01)
    C = data.stiff
    assert np.allclose(C, C.T, atol=1e-6 * abs(C[0, 0]))
    assert C[0, 0] > C[0, 1] > 0 and C[3, 3] > 0
    assert np.isclose(C[0, 1] / C[0, 0], 76.4 / 151.4, rtol=0.08)
    assert np.isclose(C[3, 3] / C[0, 0], 56.4 / 151.4, rtol=0.25)
