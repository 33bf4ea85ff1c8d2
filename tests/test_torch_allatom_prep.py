"""The port's quick material prep and stiffness probe for the charged
all-atom PE material against the JAX package, float64, on the small
fixture of tests/test_allatom_fused.py (4 chains of C4H10, 56 atoms,
LJ/Coulomb cutoffs 5 / 4.5 A, validate=False).  JAX runs its XLA engine
(exact Ewald every step); the port runs K3's plain version with
kspace_every = 1.  ``cut`` uses coul/cut, ``ewald`` the dense Ewald sum.

Tolerances, each with its reason:
* quick prep (FIRE, FIRE + NVT with JAX's Maxwell draw injected, stress,
  length, density): coul/cut 1e-7 (measured ~1e-8); Ewald 5e-4 A and 5e-3
  relative — FIRE's 100 steps amplify the erfc polynomial's 1e-7 relative
  force difference (measured 1e-5 A after FIRE, 3e-5 A and 2e-4 relative
  velocities after NVT, 6e-5 relative stress);
* the stiffness probe from JAX's equilibrated state: coul/cut 1e-7
  relative (measured 2e-8); Ewald 5e-2.  From two independently prepared
  states the probe's 60-step FIRE relaxations amplify 1e-8 A differences
  into 1e-3 relative stiffness differences, so the probe is held on one
  shared state."""
import jax
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

from torch_port_util import np64, rel_err

COMMON = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
              pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False)
PREP = dict(temperature=300.0, dt=0.5, strain_rate=1e-4, nsteps_sample=20)
CASES = {"cut": dict(use_ewald=False), "ewald": dict(use_ewald=True)}


@pytest.fixture(scope="module", params=sorted(CASES))
def prep(request):
    extra = CASES[request.param]
    jsys, jst0 = JM.build_system(JM.MaterialSpec(**COMMON, **extra, use_fused=False))
    jp = JH.MDParams(**PREP)
    key = jax.random.PRNGKey(3)
    jmin = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=100, dt0=0.5))(jst0)
    jeq = JM.equilibrate(jsys, jst0, jp, key, minimize_steps=100, equil_steps=20)
    jdata = JM.measure(jsys, jeq, jp)
    jvel = JE.maxwell_velocities(jsys, key, PREP["temperature"], dtype=jeq.pos.dtype)
    tsys, tst0 = TM.build_system(TM.MaterialSpec(**COMMON, **extra, kspace_every=1),
                                 device="cpu")
    tp = TH.MDParams(**PREP)
    tmin = TE.minimize_fire(tsys, tst0, n_steps=100, dt0=0.5)
    teq = TM.equilibrate(tsys, tst0, tp, minimize_steps=100, equil_steps=20,
                         velocities=torch.as_tensor(np.array(jvel)))
    tdata = TM.measure(tsys, teq, tp)
    return request.param, (jsys, jmin, jeq, jdata), (tsys, tmin, teq, tdata)


def test_quick_prep_matches_jax(prep):
    case, (_, jmin, jeq, jdata), (_, tmin, teq, tdata) = prep
    pos_tol, rel_tol = (5e-4, 5e-3) if case == "ewald" else (1e-7, 1e-7)
    assert np.abs(np64(tmin.pos) - np.asarray(jmin.pos)).max() < pos_tol
    assert np.abs(np64(teq.pos) - np.asarray(jeq.pos)).max() < pos_tol
    assert rel_err(teq.vel, np.asarray(jeq.vel)) < rel_tol
    for field in ("length", "stress", "density"):
        assert rel_err(getattr(tdata, field), getattr(jdata, field)) < rel_tol, field
    assert np.isfinite(tdata.stiff).all() and tdata.stiff.shape == (6, 6)


def test_stiffness_probe_matches_jax(prep):
    """The stiffness probe (12 deformed boxes, 60 FIRE steps each, then
    the virial with the k-space remainder's) from JAX's equilibrated
    state.  Ewald: 5e-2 relative — 60 FIRE steps from a hot state amplify
    the erfc polynomial's 1e-7 force difference (measured 1e-2)."""
    case, (jsys, _, jeq, _), (tsys, _, _, _) = prep
    jp, tp = JH.MDParams(**PREP), TH.MDParams(**PREP)
    Cj = np.asarray(JH.stiffness_probe(jsys, jeq, jp))
    Ct = TH.stiffness_probe(tsys, interop.md_state(jeq), tp)
    assert rel_err(Ct, Cj) < (5e-2 if case == "ewald" else 1e-7)
