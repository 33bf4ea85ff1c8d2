"""The port's staged material prep (``equilibrate_staged``: FIRE, NVT, MTK
NPT heatup/cooldown) and its unfused OPLS route against scema_tpu.

Float64 on the CPU, both sides on the unfused engine (``use_fused=False``),
JAX's 200 K Maxwell draw injected into the port (torch cannot reproduce
``jax.random``).  Tolerances, each with its reason:
* ``equilibrate_staged`` at ns_init 10 (FIRE 20, NVT 10, NPT 90 steps) on
  the small melt of tests/test_md_fused.py:540-542 and on the 64-atom SW
  box: 1e-8 A in positions, 1e-8 relative in the box and velocities — the
  same steps in another summation order, grown along ~120 MD steps;
* the unfused OPLS engine (autograd of ``OPLS.energy``) against JAX's XLA
  engine over 20 strain steps (two neighbor chunks, forces re-evaluated
  after the remap on both sides): 1e-9 A."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import material as JM
from scema_tpu.md.homogenization import MDParams as JParams

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig
from scema_tpu_torch.hmm import md_coupling as MC
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md.homogenization import MDParams

from torch_port_util import np64, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MELT = dict(name="m", force_field="opls", n_chains=32, chain_length=6, opls_lj_cutoff=6.0,
            opls_coul_cutoff=6.0, validate=False, use_fused=False)
SI64 = dict(name="si", force_field="sw", n_cells=2, use_fused=False)
PARAMS = dict(temperature=300.0, dt=2.0, strain_rate=1e-4, nsteps_sample=10)


@pytest.mark.parametrize("spec", [MELT, SI64], ids=["melt", "si64"])
def test_equilibrate_staged_matches_jax(spec):
    jsys, jst = JM.build_system(JM.MaterialSpec(**spec))
    tsys, tst = TM.build_system(TM.MaterialSpec(**spec), device="cpu")
    assert tsys.fused is None and np.array_equal(np64(tst.pos), np.asarray(jst.pos))
    key = jax.random.PRNGKey(7)
    jout = jax.jit(lambda s: JM.equilibrate_staged(jsys, s, JParams(**PARAMS), key,
                                                   ns_init=10, minimize_steps=20))(jst)
    draw = torch.as_tensor(np.array(JE.maxwell_velocities(jsys, key, 200.0)))
    tout = TM.equilibrate_staged(tsys, tst, MDParams(**PARAMS), ns_init=10,
                                 minimize_steps=20, velocities=draw)
    h0 = float(jst.h[0, 0])
    assert abs(float(tout.h[0, 0]) - h0) > 1e-6 * h0  # the barostat moved the box
    assert np.abs(np64(tout.pos) - np.asarray(jout.pos)).max() < 1e-8
    assert np.abs(np64(tout.h) - np.asarray(jout.h)).max() < 1e-8 * h0
    vmax = np.abs(np.asarray(jout.vel)).max()
    assert np.abs(np64(tout.vel) - np.asarray(jout.vel)).max() < 1e-8 * vmax
    assert np.abs(np64(tout.vxi) - np.asarray(jout.vxi)).max() < 1e-8


def test_unfused_opls_strain_matches_xla_engine():
    jsys, jst = JM.build_system(JM.MaterialSpec(**MELT))
    tsys, _ = TM.build_system(TM.MaterialSpec(**MELT), device="cpu")
    assert tsys.fused is None and tsys.nspec is not None
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, 40, dt0=0.5))(jst)
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(2), 300.0))
    eps = [1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4]
    jr = jax.jit(lambda s: JE.run_strain(jsys, s, jnp.asarray(eps), jnp.asarray(20), 300.0,
                                         2.0))(jst)
    tr = TE.run_strain(tsys, interop.md_state(jst), torch.tensor(eps, dtype=torch.float64), 20,
                       300.0, 2.0)
    assert np.abs(np64(tr.pos) - np.asarray(jr.pos)).max() < 1e-9
    assert np.abs(np64(tr.h) - np.asarray(jr.h)).max() < 1e-12


def test_build_md_hmm_staged_runs_equilibrate_staged(monkeypatch):
    """``staged=True`` prepares each replica with ``equilibrate_staged`` at
    the given ns_init; the default is the quick prep."""
    calls = []
    staged = TM.equilibrate_staged

    def spy(*a, **kw):
        calls.append(kw["ns_init"])
        return staged(*a, **kw)

    monkeypatch.setattr(TM, "equilibrate_staged", spy)
    cfg = HMMConfig()
    cfg = cfg.replace(mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=1),
                      md_dtype="float64")
    spec = TM.MaterialSpec(name="g0", force_field="opls", n_chains=8, chain_length=6,
                           opls_lj_cutoff=5.0, opls_coul_cutoff=5.0, validate=False)
    hmm = MC.build_md_hmm(cfg, spec=spec, staged=True, ns_init=2, minimize_steps=10,
                          device="cpu")
    assert calls == [2] * cfg.material.number_of_replicas
    st = hmm.backend.initial_md_state
    assert torch.isfinite(st.pos).all() and torch.isfinite(hmm.backend.ensemble.rho).all()
    MC.build_md_hmm(cfg, spec=spec, equil_steps=5, minimize_steps=5, device="cpu")
    assert len(calls) == cfg.material.number_of_replicas
