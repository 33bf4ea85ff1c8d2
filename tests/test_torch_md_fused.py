"""K1's plain version (the port's MD engine on the CPU) against the JAX
package, float64, on the small united-atom melt of tests/test_md_fused.py
(8 chains x 6 beads, 5 A cutoff, validate=False).

Tolerances, each with its reason:
* forces/virial vs the XLA engine's autodiff: 1e-9 (same pair set, only
  summation order differs — measured ~1e-13);
* 20-step strain / sampling runs vs the XLA engine (use_fused=False): pos
  1e-8 A, pressure 1e-6 relative.  The XLA system is built with
  rebuild_every=20 so both integrate the 20 steps on one force history: at
  a rebuild the XLA engine re-evaluates forces after the deform remap,
  which the fused kernel (TPU and port) does not — with the default 10-step
  chunks that alone moves positions by ~5e-6 A over 20 steps;
* the JAX Pallas kernel in interpret mode (NT = 1): 1e-10 — the same
  algorithm step for step;
* planes and topo rows: exact."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import material as JM
from scema_tpu.ops import md_fused as JMF

from scema_tpu_torch import interop
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.ops import md_fused as TMF

from torch_port_util import np64, rel_err

SMALL = dict(name="m", force_field="opls", n_chains=8, chain_length=6,
             opls_lj_cutoff=5.0, opls_coul_cutoff=5.0, validate=False)
T_MD, DT = 300.0, 2.0
EPS = [1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4]


@pytest.fixture(scope="module")
def melt():
    jsys, jst = JM.build_system(JM.MaterialSpec(**SMALL, use_fused=False, rebuild_every=20))
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, 40, dt0=0.5))(jst)
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(0), T_MD))
    tsys, _ = TM.build_system(TM.MaterialSpec(**SMALL), device="cpu")
    return jsys, jst, tsys, interop.md_state(jst)


def test_planes_and_topo_match_jax(melt):
    jsys_f, _ = JM.build_system(JM.MaterialSpec(**SMALL, use_fused=True))
    tsys = melt[2]
    n = tsys.n_atoms
    lj1, lj2 = interop.dense_planes(jsys_f.fused, n)
    assert torch.equal(tsys.fused.lj1, lj1) and torch.equal(tsys.fused.lj2, lj2)
    assert torch.equal(tsys.fused.topo, interop.lane_rows(jsys_f.fused.topo, n))
    ff = jsys_f.ff
    topo = JMF.pack_topo(ff.topo, ff.bonded, n, dtype=jnp.float64)
    assert torch.equal(tsys.fused.topo, interop.lane_rows(topo, n))


def test_forces_virial_match_jax(melt):
    jsys, jst, tsys, tst = melt
    rng = np.random.default_rng(1)
    pos = np.asarray(jst.pos) + 0.05 * rng.standard_normal(jst.pos.shape)
    h = np.asarray(jst.h).copy()
    h[0, 1] = 0.4  # a tilted box exercises the sequential triclinic image
    nbr = jsys.build_neighbors(jnp.asarray(pos), jnp.asarray(h))
    F, _, W = JE.forces_energy_virial(jsys, jnp.asarray(pos), jnp.asarray(h), nbr)
    Ft, Wt = TE.forces_virial(tsys, torch.as_tensor(pos), torch.as_tensor(h))
    W = np.asarray(W)
    W6 = np.array([W[0, 0], W[1, 1], W[2, 2], W[0, 1], W[0, 2], W[1, 2]])
    assert np.abs(np64(Ft) - np.asarray(F)).max() < 1e-9
    assert np.abs(np64(Wt) - W6).max() < 1e-9


def test_run_strain_matches_xla_engine(melt):
    jsys, jst, tsys, tst = melt
    jr = JE.run_strain(jsys, jst, jnp.asarray(EPS), jnp.asarray(20), T_MD, DT)
    tr = TE.run_strain(tsys, tst, torch.tensor(EPS, dtype=torch.float64), 20, T_MD, DT)
    assert np.abs(np64(tr.pos) - np.asarray(jr.pos)).max() < 1e-8
    assert np.abs(np64(tr.vel) - np.asarray(jr.vel)).max() < 1e-10
    assert np.abs(np64(tr.h) - np.asarray(jr.h)).max() < 1e-12
    assert np.abs(np64(tr.vxi) - np.asarray(jr.vxi)).max() < 1e-10


def test_sample_stress_matches_xla_engine(melt):
    jsys, jst, tsys, tst = melt
    jr, jp = JE.sample_stress(jsys, jst, 20, T_MD, DT)
    tr, tp = TE.sample_stress(tsys, tst, 20, T_MD, DT)
    assert np.abs(np64(tr.pos) - np.asarray(jr.pos)).max() < 1e-8
    assert rel_err(np64(tp), np.asarray(jp)) < 1e-6


def test_matches_pallas_kernel_interpret(melt):
    """One NT=1 comparison against the TPU kernel itself (fused_chunk in
    interpret mode, through run_strain_fused / sample_stress_fused)."""
    _, jst, tsys, tst = melt
    jsys_f, _ = JM.build_system(JM.MaterialSpec(**SMALL, use_fused=True))
    assert jsys_f.fused.spec.allpairs and jsys_f.fused.spec.nt == 1
    jf = JMF.run_strain_fused(jsys_f.fused, jst, jnp.asarray(EPS), jnp.asarray(10), T_MD, DT)
    tf = TE.run_strain(tsys, tst, torch.tensor(EPS, dtype=torch.float64), 10, T_MD, DT)
    assert np.abs(np64(tf.pos) - np.asarray(jf.pos)).max() < 1e-10
    assert np.abs(np64(tf.vel) - np.asarray(jf.vel)).max() < 1e-10
    assert np.abs(np64(tf.vxi) - np.asarray(jf.vxi)).max() < 1e-10
    _, jp = JMF.sample_stress_fused(jsys_f.fused, jst, 10, T_MD, DT)
    _, tp = TE.sample_stress(tsys, tst, 10, T_MD, DT)
    assert rel_err(np64(tp), np.asarray(jp)) < 1e-10


def test_inactive_job_is_bit_identical(melt):
    tsys, tst = melt[2], melt[3]
    batch = TE.MDState(*(torch.stack([x, x]) for x in (tst.pos, tst.vel, tst.h, tst.vxi)))
    eps = torch.tensor([EPS, EPS], dtype=torch.float64)
    out = TMF.run_strain_fused(tsys.fused, batch, eps, torch.tensor([0, 10]), T_MD, DT)
    for f in ("pos", "vel", "h", "vxi"):
        assert torch.equal(getattr(out, f)[0], getattr(tst, f))
        assert not torch.equal(getattr(out, f)[1], getattr(tst, f))
    out, press = TMF.sample_stress_fused(tsys.fused, batch, torch.tensor([10, 0]), T_MD, DT)
    assert torch.equal(out.pos[1], tst.pos) and torch.equal(press[1], torch.zeros(6, dtype=press.dtype))
    # a job's result does not depend on what else shares the launch
    single = TE.run_strain(tsys, tst, eps[1], 10, T_MD, DT)
    pair = TMF.run_strain_fused(tsys.fused, batch, eps, torch.tensor([10, 10]), T_MD, DT)
    assert torch.allclose(single.pos, pair.pos[0], rtol=0, atol=1e-12)
