"""The port's unfused MD engine against the JAX package's XLA engine,
float64, on the CPU: the 216-atom diamond-Si Stillinger-Weber box with a
0.05 A jiggle and JAX's Maxwell velocities at 300 K, ``use_fused=False`` on
both sides (the port on its list route: autograd of ``SW.energy`` over the
dense-built 20-slot list; JAX on its neighbor lists).

* a 30-step deform run with shear (three 10-step neighbor chunks, forces
  re-evaluated after each chunk's remap), batched beside a 20-step run and a
  job with 0 steps, which comes back bit-identical;
* 20 sampling steps (one energy evaluation per step for the force and the
  virial);
* FIRE, 30 steps;
* the 12-box stiffness probe (FIRE relaxation of 20 steps per box), held
  to JAX's ``stiffness_probe`` arithmetic with its twelve boxes run as one
  vmapped program (the unbatched JAX probe compiles twelve programs: ~30 s
  on one core);
* the brick route's plain version (K6c/K6d on the unfused engine) against
  the same JAX list run;
* SHAKE/RATTLE on a constrained, charged box (its own fixture).

Tolerances: positions 1e-9 A, stress and stiffness 1e-8 relative (only
the summation order differs; measured ~1e-15 and ~1e-13).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import box as JB
from scema_tpu.md import engine as JE
from scema_tpu.md import homogenization as JH
from scema_tpu.md import material as JM
from scema_tpu.md.units import ATM_TO_PA

from scema_tpu_torch import interop
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import homogenization as TH
from scema_tpu_torch.md import material as TM

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

T, DT = 300.0, 2.0
EPS = np.array([[1e-3, -5e-4, 2e-4, 3e-3, -2e-3, 1e-3],
                [-8e-4, 6e-4, 0.0, -1e-3, 5e-4, 2e-3]])
PARAMS = dict(temperature=T, dt=DT, strain_rate=1e-4, nsteps_sample=20)
RELAX = 20

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _stack(st, n):
    return TE.MDState(*(torch.stack([getattr(st, f)] * n) for f in ("pos", "vel", "h", "vxi")))


def _jax_probe(jsys, st, up=1e-3):
    """homogenization.stiffness_probe (thermal=False) with its twelve
    deformed boxes vmapped: FIRE at fixed box, one virial, C from the
    pressure differences, symmetrised."""
    lt = JH._LAMMPS_TO_FRAMEWORK
    eps = np.zeros((12, 6))
    for d in range(6):
        eps[2 * d, lt[d]], eps[2 * d + 1, lt[d]] = up, -up

    def pressure_at(e):
        h1 = JB.deform_path(st.h, e, jnp.asarray(1.0))
        s = st._replace(pos=JB.remap_affine(st.h, h1, st.pos), h=h1)
        s = JE.minimize_fire(jsys, s, n_steps=RELAX, dt0=0.2)
        _, _, W = JE.forces_energy_virial(jsys, s.pos, s.h, jsys.build_neighbors(s.pos, s.h))
        return JE.pressure_tensor(jsys, s._replace(vel=jnp.zeros_like(s.vel)), W)

    P = np.asarray(jax.jit(jax.vmap(pressure_at))(jnp.asarray(eps)))
    C = np.zeros((6, 6))
    for d in range(6):
        C[:, lt[d]] = -(P[2 * d] - P[2 * d + 1]) / (2.0 * up) * ATM_TO_PA
    return 0.5 * (C + C.T)


@pytest.fixture(scope="module")
def runs():
    jsys, jst = JM.build_system(JM.MaterialSpec(name="si", force_field="sw", use_fused=False))
    assert jsys.fused is None
    pos = np.asarray(jst.pos) + 0.05 * np.random.default_rng(1).standard_normal(jst.pos.shape)
    jst = jst._replace(pos=jnp.asarray(pos),
                       vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(3), T))
    strain = jax.jit(lambda s, e, n: JE.run_strain(jsys, s, e, n, T, DT))
    j30 = strain(jst, jnp.asarray(EPS[0]), jnp.asarray(30))
    j20 = strain(jst, jnp.asarray(EPS[1]), jnp.asarray(20))
    js, jp = jax.jit(lambda s: JE.sample_stress(jsys, s, 20, T, DT))(j30)
    jfire = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=30, dt0=0.5))(
        jst._replace(vel=jnp.zeros_like(jst.vel)))
    return dict(st=jst, j30=j30, j20=j20, js=js, jp=np.asarray(jp), jfire=jfire,
                jC=_jax_probe(jsys, js))


@pytest.fixture(scope="module")
def port():
    sys_l, _ = TM.build_system(TM.MaterialSpec(name="si", use_fused=False), device="cpu")
    sys_b, _ = TM.build_system(TM.MaterialSpec(name="si", use_pallas_bricks=True), device="cpu")
    assert sys_l.fused is None and sys_b.fused is None and sys_b.ff.n_bricks == 2
    return sys_l, sys_b


def _strain3(sys_, st):
    """Jobs 30 steps (EPS[0]), 0 steps, 20 steps (EPS[1]) in one batch."""
    eps = torch.as_tensor(np.stack([EPS[0], EPS[0], EPS[1]]))
    return TE.run_strain(sys_, _stack(st, 3), eps, torch.tensor([30, 0, 20]), T, DT)


@pytest.mark.parametrize("route", ["list", "bricks"])
def test_deform_run_matches_xla_engine(runs, port, route):
    sys_ = port[0] if route == "list" else port[1]
    st = interop.md_state(runs["st"])
    out = _strain3(sys_, st)
    for j, ref in ((0, runs["j30"]), (2, runs["j20"])):
        assert np.abs(np64(out.pos[j]) - np.asarray(ref.pos)).max() < 1e-9
        assert rel_err(np64(out.vel[j]), np.asarray(ref.vel)) < 1e-9
        assert rel_err(np64(out.vxi[j]), np.asarray(ref.vxi)) < 1e-9
        assert np.abs(np64(out.h[j]) - np.asarray(ref.h)).max() < 1e-12
    for f in ("pos", "vel", "h", "vxi"):  # the 0-step job: bit-identical
        assert torch.equal(getattr(out, f)[1], getattr(st, f))
    assert abs(float(out.h[0, 0, 1] - st.h[0, 1])) > 1e-3  # the shear moved the tilt


@pytest.mark.parametrize("route", ["list", "bricks"])
def test_sampling_matches_xla_engine(runs, port, route):
    sys_ = port[0] if route == "list" else port[1]
    st, press = TE.sample_stress(sys_, interop.md_state(runs["j30"]), 20, T, DT)
    assert rel_err(np64(press), runs["jp"]) < 1e-8
    assert np.abs(np64(st.pos) - np.asarray(runs["js"].pos)).max() < 1e-9
    # per-job step counts: a 0-step job keeps its state and reports zero
    two = _stack(interop.md_state(runs["j30"]), 2)
    st2, p2 = TE.sample_stress(sys_, two, torch.tensor([20, 0]), T, DT)
    assert rel_err(np64(p2[0]), runs["jp"]) < 1e-8 and float(p2[1].abs().max()) == 0.0
    assert torch.equal(st2.pos[1], two.pos[1])


def test_fire_matches_xla_engine(runs, port):
    st = interop.md_state(runs["st"])
    st = st.replace(vel=torch.zeros_like(st.vel))
    for sys_ in port:
        out = TE.minimize_fire(sys_, st, n_steps=30, dt0=0.5)
        assert np.abs(np64(out.pos) - np.asarray(runs["jfire"].pos)).max() < 1e-9
    assert np.abs(np.asarray(runs["jfire"].pos) - np64(st.pos)).max() > 1e-3


def test_stiffness_probe_matches_xla_engine(runs, port):
    C = TH.stiffness_probe(port[0], interop.md_state(runs["js"]), TH.MDParams(**PARAMS),
                           relax_steps=RELAX)
    assert rel_err(np64(C), runs["jC"]) < 1e-8
    assert np.isfinite(runs["jC"]).all() and runs["jC"][0, 0] > 0


def test_constrained_nvt_matches_xla_engine():
    """SHAKE/RATTLE on the unfused engine: the charged all-atom PE fixture of
    tests/test_allatom_fused.py with coul/cut (4 C4H10 chains, 56 atoms,
    the C-H bonds rigid), tilted to xy = 0.3 A and relaxed by JAX's FIRE (40
    steps), 20 NVT steps of 1 fs from JAX's 300 K draw, ``use_fused=False`` on both sides: positions 1e-9 A
    and velocities 1e-9 relative, as above; the SHAKE residual max |r^2 -
    d0^2| below 1e-10 A^2."""
    spec = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
                pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False,
                use_fused=False)
    jsys, jst = JM.build_system(JM.MaterialSpec(**spec))
    tsys, _ = TM.build_system(TM.MaterialSpec(**spec), device="cpu")
    assert tsys.fused is None and tsys.constraints is not None
    h = np.array(jst.h)
    h[0, 1] = 0.3
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=40, dt0=0.5))(
        jst._replace(h=jnp.asarray(h)))
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(5), T))
    jout = jax.jit(lambda s: JE.run_nvt(jsys, s, 20, T, 1.0))(jst)
    tout = TE.run_nvt(tsys, interop.md_state(jst), 20, T, 1.0)
    assert np.abs(np64(tout.pos) - np.asarray(jout.pos)).max() < 1e-9
    assert rel_err(np64(tout.vel), np.asarray(jout.vel)) < 1e-9
    assert np.abs(np.asarray(jout.pos) - np.asarray(jst.pos)).max() > 1e-2
    c = tsys.constraints
    rr = np64(tout.pos)[c.idx[:, 1]] - np64(tout.pos)[c.idx[:, 0]]
    assert np.abs((rr * rr).sum(-1) - c.d0 ** 2).max() < 1e-10
