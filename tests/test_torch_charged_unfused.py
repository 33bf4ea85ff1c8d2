"""The host constraint sweeps, the Ewald/PME energy of ``OPLS.energy`` and
the host MD loops on a constrained, charged box, against scema_tpu.

Float64 on the CPU, on the small charged all-atom PE fixture of
tests/test_allatom_fused.py (4 C4H10 chains, 56 atoms, LJ/Coulomb cutoffs
5 / 4.5 A, SHAKE on the C-H bonds, validate=False).  JAX's results are
shared through one module fixture.  Tolerances, each with its reason:

* (a) ``shake_positions`` / ``rattle_velocities`` against JAX's: 1e-12 (A,
  A/fs) — the same sweeps, the segment sums in another order (measured
  ~1e-15); against K3's plain roll sweeps (``md_fused.shake_rolls_plain``
  / ``rattle_rolls_plain``): 1e-10, the bound tests/test_fused_constraints.py
  holds JAX's rolls to (the rolls sum per offset, not per constraint);
* (b) ``OPLS.energy`` and ``engine.forces_energy_virial`` against JAX's
  XLA engine, Ewald and PME, orthorhombic and at xy = 0.3: 1e-10 relative
  to the largest entry (only the summation order differs; measured
  ~5e-15).  On the tilted box both take the reciprocal sum's volume from
  the diagonal of the deformed cell, so the port follows the XLA engine's
  virial there (ROADMAP §3, "the Ewald virial on tilted boxes");
* the fused route (K3's plain entry + the PME remainder) against the
  unfused engine with the exact erfc swapped in: 1e-13 (measured ~5e-15);
* (c)-(d) ``run_strain``, ``sample_stress`` and ``run_npt`` (MTK and
  Berendsen), ``use_fused=False`` on both sides, 20 steps from JAX's
  prepared state: 1e-8 A in positions, 1e-8 relative in pressure, box and
  velocities (measured ~1e-13); the SHAKE residual max |r^2 - d0^2| below
  1e-10 A^2 where no box scaling follows the last SHAKE (sampling, MTK);
* (e) ``equilibrate_staged`` at ns_init 10 (FIRE 100, NVT 10, NPT 90 steps
  of 0.5 fs) on the K3 route (its plain version, kspace_every = 1) against
  JAX's XLA prep with JAX's Maxwell draw injected: 5e-4 A and 5e-3
  relative, the bounds tests/test_torch_allatom_prep.py states for K3's
  erfc polynomial against the exact erfc (measured 2.6e-5 A and 1.3e-4);
* (f) ``build_md_hmm(staged=True)`` calls ``equilibrate_staged`` and runs a
  macro-step (finite, SHAKE residual below 1e-8 A^2: converged sweeps).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import constraints as JCN
from scema_tpu.md import engine as JE
from scema_tpu.md import material as JM
from scema_tpu.md.homogenization import MDParams as JParams

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig
from scema_tpu_torch.hmm import md_coupling as MC
from scema_tpu_torch.md import constraints as TCN
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md.homogenization import MDParams
from scema_tpu_torch.ops import md_fused as MF

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

PE = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
          pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False,
          use_ewald=True)
# tests/test_torch_allatom_prep.py's prep parameters
PREP = dict(temperature=300.0, dt=0.5, strain_rate=1e-4, nsteps_sample=10)
T, DT = 300.0, 0.5
EPS = [1e-3, 0.0, -5e-4, 2e-3, 0.0, 1e-3]
NPT = {"mtk": {}, "berendsen": {"compressibility": 2e-4}}


def _tilted(h, xy=0.3):
    h = np.array(h, dtype=np.float64)
    h[0, 1] = xy
    return h


# equilibrate_staged's NPT stages at ns_init 10 (material.py:887-890)
STAGES = ((10, 300.0, 500.0), (50, 500.0, 500.0), (10, 500.0, T), (20, T, T))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's XLA engine (``use_fused=False``) on the fixture: its staged
    prep at ns_init 10 (``material.equilibrate_staged``'s calls in its
    order, each jitted with the temperatures traced so that the stages of
    one length, and (d)'s 20-step MTK run, share one program), then from
    its state 20 strain steps, 20 sampling steps and 20 NPT steps of each
    barostat."""
    jsys, jst = JM.build_system(JM.MaterialSpec(**PE, use_fused=False))
    key = jax.random.PRNGKey(7)
    npt = jax.jit(lambda s, t0, t1, n, b: JE.run_npt(jsys, s, n, t0, t1, DT, barostat=b,
                                                     **NPT[b]), static_argnums=(3, 4))
    staged = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=100, dt0=0.5))(jst)
    draw = JE.maxwell_velocities(jsys, key, 200.0, dtype=staged.pos.dtype)
    staged = jax.jit(lambda s, t: JE.run_nvt(jsys, s, 10, t, DT))(staged._replace(vel=draw),
                                                                   300.0)
    for n, t0, t1 in STAGES:
        staged = npt(staged, t0, t1, n, "mtk")
    strain = jax.jit(lambda s: JE.run_strain(jsys, s, jnp.asarray(EPS), jnp.asarray(20), T,
                                             DT))(staged)
    sampled, press = jax.jit(lambda s: JE.sample_stress(jsys, s, 20, T, DT))(strain)
    return dict(sys=jsys, st0=jst, staged=staged, draw=np.array(draw), strain=strain,
                sampled=sampled, press=np.asarray(press),
                npt={b: npt(staged, T, 350.0, 20, b) for b in NPT})


@pytest.fixture(scope="module")
def port():
    sys_, st = TM.build_system(TM.MaterialSpec(**PE, use_fused=False), device="cpu")
    assert sys_.fused is None and sys_.constraints is not None
    return sys_, st


def _residual(sys_, pos) -> float:
    c = sys_.constraints
    p = np64(pos)
    rr = p[..., c.idx[:, 1], :] - p[..., c.idx[:, 0], :]
    return float(np.abs((rr * rr).sum(-1) - c.d0 ** 2).max())


@pytest.mark.parametrize("xy", [0.0, 0.3], ids=["ortho", "tilted"])
def test_shake_rattle_match_jax_and_k3_rolls(jax_runs, port, xy):
    jsys, jst = jax_runs["sys"], jax_runs["st0"]
    tsys, _ = port
    cons = tsys.constraints
    jc = jsys.constraints
    assert np.array_equal(cons.idx, np.asarray(jc.idx)) and np.allclose(cons.d0, jc.d0)
    rng = np.random.default_rng(11)
    old = np.array(jst.pos)
    new = old + 0.05 * rng.standard_normal(old.shape)
    vel = 0.01 * rng.standard_normal(old.shape)
    h = _tilted(jst.h, xy)
    m = np.array(jsys.masses)
    js = np.array(JCN.shake_positions(jc, jnp.asarray(old), jnp.asarray(new),
                                        jnp.asarray(h), 1.0 / jnp.asarray(m)))
    jr = np.asarray(JCN.rattle_velocities(jc, jnp.asarray(js), jnp.asarray(vel),
                                          jnp.asarray(h), 1.0 / jnp.asarray(m)))
    t = torch.as_tensor
    invm = 1.0 / t(m)
    ts = TCN.shake_positions(cons, t(old)[None], t(new)[None], t(h)[None], invm)[0]
    tr = TCN.rattle_velocities(cons, t(js)[None], t(vel)[None], t(h)[None], invm)[0]
    assert np.abs(np64(ts) - js).max() < 1e-12
    assert np.abs(np64(tr) - jr).max() < 1e-12
    assert np.abs(js - new).max() > 1e-3  # the sweeps moved the atoms
    # K3's plain roll sweeps (direct differences: the molecules are unwrapped)
    offsets, rows = MF.pack_shake(cons.idx, cons.d0, len(m))
    rows_of = [t(old[None, :, a]) for a in range(3)]
    pr = MF.shake_rolls_plain([t(new[None, :, a]) for a in range(3)], rows_of, invm, offsets,
                              rows)
    vr = MF.rattle_rolls_plain([t(vel[None, :, a]) for a in range(3)],
                               [t(js[None, :, a]) for a in range(3)], invm, offsets, rows)
    assert np.abs(np64(torch.stack(pr, -1)[0]) - np64(ts)).max() < 1e-10
    assert np.abs(np64(torch.stack(vr, -1)[0]) - np64(tr)).max() < 1e-10


@pytest.fixture(scope="module", params=["ewald", "pme"])
def both_ff(request):
    """Both sides' fixture with the dense Ewald sum or PME on the unfused
    engine, and JAX's (F, E, W) jitted once for both boxes."""
    spec = dict(PE, kspace=request.param, use_fused=False)
    jsys, jst = JM.build_system(JM.MaterialSpec(**spec))
    tsys, _ = TM.build_system(TM.MaterialSpec(**spec), device="cpu")
    assert type(tsys.ff.ewald).__name__ == type(jsys.ff.ewald).__name__
    fev = jax.jit(lambda p, hh, nb: JE.forces_energy_virial(jsys, p, hh, nb))
    return jsys, jst, tsys, fev


@pytest.mark.parametrize("xy", [0.0, 0.3], ids=["ortho", "tilted"])
def test_energy_forces_virial_match_xla_engine(both_ff, xy):
    jsys, jst, tsys, fev = both_ff
    pos = np.asarray(jst.pos) + 0.05 * np.random.default_rng(1).standard_normal(jst.pos.shape)
    h = _tilted(jst.h, xy)
    nbr = jsys.build_neighbors(jnp.asarray(pos), jnp.asarray(h))
    Fj, Ej, Wj = (np.asarray(x) for x in fev(jnp.asarray(pos), jnp.asarray(h), nbr))
    Wj = Wj[[0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]]
    p, hh = torch.as_tensor(pos)[None], torch.as_tensor(h)[None]
    tn = tsys.build_neighbors(p, hh)
    assert abs(float(tsys.ff.energy(p[0], hh[0], interop.neighbor_list(nbr))) - Ej) \
        <= 1e-10 * abs(Ej)
    Ft, Et, Wt = TE.forces_energy_virial(tsys, p, hh, tn)
    assert abs(float(Et[0]) - Ej) <= 1e-10 * abs(Ej)
    assert rel_err(Ft[0], Fj) < 1e-10
    assert rel_err(Wt[0], Wj) < 1e-10


def test_routes_differ_only_by_the_erfc_polynomial(monkeypatch):
    """The fused route's force + virial (K3's plain entry plus the PME
    remainder) against the unfused engine on one orthorhombic box (on a
    tilted one the XLA engine's volume quirk separates the virials), with
    K3's erfc polynomial swapped for the exact erfc: 1e-13 relative (only
    the summation order differs; measured ~5e-15).  With the polynomial
    they differ by more (measured 3e-12 for the forces, 2e-11 for the
    virial on this perturbed box)."""
    ksys, kst = TM.build_system(TM.MaterialSpec(**PE, kspace="pme"), device="cpu")
    usys, _ = TM.build_system(TM.MaterialSpec(**PE, kspace="pme", use_fused=False),
                              device="cpu")
    assert ksys.fused.spec.kernel == "K3" and usys.fused is None
    pos = kst.pos + 0.05 * torch.as_tensor(
        np.random.default_rng(2).standard_normal(tuple(kst.pos.shape)))
    args = (pos[None], kst.h[None])
    Fu, Wu = TE.forces_virial(usys, *args)
    Fk, Wk = TE.forces_virial(ksys, *args)
    assert rel_err(Wk, np64(Wu)) > 1e-13  # the polynomial differs
    monkeypatch.setattr(MF, "erfc_poly", lambda x, ex: torch.erfc(x))
    Fk, Wk = TE.forces_virial(ksys, *args)
    assert rel_err(Fk, np64(Fu)) < 1e-13
    assert rel_err(Wk, np64(Wu)) < 1e-13


def test_unfused_strain_and_sampling_match_xla_engine(jax_runs, port):
    tsys, _ = port
    st = interop.md_state(jax_runs["staged"])
    tr = TE.run_strain(tsys, st, torch.tensor(EPS, dtype=torch.float64), 20, T, DT)
    jr = jax_runs["strain"]
    assert np.abs(np64(tr.pos) - np.asarray(jr.pos)).max() < 1e-8
    assert rel_err(tr.vel, np.asarray(jr.vel)) < 1e-8
    assert np.abs(np64(tr.h) - np.asarray(jr.h)).max() < 1e-12
    ts, press = TE.sample_stress(tsys, tr, 20, T, DT)
    assert np.abs(np64(ts.pos) - np.asarray(jax_runs["sampled"].pos)).max() < 1e-8
    assert rel_err(press, jax_runs["press"]) < 1e-8
    assert _residual(tsys, ts.pos) < 1e-10  # (the deform's remap stretches the bonds)


@pytest.mark.parametrize("barostat", sorted(NPT))
def test_constrained_npt_matches_jax(jax_runs, port, barostat):
    tsys, _ = port
    st = interop.md_state(jax_runs["staged"])
    out = TE.run_npt(tsys, st, 20, T, 350.0, DT, barostat=barostat, **NPT[barostat])
    ref = jax_runs["npt"][barostat]
    assert np.abs(np64(out.pos) - np.asarray(ref.pos)).max() < 1e-8
    assert np.abs(np64(out.h) - np.asarray(ref.h)).max() < 1e-8 * float(ref.h[0, 0])
    assert rel_err(out.vel, np.asarray(ref.vel)) < 1e-8
    assert not np.allclose(np64(out.h), np64(st.h))  # the barostat moved the box
    if barostat == "mtk":  # (Berendsen scales the positions after the step)
        assert _residual(tsys, out.pos) < 1e-10


def test_staged_prep_on_k3_matches_xla_prep(jax_runs):
    ksys, kst = TM.build_system(TM.MaterialSpec(**PE, kspace_every=1), device="cpu")
    assert ksys.fused is not None and ksys.fused.spec.kernel == "K3"
    out = TM.equilibrate_staged(ksys, kst, MDParams(**PREP), ns_init=10, minimize_steps=100,
                                velocities=torch.as_tensor(jax_runs["draw"]))
    ref = jax_runs["staged"]
    assert np.abs(np64(out.pos) - np.asarray(ref.pos)).max() < 5e-4
    assert rel_err(out.vel, np.asarray(ref.vel)) < 5e-3
    assert rel_err(out.h, np.asarray(ref.h)) < 5e-3
    assert abs(float(out.h[0, 0] - kst.h[0, 0])) > 1e-3  # the barostat moved the box
    assert _residual(ksys, out.pos) < 1e-8


def test_build_md_hmm_staged_on_the_charged_box(monkeypatch):
    """``measure`` (sampling and the 12-box stiffness probe, held to JAX
    by tests/test_torch_allatom_prep.py) is replaced by an isotropic
    stiffness at the prepared box, to keep this test short."""
    calls = []
    staged = TM.equilibrate_staged

    def spy(*a, **kw):
        calls.append(kw["ns_init"])
        return staged(*a, **kw)

    def measure(sys_, st, params):
        lam, mu = 2e9, 1e9
        C = np.diag([2 * mu] * 3 + [mu] * 3).astype(float)
        C[:3, :3] += lam
        return TM.InitData(length=np64(torch.diagonal(st.h)), stress=np.zeros(6), stiff=C,
                           density=float(sys_.masses.sum()) * TM.DENSITY_CONV
                           / float(torch.det(st.h)))

    monkeypatch.setattr(TM, "equilibrate_staged", spy)
    monkeypatch.setattr(TM, "measure", measure)
    cfg = HMMConfig()
    cfg = cfg.replace(mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=1),
                      md=cfg.md.__class__(temperature=300.0, timestep_length=1.0,
                                          strain_rate=1.0e-3, nsteps_sample=10),
                      md_dtype="float64")
    hmm = MC.build_md_hmm(cfg, spec=TM.MaterialSpec(**PE), staged=True, ns_init=2,
                          minimize_steps=10, device="cpu")
    assert calls == [2] * cfg.material.number_of_replicas
    sys_ = hmm.backend.sys
    assert sys_.fused is not None and sys_.fused.spec.kernel == "K3"
    assert _residual(sys_, hmm.backend.initial_md_state.pos) < 1e-8
    (fe, (micro,)), out = hmm.step(hmm.init_state())
    assert int(out.n_jobs) > 0 and torch.isfinite(out.md_stress_repl).all()
    assert torch.isfinite(fe.u).all() and bool(micro.has_run.any())
    assert _residual(sys_, micro.pos[micro.has_run]) < 1e-8
