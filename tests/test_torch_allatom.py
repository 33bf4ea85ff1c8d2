"""K3's plain version and the charged all-atom PE material of the port
against the JAX package, float64, on the small fixture of
tests/test_allatom_fused.py (4 chains of C4H10, 56 atoms, LJ/Coulomb
cutoffs 5 / 4.5 A, validate=False): packing, the plain kernel pieces, the
k-space split, forces, runs, inactive jobs and the kernel's shared-memory
budget.  ``cut`` cases use coul/cut (``use_ewald=False``), ``ewald``
cases the dense Ewald sum with the split.

Tolerances, each with its reason:
* packing (charges, alpha, k-vectors/mesh, patterns and their rows, SHAKE
  offsets and rows, the qq plane, the constraint set, ndof): exact;
* plain pattern forces, SHAKE and RATTLE against JAX's
  ``bonded_pattern_forces``/``shake_rolls``/``rattle_rolls`` off the
  kernel: 1e-10 — the same formulas (measured ~1e-15);
* the k-space split (force and virial) against JAX's
  ``_build_kspace_split``: 1e-9 relative (measured ~4e-15);
* forces + virial against JAX's XLA engine (exact erfc): coul/cut 1e-10
  relative (measured ~2e-13); Ewald 1e-6 relative — the kernel's A&S
  erfc polynomial (|err| <= 1.5e-7; measured 9e-8);
* 20-step strain and sampling runs against the XLA engine: coul/cut pos
  1e-9 A, pressure 1e-9 relative (measured ~6e-13 / 1e-12); Ewald, with
  kspace_every = 1 against the XLA engine rebuilding every step (both
  re-evaluate the force at each step's start), pos 1e-4 A, pressure 1e-3
  relative — the frozen remainder still lags one step in the second
  half-kick (measured 1e-5 A), plus the erfc polynomial.
The quick prep and the stiffness probe are in test_torch_allatom_prep.py."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import data_io as JD
from scema_tpu.md import engine as JE
from scema_tpu.md import material as JM
from scema_tpu.ops import md_fused as JMF

from scema_tpu_torch import interop
from scema_tpu_torch.md import data_io as TD
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.ops import md_fused as TMF

from torch_port_util import np64, rel_err

COMMON = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
              pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False)
T_MD, DT = 50.0, 0.5
EPS = [0.01, 0.0, -0.01, 0.0, 0.0, 0.002]
FTM2V = 1.0 / 48.88821291 / 48.88821291
CASES = {"cut": dict(use_ewald=False), "ewald": dict(use_ewald=True)}


def _systems(case):
    """JAX's XLA engine (the reference), the port on the CPU, and JAX's
    relaxed start state with a Maxwell draw, for one case."""
    extra = CASES[case]
    # the port freezes the remainder per 1-step chunk and re-evaluates the
    # force at each chunk's start; the XLA engine does the same when it
    # rebuilds every step.  Without k-space both integrate a 20-step run on
    # one force history (rebuild_every=20).
    rebuild = 1 if extra["use_ewald"] else 20
    jsys, jst = JM.build_system(JM.MaterialSpec(**COMMON, **extra, use_fused=False,
                                                rebuild_every=rebuild))
    tsys, _ = TM.build_system(TM.MaterialSpec(**COMMON, **extra, kspace_every=1),
                              device="cpu")
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=200, dt0=0.25))(jst)
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(9), T_MD))
    return jsys, jst, tsys, interop.md_state(jst)


@pytest.fixture(scope="module", params=sorted(CASES))
def systems(request):
    return (request.param,) + _systems(request.param)


@pytest.fixture(scope="module")
def fused_pair():
    """JAX's fused-path system (packing and the k-space split are built
    at set-up; no kernel runs) and the port's, with Ewald."""
    jsys, jst = JM.build_system(JM.MaterialSpec(**COMMON, use_ewald=True, use_fused=True))
    tsys, _ = TM.build_system(TM.MaterialSpec(**COMMON, use_ewald=True), device="cpu")
    return jsys, jst, tsys


@pytest.mark.parametrize("kspace", ["ewald", "pme"])
def test_packing_matches_jax(kspace):
    jsys, _ = JM.build_system(JM.MaterialSpec(**COMMON, use_ewald=True, kspace=kspace,
                                              use_fused=True))
    tsys, _ = TM.build_system(TM.MaterialSpec(**COMMON, use_ewald=True, kspace=kspace),
                              device="cpu")
    jr, tr, n = jsys.fused, tsys.fused, tsys.n_atoms
    jew, tew = jsys.ff.ewald, tsys.ff.ewald
    assert type(jew).__name__ == type(tew).__name__
    assert np.array_equal(np64(tsys.ff.charges), np.asarray(jsys.ff.charges))
    assert tew.alpha == jew.alpha == jr.spec.ewald_alpha == tr.spec.ewald_alpha
    if kspace == "pme":
        assert tew.mesh == jew.mesh
    else:
        assert np.array_equal(np64(tew.kvecs), np.asarray(jew.kvecs))
    assert tr.spec.bonded_pattern == jr.spec.bonded_pattern and tr.spec.bonded_pattern
    assert torch.equal(tr.pat, interop.lane_rows(jr.pat_rows, n))
    assert tr.spec.shake_offsets == jr.spec.shake_offsets == (1, 2, 3)
    assert torch.equal(tr.shk, interop.lane_rows(jr.shk_rows, n))
    assert torch.equal(tr.qq, interop.dense_qq(jr, n))
    lj1, lj2 = interop.dense_planes(jr, n)
    assert torch.equal(tr.lj1, lj1) and torch.equal(tr.lj2, lj2)
    jc, tc = interop.constraints(jsys.constraints), tsys.constraints
    assert np.array_equal(tc.idx, jc.idx) and np.array_equal(tc.d0, jc.d0)
    assert tr.spec.ndof == jr.spec.ndof == tsys.ndof == jsys.ndof
    assert tr.spec.coul and tr.spec.fext and tr.spec.k3
    assert tr.spec.cutoff2 == jr.spec.cutoff2 and tr.spec.coul_cutoff2 == jr.spec.coul_cutoff2


def test_plain_pattern_forces_match_jax():
    """Plain offset-pattern forces and virial against JAX's
    ``bonded_pattern_forces`` (off the kernel, exact acos) on
    ``build_pe_melt_allatom(8, 6)``."""
    data = JD.build_pe_melt_allatom(8, 6)
    n = len(data.pos)
    jff = JD.to_opls(data, 12.0, 9.0, use_ewald=False)
    patterns, rows = JMF.pack_patterns(jff.topo, jff.bonded, n, dtype=jnp.float64)
    tff = TD.to_opls(data, 12.0, 9.0, use_ewald=False)
    tpat, trows = TMF.pack_patterns(tff, n)
    assert tpat == patterns and torch.equal(trows, interop.lane_rows(rows, n))
    pos = data.pos + 0.05 * np.random.default_rng(7).standard_normal(data.pos.shape)
    nt = JMF.pad_n(n) // JMF.LANE
    ch = [jnp.pad(jnp.asarray(pos[:, k]), (0, nt * JMF.LANE - n)).reshape(nt, JMF.LANE)
          for k in range(3)]
    fx, fy, fz, w6 = JMF.bonded_pattern_forces(*ch, rows, patterns, nt, True,
                                               in_kernel=False, use_poly_acos=False)
    jf = np.stack([np.asarray(c).reshape(-1)[:n] for c in (fx, fy, fz)], -1)
    tf, tw = TMF.bonded_pattern_forces_plain([torch.as_tensor(pos[:, k])[None] for k in range(3)],
                                             trows, tpat)
    assert rel_err(torch.stack(tf, -1)[0], jf) < 1e-10
    assert rel_err([float(w[0]) for w in tw], [float(w) for w in w6]) < 1e-10


def _ch_bonds(d):
    m = d.masses[d.types]
    sel = (m[d.bonds[:, 0]] < 1.5) | (m[d.bonds[:, 1]] < 1.5)
    idx = d.bonds[sel]
    return idx, np.linalg.norm(d.pos[idx[:, 1]] - d.pos[idx[:, 0]], axis=1)


@pytest.mark.parametrize("which", ["shake", "rattle"])
def test_plain_shake_rattle_match_jax(which):
    """Plain Jacobi SHAKE/RATTLE against JAX's ``shake_rolls`` and
    ``rattle_rolls`` off the kernel (tests/test_fused_constraints.py)."""
    d = JD.build_pe_chain_allatom(10)
    n = len(d.pos)
    idx, d0 = _ch_bonds(d)
    offsets, rows = JMF.pack_shake(idx, d0, n, dtype=jnp.float64)
    toff, trows = TMF.pack_shake(idx, d0, n)
    assert toff == offsets and torch.equal(trows, interop.lane_rows(rows, n))
    masses = d.masses[d.types]
    nt = JMF.pad_n(n) // JMF.LANE

    def ch(x):
        return jnp.pad(jnp.asarray(x), (0, nt * JMF.LANE - n)).reshape(nt, JMF.LANE)

    rng = np.random.default_rng(3)
    a = d.pos
    b = d.pos + 0.05 * rng.normal(size=d.pos.shape) if which == "shake" \
        else 0.01 * rng.normal(size=d.pos.shape)
    invm = FTM2V / masses
    if which == "shake":  # b: drifted positions, a: pre-drift positions
        out = JMF.shake_rolls(tuple(ch(b[:, k]) for k in range(3)),
                              tuple(ch(a[:, k]) for k in range(3)), ch(invm), offsets, rows,
                              nt, in_kernel=False, n_iters=20, relax=0.8)
        got = TMF.shake_rolls_plain([torch.as_tensor(b[:, k]) for k in range(3)],
                                    [torch.as_tensor(a[:, k]) for k in range(3)],
                                    torch.as_tensor(invm), toff, trows, 20, 0.8)
    else:  # b: velocities at positions a
        out = JMF.rattle_rolls(tuple(ch(b[:, k]) for k in range(3)),
                               tuple(ch(a[:, k]) for k in range(3)), ch(invm), offsets, rows,
                               nt, in_kernel=False, n_iters=10, relax=0.8)
        got = TMF.rattle_rolls_plain([torch.as_tensor(b[:, k]) for k in range(3)],
                                     [torch.as_tensor(a[:, k]) for k in range(3)],
                                     torch.as_tensor(invm), toff, trows, 10, 0.8)
    ref = np.stack([np.asarray(c).reshape(-1)[:n] for c in out], -1)
    assert np.abs(torch.stack(got, -1).numpy() - ref).max() < 1e-10


@pytest.mark.parametrize("kspace", ["ewald", "pme"])
def test_kspace_split_matches_jax(kspace):
    jsys, jst = JM.build_system(JM.MaterialSpec(**COMMON, use_ewald=True, kspace=kspace,
                                                use_fused=True))
    tsys, _ = TM.build_system(TM.MaterialSpec(**COMMON, use_ewald=True, kspace=kspace),
                              device="cpu")
    rng = np.random.default_rng(2)
    pos = np.asarray(jst.pos) + 0.05 * rng.normal(size=jst.pos.shape)
    h = np.asarray(jst.h).copy()
    h[0, 1] = 0.3  # tilted
    jr = jsys.fused
    Fj = np.asarray(jr.kspace_fn(jnp.asarray(pos), jnp.asarray(h)))
    Wj = np.asarray(jr.kspace_virial_fn(jnp.asarray(pos), jnp.asarray(h)))
    F, W = tsys.fused.kspace(torch.as_tensor(pos)[None], torch.as_tensor(h)[None],
                             want_virial=True)
    F0, none = tsys.fused.kspace(torch.as_tensor(pos)[None], torch.as_tensor(h)[None])
    assert none is None and torch.equal(F0, F)
    assert rel_err(F[0], Fj) < 1e-9
    assert rel_err(W[0], Wj) < 1e-9


def test_forces_virial_match_xla(systems):
    case, jsys, jst, tsys, tst = systems
    rng = np.random.default_rng(1)
    pos = np.asarray(jst.pos) + 0.02 * rng.standard_normal(jst.pos.shape)
    nbr = jsys.build_neighbors(jnp.asarray(pos), jst.h)
    F, _, W = JE.forces_energy_virial(jsys, jnp.asarray(pos), jst.h, nbr)
    Ft, Wt = TE.forces_virial(tsys, torch.as_tensor(pos), tst.h)
    W = np.asarray(W)
    W6 = np.array([W[0, 0], W[1, 1], W[2, 2], W[0, 1], W[0, 2], W[1, 2]])
    tol = 1e-6 if case == "ewald" else 1e-10
    assert rel_err(Ft, np.asarray(F)) < tol
    assert rel_err(Wt, W6) < tol


def test_runs_match_xla_engine(systems):
    case, jsys, jst, tsys, tst = systems
    jr = JE.run_strain(jsys, jst, jnp.asarray(EPS), jnp.asarray(20), T_MD, DT)
    tr = TE.run_strain(tsys, tst, torch.tensor(EPS, dtype=torch.float64), 20, T_MD, DT)
    js, jp = JE.sample_stress(jsys, jst, 20, T_MD, DT)
    ts, tp = TE.sample_stress(tsys, tst, 20, T_MD, DT)
    pos_tol, p_tol = (1e-4, 1e-3) if case == "ewald" else (1e-9, 1e-9)
    assert np.abs(np64(tr.pos) - np.asarray(jr.pos)).max() < pos_tol
    assert np.abs(np64(tr.h) - np.asarray(jr.h)).max() < 1e-12
    assert np.abs(np64(ts.pos) - np.asarray(js.pos)).max() < pos_tol
    assert rel_err(tp, np.asarray(jp)) < p_tol
    # the constraints hold at the end of the run (fix shake's 1e-3 A scale)
    cons = tsys.constraints
    r = np.linalg.norm(np64(tr.pos)[cons.idx[:, 1]] - np64(tr.pos)[cons.idx[:, 0]], axis=1)
    assert np.abs(r - cons.d0).max() < 1e-3


def test_inactive_job_is_bit_identical(fused_pair):
    """Through the k-space chunk loop (kspace_every = 10, so two chunks of
    a 20-step run), a job with zero steps comes back bit-identical beside a
    running one, and a job's result does not depend on its neighbour."""
    _, jst, tsys = fused_pair
    tst = interop.md_state(jst)
    gen = torch.Generator().manual_seed(1)
    vel = TE.maxwell_velocities(tsys, T_MD, gen)
    tst = tst.replace(vel=vel)
    batch = TE.MDState(*(torch.stack([x, x]) for x in (tst.pos, tst.vel, tst.h, tst.vxi)))
    eps = torch.tensor([EPS, EPS], dtype=torch.float64)
    out = TMF.run_strain_fused(tsys.fused, batch, eps, torch.tensor([0, 20]), T_MD, DT)
    for f in ("pos", "vel", "h", "vxi"):
        assert torch.equal(getattr(out, f)[0], getattr(tst, f))
        assert not torch.equal(getattr(out, f)[1], getattr(tst, f))
    out_s, press = TMF.sample_stress_fused(tsys.fused, batch, torch.tensor([20, 0]), T_MD, DT)
    assert torch.equal(out_s.pos[1], tst.pos) and not bool(press[1].any())
    single = TE.run_strain(tsys, tst, eps[1], 20, T_MD, DT)
    assert torch.allclose(single.pos, out.pos[1], rtol=0, atol=1e-12)


def test_smem_budget_raises_before_launch(fused_pair):
    """Each flag set states its own atom limit, and an oversize box is
    refused on the host (the budget function the CUDA wrappers call before
    any launch)."""
    spec = fused_pair[2].fused.spec
    assert spec.flags == "COUL+EWALD+PATTERNS+SHAKE+FEXT"
    limit = TMF.max_atoms(spec)
    assert 1792 <= limit < 3000
    TMF.check_smem(TMF.FusedSpec(**{**spec.__dict__, "n_atoms": 1792}))
    big = TMF.FusedSpec(**{**spec.__dict__, "n_atoms": limit + 1})
    with pytest.raises(ValueError, match=re.escape(f"K3 (flags {spec.flags})") + ".*"
                       + f"at most {limit} atoms"):
        TMF.check_smem(big)
    k1 = TMF.FusedSpec(n_atoms=limit + 1, cutoff2=100.0, ndof=1, boltz=1.0, ftm2v=1.0,
                       nktv2p=1.0)
    with pytest.raises(ValueError, match="K1 \\(flags none\\)"):
        TMF.check_smem(k1)


@pytest.mark.slow
def test_matches_pallas_kernel_interpret():
    """The k-space chunk loop against the TPU kernel itself: JAX's
    ``run_strain_fused``/``sample_stress_fused`` with ``fused_chunk`` in
    interpret mode, kspace_every = 5 (two chunks of a 10-step run): 1e-10
    (measured 4e-14 A, 4e-15 relative; ~120 s on one CPU core)."""
    jsys, jst = JM.build_system(JM.MaterialSpec(**COMMON, use_ewald=True, use_fused=True,
                                                kspace_every=5))
    tsys, _ = TM.build_system(TM.MaterialSpec(**COMMON, use_ewald=True, kspace_every=5),
                              device="cpu")
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=50, dt0=0.25))(jst)
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(9), T_MD))
    tst = interop.md_state(jst)
    jr = JMF.run_strain_fused(jsys.fused, jst, jnp.asarray(EPS), jnp.asarray(10), T_MD, DT)
    tr = TE.run_strain(tsys, tst, torch.tensor(EPS, dtype=torch.float64), 10, T_MD, DT)
    assert np.abs(np64(tr.pos) - np.asarray(jr.pos)).max() < 1e-10
    assert np.abs(np64(tr.vel) - np.asarray(jr.vel)).max() < 1e-10
    _, jp = JMF.sample_stress_fused(jsys.fused, jst, 10, T_MD, DT)
    _, tp = TE.sample_stress(tsys, tst, 10, T_MD, DT)
    assert rel_err(tp, np.asarray(jp)) < 1e-10

