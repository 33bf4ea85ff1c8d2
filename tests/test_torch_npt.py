"""The port's NPT engine and the energies it runs on, against scema_tpu.

Float64 on the CPU.  Tolerances: energies 1e-10 relative (list entries are
summed in another order); K1's plain force + virial entry against autograd
of ``OPLS.energy`` 1e-9 relative to the largest force and virial component
(the kernel's pair loop and autograd differ in rounding only); ``run_npt``
against JAX over 40 steps 1e-9 A in positions and 1e-9 relative in the box.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from scema_tpu.md import engine as JE
from scema_tpu.md import lattice as JL
from scema_tpu.md import material as JM
from scema_tpu.md import neighbor as JNB
from scema_tpu.md.forcefields import bonded as JBD
from scema_tpu.md.forcefields import lj as JLJ
from scema_tpu_torch import interop
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md import neighbor as TNB
from scema_tpu_torch.md.forcefields import bonded as TBD
from scema_tpu_torch.ops import md_fused as MF

from torch_port_util import np64, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

# the small melt of tests/test_md_fused.py:540-542
MELT = dict(name="m", force_field="opls", n_chains=32, chain_length=6, opls_lj_cutoff=6.0,
            opls_coul_cutoff=6.0, validate=False)


@pytest.fixture(scope="module")
def melt():
    """Both sides' small melt (each side's build_system) at one perturbed
    configuration, with JAX's list there."""
    jsys, jst = JM.build_system(JM.MaterialSpec(**MELT, use_fused=False))
    tsys, tst = TM.build_system(TM.MaterialSpec(**MELT, use_fused=False), device="cpu")
    rng = np.random.default_rng(3)
    pos = np.asarray(jst.pos) + rng.normal(0.0, 0.05, jst.pos.shape)
    h = np.asarray(jst.h)
    nbr = JNB.build(jsys.nspec, jnp.asarray(pos), jnp.asarray(h))
    return jsys, tsys, pos, h, nbr


def test_opls_and_bonded_energies_match_jax(melt):
    jsys, tsys, pos, h, nbr = melt
    tn = interop.neighbor_list(nbr)
    p, hh = torch.as_tensor(pos), torch.as_tensor(h)
    ej = float(jsys.ff.energy(jnp.asarray(pos), jnp.asarray(h), nbr))
    et = float(tsys.ff.energy(p, hh, tn))
    assert abs(et - ej) <= 1e-10 * abs(ej)
    for jfn, tfn in ((JBD.bond_energy, TBD.bond_energy), (JBD.angle_energy, TBD.angle_energy),
                     (JBD.dihedral_energy, TBD.dihedral_energy)):
        ej = float(jfn(jnp.asarray(pos), jnp.asarray(h), jsys.ff.topo, jsys.ff.bonded))
        args = {TBD.bond_energy: ("bonds", "bond_type", "bond_k", "bond_r0"),
                TBD.angle_energy: ("angles", "angle_type", "angle_k", "angle_theta0"),
                TBD.dihedral_energy: ("dihedrals", "dihedral_type", "dihedral_k")}[tfn]
        et = float(tfn(p, hh, *(getattr(tsys.ff, a) for a in args)))
        assert abs(et - ej) <= 1e-10 * abs(ej)
    # batched: two boxes in one call equal two single calls
    P = torch.stack([p, p + 0.01])
    tn2 = TNB.NeighborList(idx=tn.idx.expand(2, -1, -1), mask=tn.mask.expand(2, -1, -1))
    e2 = tsys.ff.energy(P, hh.expand(2, 3, 3), tn2)
    assert float(e2[0]) == pytest.approx(float(tsys.ff.energy(p, hh, tn)), rel=1e-14)


def test_opls_forces_and_virial_match_jax_autograd(melt):
    jsys, tsys, pos, h, nbr = melt
    Fj, _, Wj = JE.forces_energy_virial(jsys, jnp.asarray(pos), jnp.asarray(h), nbr)
    Ft, _, Wt = TE.forces_energy_virial(tsys, torch.as_tensor(pos)[None],
                                        torch.as_tensor(h)[None],
                                        TNB.NeighborList(*(x[None] for x in
                                                           interop.neighbor_list(nbr))))
    Wj = np.asarray(Wj)
    Wj6 = np.array([Wj[0, 0], Wj[1, 1], Wj[2, 2], Wj[0, 1], Wj[0, 2], Wj[1, 2]])
    fmax = np.abs(np.asarray(Fj)).max()
    assert np.abs(np64(Ft[0]) - np.asarray(Fj)).max() <= 1e-10 * fmax
    assert np.abs(np64(Wt[0]) - Wj6).max() <= 1e-10 * np.abs(Wj6).max()


def test_k1_plain_entry_matches_autograd_of_opls_energy(melt):
    """K1's hand-derived pair + chain forces (its plain version) against
    autograd of OPLS.energy over a list that holds every pair in range."""
    _, tsys, pos, h, _ = melt
    fused, _ = TM.build_system(TM.MaterialSpec(**MELT), device="cpu")
    assert fused.fused.spec.kernel == "K1" and tsys.fused is None
    p = torch.as_tensor(pos)[None]
    hh = torch.as_tensor(h)[None]
    F, W = MF.md_forces_virial(fused.fused, p.transpose(1, 2).contiguous(), MF.h6_of(hh))
    Fa, _, Wa = TE.forces_energy_virial(tsys, p, hh, tsys.build_neighbors(p, hh))
    fmax = float(Fa.abs().max())
    assert float((F.transpose(1, 2) - Fa).abs().max()) <= 1e-9 * fmax
    assert float((W - Wa).abs().max()) <= 1e-9 * float(Wa.abs().max())


def _argon(a0=5.26 * 0.97, T=20.0, seed=0):
    """test_npt.py's 108-atom argon box on both sides from one state."""
    pos, h = JL.fcc(a0, 3, 3, 3)
    n = len(pos)
    ff = JLJ.single_type(0.238, 3.405, 7.9, n)
    jsys = JE.MDSystem(ff=ff, masses=jnp.full((n,), 39.948),
                       nspec=JNB.NeighborSpec(cutoff=7.9, skin=1.0, k_max=64))
    jst = JE.init_state(jnp.asarray(pos), jnp.asarray(h))
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(seed), T))
    tsys = TE.MDSystem(ff=interop.lj(ff), masses=torch.full((n,), 39.948, dtype=torch.float64),
                       nspec=TNB.NeighborSpec(cutoff=7.9, skin=1.0, k_max=64))
    return jsys, jst, tsys, interop.md_state(jst)


def test_lj_energy_and_k1_runner_match_jax():
    """LJ.energy against JAX's on a perturbed argon crystal (1e-10
    relative), and K1's plain force + virial entry of a plain-LJ runner
    against autograd of it (1e-9 relative)."""
    jsys, jst, tsys, _ = _argon()
    rng = np.random.default_rng(4)
    pos = np.asarray(jst.pos) + rng.normal(0.0, 0.1, jst.pos.shape)
    h = np.asarray(jst.h)
    nbr = JNB.build(jsys.nspec, jnp.asarray(pos), jnp.asarray(h))
    ej = float(jsys.ff.energy(jnp.asarray(pos), jnp.asarray(h), nbr))
    p, hh = torch.as_tensor(pos)[None], torch.as_tensor(h)[None]
    tn = TNB.NeighborList(*(x[None] for x in interop.neighbor_list(nbr)))
    assert abs(float(tsys.ff.energy(p, hh, tn)[0]) - ej) <= 1e-10 * abs(ej)
    runner = MF.make_runner(tsys.ff, tsys.masses, tsys.units)
    F, W = MF.md_forces_virial(runner, p.transpose(1, 2).contiguous(), MF.h6_of(hh))
    Fa, _, Wa = TE.forces_energy_virial(tsys, p, hh, tn)
    assert float((F.transpose(1, 2) - Fa).abs().max()) <= 1e-9 * float(Fa.abs().max())
    assert float((W - Wa).abs().max()) <= 1e-9 * float(Wa.abs().max())


@pytest.mark.parametrize("barostat", ["mtk", "berendsen"])
def test_run_npt_matches_jax(barostat):
    jsys, jst, tsys, tst = _argon()
    kw = dict(p_target=1.0, pdamp=500.0, barostat=barostat)
    if barostat == "berendsen":
        kw["compressibility"] = 2e-4
    js = jax.jit(lambda s: JE.run_npt(jsys, s, 40, 20.0, 30.0, 4.0, **kw))(jst)
    ts = TE.run_npt(tsys, tst, 40, 20.0, 30.0, 4.0, **kw)
    assert np.abs(np64(ts.pos) - np.asarray(js.pos)).max() <= 1e-9
    assert np.abs(np64(ts.h) - np.asarray(js.h)).max() <= 1e-9 * float(js.h[0, 0])
    assert np.abs(np64(ts.vel) - np.asarray(js.vel)).max() <= 1e-9
    assert np.abs(np64(ts.vxi) - np.asarray(js.vxi)).max() <= 1e-9
    assert not np.allclose(np64(ts.h), np64(tst.h))  # the box moved


@pytest.mark.parametrize("barostat", ["berendsen", "mtk"])
def test_barostat_relaxes_compressed_crystal(barostat):
    """test_npt.py's relaxation tests on the port: a 3%-compressed argon
    crystal under 1 atm expands back, without exploding."""
    _, _, tsys, st = _argon()
    v0 = float(st.h[0, 0])
    kw = {"compressibility": 2e-4} if barostat == "berendsen" else {}
    st = TE.run_npt(tsys, st, 300, 20.0, 20.0, 4.0, p_target=1.0, pdamp=500.0,
                    barostat=barostat, **kw)
    v1 = float(st.h[0, 0])
    assert v0 * 1.005 < v1 < v0 * 1.2
    assert torch.isfinite(st.pos).all()


def test_batched_boxes_evolve_independently():
    """Two boxes in one run_npt call (one compressed, one at another
    temperature) equal two single-box calls."""
    _, _, tsys, a = _argon()
    _, _, _, b = _argon(a0=5.26, T=40.0, seed=1)
    both = TE.MDState(*(torch.stack([getattr(a, f), getattr(b, f)])
                        for f in ("pos", "vel", "h", "vxi")))
    out = TE.run_npt(tsys, both, 20, 20.0, 25.0, 4.0, pdamp=500.0)
    for k, one in enumerate((a, b)):
        ref = TE.run_npt(tsys, one, 20, 20.0, 25.0, 4.0, pdamp=500.0)
        for f in ("pos", "vel", "h", "vxi"):
            assert torch.allclose(getattr(out, f)[k], getattr(ref, f), rtol=0, atol=1e-12)
    assert not torch.allclose(out.h[0], out.h[1])


def test_constrained_mtk_npt_matches_jax():
    """MTK NPT with SHAKE/RATTLE: the charged all-atom PE fixture of
    tests/test_allatom_fused.py with coul/cut (56 atoms, the C-H bonds
    rigid) relaxed by JAX's FIRE (40 steps), 20 steps of 1 fs heating 300 ->
    350 K from JAX's 300 K draw,
    ``use_fused=False`` on both sides: 1e-9 A and 1e-9 relative in the box,
    as above; the SHAKE residual below 1e-10 A^2."""
    spec = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
                pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False,
                use_fused=False)
    jsys, jst = JM.build_system(JM.MaterialSpec(**spec))
    tsys, _ = TM.build_system(TM.MaterialSpec(**spec), device="cpu")
    assert tsys.constraints is not None
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=40, dt0=0.5))(jst)
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(5), 300.0))
    js = jax.jit(lambda s: JE.run_npt(jsys, s, 20, 300.0, 350.0, 1.0))(jst)
    ts = TE.run_npt(tsys, interop.md_state(jst), 20, 300.0, 350.0, 1.0)
    assert np.abs(np64(ts.pos) - np.asarray(js.pos)).max() <= 1e-9
    assert np.abs(np64(ts.h) - np.asarray(js.h)).max() <= 1e-9 * float(js.h[0, 0])
    assert np.abs(np64(ts.vel) - np.asarray(js.vel)).max() <= 1e-9
    assert not np.allclose(np64(ts.h), np.asarray(jst.h))  # the box moved
    c = tsys.constraints
    rr = np64(ts.pos)[c.idx[:, 1]] - np64(ts.pos)[c.idx[:, 0]]
    assert np.abs((rr * rr).sum(-1) - c.d0 ** 2).max() < 1e-10
