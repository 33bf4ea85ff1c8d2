"""K4's plain version (the gather-list pair loop) and the list path of the
port against the JAX package, float64, on the 56-atom COMMON fixture of
tests/test_torch_allatom.py with ``force_list_kernel`` (K = 56, pattern
bonds, SHAKE; ``cut`` uses coul/cut, ``ewald`` the dense Ewald sum with the
k-space split).

Tolerances, each with its reason:
* forces + virial on JAX's own list against JAX's XLA engine
  (``E.forces_energy_virial``, exact erfc): coul/cut 1e-10 relative (the
  same formulas; measured ~1e-13); Ewald 1e-6 — the kernel's A&S erfc
  polynomial (|err| <= 1.5e-7), as for K3;
* the list path against the all-pairs path (K3's plain version) on the
  same box: 1e-9 relative on forces, 1e-9 A after a strain run (the list
  holds every pair inside the cutoff; the two differ only in summation
  order);
* an inactive job through the list chunk loop: bit-identical.
The runs against JAX's Pallas kernel in interpret mode are in
tests/test_torch_list_{resident,streamed,run}.py."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md import neighbor as TNB
from scema_tpu_torch.ops import md_fused as TMF

from torch_port_util import np64, rel_err

COMMON = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
              pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False,
              force_list_kernel=True)
T_MD, DT = 50.0, 0.5
EPS = [0.01, 0.0, -0.01, 0.0, 0.0, 0.002]


@pytest.fixture(scope="module", params=["cut", "ewald"])
def systems(request):
    ewald = request.param == "ewald"
    jsys, jst = JM.build_system(JM.MaterialSpec(**COMMON, use_ewald=ewald, use_fused=False))
    tsys, _ = TM.build_system(TM.MaterialSpec(**COMMON, use_ewald=ewald), device="cpu")
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=100, dt0=0.25))(jst)
    return request.param, jsys, jst, tsys


def test_list_forces_virial_match_xla(systems):
    """Forces and virial of the port's list path (K4's plain pair loop +
    bonded + the k-space remainder) fed JAX's own neighbor list, against
    the XLA engine's autograd forces on that list."""
    case, jsys, jst, tsys = systems
    r = tsys.fused
    assert r.spec.k == 56 and r.spec.kernel == "K4"
    rng = np.random.default_rng(1)
    pos = np.asarray(jst.pos) + 0.02 * rng.standard_normal(jst.pos.shape)
    h = np.asarray(jst.h).copy()
    if case == "cut":
        # tilted; not with Ewald, where the XLA engine's virial of the
        # reciprocal sum takes the volume as the diagonal product of a
        # non-triangular deformed cell (ROADMAP section 3)
        h[0, 1] = 0.3
    nbr = jsys.build_neighbors(jnp.asarray(pos), jnp.asarray(h))
    F, _, W = JE.forces_energy_virial(jsys, jnp.asarray(pos), jnp.asarray(h), nbr)
    tp, th = torch.as_tensor(pos)[None], torch.as_tensor(h)[None]
    one = TNB.NeighborList(*(x[None] for x in interop.neighbor_list(nbr)))
    ch = TMF.pack_channels(r, tp, th, one)
    Ft, Wt = TMF.md_forces_virial(r, tp.transpose(1, 2), TMF.h6_of(th), nbr=ch)
    Ft = Ft.transpose(1, 2)
    if r.kspace is not None:
        Fk, Wk = r.kspace(tp, th, want_virial=True)
        Ft, Wt = Ft + Fk, Wt + Wk
    W = np.asarray(W)
    W6 = np.array([W[0, 0], W[1, 1], W[2, 2], W[0, 1], W[0, 2], W[1, 2]])
    tol = 1e-6 if case == "ewald" else 1e-10
    assert rel_err(Ft[0], np.asarray(F)) < tol
    assert rel_err(Wt[0], W6) < tol
    # the engine's entry builds its own list: the same forces
    Fe, We = TE.forces_virial(tsys, tp[0], th[0])
    assert rel_err(Fe, Ft[0]) < 1e-12 and rel_err(We, Wt[0]) < 1e-12


def test_list_matches_allpairs(systems):
    """The list path and the all-pairs path (K3's plain version) agree on
    the same box: forces, and a strain run through both chunk loops."""
    case, _, jst, tsys = systems
    spec = TM.MaterialSpec(**{**COMMON, "force_list_kernel": False},
                           use_ewald=case == "ewald")
    asys, _ = TM.build_system(spec, device="cpu")
    assert asys.fused.spec.k == 0
    st = interop.md_state(jst)
    st = st.replace(vel=TE.maxwell_velocities(tsys, T_MD, torch.Generator().manual_seed(2)))
    F1, W1 = TE.forces_virial(tsys, st.pos, st.h)
    F2, W2 = TE.forces_virial(asys, st.pos, st.h)
    assert rel_err(F1, np64(F2)) < 1e-9 and rel_err(W1, np64(W2)) < 1e-9
    eps = torch.tensor(EPS, dtype=torch.float64)
    # without k-space the all-pairs path runs whole, and a chunk restart
    # re-evaluates the force after the deform remap (ROADMAP section 3), so
    # coul/cut compares one 10-step chunk; Ewald two on both paths
    n = 20 if case == "ewald" else 10
    a = TE.run_strain(tsys, st, eps, n, T_MD, DT)
    b = TE.run_strain(asys, st, eps, n, T_MD, DT)
    assert float((a.pos - b.pos).abs().max()) < 1e-9
    assert torch.equal(a.h, b.h)


def test_inactive_job_is_bit_identical_on_the_list_path(systems):
    """Through the list chunk loop (two 10-step chunks of a 20-step run), a
    job with zero steps comes back bit-identical beside a running one, and
    a job's result does not depend on its neighbour."""
    _, _, jst, tsys = systems
    tst = interop.md_state(jst)
    tst = tst.replace(vel=TE.maxwell_velocities(tsys, T_MD, torch.Generator().manual_seed(1)))
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


def test_chunk_length_follows_rebuild_and_kspace_periods():
    spec = TM.MaterialSpec(**COMMON, use_ewald=True, kspace_every=10, rebuild_every=10)
    for rebuild, kspace, want in ((10, 10, 10), (7, 10, 5), (10, 4, 4), (3, 10, 2), (1, 10, 1)):
        sys_, _ = TM.build_system(TM.MaterialSpec(**{**spec.__dict__, "rebuild_every": rebuild,
                                                     "kspace_every": kspace}), device="cpu")
        assert TMF.launch_steps(sys_.fused) == want
    g0 = TM.MaterialSpec(name="g0", force_field="opls", force_list_kernel=True,
                         rebuild_every=7)
    sys_, _ = TM.build_system(g0, device="cpu")
    assert sys_.fused.kspace is None and TMF.launch_steps(sys_.fused) == 5


def test_k4_smem_budget_and_channel_checks():
    """K4's shared form keeps K3's 23 N floats of shared memory (the
    2240-atom box fits, 2509 is its limit with one atom type); 2510 atoms
    take K4's global form, which raises only one atom above its own cap; a
    list runner refuses to launch without its compact list, and a list of
    the wrong shape or type is refused before any launch — as are the first
    design's channels."""
    sys_, st = TM.build_system(TM.MaterialSpec(**COMMON, use_ewald=True), device="cpu")
    spec = sys_.fused.spec
    assert spec.flags == "COUL+EWALD+PATTERNS+SHAKE+FEXT+LIST"
    limit = TMF.max_atoms(spec)
    assert limit == 2509
    TMF.check_smem(TMF.FusedSpec(**{**spec.__dict__, "n_atoms": 2240}))
    above = TMF.FusedSpec(**{**spec.__dict__, "n_atoms": limit + 1})
    assert TMF.k4_big(above) and not TMF.k4_big(TMF.FusedSpec(**{**spec.__dict__,
                                                                   "n_atoms": limit}))
    TMF.check_smem(above)
    big = TMF.k4_big_max_atoms(spec)
    with pytest.raises(ValueError, match=rf"K4 \(flags .*LIST\).*at most {big} "):
        TMF.check_smem(TMF.FusedSpec(**{**spec.__dict__, "n_atoms": big + 1}))
    with pytest.raises(ValueError, match="compact list"):
        TMF._check_slots(sys_.fused, None, 1)
    sl = sys_.fused.channels(st.pos[None], st.h[None])
    with pytest.raises(ValueError, match="slot shape"):
        TMF._check_slots(sys_.fused, {**sl, "slot": sl["slot"][:, :8]}, 1)
    with pytest.raises(TypeError, match="count has dtype"):
        TMF._check_slots(sys_.fused, {**sl, "count": sl["count"].long()}, 1)
    with pytest.raises(ValueError, match="seven channels"):
        TMF._check_channels(sys_.fused, None, 1)
    ch = sys_.fused.channels_first(st.pos[None], st.h[None])
    with pytest.raises(ValueError, match="channel lj1 shape"):
        TMF._check_channels(sys_.fused, {**ch, "lj1": ch["lj1"][:, :8]}, 1)
    with pytest.raises(TypeError, match="channel idx"):
        TMF._check_channels(sys_.fused, {**ch, "idx": ch["idx"].long()}, 1)
