"""K4's run for list boxes above one block's shared memory (the cluster
form, csrc/md_k4_big.cu; the global form stays as its A/B partner): the
host contract that picks it, and the plain version of its function on the
4096-atom charged all-atom PE box against the JAX package, float64, on the
CPU.

* The form choice: K4's shared form keeps 23 N floats per job and fits
  2509 atoms with one type; a list box above that takes the cluster form,
  one job on C CTAs (a power of two up to 16), each holding the job's
  float4s and charges (20 B per atom), the table and 18 floats per row it
  owns plus a fixed halo and reduction part, up to its own cap (the CTA at
  16 per job), and only a box above that cap raises.  The cap is no lower
  than the global form's (7215 atoms at 1 type, 6191 at 64).  K3 keeps its
  cap (tests/test_torch_allatom.py).
* The host's C over a grid of (jobs, atoms, types): a size whose CTA fits,
  the fewest waves x rows per CTA; the row cuts at chain boundaries on
  PEAA4096, and cuts that split a SHAKE constraint flagged.
* The 4096-atom box (``material.PEAA4096``: 128 C10H22 chains, the PME
  split, SHAKE) builds on K4's cluster form; its forces and virial from the
  port's list path (K4's plain pair loop + the bonded patterns + the
  k-space remainder) fed JAX's own neighbor list equal the XLA engine's
  autograd forces on that list to 1e-6 relative — the kernel's A&S erfc
  polynomial (|err| <= 1.5e-7), as in tests/test_torch_list.py (measured
  ~1e-12)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md import neighbor as TNB
from scema_tpu_torch.ops import md_fused as TMF

from torch_port_util import one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
             pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False,
             force_list_kernel=True, use_ewald=True)


@pytest.fixture(scope="module")
def big():
    """The port's 4096-atom box and JAX's, with one seeded perturbation."""
    tsys, _ = TM.build_system(TM.PEAA4096, device="cpu")
    fields = {k: getattr(TM.PEAA4096, k) for k in (
        "name", "force_field", "allatom", "n_chains", "chain_length", "pe_density",
        "opls_lj_cutoff", "opls_coul_cutoff", "use_ewald", "kspace_every", "kspace")}
    jsys, jst = JM.build_system(JM.MaterialSpec(**fields, use_fused=False))
    pos = np.asarray(jst.pos) + 0.02 * np.random.default_rng(1).standard_normal(jst.pos.shape)
    return tsys, jsys, pos, np.asarray(jst.h)


def _spec(**kw):
    sys_, _ = TM.build_system(TM.MaterialSpec(**SMALL), device="cpu")
    return TMF.FusedSpec(**{**sys_.fused.spec.__dict__, **kw})


# what the cluster form's CTA keeps beside 20 B per atom, the table and 72 B
# per row it owns: a 12-row role buffer over 32 halo rows on each side, the
# block reduction (32 x 12 floats), two cluster reductions (2 x 16 x 12) and
# the NHC chain + broadcast (4)
CL_FIXED = 4 * (12 * 64 + 32 * 12 + 2 * 16 * 12 + 4)


def _cl_bytes(n, n_types, C):
    rows = min(n, -(-n // C) + 16)  # the even split and the cut's slack
    return 20 * n + 8 * n_types ** 2 + 72 * rows + CL_FIXED


@pytest.mark.parametrize("n_types", [1, 3])
def test_form_choice_and_caps(n_types):
    spec = _spec()
    shared, glob = TMF.max_atoms(spec, n_types), TMF.k4_big_max_atoms(spec, n_types)
    room = TMF._MAX_SMEM // 4 - 2 * n_types ** 2 - 32 * 12 - 4
    # the cluster form's cap: its CTA fits at 16 CTAs per job, one atom more does not
    assert shared == room // 23 and glob > 2 * shared
    assert _cl_bytes(glob, n_types, 16) <= TMF._MAX_SMEM < _cl_bytes(glob + 1, n_types, 16)
    assert glob >= room // 8  # no lower than the global form's
    for n, big in ((2240, False), (shared, False), (shared + 1, True), (4096, True),
                   (glob, True)):
        s = _spec(n_atoms=n)
        assert TMF.k4_big(s, n_types) == big, n
        TMF.check_smem(s, n_types)
        if big:  # the CTA at the fewest CTAs per job that fit
            C = min(c for c in (1, 2, 4, 8, 16) if _cl_bytes(n, n_types, c) <= TMF._MAX_SMEM)
            assert TMF.k34_smem_bytes(s, n_types) == _cl_bytes(n, n_types, C)
        else:
            assert TMF.k34_smem_bytes(s, n_types) == 4 * (23 * n + 2 * n_types ** 2 + 32 * 12 + 4)
        assert TMF.k34_smem_bytes(s, n_types) <= TMF._MAX_SMEM
    with pytest.raises(ValueError, match=rf"K4 \(flags .*LIST\).*cluster form.*at most {glob} "):
        TMF.check_smem(_spec(n_atoms=glob + 1), n_types)
    # K3 has no cluster form: its cap is its shared form's
    k3 = _spec(k=0, n_atoms=shared + 1)
    assert k3.kernel == "K3" and not TMF.k4_big(k3, n_types)
    with pytest.raises(ValueError, match=rf"K3 .*at most {shared} "):
        TMF.check_smem(k3, n_types)


@pytest.mark.parametrize("n_types", [1, 2, 64])
def test_cluster_size_and_budget_grid(n_types):
    """Over a grid of (jobs, atoms): the host's C is a power of two up to 16
    whose CTA fits 232448 B: the fewest CTAs that fit, doubled only while
    every job still runs at once on one CTA per SM of the card's 132; the
    cap is no lower than the global form's; no size fits above it."""
    spec = _spec()
    cap = TMF.k4_big_max_atoms(spec, n_types)
    assert cap >= {1: 7215, 2: 7215, 64: 6191}[n_types]
    for n in (TMF.max_atoms(spec, n_types) + 1, 3000, 4096, 5000, 6191, cap):
        fits = TMF.k4_cluster_fits(n, n_types)
        assert fits and fits == tuple(c for c in (1, 2, 4, 8, 16)
                                      if _cl_bytes(n, n_types, c) <= TMF._MAX_SMEM)
        for jobs in (1, 5, 8, 16, 32, 33, 37, 100, 128, 132, 576):
            C = TMF.k4_cluster_size(n, n_types, jobs)
            assert C in fits and C & (C - 1) == 0 and C <= 16
            assert TMF.k4_cluster_smem_bytes(n, n_types, -(-n // C) + 16) <= TMF._MAX_SMEM
            one_wave = [c for c in fits if jobs * c <= 132 and 132 // c >= jobs]
            assert C == max([fits[0]] + one_wave), (n, jobs, C)
    assert not TMF.k4_cluster_fits(cap + 1, n_types)
    with pytest.raises(ValueError, match="fit no cluster"):
        TMF.k4_cluster_size(cap + 1, n_types, 32)
    # 4096 atoms: 4 CTAs per job at the slice's 32 jobs (128 SMs) and at 128
    # jobs; 16 at 8 jobs; 8 where the card holds too few clusters of 16
    assert TMF.k4_cluster_size(4096, n_types, 32) == 4
    assert TMF.k4_cluster_size(4096, n_types, 128) == 4
    assert TMF.k4_cluster_size(4096, n_types, 8) == 16
    assert TMF.k4_cluster_size(4096, n_types, 8, active=lambda c: {16: 7}.get(c, 132 // c)) == 8
    with pytest.raises(RuntimeError, match="schedules no cluster"):
        TMF.k4_cluster_size(4096, n_types, 32, active=lambda c: 0)


@pytest.mark.parametrize("n_types", [1, 64])
def test_route_follows_the_cluster_budget(n_types):
    """``smem_refusal`` (the build-time route) and ``check_smem`` (the
    launch's test) agree with the cluster form's budget about its cap."""
    spec = _spec(coul=True)
    cap = TMF.k4_big_max_atoms(spec, n_types)
    for n in (cap - 1, cap, cap + 1):
        s = _spec(coul=True, n_atoms=n)
        fits = bool(TMF.k4_cluster_fits(n, n_types))
        assert (TMF.smem_refusal(s, n_types) is None) == fits == (n <= cap)
        if not fits:
            why = TMF.smem_refusal(s, n_types)
            assert f"in its cluster form fits at most {cap} atoms" in why
            with pytest.raises(ValueError, match="cluster form"):
                TMF.check_smem(s, n_types)


def test_peaa4096_builds_on_the_global_form(big):
    tsys, jsys, _, _ = big
    r = tsys.fused
    T = int(r.k34_tbl.shape[0])
    assert tsys.n_atoms == 4096 and r.spec.kernel == "K4" and r.spec.k == 1112
    assert r.spec.flags == "COUL+EWALD+PATTERNS+SHAKE+FEXT+LIST"
    assert TMF.k4_big(r.spec, T) and tsys.n_atoms <= TMF.k4_big_max_atoms(r.spec, T)
    TMF.check_smem(r.spec, T)
    assert jsys.nspec.k_max == r.nspec.k_max and jsys.nspec.cells == r.nspec.cells


def test_cluster_cuts_on_peaa4096(big):
    """The row cuts of the cluster form: on 128 chains of 32 atoms the even
    splits at 4, 8 and 16 CTAs fall between chains, where no SHAKE
    constraint crosses; cuts moved one row into a chain are flagged
    ``cross``; the halo covers the patterns' reach and SHAKE's offsets."""
    tsys = big[0]
    r = tsys.fused
    n = tsys.n_atoms
    split = TMF._shake_split(r)
    shk = r.shk.numpy()
    for k, o in enumerate(r.spec.shake_offsets):
        for a in np.nonzero(shk[k] > 0)[0][:50]:
            assert split[a + 1:a + o + 1].all()
    for C in (4, 8, 16):
        cuts, cross = TMF.k4_cluster_cuts(r, C)
        assert cuts == tuple(range(0, n + 1, n // C)) and not cross
        assert all(c % 32 == 0 for c in cuts)
    cuts = [0] + [next(c for c in range(k * n // 8, n) if split[c]) for k in range(1, 8)] + [n]
    got, cross = TMF.k4_cluster_cuts(r, 8, cuts)
    assert cross and got == tuple(cuts) and max(np.diff(cuts)) <= n // 8 + 16
    lo, hi = TMF.pattern_reach(r.spec.bonded_pattern)
    assert max(lo, hi) < TMF._CL_HALO and max(r.spec.shake_offsets) < TMF._CL_HALO
    # a box whose even split cuts a constraint: the nearest clean cut within the slack
    moved = split.copy()
    moved[1024] = True
    r._cluster.clear()
    r._cluster["split"] = moved
    cuts4, cross4 = TMF.k4_cluster_cuts(r, 4)
    d = abs(cuts4[1] - 1024)
    assert 0 < d <= TMF._CL_SLACK // 2 and not moved[cuts4[1]] and not cross4
    assert moved[1024 - d + 1:1024 + d].all() and cuts4[2:] == (2048, 3072, 4096)
    r._cluster.clear()


def test_plain_forces_virial_match_xla(big):
    tsys, jsys, pos, h = big
    r = tsys.fused
    nbr = jsys.build_neighbors(jnp.asarray(pos), jnp.asarray(h))
    F, _, W = JE.forces_energy_virial(jsys, jnp.asarray(pos), jnp.asarray(h), nbr)
    tp, th = torch.tensor(pos)[None], torch.tensor(h)[None]
    one = TNB.NeighborList(*(x[None] for x in interop.neighbor_list(nbr)))
    Ft, Wt = TMF.md_forces_virial(r, tp.transpose(1, 2), TMF.h6_of(th),
                                  nbr=TMF.pack_channels(r, tp, th, one))
    Fk, Wk = r.kspace(tp, th, want_virial=True)
    Ft, Wt = Ft.transpose(1, 2) + Fk, Wt + Wk
    W = np.asarray(W)
    assert rel_err(Ft[0], np.asarray(F)) < 1e-6
    assert rel_err(Wt[0], [W[0, 0], W[1, 1], W[2, 2], W[0, 1], W[0, 2], W[1, 2]]) < 1e-6

