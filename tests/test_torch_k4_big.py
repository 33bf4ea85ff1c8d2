"""K4's form for list boxes above one block's shared memory (the global
form, csrc/md_k4_big.cu): the host contract that picks it, and the plain
version of its function on the 4096-atom charged all-atom PE box against
the JAX package, float64, on the CPU.

* The form choice: K4's shared form keeps 23 N floats per job and fits
  2509 atoms with one type; a list box above that takes the global form
  (8 N floats in shared memory) up to its own cap, and only a box above
  that cap raises.  K3 keeps its cap (tests/test_torch_allatom.py).
* The 4096-atom box (``material.PEAA4096``: 128 C10H22 chains, the PME
  split, SHAKE) builds on K4's global form; its forces and virial from the
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


@pytest.mark.parametrize("n_types", [1, 3])
def test_form_choice_and_caps(n_types):
    spec = _spec()
    shared, glob = TMF.max_atoms(spec, n_types), TMF.k4_big_max_atoms(spec, n_types)
    room = TMF._MAX_SMEM // 4 - 2 * n_types ** 2 - 32 * 12 - 4
    assert shared == room // 23 and glob == room // 8 and glob > 2 * shared
    for n, big in ((2240, False), (shared, False), (shared + 1, True), (4096, True),
                   (glob, True)):
        s = _spec(n_atoms=n)
        assert TMF.k4_big(s, n_types) == big, n
        TMF.check_smem(s, n_types)
        rows = 8 if big else 23
        assert TMF.k34_smem_bytes(s, n_types) == 4 * (rows * n + 2 * n_types ** 2 + 32 * 12 + 4)
        assert TMF.k34_smem_bytes(s, n_types) <= TMF._MAX_SMEM
    with pytest.raises(ValueError, match=rf"K4 \(flags .*LIST\).*global form.*at most {glob} "):
        TMF.check_smem(_spec(n_atoms=glob + 1), n_types)
    # K3 has no global form: its cap is its shared form's
    k3 = _spec(k=0, n_atoms=shared + 1)
    assert k3.kernel == "K3" and not TMF.k4_big(k3, n_types)
    with pytest.raises(ValueError, match=rf"K3 .*at most {shared} "):
        TMF.check_smem(k3, n_types)


def test_peaa4096_builds_on_the_global_form(big):
    tsys, jsys, _, _ = big
    r = tsys.fused
    T = int(r.k34_tbl.shape[0])
    assert tsys.n_atoms == 4096 and r.spec.kernel == "K4" and r.spec.k == 1112
    assert r.spec.flags == "COUL+EWALD+PATTERNS+SHAKE+FEXT+LIST"
    assert TMF.k4_big(r.spec, T) and tsys.n_atoms <= TMF.k4_big_max_atoms(r.spec, T)
    TMF.check_smem(r.spec, T)
    assert jsys.nspec.k_max == r.nspec.k_max and jsys.nspec.cells == r.nspec.cells


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
