"""The build-time route knows each kernel's shared-memory budget
(``md_fused.fused_refusal`` / ``smem_refusal`` against ``check_smem``, the
test each kernel's launch makes on the card), float64 on the CPU.

* A 512-site data-file melt (the g0 melt written by
  tests/torch_file_util.py) with its beads spread over 160 atom types:
  K1's (160, 160) table leaves room for 296 atoms, so the system takes
  ``unfused: K1: ...`` with the box, the type count and the cap, and its
  20 strain steps on the unfused engine equal JAX's XLA engine to 1e-10 A
  (JAX's FIRE'd state and Maxwell draw injected; the same autograd sums in
  another order, as tests/test_torch_data_route.py holds them).
* On a grid of (N, T) about each kernel's cap (K1 on LJ crystals' tables,
  K3 and K4 on charged gases), ``fused_refusal`` is None exactly where
  ``check_smem`` passes, so the route and the launch cannot disagree.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.md import data_io as TD
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md.forcefields.lj import LJ
from scema_tpu_torch.ops import md_fused as TMF

from torch_file_util import with_types, write_data
from torch_port_util import np64, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

OPTS = dict(force_field="opls", opls_lj_cutoff=6.0, opls_coul_cutoff=6.0, validate=False)
N_TYPES = 160


@pytest.fixture(scope="module")
def many_types(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("data") / "g0_160.data")
    write_data(path, with_types(TD.build_alkane_melt(64, 8), N_TYPES))
    spec = dict(OPTS, name="g0t", data_file=path)
    jsys, jst = JM.build_system(JM.MaterialSpec(**spec))
    tsys, tst = TM.build_system(TM.MaterialSpec(**spec), device="cpu")
    return jsys, jst, tsys, tst


def test_many_types_take_the_unfused_route(many_types):
    jsys, jst, tsys, tst = many_types
    assert tsys.n_atoms == 512 and int(tsys.ff.lj_epsilon.shape[0]) == N_TYPES
    assert tsys.fused is None and jsys.fused is None
    why = TMF.fused_refusal(tsys.ff, tsys.masses, tsys.constraints)
    assert tsys.route == f"unfused: {why}"
    assert why.startswith(f"K1: 512 atoms of {N_TYPES} atom types need ")
    assert why.endswith(f"K1 fits at most 296 atoms of {N_TYPES} atom types")
    with pytest.raises(ValueError, match="fits at most 296 atoms"):
        TMF.check_smem(TMF.FusedSpec(n_atoms=512, cutoff2=36.0, ndof=1533, boltz=1.0,
                                     ftm2v=1.0, nktv2p=1.0), N_TYPES)
    assert np.array_equal(np64(tst.pos), np.asarray(jst.pos))


def test_many_types_run_matches_xla_engine(many_types):
    jsys, jst, tsys, _ = many_types
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, 40, dt0=0.5))(jst)
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(3), 300.0))
    eps = [1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4]
    jr = jax.jit(lambda s: JE.run_strain(jsys, s, jnp.asarray(eps), jnp.asarray(20), 300.0,
                                         2.0))(jst)
    tr = TE.run_strain(tsys, interop.md_state(jst), torch.tensor(eps, dtype=torch.float64), 20,
                       300.0, 2.0)
    assert np.abs(np64(tr.pos) - np.asarray(jst.pos)).max() > 1e-3  # the steps moved the atoms
    assert np.abs(np64(tr.pos) - np.asarray(jr.pos)).max() < 1e-10
    assert np.abs(np64(tr.h) - np.asarray(jr.h)).max() < 1e-12


def _spec(n, **flags):
    return TMF.FusedSpec(n_atoms=n, cutoff2=1.0, ndof=3 * n - 3, boltz=1.0, ftm2v=1.0,
                         nktv2p=1.0, **flags)


def _launch_fits(spec, n_types) -> bool:
    try:
        TMF.check_smem(spec, n_types)
    except ValueError:
        return False
    return True


def _gas(n, n_types):
    """n charged LJ atoms of ``n_types`` types on a cubic grid, no bonds."""
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    t = np.arange(n_types)
    e = np.zeros((0, 2), np.int32)
    return TD.MolecularData(
        masses=12.0 + 1e-3 * t, pos=3.0 * grid[:n] + 0.5, vel=None,
        types=(np.arange(n) % n_types).astype(np.int32),
        charges=0.1 * (-1.0) ** np.arange(n), box=np.eye(3) * 3.0 * side,
        pair_coeffs=np.stack([0.1 + 1e-4 * t, 2.5 + 1e-3 * t], 1), bonds=e,
        bond_types=np.zeros(0, np.int32), bond_coeffs=np.zeros((0, 2)),
        angles=np.zeros((0, 3), np.int32), angle_types=np.zeros(0, np.int32),
        angle_coeffs=np.zeros((0, 2)), dihedrals=np.zeros((0, 4), np.int32),
        dihedral_types=np.zeros(0, np.int32), dihedral_coeffs=np.zeros((0, 4)))


@pytest.mark.parametrize("kernel", ["K1", "K3", "K4"])
def test_route_refuses_exactly_where_the_launch_would(kernel):
    types = {"K1": (1, 100, 128, 150, 165, 170), "K3": (1, 40, 64), "K4": (1, 64)}[kernel]
    flags = {"K1": {}, "K3": dict(coul=True), "K4": dict(coul=True, k=1)}[kernel]
    seen = set()
    for T in types:
        cap = (TMF.k4_big_max_atoms if kernel == "K4" else TMF.max_atoms)(_spec(64, **flags), T)
        for n in sorted({64, max(cap, 1), max(cap, 1) + 1}):
            want = _launch_fits(_spec(n, **flags), T)
            if kernel == "K1":
                ff = LJ(epsilon=torch.full((T, T), 0.2, dtype=torch.float64),
                        sigma=torch.full((T, T), 3.4, dtype=torch.float64), cutoff=8.0,
                        types=torch.arange(n) % T)
                why = TMF.fused_refusal(ff, torch.full((n,), 40.0, dtype=torch.float64))
            else:
                ff = TD.to_opls(_gas(n, T), lj_cutoff=8.0, coul_cutoff=8.0, use_ewald=False)
                why = TMF.fused_refusal(ff, torch.full((n,), 12.0, dtype=torch.float64),
                                        list_kernel=kernel == "K4")
            assert (why is None) == want, (kernel, n, T, why)
            assert want or why.startswith(f"{kernel}: {n} atoms of {T} atom type")
            seen.add(want)
    assert seen == {True, False}
