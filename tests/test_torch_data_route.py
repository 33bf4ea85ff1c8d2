"""Systems read from LAMMPS data files (``MaterialSpec.data_file``) and the
route ``material.build_system`` chooses for them, against the JAX package,
float64 on the CPU.

The input is the small united-atom melt of tests/test_torch_staged_prep.py
(27 chains of 6 beads, 6 A cutoffs) written out by tests/torch_file_util.py,
once as it is and once with one harmonic improper per interior bead triple
of each chain (beads k+1, k, k+2, k+3: an angle near 0 on the built
zigzag, far from the +-180 degree cut).  Checks, each with its tolerance:

* the improper file takes ``unfused: impropers`` (JAX's XLA route, where
  its ``_build_fused_runner`` returns None), and the engine's forces,
  energy and virial equal JAX's XLA engine on a perturbed box to 1e-10
  relative (the same autograd sums in another order); with the improper
  constant 0 the forces and virial equal the box without impropers exactly,
  with 2 kcal/mol/rad^2 they do not (the term is there);
* 20 strain steps on the unfused engine equal JAX's XLA engine to 1e-9 A
  (JAX's FIRE'd state and Maxwell draw injected);
* the file without impropers takes K1, and its system equals the built-in
  spec's bit for bit (same data);
* a constraint set whose offsets K3 cannot hold, and special-bond partners
  beyond K3's window, each take the unfused route with the reason in
  ``MDSystem.route``; ``make_runner`` still raises on them.
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
from scema_tpu_torch.md.units import REAL
from scema_tpu_torch.ops import md_fused as TMF

from torch_file_util import with_impropers, write_data
from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

MELT = dict(n_chains=32, chain_length=6)
OPTS = dict(force_field="opls", opls_lj_cutoff=6.0, opls_coul_cutoff=6.0, validate=False)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("data")
    melt = TD.build_alkane_melt(MELT["n_chains"], MELT["chain_length"])
    paths = {}
    L = MELT["chain_length"]
    for name, data in (("plain", melt), ("improper", with_impropers(melt, L, 2.0)),
                       ("improper0", with_impropers(melt, L, 0.0))):
        paths[name] = str(d / f"{name}.data")
        write_data(paths[name], data)
    return paths


@pytest.fixture(scope="module")
def improper_systems(files):
    spec = dict(OPTS, name="m", data_file=files["improper"])
    jsys, jst = JM.build_system(JM.MaterialSpec(**spec))
    tsys, tst = TM.build_system(TM.MaterialSpec(**spec), device="cpu")
    return jsys, jst, tsys, tst


def test_impropers_take_the_unfused_route(improper_systems):
    jsys, jst, tsys, tst = improper_systems
    assert tsys.route == "unfused: impropers" and tsys.fused is None
    assert jsys.fused is None  # the JAX package's XLA engine
    assert len(tsys.ff.impropers) == 27 * 3
    assert np.array_equal(np64(tst.pos), np.asarray(jst.pos))
    assert np.array_equal(np64(tst.h), np.asarray(jst.h))
    with pytest.raises(NotImplementedError, match="impropers"):
        TMF.make_runner(tsys.ff, tsys.masses, REAL)


def test_forces_energy_virial_match_xla_engine(improper_systems):
    jsys, jst, tsys, _ = improper_systems
    pos = np.asarray(jst.pos) + 0.05 * np.random.default_rng(1).standard_normal(jst.pos.shape)
    h = np.asarray(jst.h)
    nbr = jsys.build_neighbors(jnp.asarray(pos), jnp.asarray(h))
    Fj, Ej, Wj = (np.asarray(x) for x in jax.jit(
        lambda p, hh, nb: JE.forces_energy_virial(jsys, p, hh, nb))(
            jnp.asarray(pos), jnp.asarray(h), nbr))
    Wj = Wj[[0, 1, 2, 0, 0, 1], [0, 1, 2, 1, 2, 2]]
    p, hh = torch.as_tensor(pos)[None], torch.as_tensor(h.copy())[None]
    Ft, Et, Wt = TE.forces_energy_virial(tsys, p, hh, tsys.build_neighbors(p, hh))
    assert abs(float(Et[0]) - float(Ej)) <= 1e-10 * abs(float(Ej))
    assert rel_err(Ft[0], Fj) < 1e-10
    assert rel_err(Wt[0], Wj) < 1e-10


def test_improper_term_is_in_the_forces_and_virial(files):
    """The unfused engine takes the improper term through ``OPLS.energy``:
    with K = 0 its forces and virial are the plain box's exactly, with K =
    2 kcal/mol/rad^2 they differ."""
    out = {}
    for name in ("plain", "improper0", "improper"):
        sys_, st = TM.build_system(TM.MaterialSpec(**OPTS, name="m", data_file=files[name],
                                                   use_fused=False), device="cpu")
        pos = st.pos + 0.05 * torch.as_tensor(
            np.random.default_rng(4).standard_normal(tuple(st.pos.shape)))
        out[name] = TE.forces_virial(sys_, pos[None], st.h[None])
    assert torch.equal(out["improper0"][0], out["plain"][0])
    assert torch.equal(out["improper0"][1], out["plain"][1])
    # K (chi - chi0) ~ 2 x 0.17 rad: forces of ~0.1-1 kcal/mol/A on the improper atoms
    assert float((out["improper"][0] - out["plain"][0]).abs().max()) > 0.1
    assert float((out["improper"][1] - out["plain"][1]).abs().max()) > 0.1


def test_strain_steps_match_xla_engine(improper_systems):
    jsys, jst, tsys, _ = improper_systems
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, 40, dt0=0.5))(jst)
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(3), 300.0))
    eps = [1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4]
    jr = jax.jit(lambda s: JE.run_strain(jsys, s, jnp.asarray(eps), jnp.asarray(20), 300.0,
                                         2.0))(jst)
    tr = TE.run_strain(tsys, interop.md_state(jst), torch.tensor(eps, dtype=torch.float64), 20,
                       300.0, 2.0)
    assert np.abs(np64(tr.pos) - np.asarray(jst.pos)).max() > 1e-3  # the steps moved the atoms
    assert np.abs(np64(tr.pos) - np.asarray(jr.pos)).max() < 1e-9
    assert np.abs(np64(tr.h) - np.asarray(jr.h)).max() < 1e-12


def test_file_without_impropers_takes_k1_as_the_built_in_melt(files):
    fsys, fst = TM.build_system(TM.MaterialSpec(**OPTS, name="m", data_file=files["plain"]),
                                device="cpu")
    bsys, bst = TM.build_system(TM.MaterialSpec(**OPTS, **MELT, name="m"), device="cpu")
    assert fsys.route == bsys.route == "K1"
    for f in ("pos", "vel", "h", "vxi"):
        assert torch.equal(getattr(fst, f), getattr(bst, f))
    assert torch.equal(fsys.masses, bsys.masses)
    for f in ("k1_tbl", "k1_code", "k1_win", "topo", "lj1", "lj2"):
        assert torch.equal(getattr(fsys.fused, f), getattr(bsys.fused, f)), f
    assert fsys.fused.spec == bsys.fused.spec
    pos = fst.pos + 0.05 * torch.as_tensor(
        np.random.default_rng(5).standard_normal(tuple(fst.pos.shape)))
    Ff, Wf = TE.forces_virial(fsys, pos[None], fst.h[None])
    Fb, Wb = TE.forces_virial(bsys, pos[None], bst.h[None])
    assert torch.equal(Ff, Fb) and torch.equal(Wf, Wb)


def _pairs(offset: int, n_blocks: int, mass: float) -> TD.MolecularData:
    """A gas of bonded pairs (a, a + offset), ``n_blocks`` blocks of
    2 offset atoms on a cubic grid, one atom type of ``mass``."""
    n = 2 * offset * n_blocks
    side = int(np.ceil(n ** (1 / 3)))
    grid = np.stack(np.meshgrid(*[np.arange(side)] * 3, indexing="ij"), -1).reshape(-1, 3)
    pos = 3.0 * grid[:n] + 0.5
    bonds = np.array([[b + i, b + i + offset] for b in range(0, n, 2 * offset)
                      for i in range(offset)], np.int32)
    return TD.MolecularData(
        masses=np.array([mass]), pos=pos, vel=None, types=np.zeros(n, np.int32),
        charges=np.zeros(n), box=np.eye(3) * 3.0 * side, pair_coeffs=np.array([[0.1, 2.5]]),
        bonds=bonds, bond_types=np.zeros(len(bonds), np.int32),
        bond_coeffs=np.array([[300.0, 1.1]]), angles=np.zeros((0, 3), np.int32),
        angle_types=np.zeros(0, np.int32), angle_coeffs=np.zeros((0, 2)),
        dihedrals=np.zeros((0, 4), np.int32), dihedral_types=np.zeros(0, np.int32),
        dihedral_coeffs=np.zeros((0, 4)))


@pytest.mark.parametrize("offset, mass, reason", [
    (9, 1.008, "constraint offsets (pack_shake: constraint offset 9 too large)"),
    (13, 12.0, "are special-bond partners 13 apart; K3's window"),
], ids=["shake_offsets", "k3_window"])
def test_kernel_refusals_take_the_unfused_route(tmp_path, offset, mass, reason):
    """Bonds 9 apart between mass-1 atoms: K3's roll SHAKE takes offsets
    below 8 (JAX's XLA route too); bonds 13 apart: special-bond partners
    beyond K3's window of 12 (the port's own route; JAX's kernel reads its
    planes)."""
    path = tmp_path / "pairs.data"
    write_data(path, _pairs(offset, 4, mass))
    sys_, _ = TM.build_system(TM.MaterialSpec(**OPTS, name="p", data_file=str(path), shake=True),
                              device="cpu")
    assert sys_.fused is None and sys_.route.startswith("unfused: ") and reason in sys_.route
    assert sys_.route[len("unfused: "):] == TMF.fused_refusal(sys_.ff, sys_.masses,
                                                              sys_.constraints)
    with pytest.raises(NotImplementedError, match="too large" if offset == 9 else "13 apart"):
        TMF.make_runner(sys_.ff, sys_.masses, REAL, constraints=sys_.constraints)


def test_routes_of_the_built_in_systems():
    """``MDSystem.route`` of the other build_system branches: the SW box on K5, above
    K5's gate or with ``use_fused=False`` on the unfused engine, the LJ
    crystal on K1."""
    routes = {}
    for name, spec in (("sw", dict(force_field="sw", n_cells=2)),
                       ("sw_off", dict(force_field="sw", n_cells=2, use_fused=False)),
                       ("sw_big", dict(force_field="sw", n_cells=5)),
                       ("lj", dict(force_field="lj", a0=5.26, n_cells=4, lj_cutoff=6.0))):
        sys_, _ = TM.build_system(TM.MaterialSpec(name=name, **spec), device="cpu")
        routes[name] = sys_.route
    assert routes == {"sw": "K5", "sw_off": "unfused: use_fused=False",
                      "sw_big": "unfused: 1000 atoms above K5's 640", "lj": "K1"}
