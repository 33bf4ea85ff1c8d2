"""The port's ReaxFF fields against the JAX package's, float64, on the CPU,
on the synthetic H/C/N/O parameter file of tests/torch_file_util.py (the
repository holds no ffield.reax.2):

* the parser: every field of ``parse_ffield`` equal, and both packages'
  ``build_reax`` tables equal to the port's ``interop.reax`` carry;
* the dense and the list field (``energy_terms``, forces by autograd,
  QEq charges) on CH4, a water dimer (hydrogen bonds on) and the 32-atom
  all-atom PE melt (4 x C2 at 0.25 g/cm^3, on the engine's neighbor list
  for the list field), each a batch of 3 randomly perturbed states against
  JAX's vmapped field: 1e-10 relative (measured ~1e-15);
* the list field on its all-pairs list against the port's dense field;
* QEq: each job's charges sum to 0, and a warm solve seeded from a
  converged one gives the cold solve's charges;
* ``qeq=False`` and the ``bond_orders`` diagnostics of both fields (the
  latter against JAX's);
* the errors: the dense field's 2048-atom cap, a missing ffield path and
  an element the file lacks.

JAX's side runs jitted (one compile per field and system, ~3-6 s each)
in module fixtures.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import material as JM
from scema_tpu.md.forcefields import reax as JR
from scema_tpu.md.forcefields.reax_ffield import parse_ffield as j_parse

from scema_tpu_torch import interop
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md.forcefields import reax as TR
from scema_tpu_torch.md.forcefields.reax_ffield import parse_ffield as t_parse

import torch_file_util as fu
from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

ELEMENTS = ["H", "C", "N", "O"]
BOX = np.eye(3) * 30.0
TOL = 1e-10
MELT = dict(name="rx", force_field="reax", n_chains=4, chain_length=2, pe_density=0.25,
            validate=False)

pytestmark = pytest.mark.usefixtures("one_torch_thread")


@pytest.fixture(scope="module")
def ffield(tmp_path_factory):
    path = tmp_path_factory.mktemp("lammps_scripts_reax") / "ffield.reax.synthetic"
    fu.write_ffield(path)
    return str(path)


def _ch4():
    d = 1.09 / math.sqrt(3.0)
    pos = np.array([[0, 0, 0], [d, d, d], [d, -d, -d], [-d, d, -d], [-d, -d, d]], float)
    return pos + 15.0, [12.011, 1.008, 1.008, 1.008, 1.008]


def _water_dimer():
    w = np.array([[0, 0, 0], [0.97, 0, 0], [-0.25, 0.94, 0]], float)
    return np.vstack([w, w + np.array([2.9, 0.2, 0.1])]) + 15.0, [15.999, 1.008, 1.008] * 2


def _perturbed(pos, seed, scale=0.03):
    rng = np.random.default_rng(seed)
    return np.stack([pos + scale * rng.standard_normal(pos.shape) for _ in range(3)])


def _jax_eval(ff, pos, box, nbr=None):
    """JAX's energy terms, forces and charges, vmapped over the states."""
    def terms_of(p, b, nb):
        terms = ff.energy_terms(p, b) if nb is None else ff.energy_terms(p, b, nb)
        return terms["total"], {k: v for k, v in terms.items() if k != "qeq_aux"}

    def one(p, b, nb):
        (_, terms), g = jax.value_and_grad(terms_of, has_aux=True)(p, b, nb)
        return terms, -g

    axes = (0, 0, None if nbr is None else 0)
    terms, F = jax.jit(jax.vmap(one, in_axes=axes))(jnp.asarray(pos), jnp.asarray(box), nbr)
    return {k: np.asarray(v) for k, v in terms.items()}, np.asarray(F)


def _port_eval(ff, pos, box, nbr=None):
    p = torch.as_tensor(pos).requires_grad_(True)
    terms = ff.energy_terms(p, torch.as_tensor(box), nbr)
    (g,) = torch.autograd.grad(terms["total"].sum(), p)
    return {k: np64(v) for k, v in terms.items() if k != "qeq_aux"}, np64(-g)


def _melt_states(ffield):
    """The 32-atom melt (JAX's build), 3 perturbed states, their boxes and
    JAX's engine neighbor lists."""
    jsys, jst = JM.build_system(JM.MaterialSpec(**MELT, reax_ffield=ffield))
    pos = _perturbed(np.asarray(jst.pos), 7, scale=0.05)
    box = np.repeat(np.asarray(jst.h)[None], 3, 0)
    nbr = jax.vmap(jsys.build_neighbors)(jnp.asarray(pos), jnp.asarray(box))
    return jsys, pos, box, nbr


@pytest.fixture(scope="module")
def systems(ffield):
    """(name, masses, positions (3, N, 3), boxes, JAX list or None) of the
    three test systems."""
    ch4, m_ch4 = _ch4()
    wat, m_wat = _water_dimer()
    jsys, mpos, mbox, mnbr = _melt_states(ffield)
    melt_m = np.asarray(jsys.masses)
    box3 = np.repeat(BOX[None], 3, 0)
    return {"ch4": (m_ch4, _perturbed(ch4, 1), box3, None),
            "water": (m_wat, _perturbed(wat, 2), box3, None),
            "melt": (melt_m, mpos, mbox, mnbr)}


@pytest.fixture(scope="module")
def jax_runs(ffield, systems):
    out = {}
    for name, (m, pos, box, nbr) in systems.items():
        for impl in ("dense", "list"):
            ff = JR.build_reax(ffield, ELEMENTS, m, impl=impl)
            out[name, impl] = _jax_eval(ff, pos, box, nbr if impl == "list" else None)
    return out


def test_parser_matches_jax(ffield):
    a, b = j_parse(ffield, ELEMENTS), t_parse(ffield, ELEMENTS)
    for f in a.__dataclass_fields__:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype and np.array_equal(x, y, equal_nan=True), f
        else:
            assert x == y, f
    assert b.symbols == ("H", "C", "N", "O") and b.swb == 10.0


@pytest.mark.parametrize("impl", ["dense", "list"])
def test_tables_match_jax_and_interop(ffield, impl):
    """``build_reax`` in both packages gives the same tables, types,
    cutoff and flags from one file, and ``interop.reax`` carries JAX's
    field into an equal port field."""
    m = [15.999, 1.008, 1.008, 12.011, 14.007]
    jff = JR.build_reax(ffield, ELEMENTS, m, impl=impl)
    tff = TR.build_reax(ffield, ELEMENTS, m, impl=impl)
    cff = interop.reax(jff)
    assert type(cff) is type(tff) and tff.with_hbond and tff.qeq
    assert list(np64(tff.types)) == [3, 0, 0, 1, 2]
    for other in (jff, cff):
        assert set(other.tables) == set(tff.tables)
        assert other.cutoff == tff.cutoff and other.with_hbond == tff.with_hbond
        assert np.array_equal(np.asarray(other.types), np64(tff.types))
        for k, v in tff.tables.items():
            w = other.tables[k]
            if torch.is_tensor(v):
                assert np.array_equal(np.asarray(w if not torch.is_tensor(w) else w.cpu()),
                                      v.cpu().numpy()), k
            else:
                assert w == v, k


@pytest.mark.parametrize("impl", ["dense", "list"])
@pytest.mark.parametrize("name", ["ch4", "water", "melt"])
def test_field_matches_jax(ffield, systems, jax_runs, name, impl):
    m, pos, box, nbr = systems[name]
    ff = TR.build_reax(ffield, ELEMENTS, m, impl=impl)
    tnbr = interop.neighbor_list(nbr) if (impl == "list" and nbr is not None) else None
    terms, F = _port_eval(ff, pos, box, tnbr)
    jterms, jF = jax_runs[name, impl]
    assert set(terms) == set(jterms)
    for k, v in jterms.items():
        assert terms[k].shape == v.shape, k
        scale = max(np.abs(v).max(), 1.0) if k != "q" else np.abs(v).max()
        assert np.abs(terms[k] - v).max() <= TOL * scale, k
    assert rel_err(F, jF) < TOL
    assert np.isfinite(F).all() and np.abs(F).max() > 1.0
    # three different states: per-job energies differ
    assert len(set(np.round(jterms["total"], 6))) == 3
    if name == "water":
        assert ff.with_hbond and (jterms["e_hb"] < -0.5).all()


@pytest.mark.parametrize("name", ["ch4", "water", "melt"])
def test_list_matches_dense(ffield, systems, name):
    """The port's list field on its all-pairs list (``_default_nbr``)
    against its dense field, batch of 3."""
    m, pos, box, _ = systems[name]
    td, Fd = _port_eval(TR.build_reax(ffield, ELEMENTS, m, impl="dense"), pos, box)
    tl, Fl = _port_eval(TR.build_reax(ffield, ELEMENTS, m, impl="list"), pos, box)
    for k in TR.TERMS + ("total", "q"):
        assert np.abs(tl[k] - td[k]).max() <= 1e-9 * max(np.abs(td[k]).max(), 1.0), k
    assert rel_err(Fl, Fd) < 1e-9


@pytest.mark.parametrize("impl", ["dense", "list"])
def test_qeq_neutral_per_job(ffield, systems, impl):
    """Each job's charges sum to 0 on its own (the neutrality shift sums
    within the job), and the batch equals its jobs run one by one."""
    m, pos, box, _ = systems["melt"]
    ff = TR.build_reax(ffield, ELEMENTS, m, impl=impl)
    pos_t, box_t = torch.as_tensor(pos), torch.as_tensor(box)
    terms = ff.energy_terms(pos_t, box_t)
    q = np64(terms["q"])
    assert q.shape == (3, len(m)) and np.abs(q).max() > 1e-3
    assert np.abs(q.sum(-1)).max() < 1e-10
    for b in range(3):
        one = ff.energy_terms(pos_t[b], box_t[b])
        assert np.abs(np64(one["q"]) - q[b]).max() < 1e-12
        assert abs(float(one["total"]) - float(terms["total"][b])) < 1e-9


def test_warm_solve_from_converged_matches_cold(ffield, systems):
    """A warm CG solve (12 trips) seeded from a converged cold solve's
    (s, tv) reproduces its charges (test_reax.py:573-583's shape), per
    job of a batch of 3."""
    m, pos, box, _ = systems["melt"]
    ff = TR.build_reax(ffield, ELEMENTS, m, impl="list")
    pos_t, box_t = torch.as_tensor(pos), torch.as_tensor(box)
    cold = ff.energy_terms(pos_t, box_t)
    assert cold["qeq_aux"].shape == (3, 2, len(m))
    warm = ff.energy_terms(pos_t, box_t, qeq_guess=cold["qeq_aux"])
    q_cold = np64(cold["q"])
    assert np.abs(np64(warm["q"]) - q_cold).max() < 1e-9 * max(np.abs(q_cold).max(), 1e-3)
    E, aux = ff.energy_qeq(pos_t, box_t, qeq_guess=cold["qeq_aux"])
    assert torch.equal(E, warm["total"]) and torch.equal(aux, warm["qeq_aux"])


@pytest.mark.parametrize("impl", ["dense", "list"])
def test_qeq_off(ffield, systems, jax_runs, impl):
    """``qeq=False``: no charges, no Coulomb or polarization energy, and
    every other term JAX's (with QEq: no other term reads the charges)."""
    m, pos, box, _ = systems["ch4"]
    ff = TR.build_reax(ffield, ELEMENTS, m, impl=impl, qeq=False)
    terms, F = _port_eval(ff, pos, box)
    jterms, _ = jax_runs["ch4", impl]
    rest = [k for k in TR.TERMS if k not in ("e_coul", "e_pol")]
    for k in rest:
        assert np.abs(terms[k] - jterms[k]).max() <= TOL * max(np.abs(jterms[k]).max(), 1.0), k
    assert np.abs(terms["total"] - sum(jterms[k] for k in rest)).max() < 1e-9
    assert not terms["q"].any() and not terms["e_coul"].any() and not terms["e_pol"].any()
    assert np.isfinite(F).all() and np.abs(F).max() > 1.0
    if impl == "list":
        assert not ff.energy_terms(torch.as_tensor(pos), torch.as_tensor(box))["qeq_aux"].any()


@pytest.mark.parametrize("impl", ["dense", "list"])
def test_bond_orders_match_jax(ffield, impl):
    """The ``fix reax/c/bonds`` diagnostics, as (N, N) matrices per job."""
    pos, m = _ch4()
    pos = _perturbed(pos, 4)
    box = np.repeat(BOX[None], 3, 0)
    jff = JR.build_reax(ffield, ELEMENTS, m, impl=impl)
    jb = jax.jit(jax.vmap(lambda p, b: jff.bond_orders(p, b)))(jnp.asarray(pos), jnp.asarray(box))
    tb = TR.build_reax(ffield, ELEMENTS, m, impl=impl).bond_orders(torch.as_tensor(pos),
                                                                   torch.as_tensor(box))
    assert set(tb) == set(jb)
    for k in jb:
        assert tb[k].shape == jb[k].shape, k
        assert np.abs(np64(tb[k]) - np.asarray(jb[k])).max() < TOL, k
    # C-H single bonds: totals ~1 on H, ~4 on C
    assert np.allclose(np64(tb["total"])[:, 1:], 1.0, atol=0.2)
    assert np.allclose(np64(tb["total"])[:, 0], 4.0, atol=0.6)


def test_errors_match_jax(ffield):
    """The dense field's 2048-atom cap, a spec without an ffield, and an
    element the file lacks raise the JAX package's errors."""
    big = TM.MaterialSpec(name="big", force_field="reax", n_chains=80, chain_length=10,
                          validate=False, reax_ffield=ffield, reax_impl="dense")
    with pytest.raises(ValueError, match="dense bond-order field"):
        TM.build_system(big, device="cpu")
    with pytest.raises(ValueError, match="needs reax_ffield"):
        TM.build_system(TM.MaterialSpec(name="g0", force_field="reax"), device="cpu")
    with pytest.raises(ValueError, match="not in force field"):
        t_parse(ffield, ["H", "C", "Xx"])
    with pytest.raises(ValueError, match="minimum-image bound"):
        TM.build_system(TM.MaterialSpec(**{**MELT, "validate": True}, reax_ffield=ffield),
                        device="cpu")


def test_build_system_matches_jax(ffield):
    """``build_system`` of the 32-atom melt: the state, masses, types and
    neighbor spec of the JAX package's, route "unfused: reax", the list
    field by default and the dense one on request."""
    jsys, jst = JM.build_system(JM.MaterialSpec(**MELT, reax_ffield=ffield))
    tsys, tst = TM.build_system(TM.MaterialSpec(**MELT, reax_ffield=ffield), device="cpu")
    assert isinstance(tsys.ff, TR.ReaxFFList) and tsys.fused is None
    assert tsys.route == "unfused: reax" and tsys.ff.fire_dt0 == 0.05
    assert np.array_equal(np64(tst.pos), np.asarray(jst.pos))
    assert np.array_equal(np64(tst.h), np.asarray(jst.h))
    assert np.array_equal(np64(tsys.masses), np.asarray(jsys.masses))
    assert np.array_equal(np64(tsys.ff.types), np.asarray(jsys.ff.types))
    assert tsys.nspec == TM.NB.NeighborSpec(**jsys.nspec.__dict__)
    assert tsys.nspec.k_max == tsys.n_atoms - 1 == 31
    dsys, _ = TM.build_system(TM.MaterialSpec(**MELT, reax_ffield=ffield, reax_impl="dense"),
                              device="cpu")
    assert isinstance(dsys.ff, TR.ReaxFFDense) and dsys.build_neighbors(tst.pos, tst.h) is None
