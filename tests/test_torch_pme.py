"""The port's k-space sums (``md/forcefields/coulomb.py`` Ewald and
``md/forcefields/pme.py`` PME) against the JAX package, float64, on the
boxes of tests/test_pme.py: a random neutral box and a triclinic one.

Tolerances: reciprocal energies and their forces 1e-10 relative — the same
sums in another order (the port spreads with ``index_add``, JAX with
per-axis matrices and a matrix product; measured ~1e-15); the B-spline
weights and Euler factors, the k-vector sets and the mesh sizes exactly;
the batched form equals the per-job values to 1e-12."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import data_io as JD
from scema_tpu.md.forcefields import coulomb as JC
from scema_tpu.md.forcefields import pme as JP

from scema_tpu_torch import interop
from scema_tpu_torch.md import data_io as TD
from scema_tpu_torch.md.forcefields import coulomb as TC
from scema_tpu_torch.md.forcefields import pme as TP

from torch_port_util import rel_err


def _random_box(seed, n, h):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(0, 1, (n, 3)) @ np.asarray(h).T
    q = rng.normal(size=n)
    return pos, q - q.mean(), np.asarray(h, dtype=float)


BOXES = {
    "random": lambda: _random_box(3, 96, np.eye(3) * 18.0),
    "triclinic": lambda: _random_box(5, 64, [[16.0, 1.2, 0.8], [0.0, 15.0, 1.0],
                                             [0.0, 0.0, 17.0]]),
}


def _energy_and_forces(obj, pos, h):
    p = torch.as_tensor(pos)[None].requires_grad_(True)
    e = obj.reciprocal_energy(p, torch.as_tensor(h)[None])
    (g,) = torch.autograd.grad(e.sum(), p)
    return float(e[0].detach()), -g[0].numpy()


@pytest.mark.parametrize("box", sorted(BOXES))
@pytest.mark.parametrize("kind", ["ewald", "pme"])
def test_reciprocal_energy_and_forces_match_jax(box, kind):
    pos, q, h = BOXES[box]()
    maker_j, maker_t = (JC.Ewald, TC.Ewald) if kind == "ewald" else (JP.PME, TP.PME)
    jew = maker_j.create(q, cutoff=6.0, h0=h, accuracy=1e-5)
    tew = maker_t.create(q, cutoff=6.0, h0=h, accuracy=1e-5)
    assert tew.alpha == jew.alpha
    if kind == "ewald":
        assert np.array_equal(tew.kvecs.numpy(), np.asarray(jew.kvecs))
    else:
        assert tew.mesh == jew.mesh
    pj, hj = jnp.asarray(pos), jnp.asarray(h)
    e_j = float(jew.reciprocal_energy(pj, hj))
    f_j = -np.asarray(jax.grad(lambda p: jew.reciprocal_energy(p, hj))(pj))
    e_t, f_t = _energy_and_forces(tew, pos, h)
    assert abs(e_t - e_j) <= 1e-10 * abs(e_j)
    assert rel_err(f_t, f_j) < 1e-10
    assert float(tew.self_energy()) == pytest.approx(float(jew.self_energy()), rel=1e-14)


@pytest.mark.parametrize("mesh", [(16, 16, 16), (16, 16, 15)])
def test_half_spectrum_even_and_odd_mesh_match_jax(mesh):
    """The port's rfftn half spectrum (interior K3 columns counted twice)
    against JAX's full-spectrum fftn, even and odd K3."""
    pos, q, h = _random_box(12, 48, np.eye(3) * 14.0)
    jpme = dataclasses.replace(JP.PME.create(q, cutoff=6.0, h0=h, mesh=mesh),
                               half_spectrum=False)
    tpme = TP.PME.create(q, cutoff=6.0, h0=h, mesh=mesh)
    e_j = float(jpme.reciprocal_energy(jnp.asarray(pos), jnp.asarray(h)))
    e_t, _ = _energy_and_forces(tpme, pos, h)
    assert abs(e_t - e_j) <= 1e-10 * abs(e_j)


def test_bspline_and_euler_factors_match_jax():
    u = np.random.default_rng(0).uniform(0, 1, 64)
    for j in range(5):
        a = TP.bspline_m(5, torch.as_tensor(u + j)).numpy()
        assert np.array_equal(a, JP.bspline_m(5, u + j))
    for K in (15, 16, 36):
        assert np.array_equal(TP._euler_b2(K, 5), JP._euler_b2(K, 5))
        assert TP._next_fast(K) == JP._next_fast(K)


def test_batched_jobs_with_own_boxes_match_single():
    """A batch of jobs, each with its own (strained) box, gives each job's
    own reciprocal energy — the form the k-space split runs in."""
    pos, q, h = BOXES["triclinic"]()
    tpme = TP.PME.create(q, cutoff=6.0, h0=h, accuracy=1e-5)
    jpme = interop.kspace(JP.PME.create(q, cutoff=6.0, h0=h, accuracy=1e-5))
    scale = torch.tensor([1.0, 1.01, 0.99], dtype=torch.float64)[:, None, None]
    hb = torch.as_tensor(h)[None] * scale
    pb = torch.as_tensor(pos)[None] * scale.transpose(1, 2)
    e_b = tpme.reciprocal_energy(pb, hb)
    for k in range(3):
        e_1 = jpme.reciprocal_energy(pb[k:k + 1], hb[k:k + 1])
        assert abs(float(e_b[k]) - float(e_1[0])) <= 1e-12 * abs(float(e_1[0]))


def _charged_melt(n_chains):
    data = JD.build_alkane_melt(n_chains, 8)
    q = np.where(np.arange(len(data.pos)) % 2 == 0, 0.1, -0.1)
    return dataclasses.replace(data, charges=q)


@pytest.mark.parametrize("kspace,n_chains,expect", [
    ("auto", 8, "Ewald"), ("auto", 300, "PME"), ("ewald", 8, "Ewald"), ("pme", 8, "PME")])
def test_to_opls_kspace_selection_matches_jax(kspace, n_chains, expect):
    """``to_opls``'s choice (dense Ewald below 2048 atoms, PME from 2048
    up under 'auto'), its charges, alpha and k-vectors or mesh equal
    JAX's."""
    data = _charged_melt(n_chains)
    jff = JD.to_opls(data, lj_cutoff=6.0, coul_cutoff=6.0, use_ewald=True, kspace=kspace)
    tff = TD.to_opls(data, lj_cutoff=6.0, coul_cutoff=6.0, use_ewald=True, kspace=kspace)
    assert type(jff.ewald).__name__ == type(tff.ewald).__name__ == expect
    assert np.array_equal(tff.charges.numpy(), np.asarray(jff.charges))
    assert tff.ewald.alpha == jff.ewald.alpha
    if expect == "PME":
        assert tff.ewald.mesh == jff.ewald.mesh
        assert np.array_equal(tff.ewald.b2z.numpy(), np.asarray(jff.ewald.b2z))
    else:
        assert np.array_equal(tff.ewald.kvecs.numpy(), np.asarray(jff.ewald.kvecs))
    assert TD.to_opls(data, 6.0, 6.0, use_ewald=False).ewald is None
