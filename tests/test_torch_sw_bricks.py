"""The SW tile kernels' plain versions (K6a-e, ``ops/sw_bricks.py``)
against the JAX package, float64, on the CPU.

* K6d (brick moments), K6e (brick energy) and K6c (forces, energy,
  virial) against ``scema_tpu.ops.sw_pallas`` in interpret mode on the
  216-atom diamond box (2 bricks) with a 0.05 A jiggle: energy 1e-10
  relative, forces 1e-10, virial 1e-9, moments 1e-10 (only the summation
  order differs).
* K6a (all tile pairs, q = 0 and the general q = 0.5) on the 64-atom box
  and K6b (tile adjacency) on the 216-atom box against interpret mode:
  1e-10.
* The brick forces against JAX autograd of ``SW.energy`` over a full list
  on the 512-atom box with ``target_occ=8`` (64 bricks of 5-12 atoms, all
  27 stencil entries valid, so the stencil prunes): forces and energy
  1e-10, virial 1e-9.
* The reference-side fault on a tilted box (xy = 0.5 A): JAX's brick
  kernels round the minimum image per axis by the diagonal of h, so their
  energy and forces depart from JAX's own list ``SW.energy``; the port's
  brick plain version, on the triclinic minimum image, equals it to 1e-10.
* The numpy structure builders equal JAX's; the brick structure and
  constants come across through ``interop.sw_bricks``; a box on the brick
  kernels refuses any SW family but p = 4, q = 0.

JAX's interpret-mode calls are made once, in a module fixture.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import lattice as JL
from scema_tpu.md import neighbor as JNB
from scema_tpu.md.forcefields import sw as JSW
from scema_tpu.ops import sw_pallas as JSP

from scema_tpu_torch import interop
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md import neighbor as TNB
from scema_tpu_torch.md.forcefields import sw as TSW
from scema_tpu_torch.ops import sw_bricks as SWB

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _box(cells: int, tilt: float = 0.0, seed: int = 0):
    pos, h = JL.diamond(5.431, cells, cells, cells)
    pos = pos + 0.05 * np.random.default_rng(seed).standard_normal(pos.shape)
    h = h.copy()
    h[0, 1] = tilt
    return pos, h


def _voigt(W):
    W = np.asarray(W)
    return np.array([W[0, 0], W[1, 1], W[2, 2], 0.5 * (W[0, 1] + W[1, 0]),
                     0.5 * (W[0, 2] + W[2, 0]), 0.5 * (W[1, 2] + W[2, 1])])


def _e_of(p, f, hh, nl):
    m = jnp.eye(3) + f
    return JSW.SI.energy(p @ m.T, m @ hh, nl)


_E_GRAD = jax.jit(jax.value_and_grad(_e_of, argnums=(0, 1)))


def _list_reference(pos, h):
    """JAX autograd of SW.energy over a full list (every pair within the
    cutoff + 1 A, built by the port's dense build): (E, F, W Voigt)."""
    spec = TNB.NeighborSpec(cutoff=TSW.SI.cutoff, skin=1.0, k_max=30, n2_threshold=10 ** 6)
    nbr = TNB.build_dense(spec, _t(pos), _t(h))
    assert int(nbr.mask.sum(-1).max()) < 30
    nl = JNB.NeighborList(idx=jnp.asarray(nbr.idx.numpy(), jnp.int32),
                          mask=jnp.asarray(nbr.mask.numpy()))
    E, (gp, gf) = _E_GRAD(jnp.asarray(pos), jnp.zeros((3, 3)), jnp.asarray(h), nl)
    return float(E), -np.asarray(gp), _voigt(-0.5 * (gf + gf.T))


@pytest.fixture(scope="module")
def jax_runs():
    """JAX's interpret-mode K6 calls, once per module."""
    out = {}
    pos, h = _box(3)
    sl, nb, va = JSP.brick_structure(pos, h, JSW.SI.cutoff)
    p, hh = jnp.asarray(pos), jnp.asarray(h)
    out["216"] = dict(
        pos=pos, h=h, struct=(sl, nb, va),
        mom=np.asarray(JSP.sw_moments_pallas_bricks_raw(JSW.SI, p, hh, sl, nb, va,
                                                        interpret=True)),
        energy=float(JSP.sw_energy_pallas_bricks(JSW.SI, p, hh, sl, nb, va, interpret=True)),
        fev=[np.asarray(x) for x in JSP.sw_forces_pallas_bricks(JSW.SI, p, hh, sl, nb, va,
                                                                interpret=True)])
    pos_t, h_t = _box(3, tilt=0.5)
    sl_t, nb_t, va_t = JSP.brick_structure(pos_t, h_t, JSW.SI.cutoff)
    out["tilted"] = dict(
        pos=pos_t, h=h_t, struct=(sl_t, nb_t, va_t),
        fev=[np.asarray(x) for x in JSP.sw_forces_pallas_bricks(
            JSW.SI, jnp.asarray(pos_t), jnp.asarray(h_t), sl_t, nb_t, va_t, interpret=True)])
    pos64, h64 = _box(2, seed=1)
    out["k6a"] = {q: np.asarray(JSP.sw_moments_pallas(
        dataclasses.replace(JSW.SI, q=q), jnp.asarray(pos64), jnp.asarray(h64), 64,
        interpret=True)) for q in (0.0, 0.5)}
    out["k6a_box"] = (pos64, h64)
    nbr_a, val_a = JSP.tile_adjacency(pos, h, JSW.SI.cutoff, skin=1.0)
    out["k6b"] = (nbr_a, val_a, np.asarray(JSP.sw_moments_pallas_adj(
        JSW.SI, p, hh, nbr_a, val_a, interpret=True)))
    return out


def _t(x):
    return torch.as_tensor(np.asarray(x, dtype=np.float64))


def test_k6d_k6e_match_interpret(jax_runs):
    r = jax_runs["216"]
    assert r["struct"][0].shape[0] == 2  # two bricks
    mom = SWB.sw_moments_bricks(TSW.SI, _t(r["pos"]), _t(r["h"]), *r["struct"])
    assert rel_err(np64(mom), r["mom"][:, :SWB.NMOM]) < 1e-10
    e = float(SWB.sw_energy_bricks(TSW.SI, _t(r["pos"]), _t(r["h"]), *r["struct"]))
    assert abs(e - r["energy"]) <= 1e-10 * abs(r["energy"])


def test_k6c_matches_interpret(jax_runs):
    r = jax_runs["216"]
    before = SWB.sw_forces_bricks.launches
    F, E, W = SWB.sw_forces_bricks(TSW.SI, _t(r["pos"]), _t(r["h"]), *r["struct"])
    assert SWB.sw_forces_bricks.launches == before  # CPU tensors: the plain version
    jF, jE, jW = r["fev"]
    assert rel_err(np64(F), jF) < 1e-10
    assert abs(float(E) - float(jE)) <= 1e-10 * abs(float(jE))
    assert rel_err(np64(W), _voigt(jW)) < 1e-9
    # and against JAX autograd of SW.energy over a list
    Er, Fr, Wr = _list_reference(r["pos"], r["h"])
    assert rel_err(np64(F), Fr) < 1e-10 and rel_err(np64(W), Wr) < 1e-9
    assert abs(float(E) - Er) <= 1e-10 * abs(Er)


@pytest.mark.parametrize("q", [0.0, 0.5])
def test_k6a_matches_interpret(jax_runs, q):
    pos, h = jax_runs["k6a_box"]
    sw = dataclasses.replace(TSW.SI, q=q)
    mom = SWB.sw_moments(sw, _t(pos), _t(h))
    assert rel_err(np64(mom), jax_runs["k6a"][q][:, :SWB.NMOM]) < 1e-10


def test_k6b_matches_interpret(jax_runs):
    r = jax_runs["216"]
    nbr, valid, jm = jax_runs["k6b"]
    tn, tv = SWB.tile_adjacency(r["pos"], r["h"], TSW.SI.cutoff)
    assert np.array_equal(tn, nbr) and np.array_equal(tv, valid)
    mom = SWB.sw_moments_adj(TSW.SI, _t(r["pos"]), _t(r["h"]), tn, tv)
    assert rel_err(np64(mom), jm[:, :SWB.NMOM]) < 1e-10


def test_brick_forces_match_autograd_where_the_stencil_prunes():
    pos, h = _box(4, seed=2)
    sl, nb, va = SWB.brick_structure(pos, h, TSW.SI.cutoff, target_occ=8)
    occ = (sl < len(pos)).sum(1)
    assert sl.shape[0] == 64 and int(va.sum(1).min()) == 27 and occ.max() < 20
    F, E, W = SWB.sw_forces_bricks(TSW.SI, _t(pos), _t(h), sl, nb, va)
    Er, Fr, Wr = _list_reference(pos, h)
    assert rel_err(np64(F), Fr) < 1e-10
    assert abs(float(E) - Er) <= 1e-10 * abs(Er)
    assert rel_err(np64(W), Wr) < 1e-9


def test_tilted_box_reference_fault(jax_runs):
    """JAX's brick kernels take the minimum image from the diagonal of h
    only (sw_pallas.py:131, :294, :569, :660, :691): on a tilted box their
    energy and forces leave JAX's own list SW.energy; the port's, on the
    triclinic minimum image, equal it."""
    r = jax_runs["tilted"]
    Er, Fr, _ = _list_reference(r["pos"], r["h"])
    jF, jE, _ = r["fev"]
    assert abs(float(jE) - Er) > 1e-3 * abs(Er)
    assert rel_err(jF, Fr) > 1e-3
    F, E, _ = SWB.sw_forces_bricks(TSW.SI, _t(r["pos"]), _t(r["h"]), *r["struct"])
    assert abs(float(E) - Er) <= 1e-10 * abs(Er)
    assert rel_err(np64(F), Fr) < 1e-10
    e = float(SWB.sw_energy_bricks(TSW.SI, _t(r["pos"]), _t(r["h"]), *r["struct"]))
    assert abs(e - Er) <= 1e-10 * abs(Er)


@pytest.mark.parametrize("cells", [3, 8])
def test_structures_and_interop_match_jax(cells):
    pos, h = JL.diamond(5.431, cells, cells, cells)
    j = JSP.brick_structure(pos, h, JSW.SI.cutoff)
    t = SWB.brick_structure(pos, h, TSW.SI.cutoff)
    assert all(np.array_equal(a, b) for a, b in zip(j, t))
    jff = JSP.SWBricksFF(JSW.SI, pos, h)
    tff = interop.sw_bricks(jff, len(pos))
    assert tff.sw == TSW.SI and tff.n_bricks == len(j[0])
    assert np.array_equal(tff.slot_ids.numpy(), jff.slot_ids)
    # the material's own structure is the same
    sys_, _ = TM.build_system(TM.MaterialSpec(name="si", n_cells=cells, use_pallas_bricks=True),
                              device="cpu")
    assert sys_.fused is None and np.array_equal(sys_.ff.nbr.numpy(), jff.nbr)
    assert sys_.build_neighbors(None, None) is None  # the static structure needs no list


def test_other_sw_families_are_refused():
    p6 = dataclasses.replace(TSW.SI, p=6.0)
    with pytest.raises(ValueError, match="p = 4"):
        SWB.check_family(p6)
    with pytest.raises(ValueError, match="q = 0"):
        SWB.check_family(dataclasses.replace(TSW.SI, q=1.0))
    SWB.check_family(dataclasses.replace(TSW.SI, q=1.0), general_q=True)  # K6a takes any q
    with pytest.raises(NotImplementedError, match="p = 4, q = 0"):
        TM.build_system(TM.MaterialSpec(name="si", use_pallas_bricks=True, sw=p6), device="cpu")
