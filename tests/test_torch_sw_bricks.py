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
* The path's design (the live list and chunk pruning), float64: the live
  list equals a direct sweep (counts, slots in sweep order), the forces
  over it equal ``sw_forces_plain`` to 1e-12 with and without overflowing
  slots (a cap of 2), and through it K6c equals JAX's interpret mode to
  1e-10; no live pair falls in a pruned chunk pair; the check that holds
  the card's list to the sweep (``live_list_errors``) passes the sweep's
  list and catches a dropped pair, a dead pair and a wrong count.  On orthorhombic,
  tilted and drifted boxes (atoms moved up to 1.5 A after the bricks were
  built).  The moments kernel's plain version stays ``sw_moments_plain``,
  which the tests above hold to JAX.

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


def _drifted(cells: int, tilt: float, drift: float, seed: int):
    """A box whose bricks were built before its atoms moved: positions up
    to ``drift`` A (each axis) from the ones the structure was built on,
    and the box tilted (xy = tilt, xz = tilt / 2) afterwards."""
    pos, h = _box(cells, seed=seed)
    sl, nb, va = SWB.brick_structure(pos, h, TSW.SI.cutoff)
    rng = np.random.default_rng(seed + 100)
    pos = pos + rng.uniform(-drift, drift, pos.shape)
    h = h.copy()
    h[0, 1], h[0, 2] = tilt, 0.5 * tilt
    return pos, h, (sl, nb, va)


def _plain_inputs(pos, h, struct):
    sl, nb, va = struct
    tiles = SWB.pack_bricks(_t(pos)[None], torch.as_tensor(sl))
    hh, ih = SWB.boxes(_t(h)[None], (1,), torch.float64, "cpu")
    return tiles, torch.as_tensor(nb), torch.as_tensor(va), hh, ih


# (cells, tilt xy in A, drift in A): orthorhombic, tilted, drifted and both
LIST_BOXES = [(3, 0.0, 0.0), (3, 0.8, 0.0), (3, 0.0, 1.5), (4, 0.6, 1.0)]


@pytest.mark.parametrize("cells,tilt,drift", LIST_BOXES)
def test_live_list_is_the_sweep_in_order(cells, tilt, drift):
    """Each slot's count and listed slots equal a direct sweep of its
    stencil: entries in list order, lanes ascending, every occupied slot
    of the entry's tile but itself within rc2 by the minimum image."""
    pos, h, struct = _drifted(cells, tilt, drift, seed=cells)
    tiles, nb, va, hh, ih = _plain_inputs(pos, h, struct)
    count, lst = SWB.live_list_plain(TSW.SI, tiles, nb, va, hh, ih, cap=SWB.LIST_CAP)
    rc2 = SWB.sw_consts(TSW.SI)["rc2"]
    x = tiles[0, :, :3].transpose(1, 2).numpy()  # (C, 128, 3)
    occ = tiles[0, :, 3].numpy() > 0.5
    hn, ihn = hh[0].numpy(), ih[0].numpy()
    for c in range(x.shape[0]):
        want = [[] for _ in range(SWB.TILE)]
        for e in range(nb.shape[1]):
            if not va[c, e]:
                continue
            b = int(nb[c, e])
            d = x[b][None, :, :] - x[c][:, None, :]
            s = d @ ihn.T
            d = (s - np.round(s)) @ hn.T
            live = occ[c][:, None] & occ[b][None, :] & ((d * d).sum(-1) < rc2)
            if b == c:
                np.fill_diagonal(live, False)
            for i in range(SWB.TILE):
                want[i] += [b * SWB.TILE + j for j in np.nonzero(live[i])[0]]
        for i in range(SWB.TILE):
            n = len(want[i])
            assert int(count[0, c, i]) == n
            got = lst[0, c, :, i].tolist()
            assert got[:min(n, SWB.LIST_CAP)] == want[i][:SWB.LIST_CAP]
            assert all(v == -1 for v in got[n:])
    assert int(count.max()) < SWB.LIST_CAP  # the cap's headroom on these boxes


@pytest.mark.parametrize("cap", [SWB.LIST_CAP, 2])
@pytest.mark.parametrize("cells,tilt,drift", LIST_BOXES)
def test_forces_over_the_list_equal_the_sweep(cells, tilt, drift, cap):
    """K6c's plain version over the live list (a slot past ``cap`` sweeping
    the stencil) equals the first design's stencil sweep to 1e-12."""
    pos, h, struct = _drifted(cells, tilt, drift, seed=cells)
    tiles, nb, va, hh, ih = _plain_inputs(pos, h, struct)
    mom = SWB.sw_moments_plain(TSW.SI, tiles, nb, va, hh, ih)
    adj = SWB.adjoints(TSW.SI, mom)
    count, lst = SWB.live_list_plain(TSW.SI, tiles, nb, va, hh, ih, cap=cap)
    over = int((count > cap).sum())
    assert (over > 0) == (cap == 2)
    got = SWB.sw_forces_list_plain(TSW.SI, tiles, adj, count, lst, nb, va, hh, ih)
    want = SWB.sw_forces_plain(TSW.SI, tiles, adj, nb, va, hh, ih)
    assert rel_err(np64(got), np64(want)) < 1e-12
    F, _, W = SWB._fev(TSW.SI, got, mom, _t(pos)[None], torch.as_tensor(struct[0]))
    Er, Fr, Wr = _list_reference(pos, h)
    assert rel_err(np64(F[0]), Fr) < 1e-10 and rel_err(np64(W[0]), Wr) < 1e-9


@pytest.mark.parametrize("key", ["216", "tilted"])
def test_k6c_over_an_overflowing_list_matches_interpret(jax_runs, key):
    """Through the list with most slots past a cap of 2, K6c still equals
    JAX's interpret-mode kernel (the 216-atom box; the tilted one against
    JAX's list energy, as test_tilted_box_reference_fault)."""
    r = jax_runs[key]
    tiles, nb, va, hh, ih = _plain_inputs(r["pos"], r["h"], r["struct"])
    mom = SWB.sw_moments_plain(TSW.SI, tiles, nb, va, hh, ih)
    adj = SWB.adjoints(TSW.SI, mom)
    count, lst = SWB.live_list_plain(TSW.SI, tiles, nb, va, hh, ih, cap=2)
    assert int((count > 2).sum()) > 0
    fout = SWB.sw_forces_list_plain(TSW.SI, tiles, adj, count, lst, nb, va, hh, ih)
    F, E, W = (x[0] for x in SWB._fev(TSW.SI, fout, mom, _t(r["pos"])[None],
                                       torch.as_tensor(r["struct"][0])))
    if key == "216":
        jF, jE, jW = r["fev"]
        assert rel_err(np64(F), jF) < 1e-10
        assert abs(float(E) - float(jE)) <= 1e-10 * abs(float(jE))
        assert rel_err(np64(W), _voigt(jW)) < 1e-9
    else:
        Er, Fr, _ = _list_reference(r["pos"], r["h"])
        assert rel_err(np64(F), Fr) < 1e-10 and abs(float(E) - Er) <= 1e-10 * abs(Er)


@pytest.mark.parametrize("cap", [SWB.LIST_CAP, 2])
@pytest.mark.parametrize("cells,tilt,drift", LIST_BOXES[1:3])
def test_live_list_check_passes_the_sweep_and_catches_faults(cells, tilt, drift, cap):
    """live_list_errors, which holds the card's list to the sweep, passes
    the plain list (whole or cut at a cap of 2) and counts a dropped live
    pair, a listed dead pair and a wrong count each as a violation."""
    pos, h, struct = _drifted(cells, tilt, drift, seed=cells)
    tiles, nb, va, hh, ih = _plain_inputs(pos, h, struct)
    count, lst = SWB.live_list_plain(TSW.SI, tiles, nb, va, hh, ih, cap=cap)
    assert SWB.live_list_errors(TSW.SI, tiles, nb, va, hh, ih, count, lst)[0] == 0
    c, i = (int(v) for v in torch.nonzero(count[0] >= 2)[0])
    k = min(int(count[0, c, i]), cap) - 1
    dropped_c, dropped_l = count.clone(), lst.clone()
    dropped_c[0, c, i] -= 1
    dropped_l[0, c, k, i] = -1
    d = SWB._min_image([(tiles[0, :, a] - tiles[0, c, a, i]).reshape(1, -1) for a in range(3)],
                       hh, ih)
    far = int(torch.argmax(d[0] ** 2 + d[1] ** 2 + d[2] ** 2))
    dead_l = lst.clone()
    dead_l[0, c, k, i] = far  # a slot at the far side of the box
    wrong_c = count.clone()
    wrong_c[0, c, i] += 1
    for cn, ls in ((dropped_c, dropped_l), (count, dead_l), (wrong_c, lst)):
        assert SWB.live_list_errors(TSW.SI, tiles, nb, va, hh, ih, cn, ls)[0] > 0


@pytest.mark.parametrize("tilt,drift", [(0.0, 0.0), (2.0, 0.0), (1.0, 1.5)])
def test_no_live_pair_in_a_pruned_chunk_pair(tilt, drift):
    """On the slice's 4096-atom box (48 bricks), orthorhombic, tilted and
    drifted: the sphere test prunes chunk pairs, and every pair of slots in
    a pruned chunk pair is dead (at least rc apart by the minimum image)."""
    pos, h, struct = _drifted(8, tilt, drift, seed=8)
    tiles, nb, va, hh, ih = _plain_inputs(pos, h, struct)
    sph = SWB.chunk_spheres_plain(tiles, hh, ih)
    rc = SWB.sw_consts(TSW.SI)["rc"]
    pruned = SWB.pruned_chunks_plain(sph, nb, va, hh, ih, rc)[0]  # (C, K, 4, 4)
    assert 0.1 < float(pruned.double().mean()) < 0.9
    C, W = tiles.shape[1], SWB.TILE // SWB.CHUNK
    ti = tiles[0]
    for e in range(nb.shape[1]):
        b = nb[:, e].long()
        d = SWB._min_image([ti[b, a][:, None, :] - ti[:, a, :, None] for a in range(3)],
                           hh.expand(C, 3, 3), ih.expand(C, 3, 3))
        r2 = (d[0] ** 2 + d[1] ** 2 + d[2] ** 2).reshape(C, W, SWB.CHUNK, W, SWB.CHUNK)
        both = ((ti[:, 3] > 0.5).reshape(C, W, SWB.CHUNK, 1, 1)
                & (ti[b, 3] > 0.5).reshape(C, 1, 1, W, SWB.CHUNK))
        closest = torch.where(both, r2, torch.full_like(r2, float("inf"))).amin((2, 4))
        assert bool((closest[pruned[:, e]] >= rc * rc).all()), e
