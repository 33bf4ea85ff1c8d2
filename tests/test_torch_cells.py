"""The port's cell-binned neighbor builds (``neighbor.build_cells``, the
gather form, and ``neighbor.build_cells_structured``) against the JAX
package's, float64 on the CPU, and the SW list route on a cell spec.

Tolerances, each with its reason:
* lists: equal per-row neighbor sets and masks — ``torch.topk`` and
  ``lax.top_k`` may order ties differently, so slot order is not compared;
* at cell capacity the same atoms drop out of the gather form on both
  sides; the JAX structured form clips the rank, so on the CPU an
  overflow atom also erases the last slot's occupant of its cell (the
  fault its gather form's comment describes): the port's structured form
  drops only the atoms beyond the capacity, so it equals JAX's gather form
  on every kept atom, and JAX's structured form except where an erased
  atom is a row or a candidate;
* the 1728-atom SW box's 20 steps on the cell build equal the same run on
  the dense build to 1e-10 A (the same pairs in another slot order, so the
  sums over a row differ in rounding only).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import lattice as JL
from scema_tpu.md import material as JM
from scema_tpu.md import neighbor as JNB

from scema_tpu_torch import interop
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md import neighbor as TNB

from torch_port_util import np64, one_torch_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _row_sets(idx, mask):
    idx, mask = np.asarray(idx), np.asarray(mask)
    return [frozenset(r[m].tolist()) for r, m in zip(idx.reshape(-1, idx.shape[-1]),
                                                   mask.reshape(-1, mask.shape[-1]))]


def _spec(jspec):
    return TNB.NeighborSpec(**dataclasses.asdict(jspec))


def _fcc():
    """tests/test_md_engine.py::test_neighbor_cells_match_dense's box: an fcc
    crystal of 6^3 cells of edge 4 A with 0.05 A of noise (864 atoms, 4^3
    cells of capacity 31)."""
    pos, h = JL.fcc(4.0, 6, 6, 6)
    pos = pos + 0.05 * np.random.default_rng(0).standard_normal(pos.shape)
    return pos, np.asarray(h, dtype=float), JNB.derive_spec(len(pos), h, cutoff=4.5,
                                                           skin=0.5, k_max=48)


def _tilted(pos, h, xy=0.3):
    """The same fractional coordinates in a box tilted by xy = 0.3 of its
    height (the minimum image and the binning of a triclinic cell)."""
    h2 = h.copy()
    h2[0, 1] = xy * h[1, 1]
    return (pos @ np.linalg.inv(h).T) @ h2.T, h2


def _jax_lists(fn, spec, pos, h):
    out = jax.jit(fn, static_argnums=0)(spec, jnp.asarray(pos), jnp.asarray(h))
    return _row_sets(out.idx, out.mask), np.asarray(out.mask)


@pytest.mark.parametrize("box", ["fcc", "tilted"])
def test_cell_builds_match_jax(box):
    pos, h, jspec = _fcc()
    if box == "tilted":
        pos, h = _tilted(pos, h)
    assert jspec.cells == (4, 4, 4)
    spec = _spec(jspec)
    dense = _jax_lists(JNB.build_dense, jspec, pos, h)[0]
    for tfn, jfn in ((TNB.build_cells, JNB.build_cells),
                     (TNB.build_cells_structured, JNB.build_cells_structured)):
        jsets, jmask = _jax_lists(jfn, jspec, pos, h)
        t = tfn(spec, torch.as_tensor(pos), torch.as_tensor(h))
        assert t.idx.shape == (len(pos), 48) and t.idx.dtype == torch.int64
        assert np.array_equal(t.mask.numpy().sum(1), jmask.sum(1))
        assert _row_sets(t.idx, t.mask) == jsets == dense
        dead = ~t.mask.numpy()  # dead slots are self-padded
        assert np.array_equal(t.idx.numpy()[dead], np.nonzero(dead)[0])


def test_cell_builds_batched_with_their_own_boxes():
    """A batch of 3 jobs, each with its own h (orthorhombic, tilted,
    strained), against JAX's builds job by job."""
    pos0, h0, jspec = _fcc()
    rng = np.random.default_rng(1)
    ps, hs = [pos0], [h0]
    p1, h1 = _tilted(pos0, h0, 0.2)
    ps.append(p1 + 0.1 * rng.standard_normal(p1.shape))
    hs.append(h1)
    h2 = h0 @ np.diag([1.03, 0.98, 1.01])
    ps.append(pos0 @ np.linalg.inv(h0).T @ h2.T)
    hs.append(h2)
    spec = _spec(jspec)
    P, H = torch.as_tensor(np.stack(ps)), torch.as_tensor(np.stack(hs))
    for tfn, jfn in ((TNB.build_cells, JNB.build_cells),
                     (TNB.build_cells_structured, JNB.build_cells_structured)):
        t = tfn(spec, P, H)
        assert t.idx.shape == (3, len(pos0), 48)
        for b in range(3):
            assert _row_sets(t.idx[b], t.mask[b]) == _jax_lists(jfn, jspec, ps[b], hs[b])[0]


def _crowded():
    """300 atoms in a 20 A box with 12 crowded into one cell of a 4^3 grid
    of capacity 8: four cells hold more atoms than the capacity."""
    rng = np.random.default_rng(0)
    pos = rng.uniform(0.0, 20.0, (300, 3))
    pos[:12] = 2.0 + 0.3 * rng.standard_normal((12, 3))
    spec = JNB.NeighborSpec(cutoff=4.0, skin=1.0, k_max=40, n2_threshold=10,
                            cells=(4, 4, 4), cell_capacity=8)
    return pos, np.eye(3) * 20.0, spec


def _ranks(spec, pos, h):
    """(rank of each atom within its cell, the cell's atom count) by the
    stable sort of the cell ids, in numpy."""
    nc = np.asarray(spec.cells)
    s = pos @ np.linalg.inv(h).T
    s -= np.floor(s)
    c = np.clip((s * nc).astype(int), 0, nc - 1)
    cid = (c[:, 0] * nc[1] + c[:, 1]) * nc[2] + c[:, 2]
    order = np.argsort(cid, kind="stable")
    cs = cid[order]
    rank = np.empty(len(pos), int)
    rank[order] = np.arange(len(pos)) - np.searchsorted(cs, cs, side="left")
    return rank, np.bincount(cid)[cid]


def test_cell_builds_at_capacity():
    pos, h, jspec = _crowded()
    assert JNB.max_cell_occupancy(jspec, pos, h) == 14 > jspec.cell_capacity
    spec = _spec(jspec)
    rank, count = _ranks(jspec, pos, h)
    dropped = set(np.flatnonzero(rank >= 8).tolist())
    erased = set(np.flatnonzero((rank == 7) & (count > 8)).tolist())
    assert len(dropped) == 11 and len(erased) == 4
    P, H = torch.as_tensor(pos), torch.as_tensor(h)
    # the gather form: the same atoms drop out on both sides
    jg = _jax_lists(JNB.build_cells, jspec, pos, h)[0]
    tg = _row_sets(*TNB.build_cells(spec, P, H))
    assert tg == jg
    assert all(not (s & dropped) for s in tg) and all(tg[i] for i in dropped)
    # the structured form: no row and no candidate for a dropped atom
    ts = _row_sets(*TNB.build_cells_structured(spec, P, H))
    assert all(not ts[i] for i in dropped)
    assert all(ts[i] == tg[i] for i in range(len(pos)) if i not in dropped)
    js = _jax_lists(JNB.build_cells_structured, jspec, pos, h)[0]
    assert all(not js[i] for i in dropped | erased)  # JAX's fault: the erased rows
    lost = dropped | erased
    for i in range(len(pos)):
        if i not in lost:
            assert js[i] == ts[i] - erased


def test_jobs_per_slice_counts_the_chosen_build():
    n = 4096
    dense = TNB.NeighborSpec(cutoff=3.7712, skin=1.0, k_max=20, n2_threshold=n)
    cells = TNB.NeighborSpec(cutoff=3.7712, skin=1.0, k_max=20, cells=(7, 7, 7),
                             cell_capacity=28)
    assert TNB.jobs_per_slice(dense, n) == (1 << 27) // (n * n) == 8
    assert TNB.jobs_per_slice(cells, n) == (1 << 27) // (n * 27 * 28) == 43


@pytest.fixture(scope="module")
def sw1728():
    """The 1728-atom diamond-Si SW box (6^3 cells) on the unfused list
    route: JAX's state and Maxwell draw, two jobs strained apart."""
    spec = dict(name="si", force_field="sw", n_cells=6)
    jsys, jst = JM.build_system(JM.MaterialSpec(**spec, use_fused=False))
    tsys, _ = TM.build_system(TM.MaterialSpec(**spec), device="cpu")
    vel = JE.maxwell_velocities(jsys, jax.random.PRNGKey(7), 300.0)
    st = interop.md_state(jst._replace(vel=vel))
    st2 = TE.MDState(*(torch.stack([getattr(st, f)] * 2) for f in ("pos", "vel", "h", "vxi")))
    return jsys, tsys, st2


def test_sw_list_route_takes_the_cell_build(sw1728):
    jsys, tsys, _ = sw1728
    assert tsys.fused is None and tsys.route.startswith("unfused: 1728 atoms")
    assert tsys.nspec == _spec(jsys.nspec) and tsys.nspec.cells == (5, 5, 5)
    assert TNB._form(tsys.nspec, tsys.n_atoms) == "gather"


def test_sw_run_on_cells_equals_the_dense_build(sw1728):
    _, tsys, st = sw1728
    dense = dataclasses.replace(tsys, nspec=dataclasses.replace(tsys.nspec, cells=(0, 0, 0)))
    eps = torch.tensor([[1e-3, 0.0, -5e-4, 2e-4, 0.0, 1e-4],
                        [-1e-3, 5e-4, 0.0, 0.0, 3e-4, 0.0]], dtype=torch.float64)
    a = TE.run_strain(tsys, st, eps, 20, 300.0, 2.0)
    b = TE.run_strain(dense, st, eps, 20, 300.0, 2.0)
    assert np.abs(np64(a.pos) - np64(st.pos)).max() > 1e-3  # the steps moved the atoms
    assert np.abs(np64(a.pos) - np64(b.pos)).max() < 1e-10
    assert np.abs(np64(a.vel) - np64(b.vel)).max() < 1e-10
    assert np.abs(np64(a.h) - np64(b.h)).max() < 1e-12
