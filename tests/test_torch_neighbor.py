"""The port's neighbor lists and K4's channel packing against the JAX
package (``scema_tpu.md.neighbor``, ``FusedRunner.channels`` +
``pack_channels``), float64, and the all-pairs / list path choice.

Tolerances, each with its reason:
* ``required_k``, ``derive_spec``, ``max_in_range``, ``max_cell_occupancy``
  and ``_validate_setup``'s errors: exact (the same numpy arithmetic;
  the list-width error's advice names r_list, since the port has no
  width override);
* lists: equal per-row neighbor sets and masks — ``torch.topk`` and
  ``lax.top_k`` may order ties differently, so slot order is not compared;
* channels: 1e-12 per row after sorting the slots by neighbor index (the
  same products; lj1/lj2 come from JAX's w4e/sig2 through ``interop``,
  ~1e-16 relative rounding)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import material as JM
from scema_tpu.md import neighbor as JNB

from scema_tpu_torch import interop
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md import neighbor as TNB
from scema_tpu_torch.ops import md_fused as TMF


COMMON = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
              pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False)


def _tilted(h, rng):
    """A strained triclinic copy of the box h."""
    h = np.asarray(h, dtype=float).copy()
    h = h @ np.diag(1.0 + 0.02 * rng.standard_normal(3))
    h[0, 1], h[0, 2], h[1, 2] = 0.11 * h[1, 1], -0.07 * h[2, 2], 0.05 * h[2, 2]
    return h


def _row_sets(idx, mask):
    idx, mask = np.asarray(idx), np.asarray(mask)
    return [frozenset(r[m].tolist()) for r, m in zip(idx.reshape(-1, idx.shape[-1]),
                                                   mask.reshape(-1, mask.shape[-1]))]


@pytest.fixture(scope="module")
def g0():
    """The g0 material's data (512 sites) with a strained triclinic box."""
    from scema_tpu.md import data_io as JD

    data = JD.build_alkane_melt(64, 8)
    rng = np.random.default_rng(4)
    h = _tilted(data.box, rng)
    s = np.asarray(data.pos) @ np.linalg.inv(np.asarray(data.box)).T
    pos = s @ h.T + 0.1 * rng.standard_normal(data.pos.shape)
    return pos, h, len(data.pos)


def test_sizing_and_spec_match_jax(g0):
    pos, h, n = g0
    for r in (6.0, 11.0, 13.0):
        assert TNB.required_k(n, h, r) == JNB.required_k(n, h, r)
        assert TNB.max_in_range(pos, h, r) == JNB.max_in_range(pos, h, r)
    assert TNB.required_k(10, h, 13.0) == JNB.required_k(10, h, 13.0) == 9
    for L, cut in ((25.8, 10.0), (29.0, 12.0), (60.0, 12.0), (90.0, 5.0)):
        box = np.diag([L, L * 1.1, L * 0.9])
        ts, js = TNB.derive_spec(n, box, cut, 1.0, 64), JNB.derive_spec(n, box, cut, 1.0, 64)
        assert dataclasses.asdict(ts) == dataclasses.asdict(js)
        assert TNB.max_cell_occupancy(ts, pos, box) == JNB.max_cell_occupancy(js, pos, box)
    # the charged list boxes take the dense build (fewer than 3 cells)
    assert TNB.derive_spec(2240, np.eye(3) * 29.0, 12.0, 1.0).cells == (0, 0, 0)


@pytest.mark.parametrize("which", ["min_image", "k_max", "cells"])
def test_validate_setup_errors_match_jax(g0, which):
    pos, h, n = g0
    nspec = dict(cutoff=10.0, skin=1.0, k_max=224)
    if which == "min_image":
        nspec["cutoff"] = 14.0
    elif which == "k_max":
        nspec["k_max"] = 96
    else:
        nspec.update(cells=(3, 3, 3), cell_capacity=4)
    with pytest.raises(ValueError) as jerr:
        JM._validate_setup(JM.MaterialSpec(name="g0"), pos, h, JNB.NeighborSpec(**nspec))
    with pytest.raises(ValueError) as terr:
        TM._validate_setup(TM.MaterialSpec(name="g0", force_field="opls"), pos, h,
                           TNB.NeighborSpec(**nspec))
    jmsg, tmsg = str(jerr.value), str(terr.value)
    if which == "k_max":  # the port's width is density-derived: its advice names r_list
        assert tmsg.endswith(f"reduce the list range r_list={11.0:.2f} A (cutoff + skin)")
        jmsg, tmsg = jmsg.rsplit("; ", 1)[0], tmsg.rsplit("; ", 1)[0]
    assert tmsg == jmsg
    TM._validate_setup(TM.MaterialSpec(name="g0", force_field="opls"), pos, h,
                       TNB.NeighborSpec(cutoff=10.0, skin=1.0, k_max=224))


def test_dense_lists_match_jax_triclinic_g0(g0):
    """Row sets and masks of ``build_dense`` on the strained triclinic g0
    box, one box and a batch of two (the job axis)."""
    pos, h, n = g0
    spec_j = JNB.NeighborSpec(cutoff=10.0, skin=1.0, k_max=224, n2_threshold=n)
    spec_t = TNB.NeighborSpec(cutoff=10.0, skin=1.0, k_max=224, n2_threshold=n)
    jl = JNB.build(spec_j, jnp.asarray(pos), jnp.asarray(h))
    tl = TNB.build(spec_t, torch.as_tensor(pos), torch.as_tensor(h))
    assert tl.idx.shape == jl.idx.shape == (n, 224)
    assert np.array_equal(tl.mask.numpy().sum(1), np.asarray(jl.mask).sum(1))
    assert _row_sets(tl.idx, tl.mask) == _row_sets(jl.idx, jl.mask)
    # dead slots are self-padded
    self_idx = np.arange(n)[:, None].repeat(224, 1)
    assert np.array_equal(tl.idx.numpy()[~tl.mask.numpy()], self_idx[~tl.mask.numpy()])
    pos2 = np.stack([pos, pos + 0.3 * np.random.default_rng(1).standard_normal(pos.shape)])
    h2 = np.stack([h, _tilted(h, np.random.default_rng(2))])
    tb = TNB.build_dense(spec_t, torch.as_tensor(pos2), torch.as_tensor(h2))
    for b in range(2):
        jb = JNB.build_dense(spec_j, jnp.asarray(pos2[b]), jnp.asarray(h2[b]))
        assert _row_sets(tb.idx[b], tb.mask[b]) == _row_sets(jb.idx, jb.mask)


@pytest.fixture(scope="module")
def common_list():
    """JAX's and the port's list runners on the 56-atom COMMON box (K = 56)."""
    jsys, jst = JM.build_system(JM.MaterialSpec(**COMMON, use_ewald=True, use_fused=True,
                                                force_list_kernel=True))
    tsys, _ = TM.build_system(TM.MaterialSpec(**COMMON, use_ewald=True, force_list_kernel=True),
                              device="cpu")
    rng = np.random.default_rng(3)
    pos = np.asarray(jst.pos) + 0.05 * rng.standard_normal(jst.pos.shape)
    return jsys, tsys, pos, _tilted(jst.h, rng)


def test_common_box_lists_match_jax(common_list):
    jsys, tsys, pos, h = common_list
    assert dataclasses.asdict(tsys.fused.nspec) == dataclasses.asdict(jsys.nspec)
    jl = JNB.build(jsys.nspec, jnp.asarray(pos), jnp.asarray(h))
    tl = TNB.build(tsys.fused.nspec, torch.as_tensor(pos), torch.as_tensor(h))
    assert np.array_equal(tl.mask.numpy(), np.asarray(jl.mask))  # rows fill in distance order
    assert _row_sets(tl.idx, tl.mask) == _row_sets(jl.idx, jl.mask)
    conv = interop.neighbor_list(jl)
    assert np.array_equal(conv.idx.numpy(), np.asarray(jl.idx))


def _sorted_by_idx(ch, keep=None):
    """Each atom's slots sorted by neighbor index; with ``keep`` (1, K, N)
    the kept slots first (the others after them, in slot order)."""
    key = ch["idx"][0].long()
    if keep is not None:
        key = torch.where(keep[0], key, key.shape[1] + torch.arange(key.shape[0])[:, None])
    order = torch.sort(key, dim=0, stable=True).indices
    return {k: torch.gather(v[0], 0, order).double().numpy() for k, v in ch.items()}


def test_channels_match_jax_pack_channels(common_list):
    jsys, tsys, pos, h = common_list
    jr, tr = jsys.fused, tsys.fused
    assert tr.spec.k == jr.spec.k == 56 and tr.spec.flags.endswith("+LIST")
    jch = interop.list_channels(jr.channels(jnp.asarray(pos), jnp.asarray(h)), tsys.n_atoms)
    # the first design's seven channels (pack_channels) slot for slot
    tch = tr.channels_first(torch.as_tensor(pos)[None], torch.as_tensor(h)[None])
    assert set(tch) == set(jch) == set(tr.channel_names)
    assert tch["idx"].dtype == torch.int32 and tch["idx"].shape == (1, 56, tsys.n_atoms)
    a, b = _sorted_by_idx(tch), _sorted_by_idx(jch)
    assert np.array_equal(a["idx"], b["idx"])
    for name in ("lj1", "lj2", "qq", "imx", "imy", "imz"):
        scale = max(np.abs(b[name]).max(), 1.0)
        assert np.abs(a[name] - b[name]).max() <= 1e-12 * scale, name
    # the tilted box needs nonzero images, and special-bond weights zero
    # some in-range slots
    assert np.abs(a["imx"]).max() >= 1 and (a["lj1"] == 0).sum() > (a["idx"] == np.arange(
        tsys.n_atoms)).sum()
    # the path's compact list (pack_slots) decodes to JAX's slots less the
    # ones whose weights are all 0, which it drops
    slots = tr.channels(torch.as_tensor(pos)[None], torch.as_tensor(h)[None])
    dec = TMF.k4_slots_to_channels(tr, slots)
    n = tsys.n_atoms
    keep = (jch["idx"] != torch.arange(n, dtype=jch["idx"].dtype)) & ~(
        (jch["lj1"] == 0) & (jch["lj2"] == 0) & (jch["qq"] == 0))
    assert torch.equal(slots["count"][0], keep[0].sum(0).to(torch.int32))
    live = torch.arange(56)[:, None] < slots["count"][0][None, :]
    a, b = _sorted_by_idx(dec, live[None]), _sorted_by_idx(jch, keep)
    m = live.numpy()  # each atom's kept slots come first in both
    assert np.array_equal(a["idx"][m], b["idx"][m])
    for name in ("lj1", "lj2", "qq", "imx", "imy", "imz"):
        scale = max(np.abs(b[name]).max(), 1.0)
        assert np.abs(a[name][m] - b[name][m]).max() <= 1e-12 * scale, name


def test_reused_buffers_rebuild_only_the_given_jobs(common_list):
    _, tsys, pos, h = common_list
    tr = tsys.fused
    p = torch.as_tensor(np.stack([pos, pos[::-1].copy()]))
    hh = torch.as_tensor(np.stack([h, h]))
    full = tr.channels(p, hh)
    buf = tr.channels(p, hh, reuse=True)
    assert all(torch.equal(buf[k], full[k]) for k in full)
    again = tr.channels(p.flip(0), hh, jobs=torch.tensor([1]), reuse=True)
    assert again["slot"].data_ptr() == buf["slot"].data_ptr()
    for k in full:  # job 1 now holds job 0's list, job 0 is untouched
        assert torch.equal(again[k][0], full[k][0]) and torch.equal(again[k][1], full[k][0])


@pytest.mark.parametrize("case", ["dense_small", "dense_no_cells", "cells"])
def test_build_dispatch_matches_jax(case, monkeypatch):
    """``build`` takes the dense build where N <= n2_threshold or the spec
    has no cells (JAX too), else the gather cell build: the same sets as
    JAX's ``build`` (its structured form) on an fcc crystal of 6^3 cells
    with noise (864 atoms, 4^3 cells of capacity 31)."""
    from scema_tpu.md import lattice as JL

    pos, h = JL.fcc(4.0, 6, 6, 6)
    pos = pos + 0.05 * np.random.default_rng(0).standard_normal(pos.shape)
    jspec = JNB.derive_spec(len(pos), h, cutoff=4.5, skin=0.5, k_max=48)
    assert jspec.cells == (4, 4, 4)
    jspec = dataclasses.replace(jspec, n2_threshold=len(pos) if case == "dense_small" else 100,
                                cells=(0, 0, 0) if case == "dense_no_cells" else jspec.cells)
    jl = jax.jit(JNB.build, static_argnums=0)(jspec, jnp.asarray(pos), jnp.asarray(h))
    calls = []
    for name in ("build_dense", "build_cells", "build_cells_structured"):
        def spy(*a, _fn=getattr(TNB, name), _name=name):
            calls.append(_name)
            return _fn(*a)

        monkeypatch.setattr(TNB, name, spy)
    tl = TNB.build(TNB.NeighborSpec(**dataclasses.asdict(jspec)), torch.as_tensor(pos),
                   torch.as_tensor(np.asarray(h, dtype=float)))
    assert _row_sets(tl.idx, tl.mask) == _row_sets(jl.idx, jl.mask)
    assert calls == (["build_cells"] if case == "cells" else ["build_dense"])


def _jax_gate(n_atoms, charged, force_list):
    """material.py:379-393 as the JAX package computes it."""
    npad = -(-n_atoms // 128) * 128
    return (2 + int(charged) + 3) * npad * npad * 4 <= 81 * 1024 * 1024 and not force_list


@pytest.mark.parametrize("which", ["g0", "peaa", "peaa2240", "g0_forced"])
def test_path_choice_matches_reference_rule(which):
    """The port takes the reference's path: all-pairs for g0 and PEAA, the
    list for PEAA2240 and for any ``force_list_kernel`` spec; the list
    width of bench.py's 2240-atom box is required_k(2240, box, 13 A)
    rounded up to 8 (~1112)."""
    from scema_tpu.md import data_io as JD

    g0 = TM.MaterialSpec(name="g0", force_field="opls")
    spec = {"g0": g0, "peaa": TM.PEAA, "peaa2240": TM.PEAA2240,
            "g0_forced": TM.MaterialSpec(**{**g0.__dict__, "force_list_kernel": True})}[which]
    data = (JD.build_pe_melt_allatom(spec.n_chains, spec.chain_length, density=spec.pe_density)
            if spec.allatom else JD.build_alkane_melt(spec.n_chains, spec.chain_length))
    n = len(data.pos)
    want_allpairs = _jax_gate(n, spec.allatom, spec.force_list_kernel)
    assert want_allpairs == (which in ("g0", "peaa"))
    assert TM.allpairs_admitted(n, spec.allatom, spec.force_list_kernel) == want_allpairs
    sys_, _ = TM.build_system(spec, device="cpu")
    r = sys_.fused
    assert (r.spec.k == 0) == want_allpairs
    if not want_allpairs:
        cutoff = max(spec.opls_lj_cutoff, spec.opls_coul_cutoff if spec.allatom else 0.0)
        k = max(32, JNB.required_k(n, data.box, cutoff + 1.0))
        assert r.spec.k == r.nspec.k_max == ((k + 7) // 8) * 8
        assert r.spec.flags.split("+")[-1] == "LIST" and r.nspec.cells == (0, 0, 0)
    if which == "peaa2240":
        assert n == 2240 and 1100 <= r.spec.k <= 1120
        assert not _jax_gate(n, True, False)  # refused by the gate even unforced
