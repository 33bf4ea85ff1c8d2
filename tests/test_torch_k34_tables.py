"""K3's and K4's pair parameters without N x N planes, K4's compact list,
and their force entries' tiling (scema_tpu_torch/ops/md_fused.py,
csrc/md_charged.cuh), on the CPU.

K3's kernel reads a (T, T) lj1/lj2 type table, per-atom charges and a
window of offsets |j - i| <= W for the special-bond weights where the plain
version (and the TPU kernel) reads dense planes with the weights folded in;
K4's kernel reads one 32-bit word per list slot (neighbor, image integers,
special-bond order) and a count of live slots per row where the first
design read seven channels; both force entries split each box into tiles of
rows.  These tests hold the host-side pieces to the planes, to the first
design's channels and to the plain force entry.

Tolerances, each with its reason:
* the planes rebuilt from the tables (``k3_dense_planes``) equal
  ``dense_planes`` and ``dense_qq`` bit for bit in float64: the table entry
  and q_i q_j are the planes' float64 products before the weight, and every
  weight on all-atom polyethylene is 0 or 1 — or, with the usual OPLS 1-4
  weight special_lj = special_coul = (0, 0, 0.5), a power of two, which
  scales the product exactly;
* the compact list decoded (``k4_slots_to_channels``) equals the first
  design's channels (``pack_channels``) bit for bit in float64, once the
  slots whose LJ and Coulomb weights are both 0 are dropped from them in
  their order: the same products, and the same image integers;
* the tiling's fixed-order partial sums against ``md_forces_virial_plain``
  in float64: 1e-12 relative (the same terms summed per tile of rows)."""
import dataclasses

import numpy as np
import pytest
import torch

from scema_tpu_torch.md import box as TB
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md import neighbor as TNB
from scema_tpu_torch.md.units import REAL
from scema_tpu_torch.ops import md_fused as TMF

from torch_port_util import one_torch_thread  # noqa: F401  (module fixture)

# the 56-atom all-atom fixture of tests/test_torch_allatom.py: patterns,
# SHAKE, the Ewald k-space split; K3 all-pairs or (force_list_kernel) K4
SMALL = dict(name="pe", force_field="opls", allatom=True, n_chains=4, chain_length=4,
             pe_density=0.33, opls_lj_cutoff=5.0, opls_coul_cutoff=4.5, validate=False,
             use_ewald=True)
G0_LIST = TM.MaterialSpec(name="g0", force_field="opls", force_list_kernel=True)
HALF = (0.0, 0.0, 0.5)  # OPLS's usual special_lj / special_coul: 1-4 pairs at half weight


@pytest.fixture(scope="module")
def systems(one_torch_thread):
    out = {}
    for name, spec in (("peaa", TM.PEAA), ("peaa2240", TM.PEAA2240),
                       ("k3", TM.MaterialSpec(**SMALL)),
                       ("k4", TM.MaterialSpec(**SMALL, force_list_kernel=True)),
                       ("g0_list", G0_LIST)):
        out[name] = TM.build_system(spec, dtype=torch.float64, device="cpu")
    return out


@pytest.mark.parametrize("case", ["peaa", "peaa2240"])
def test_k3_tables_rebuild_the_planes(systems, case):
    ff = systems[case][0].ff
    t = TMF.k3_tables(ff, torch.float64)
    lj1, lj2 = TMF.dense_planes(ff, torch.float64)
    qq = TMF.dense_qq(ff, torch.float64)
    r1, r2, rq = TMF.k3_dense_planes(t["tbl"], t["q"], t["code"], t["spec"], t["win"])
    assert t["tbl"].shape == (3, 3, 2) and t["win"].shape == (ff.types.shape[0], 21, 2)
    assert torch.equal(r1, lj1) and torch.equal(r2, lj2) and torch.equal(rq, qq)
    # every special weight of all-atom PE is 0: the window only excludes
    assert int(t["spec"].count_nonzero()) == 0
    assert bool(((t["code"] >> (TMF.K34_EXCL + 10)) & 1).all())  # the atom itself


def _special_half(sys_):
    """The float64 runner of ``sys_`` with special_lj = special_coul =
    (0, 0, 0.5): 1-2 and 1-3 partners excluded, 1-4 partners at half
    weight."""
    ff = dataclasses.replace(sys_.ff, special_lj=HALF, special_coul=HALF)
    r = sys_.fused
    return TMF.make_runner(ff, sys_.masses, REAL, dtype=torch.float64,
                           constraints=sys_.constraints, kspace=r.kspace,
                           kspace_every=r.kspace_every, nspec=r.nspec,
                           rebuild_every=r.rebuild_every)


@pytest.mark.parametrize("case", ["peaa", "peaa2240"])
def test_k3_tables_rebuild_the_planes_with_special_weights(systems, case):
    """With the 1-4 pairs at half weight the window holds them as offsets
    of another weight (0.5 in both columns of ``win``), the 1-2 and 1-3
    partners as excluded, and the planes rebuilt from the tables equal the
    dense planes with those weights folded in."""
    ff = dataclasses.replace(systems[case][0].ff, special_lj=HALF, special_coul=HALF)
    t = TMF.k3_tables(ff, torch.float64)
    lj1, lj2 = TMF.dense_planes(ff, torch.float64)
    qq = TMF.dense_qq(ff, torch.float64)
    r1, r2, rq = TMF.k3_dense_planes(t["tbl"], t["q"], t["code"], t["spec"], t["win"])
    assert torch.equal(r1, lj1) and torch.equal(r2, lj2) and torch.equal(rq, qq)
    W = (t["win"].shape[1] - 1) // 2
    sp = torch.stack([(t["spec"] >> d) & 1 for d in range(2 * W + 1)], 1).bool()
    ex = torch.stack([(t["code"] >> (TMF.K34_EXCL + d)) & 1 for d in range(2 * W + 1)], 1).bool()
    # every 1-4 partner is an offset of weight 0.5, and no offset is both
    wl = torch.as_tensor(ff.pair_weights(HALF))
    assert int(sp.sum()) == int((wl == 0.5).sum()) > 0 and not bool((sp & ex).any())
    assert bool((t["win"][sp] == 0.5).all())
    # the 1-2 and 1-3 partners excluded, and each atom itself (the diagonal)
    assert int(ex.sum()) == int((wl == 0.0).sum())


def test_runners_carry_their_tables(systems):
    r3, r4 = systems["peaa"][0].fused, systems["peaa2240"][0].fused
    assert r3.spec.kernel == "K3" and TMF.k3_window(r3) == 10 and r3.k4_ord is None
    assert r4.spec.kernel == "K4" and r4.k34_win.shape[1] == 1 and r4.k4_ord.dtype == torch.int8
    assert bool((r4.k34_code == r4.k34_code & TMF.K34_TYPE).all())  # K4: type bits only
    moved = r4.to(dtype=torch.float32)
    assert moved.k34_code.dtype == torch.int32 and moved.k34_tbl.dtype == torch.float32
    assert moved.k4_ord.dtype == torch.int8
    # 23 rows of N floats: 2240 atoms fit one block, 2510 do not
    assert TMF.max_atoms(r4.spec, 3) == (TMF._MAX_SMEM // 4 - 18 - 32 * 12 - 4) // 23
    TMF.check_smem(r4.spec, 3)


def test_partner_beyond_the_window_raises(systems):
    """A special-bond partner 13 sites away: the window cannot hold it, so
    make_runner refuses the system rather than run it without the weight."""
    sys_ = systems["k3"][0]
    excl = sys_.ff.excl.copy()
    excl[0, 2, 0], excl[13, 2, 0] = 13, 0  # atoms 0 and 13 made 1-4 partners
    ff = dataclasses.replace(sys_.ff, excl=excl)
    with pytest.raises(NotImplementedError, match="13 apart"):
        TMF.make_runner(ff, sys_.masses, REAL, dtype=torch.float32, constraints=sys_.constraints,
                        kspace=sys_.fused.kspace)


def _compact(ch: dict, keep: torch.Tensor, n: int) -> dict:
    """The first design's channels (1, K, N) with the slots not in ``keep``
    taken out in their order, the tail self-padded (index i, zeros)."""
    out = {}
    K = ch["idx"].shape[1]
    for name, x in ch.items():
        tail = torch.arange(n, dtype=x.dtype) if name == "idx" else torch.zeros(n, dtype=x.dtype)
        y = tail.expand(1, K, n).clone()
        for i in range(n):
            col = x[0, keep[0, :, i], i]
            y[0, :col.shape[0], i] = col
        out[name] = y
    return out


@pytest.fixture(scope="module")
def peaa2240_fired(systems):
    """The PEAA2240 box after one FIRE step, in float64."""
    sys_, st = systems["peaa2240"]
    return TE.minimize_fire(sys_, st, n_steps=1, dt0=0.5)


def _check_decode(r, ff, st) -> torch.Tensor:
    """K4's compact list of runner r (force field ff) at state st: its
    count is each row's live slots less the partners whose LJ and Coulomb
    weights are both 0, and its words decode to the first design's channels
    with those slots dropped.  Returns the special-bond order of each kept
    slot (0 on dead slots)."""
    n = r.spec.n_atoms
    pos, h = st.pos[None], st.h[None]
    slots = r.channels(pos, h)
    ch = r.channels_first(pos, h)
    idx = ch["idx"].long()
    live = idx != torch.arange(n)
    wl = torch.as_tensor(ff.pair_weights(ff.special_lj))
    wc = torch.as_tensor(ff.pair_weights(ff.special_coul))
    ii = torch.arange(n).expand_as(idx)
    keep = live & ~((wl[ii, idx] == 0) & (wc[ii, idx] == 0))
    assert torch.equal(slots["count"], keep.sum(1).to(torch.int32))
    assert int(slots["count"].max()) < r.spec.k
    dec = TMF.k4_slots_to_channels(r, slots)
    ref = _compact(ch, keep, n)
    for name in r.channel_names:
        assert torch.equal(dec[name], ref[name]), name
    slot = slots["slot"].long()
    on = torch.arange(r.spec.k)[None, :, None] < slots["count"].long()[:, None, :]
    return torch.where(on, (slot >> 28) & 3, 0)


def test_compact_slots_decode_to_the_channels(systems, peaa2240_fired):
    """On a FIRE'd PEAA2240 state in float64: the compact list's count is
    each row's live slots less its excluded partners, and its words decode
    to the first design's channels with those slots dropped."""
    sys_ = systems["peaa2240"][0]
    order = _check_decode(sys_.fused, sys_.ff, peaa2240_fired)
    assert int(order.count_nonzero()) == 0  # every special partner dropped


def test_compact_slots_decode_with_special_weights(systems, peaa2240_fired):
    """With the 1-4 pairs at half weight the pack keeps them (order 3 in
    their words) and drops only the 1-2 and 1-3 partners; the words decode
    to the first design's channels, whose planes carry the 0.5."""
    sys_ = systems["peaa2240"][0]
    r = _special_half(sys_)
    ff = dataclasses.replace(sys_.ff, special_lj=HALF, special_coul=HALF)
    order = _check_decode(r, ff, peaa2240_fired)
    assert int((order == 3).sum()) > 0 and int(((order == 1) | (order == 2)).sum()) == 0


def test_image_outside_the_range_raises(systems):
    """An atom moved ten boxes away needs an image integer of about -10,
    which the slot word's 4 bits cannot hold: the pack raises."""
    sys_, st = systems["k4"]
    pos = st.pos.clone()
    pos[0] += 10.0 * st.h[0]
    pos, h = pos[None], st.h[None]
    with pytest.raises(ValueError, match="image integer"):
        TMF.pack_slots(sys_.fused, pos, h, TNB.build(sys_.fused.nspec, pos, h))


@pytest.mark.parametrize("case", ["k3", "k4", "g0_list"])
@pytest.mark.parametrize("rows", [TMF.K34_TILE_ROWS, 8])
def test_force_tiling_sums_to_the_plain_force_entry(systems, case, rows):
    """Three perturbed, tilted boxes in float64: each tile's rows, its
    bonded halo (the patterns' reach, or the chain's 3 anchors) and its
    partial virial, summed in tile order, give the plain force entry's
    forces and virial."""
    sys_, st = systems[case]
    n = sys_.n_atoms
    rng = np.random.default_rng(3)
    pos = st.pos.expand(3, -1, -1) + torch.as_tensor(rng.normal(scale=0.02, size=(3, n, 3)))
    h = st.h.expand(3, 3, 3).clone()
    h[1, 0, 1], h[2, 0, 2], h[2, 1, 2] = 0.4, 0.3, -0.2
    pos = TB.remap_affine(st.h.expand(3, 3, 3), h, pos)
    p = pos.transpose(1, 2).contiguous()
    h6 = TMF.h6_of(h)
    r = sys_.fused
    nbr = r.channels(pos, h) if r.spec.k else None
    F, W = TMF.md_forces_virial_plain(r, p, h6, nbr)
    Ft, Wt = TMF.k34_tiles_plain(r, p, h6, nbr, rows=rows)
    assert float((Ft - F).abs().max() / F.abs().max()) < 1e-12
    assert float((Wt - W).abs().max() / W.abs().max()) < 1e-12
