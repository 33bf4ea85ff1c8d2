"""K1's pair parameters without N x N planes, and its force entry's tiling
(scema_tpu_torch/ops/md_fused.py, csrc/md_k1.cu), on the CPU.

K1's kernel reads a (T, T) lj1/lj2 type table and a window of chain offsets
|j - i| <= 3 for the special-bond weights where the plain version (and the
TPU kernel) reads dense planes with the weights folded in; its force entry
splits each box into tiles of rows.  These tests hold both host-side pieces
to the planes and to the plain force entry.

Tolerances, each with its reason:
* the planes rebuilt from table and window (``k1_dense_planes``) equal
  ``dense_planes`` bit for bit in float32 where every weight is 0 or 1 (the
  g0 melt, a plain LJ crystal): the table entry is the plane's float64
  value before the cast, and a weight of 1 or 0 is exact; with
  special_lj = (0, 0, 0.5) the 1-4 entries are the float32 table entry
  times the weight in float32, within 1 ulp of the plane's float64 product
  cast once (here equal, 0.5 being a power of two);
* the tiling's fixed-order partial sums against ``md_forces_virial_plain``
  in float64: 1e-12 relative (the same terms summed per tile of rows).
The JAX package's planes are held to the port's in
tests/test_torch_md_fused.py."""
import dataclasses

import numpy as np
import pytest
import torch

from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md.units import REAL
from scema_tpu_torch.ops import md_fused as TMF

from torch_port_util import one_torch_thread  # noqa: F401  (module fixture)

G0 = TM.MaterialSpec(name="g0", force_field="opls")  # 64 x 8 beads, 512 sites
LJX = TM.MaterialSpec(name="lj", force_field="lj", n_cells=4, a0=5.4)  # 256-atom fcc


def _three_type_ff(ff):
    """The g0 force field over three atom types with asymmetric tables (so a
    transposed table would show) and special_lj = (0, 0, 0.5)."""
    rng = np.random.default_rng(8)
    n = ff.types.shape[0]
    eps = torch.as_tensor(0.1 + 0.1 * rng.random((3, 3)), dtype=torch.float64)
    sig = torch.as_tensor(3.5 + 0.5 * rng.random((3, 3)), dtype=torch.float64)
    types = torch.as_tensor(rng.integers(0, 3, n), dtype=torch.int64)
    return dataclasses.replace(ff, types=types, lj_epsilon=eps, lj_sigma=sig,
                               special_lj=(0.0, 0.0, 0.5))


@pytest.fixture(scope="module")
def systems(one_torch_thread):
    g0, g0_st = TM.build_system(G0, dtype=torch.float32, device="cpu")
    lj, _ = TM.build_system(LJX, dtype=torch.float32, device="cpu")
    g064, _ = TM.build_system(G0, dtype=torch.float64, device="cpu")
    return {"g0": g0, "lj": lj, "g0_64": g064, "g0_state": g0_st}


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance in float32 units in the last place."""
    ia = a.contiguous().view(torch.int32).long()
    ib = b.contiguous().view(torch.int32).long()
    return int((ia - ib).abs().max())


@pytest.mark.parametrize("case", ["g0", "lj", "three_types_special_half"])
def test_table_and_window_rebuild_the_planes(systems, case):
    ff = systems["lj" if case == "lj" else "g0"].ff
    if case == "three_types_special_half":
        ff = _three_type_ff(ff)
    tbl, code, win = TMF.k1_tables(ff, torch.float32)
    lj1, lj2 = TMF.dense_planes(ff, torch.float32)
    r1, r2 = TMF.k1_dense_planes(tbl, code, win)
    assert tbl.shape == ((3, 3, 2) if case == "three_types_special_half" else (1, 1, 2))
    if case == "three_types_special_half":
        assert int(((code >> TMF.K1_SPEC) & 0x7F).count_nonzero()) > 0
        assert _ulps(r1, lj1) <= 1 and _ulps(r2, lj2) <= 1
    else:
        assert torch.equal(r1, lj1) and torch.equal(r2, lj2)
    # the atom itself is always excluded; a chain's 1-2 partners too
    assert bool(((code >> (TMF.K1_EXCL + TMF.K1_REACH)) & 1).all())
    if case == "g0":
        assert bool(((code[:-1] >> (TMF.K1_EXCL + TMF.K1_REACH + 1)) & 1)[0::8].all())


def test_k1_runner_carries_its_table(systems):
    r = systems["g0"].fused
    assert r.spec.kernel == "K1" and r.k1_tbl.shape[:2] == (1, 1)
    assert r.k1_tbl.dtype == torch.float32 and r.k1_code.dtype == torch.int32
    assert r.k1_win.shape == (512, TMF.K1_WIN)
    moved = r.to(dtype=torch.float64)
    assert moved.k1_code.dtype == torch.int32 and moved.k1_tbl.dtype == torch.float64
    assert TMF.max_atoms(r.spec, 1) == (TMF._MAX_SMEM // 4 - 2 - 32 * 12 - 4) // 22
    assert TMF.max_atoms(r.spec, 3) == (TMF._MAX_SMEM // 4 - 18 - 32 * 12 - 4) // 22


def test_partner_outside_the_window_raises(systems):
    """A special-bond partner 5 sites away: the window cannot hold it, so
    make_runner refuses the system rather than run it without the weight."""
    sys_ = systems["g0"]
    excl = sys_.ff.excl.copy()
    excl[0, 2, 0], excl[5, 2, 0] = 5, 0  # atoms 0 and 5 made 1-4 partners
    ff = dataclasses.replace(sys_.ff, excl=excl)
    with pytest.raises(NotImplementedError, match="5 apart"):
        TMF.make_runner(ff, sys_.masses, REAL, dtype=torch.float32)


@pytest.mark.parametrize("rows", [TMF.K1_TILE_ROWS, 8])
def test_force_tiling_sums_to_the_plain_force_entry(systems, rows):
    """Three perturbed, tilted g0 boxes in float64: each tile's rows, its
    halo of 3 anchors and the virial of the anchors it owns, summed in tile
    order, give the plain force entry's forces and virial."""
    sys_, st = systems["g0_64"], systems["g0_state"]
    rng = np.random.default_rng(3)
    pos = st.pos.double().expand(3, -1, -1) + torch.as_tensor(
        rng.normal(scale=0.05, size=(3, 512, 3)))
    h = st.h.double().expand(3, 3, 3).clone()
    h[1, 0, 1], h[2, 0, 2], h[2, 1, 2] = 0.4, 0.3, -0.2
    p = pos.transpose(1, 2).contiguous()
    h6 = TMF.h6_of(h)
    F, W = TMF.md_forces_virial_plain(sys_.fused, p, h6)
    Ft, Wt = TMF.k1_tiles_plain(sys_.fused, p, h6, rows=rows)
    assert float((Ft - F).abs().max() / F.abs().max()) < 1e-12
    assert float((Wt - W).abs().max() / W.abs().max()) < 1e-12
