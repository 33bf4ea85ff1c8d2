"""K5's redesign (csrc/md_k5.cu) walks, in its second sweep, the live js
that its first sweep listed per atom (a cap of ``md_fused.K5_CAP`` slots;
an atom with more walks all N).  Its plain twin against K5's plain version
and the JAX package, float64, on the CPU, on the perturbed 64-atom diamond
boxes of tests/test_torch_sw.py, cubic and tilted.

* ``k5_live_lists``: each atom's list holds its live js (r2 < (rc -
  1e-6)^2, r2 > 1e-8, j != i) in j order up to the cap, and its count is
  the number of live js — checked against a brute-force numpy sweep.
* ``k5_forces_list_plain`` (sweep 2 over the lists, all N js for an atom
  above the cap) against ``md_forces_virial_plain`` (K5's plain version,
  ``_sw_forces_plain``): 1e-12 relative — the same pairs, summed in
  another order; at caps 16 (no atom above), 8 (some) and 2 (all);
  against JAX autograd of ``sw.SW.energy``: forces 1e-10, virial 1e-9, as
  tests/test_torch_sw.py holds the plain version."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import neighbor as JNB
from scema_tpu.md.forcefields import sw as JSW

from scema_tpu_torch.md import lattice as TL
from scema_tpu_torch.md import neighbor as TNB
from scema_tpu_torch.md.forcefields import sw as TSW
from scema_tpu_torch.md.units import REAL
from scema_tpu_torch.ops import md_fused as TMF

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _box(tilted: bool):
    pos, h = TL.diamond(5.431, 2, 2, 2)
    pos = pos + np.random.default_rng(7).normal(scale=0.15, size=pos.shape)
    if tilted:
        h = h.copy()
        h[0, 1], h[0, 2], h[1, 2] = 0.9, -0.6, 0.4
    return pos, h


def _runner():
    return TMF.make_runner_sw(TSW.SI, torch.full((64,), 28.0855, dtype=torch.float64), REAL)


def _rows(pos, h):
    return torch.as_tensor(pos).T[None].contiguous(), TMF.h6_of(torch.as_tensor(h))[None]


@pytest.fixture(scope="module", params=[False, True], ids=["cubic", "tilted"])
def box(request):
    pos, h = _box(request.param)
    p, h6 = _rows(pos, h)
    return pos, h, p, h6, TMF.md_forces_virial_plain(_runner(), p, h6)


def _live_brute(pos, h, rc2):
    """live[i, j] of d = r_j - r_i by the kernel's sequential triclinic
    rounding (z, then y, then x), pair by pair in numpy."""
    n = len(pos)
    live = np.zeros((n, n), dtype=bool)
    for i in range(n):
        for j in range(n):
            d = pos[j] - pos[i]
            d = d - np.round(d[2] / h[2, 2]) * h[:, 2]  # box vectors: h's columns
            d = d - np.round(d[1] / h[1, 1]) * h[:, 1]
            d = d - np.round(d[0] / h[0, 0]) * h[:, 0]
            r2 = float(d @ d)
            live[i, j] = i != j and 1e-8 < r2 < rc2
    return live


@pytest.mark.parametrize("cap", [16, 8])
def test_live_lists_hold_every_live_pair(box, cap):
    pos, h, p, h6, _ = box
    lst, cnt = TMF.k5_live_lists(_runner(), p, h6, cap)
    live = _live_brute(pos, h, TMF.sw_consts(_runner().spec)["rc2"])
    assert np.array_equal(cnt[0].numpy(), live.sum(1))
    for i in range(64):
        js = np.nonzero(live[i])[0]
        k = min(cap, len(js))
        assert np.array_equal(lst[0, :k, i].numpy(), js[:k])
        assert bool((lst[0, k:, i] == i).all())  # dead slots: the atom itself
    assert int(cnt.max()) <= 16


@pytest.mark.parametrize("cap", [16, 8, 2])
def test_list_walk_matches_plain_and_jax(box, cap):
    pos, h, p, h6, (F0, W0) = box
    F, W = TMF.k5_forces_list_plain(_runner(), p, h6, cap)
    _, cnt = TMF.k5_live_lists(_runner(), p, h6, cap)
    over = int((cnt > cap).sum())
    assert (over == 0) if cap == 16 else (over == 64 if cap == 2 else 0 < over < 64)
    assert rel_err(np64(F), np64(F0)) < 1e-12 and rel_err(np64(W), np64(W0)) < 1e-12
    spec = TNB.NeighborSpec(cutoff=TSW.SI.cutoff, skin=1.0, k_max=40, n2_threshold=10 ** 6)
    nbr = TNB.build_dense(spec, torch.as_tensor(pos), torch.as_tensor(h))
    jn = JNB.NeighborList(idx=jnp.asarray(nbr.idx.numpy(), jnp.int32),
                          mask=jnp.asarray(nbr.mask.numpy()))
    jp, jh = jnp.asarray(pos), jnp.asarray(h)
    Fj = -jax.grad(lambda q: JSW.SI.energy(q, jh, jn))(jp)
    Wj = np.asarray(-jax.grad(lambda f: JSW.SI.energy(jp @ (jnp.eye(3) + f).T,
                                                       (jnp.eye(3) + f) @ jh, jn))(
        jnp.zeros((3, 3))))
    Wj6 = [Wj[0, 0], Wj[1, 1], Wj[2, 2], 0.5 * (Wj[0, 1] + Wj[1, 0]),
           0.5 * (Wj[0, 2] + Wj[2, 0]), 0.5 * (Wj[1, 2] + Wj[2, 1])]
    assert rel_err(np64(F[0]).T, np.asarray(Fj)) < 1e-10
    assert rel_err(np64(W[0]), Wj6) < 1e-9


def test_k5_smem_budget():
    """K5's run keeps 80 B per atom of rows and 2 (cap + 1) B of list and
    count per atom: the fused gate's boxes (<= 640 atoms) fit, and the host
    refuses a box one atom above the budget before any launch."""
    spec = _runner().spec
    big = TMF.max_atoms(spec)
    assert TMF.k5_smem_bytes(spec) == (80 + 2 * (TMF.K5_CAP + 1)) * 64 + 4 * (32 * 12 + 8)
    for n in (216, 640, big):
        TMF.check_smem(TMF.FusedSpec(**{**spec.__dict__, "n_atoms": n}))
    with pytest.raises(ValueError, match=rf"K5 \(flags SW\).*at most {big} "):
        TMF.check_smem(TMF.FusedSpec(**{**spec.__dict__, "n_atoms": big + 1}))
