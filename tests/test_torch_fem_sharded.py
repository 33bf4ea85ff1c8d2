"""``scema_tpu_torch.fem.sharded`` (the node- and qp-sharded FE step)
against the JAX package's unsharded step on four gloo CPU ranks (float64,
one torch thread each; the ranks spawn once, tests/torch_dist_util.py):
the 3x3x7-cell Hooke dogbone (384 dofs, 504 qps) over meshes of 2 and 4
ranks for 4 steps, stress within 1e-9 and u within 1e-12 relative, equal
job counts (tests/test_sharding.py:185-229), and each rank holding n /
ranks rows of the nodal and qp leaves.  Over 2 ranks each qp block splits
a cell (63 cells), so a shared cell is assembled with the other rank's
qps at zero; over 4 too."""
import jax
import numpy as np
import pytest

from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.hmm.problem import assign_materials, build_hooke_hmm

import torch_dist_util as DU

WORLD = 4
N_STEPS = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    jcfg = DU.hooke_cfg(JCfg, (3, 3, 7))
    jh = build_hooke_hmm(jcfg)
    material = np.asarray(assign_materials(jcfg, jh.geom, jh.dtype))
    ranks = DU.run_ranks(DU.fem_sharded_worker, WORLD, tmp_path_factory.mktemp("fem"),
                         material, N_STEPS)
    step = jax.jit(jh.step)
    s = jh.init_state()
    outs = []
    for _ in range(N_STEPS):
        s, o = step(s)
        outs.append((int(o.n_jobs), int(o.n_flagged), float(o.residual0),
                     float(o.residual1), float(o.reaction_force)))
    return ranks, s, outs


@pytest.mark.parametrize("ways", [2, 4])
def test_sharded_fe_matches_jax(runs, ways):
    ranks, s1, outs = runs
    sig1, u1, v1 = (np.asarray(x) for x in (s1.qp.new_stress, s1.u, s1.v))
    for r in range(ways):
        got = ranks[r][ways]
        assert np.allclose(got["stress"], sig1, atol=1e-9 * max(np.abs(sig1).max(), 1.0))
        assert np.allclose(got["u"], u1, atol=1e-12 * max(np.abs(u1).max(), 1.0))
        assert np.abs(got["v"] - v1).max() <= 1e-12 * np.abs(v1).max()
        for (j0, f0, a0, b0, rf0), (j1, f1, a1, b1, rf1) in zip(got["outs"], outs):
            assert (j0, f0) == (j1, f1) and j1 > 0
            assert np.allclose([a0, b0, rf0], [a1, b1, rf1], rtol=1e-9)


@pytest.mark.parametrize("ways", [2, 4])
def test_state_is_distributed(runs, ways):
    """The memory posture is real: each rank holds n / ranks rows of the
    nodal and qp leaves, so its persistent state is 1 / ranks of the full
    one."""
    ranks = runs[0]
    n_dofs, n_qp = 384, 504
    for r in range(ways):
        assert ranks[r][ways]["rows"] == (n_dofs // ways, n_qp // ways, n_qp // ways)
        assert ranks[r][ways]["bytes"] * ways == ranks[r][ways]["full_bytes"]
    # ranks 2 and 3 lie outside the 2-rank mesh and hold no block of it
    assert all((ways in ranks[r]) == (r < ways) for r in range(WORLD))
