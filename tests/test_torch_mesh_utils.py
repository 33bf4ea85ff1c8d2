"""``scema_tpu_torch.parallel.mesh_utils`` against ``scema_tpu.parallel.
mesh_utils`` on four gloo CPU ranks (float64, one torch thread each; the
ranks spawn once, tests/torch_dist_util.py): ``pad_to_multiple``, the
sharded pairwise L2 over meshes of 2 and 4 ranks (1e-12 against JAX's
``pairwise_l2``), the ("dcn", "md") mesh at (2, 2), the Hooke step sharded
over 2 ranks and over that mesh against JAX's unsharded ``build_hooke_hmm``
(1e-9 x max|sigma|, equal job counts; tests/test_sharding.py:22-45,
115-143), and the ``md_cores_min`` auto-shard rule."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.clustering.similarity import pairwise_l2
from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.hmm.problem import assign_materials, build_hooke_hmm
from scema_tpu.parallel import mesh_utils as JMU

from scema_tpu_torch.hmm.md_coupling import auto_spatial_shards
from scema_tpu_torch.md.material import MaterialSpec
from scema_tpu_torch.parallel import mesh_utils as TMU

import torch_dist_util as DU

WORLD = 4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    splines = np.random.default_rng(0).standard_normal((37, 60))
    jcfg = DU.hooke_cfg(JCfg, (2, 2, 3))
    jh = build_hooke_hmm(jcfg)
    material = np.asarray(assign_materials(jcfg, jh.geom, jh.dtype))
    ranks = DU.run_ranks(DU.mesh_utils_worker, WORLD, tmp_path_factory.mktemp("mesh"),
                         splines, material)
    step = jax.jit(jh.step)
    s = jh.init_state()
    ref = {}
    for i in range(4):
        s, o = step(s)
        ref[i + 1] = (np.asarray(s.qp.new_stress), int(o.n_jobs))
    return splines, ranks, ref


def test_pad_to_multiple():
    for n, m in ((10, 8), (16, 8), (5, 3)):
        x = np.arange(2 * n, dtype=np.float64).reshape(n, 2)
        tp, tn = TMU.pad_to_multiple(torch.as_tensor(x), m)
        jp, jn = JMU.pad_to_multiple(jnp.asarray(x), m)
        assert tn == jn == n and np.array_equal(tp.numpy(), np.asarray(jp))
    p, n = TMU.pad_to_multiple(torch.arange(10), 8)
    assert p.shape[0] == 16 and n == 10


@pytest.mark.parametrize("ways", [2, 4])
def test_sharded_pairwise_l2_matches_jax(runs, ways):
    splines, ranks, _ = runs
    ref = np.asarray(pairwise_l2(jnp.asarray(splines)))
    for r in range(WORLD):  # ranks outside the 2-rank mesh compute it alone
        assert np.allclose(ranks[r][f"l2_{ways}"], ref, atol=1e-12)
    assert [ranks[r]["in_m2"] for r in range(WORLD)] == [0, 1, None, None]


def test_multislice_mesh_layout(runs):
    _, ranks, _ = runs
    for r in range(WORLD):
        ms = ranks[r]["ms"]
        assert ms["names"] == ("dcn", "md") and ms["size"] == 4 and ms["shape"] == (2, 2)
        assert ms["flat"] == r and (ms["dcn"], ms["md"]) == divmod(r, 2)
        # the "md" group of slice r // 2 holds ranks 2 (r // 2) and 2 (r // 2) + 1
        assert ms["md_sum"] == 4 * (r // 2) + 1


def test_shard_md_update_runs_first_ranks_inputs(runs):
    """Ranks whose job masks, strains and ids differ all get the update of
    rank 0's inputs (``broadcast_job_inputs``), not a mix of blocks."""
    _, ranks, _ = runs
    n = 10
    jobs = np.arange(n) % DU.WORLD_OF_BCAST == 0
    want = np.where(jobs[:, None], 1.0 + np.arange(n)[:, None], 0.0) * np.ones((1, 6))
    for r in range(WORLD):
        assert np.array_equal(ranks[r]["bcast"], want)


@pytest.mark.parametrize("mesh,n_steps", [("hooke_2", 4), ("hooke_ms", 3)])
def test_sharded_hooke_step_matches_jax(runs, mesh, n_steps):
    _, ranks, ref = runs
    sig1, n1 = ref[n_steps]
    for r in range(WORLD):
        sig0, n0 = ranks[r][mesh]
        assert np.allclose(sig0, sig1, atol=1e-9 * max(np.abs(sig1).max(), 1.0))
        assert n0 == n1 > 0


def test_md_cores_min_rule():
    """md_coupling.py:463-474: an SW box of more than 2048 atoms takes
    md_cores_min shards where the ranks reach it; nothing else changes."""
    specs = [MaterialSpec(name="a", n_cells=8), MaterialSpec(name="b", n_cells=6),
             MaterialSpec(name="c", n_cells_xyz=(8, 8, 5)),
             MaterialSpec(name="d", force_field="opls"),
             MaterialSpec(name="e", n_cells=10, spatial_shards=2)]
    got = [s.spatial_shards for s in auto_spatial_shards(specs, 4, 4)]
    # 4096 atoms; 1728; 2560; an OPLS box; already sharded
    assert got == [4, 0, 4, 0, 2]
    assert [s.spatial_shards for s in auto_spatial_shards(specs, 4, 2)] == [0, 0, 0, 0, 2]
    assert [s.spatial_shards for s in auto_spatial_shards(specs, 1, 8)] == [0, 0, 0, 0, 2]
    assert TMU.world_size() == 1 and TMU.rank() == 0
