"""``scema_tpu_torch.parallel.spatial_md``: one SW box's force calls
x-slab sharded over ranks (``MaterialSpec.spatial_shards``) on four gloo
CPU ranks (float64, one torch thread each; tests/torch_dist_util.py), on
the 1000-atom diamond box (n_cells 5) jiggled as tests/test_spatial_md.py
jiggles it (JAX's draws):

- energy and forces over 2 and 4 slabs against JAX's list reference
  (``NB.build`` + ``sw.energy``, test_spatial_md.py:33-42): 1e-10 relative
  in energy, 1e-9 in forces; the virial against the port's unsharded list
  route;
- ``run_strain`` for 20 steps and ``sample_stress`` for 10 over 4 slabs
  against the port's unsharded list route from JAX's Maxwell draw: 1e-8 A
  (and A/fs) on positions and velocities, the cells equal to 1e-8, the
  pressure to 1e-8 relative; the same against JAX's own sharded run
  (marked slow, as JAX's module is).

Ranks 2 and 3 lie outside the 2-slab runner's mesh and evaluate the whole
box alone; their results are checked too."""
import jax
import numpy as np
import pytest
import torch

from scema_tpu.md import lattice as JL
from scema_tpu.md import neighbor as JNB
from scema_tpu.md.forcefields import sw as JSW

from scema_tpu_torch.md import engine as E
from scema_tpu_torch.md import material as TM

import torch_dist_util as DU
from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

WORLD = 4
COMMON = dict(name="si", force_field="sw", n_cells=5, rebuild_every=10)
EPS = np.array([0.002, 0.0, -0.001, 0.0, 0.0005, 0.0])
N_STRAIN, N_SAMPLE, T, DT = 20, 10, 50.0, 0.5

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _box():
    pos, h = JL.diamond(5.431, 5, 5, 5)
    pos = jax.numpy.asarray(pos)
    pos = pos + 0.05 * jax.random.normal(jax.random.PRNGKey(0), pos.shape, pos.dtype)
    return np.asarray(pos), np.asarray(h)


def _jax_velocities():
    from scema_tpu.md import engine as JE
    from scema_tpu.md import material as JM

    jsys, _ = JM.build_system(JM.MaterialSpec(**COMMON, use_fused=False))
    return jsys, np.asarray(JE.maxwell_velocities(jsys, jax.random.PRNGKey(7), T))


@pytest.mark.parametrize("n_cells,shards", [(5, 1), (5, 2), (8, 4), (8, 3), (2, 2)])
def test_sharded_grid_matches_jax(n_cells, shards):
    """The x-plane count, a multiple of the shards, and the ValueError of
    a box too small to shard, as JAX's ``derive_sharded_grid`` gives them."""
    from scema_tpu.parallel import spatial_md as JSP

    from scema_tpu_torch.parallel import spatial_md as TSP

    _, h = JL.diamond(5.431, n_cells, n_cells, n_cells)
    h = np.asarray(h)
    n = 8 * n_cells ** 3
    try:
        want = JSP.derive_sharded_grid(n, h, cutoff=3.77, n_shards=shards)
    except ValueError as e:
        with pytest.raises(ValueError, match="box too small to shard") as got:
            TSP.derive_sharded_grid(n, h, cutoff=3.77, n_shards=shards)
        assert str(got.value) == str(e)
        return
    got = TSP.derive_sharded_grid(n, h, cutoff=3.77, n_shards=shards)
    assert got.cells == want.cells and got.r_list == want.r_list
    assert got.cells[0] % shards == 0


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    pos, h = _box()
    _, vel = _jax_velocities()
    ranks = DU.run_ranks(DU.spatial_worker, WORLD, tmp_path_factory.mktemp("spatial"),
                         pos, h, vel, EPS, N_STRAIN, N_SAMPLE, T, DT)
    # the port's unsharded list route on the same inputs
    sys_x, st_x = TM.build_system(TM.MaterialSpec(**COMMON, use_fused=False), device="cpu")
    p, hh = torch.as_tensor(pos)[None], torch.as_tensor(h)[None]
    F, En, W = E.forces_energy_virial(sys_x, p, hh, sys_x.build_neighbors(p, hh))
    st = st_x.replace(vel=torch.as_tensor(vel))
    st = E.run_strain(sys_x, st, torch.as_tensor(EPS), N_STRAIN, T, DT)
    st2, press = E.sample_stress(sys_x, st, N_SAMPLE, T, DT)
    ref = dict(forces=np64(F[0]), energy=float(En[0]), virial=np64(W[0]), pos=np64(st.pos),
               vel=np64(st.vel), h=np64(st.h), press=np64(press), pos2=np64(st2.pos))
    return pos, h, vel, ranks, ref


@pytest.mark.parametrize("ways", [2, 4])
def test_energy_forces_match_jax_list_reference(runs, ways):
    pos, h, _, ranks, _ = runs
    sw = JSW.SI
    n = pos.shape[0]
    assert n == 1000
    nspec = JNB.derive_spec(n, h, cutoff=sw.cutoff, skin=0.5, k_max=24)
    nbr = JNB.build(nspec, jax.numpy.asarray(pos), jax.numpy.asarray(h))
    e_ref = float(sw.energy(jax.numpy.asarray(pos), jax.numpy.asarray(h), nbr))
    f_ref = -np.asarray(jax.grad(lambda p: sw.energy(p, jax.numpy.asarray(h), nbr))(
        jax.numpy.asarray(pos)))
    for r in range(WORLD):
        got = ranks[r][ways]
        assert got["route"] == f"unfused: spatial_shards={ways}" and got["c1"] % ways == 0
        assert abs(got["energy"] - e_ref) / abs(e_ref) < 1e-10
        assert rel_err(got["forces"], f_ref) < 1e-9
    # each rank of the mesh evaluates its slab's centres only, and the
    # slabs cover the box once
    rows = [ranks[r][ways]["rows"] for r in range(ways)]
    assert sum(rows) == n and max(rows) < n


@pytest.mark.parametrize("ways", [2, 4])
def test_virial_matches_unsharded_list_route(runs, ways):
    _, _, _, ranks, ref = runs
    for r in range(WORLD):
        assert rel_err(ranks[r][ways]["virial"], ref["virial"]) < 1e-10
        assert abs(ranks[r][ways]["energy"] - ref["energy"]) <= 1e-10 * abs(ref["energy"])


def test_strain_and_sampling_match_unsharded(runs):
    """The sharded strain + NVT loop (binning reuse over each 10-step
    chunk, the deform remap) and the sampling loop follow the unsharded
    list route's trajectory and pressure."""
    _, _, _, ranks, ref = runs
    for r in range(WORLD):
        got = ranks[r]["run"]
        for f in ("pos", "vel"):
            assert np.abs(got[f] - ref[f]).max() < 1e-8
        assert np.allclose(got["h"], ref["h"], atol=1e-8)
        assert np.allclose(got["press"], ref["press"], rtol=1e-8, atol=1e-6)
        assert np.abs(got["pos2"] - ref["pos2"]).max() < 1e-8


@pytest.mark.slow
def test_strain_and_sampling_match_jax_sharded(runs):
    """The same runs against JAX's slab-sharded loops (spatial_shards=4 on
    the 8-device CPU mesh; tests/test_spatial_md.py:68-109)."""
    from scema_tpu.md import engine as JE
    from scema_tpu.md import material as JM

    _, _, vel, ranks, _ = runs
    jsys, jst = JM.build_system(JM.MaterialSpec(**COMMON, use_fused=False, spatial_shards=4))
    jst = jst._replace(vel=jax.numpy.asarray(vel))
    out = JE.run_strain(jsys, jst, jax.numpy.asarray(EPS), jax.numpy.asarray(N_STRAIN), T, DT)
    st2, p = JE.sample_stress(jsys, out, N_SAMPLE, T, DT)
    got = ranks[0]["run"]
    assert np.abs(got["pos"] - np.asarray(out.pos)).max() < 1e-8
    assert np.abs(got["vel"] - np.asarray(out.vel)).max() < 1e-8
    assert np.allclose(got["h"], np.asarray(out.h), atol=1e-8)
    assert np.allclose(got["press"], np.asarray(p), rtol=1e-8, atol=1e-6)
    assert np.abs(got["pos2"] - np.asarray(st2.pos)).max() < 1e-8


def test_build_system_refusals():
    """``spatial_shards`` on a non-SW box, and more shards than ranks
    (this process has no group: one rank; JAX's CPU mesh has 8 devices),
    raise ValueError in both packages (material.py:809-821)."""
    from scema_tpu.md import material as JM

    ar = dict(name="ar", force_field="lj", a0=5.26, n_cells=4, mass=39.948, spatial_shards=2)
    with pytest.raises(ValueError, match="only SW boxes have a sharded force path"):
        JM.build_system(JM.MaterialSpec(**ar))
    with pytest.raises(ValueError, match="only SW boxes have a sharded force path"):
        TM.build_system(TM.MaterialSpec(**ar), device="cpu")
    with pytest.raises(ValueError, match="spatial_shards=16 but only 8 devices"):
        JM.build_system(JM.MaterialSpec(**COMMON, spatial_shards=16))
    with pytest.raises(ValueError, match="spatial_shards=2 but only 1 ranks"):
        TM.build_system(TM.MaterialSpec(**COMMON, spatial_shards=2), device="cpu")
