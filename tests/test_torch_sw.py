"""The Stillinger-Weber force field and K5's plain version against the JAX
package, float64, on the CPU.

* ``forcefields.sw.SW.energy`` (torch, moment form) against JAX's
  ``sw.SW.energy`` on a perturbed 64-atom diamond box (n_cells = 2), cubic
  and tilted, on the same full neighbor list: 1e-12 relative.
* K5's plain force + virial entry (``md_forces_virial`` on CPU tensors)
  against JAX autograd of that energy and against the port's own autograd:
  forces 1e-10 relative, virial 1e-9 (W = -dE/dF for a 3x3 deformation F
  of positions and box, symmetrised; measured ~1e-15).
* The builders and the gate: the lattice, K5's spec against the JAX
  runner's, the routing off the gate (more than 640 atoms or p != 4: the
  list route; brick kernels: the bricks), the refusals (spatial shards,
  bricks with p != 4), the ``force_field`` default, an unreadable LAMMPS restart
  (a warning, then the device prep),
  the config selecting SW (``"force field": "sw"`` or a sisw scripts
  directory) through ``build_md_hmm``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import lattice as JL
from scema_tpu.md import material as JM
from scema_tpu.md import neighbor as JNB
from scema_tpu.md.forcefields import sw as JSW

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.config import config_from_dict
from scema_tpu_torch.hmm.md_coupling import build_md_hmm as t_build_md_hmm
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import lattice as TL
from scema_tpu_torch.md import material as TM
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


def _nbr(pos, h):
    """A full list (each pair in both rows) holding every pair within the
    SW cutoff + 1 A."""
    spec = TNB.NeighborSpec(cutoff=TSW.SI.cutoff, skin=1.0, k_max=40, n2_threshold=10 ** 6)
    nbr = TNB.build_dense(spec, torch.as_tensor(pos), torch.as_tensor(h))
    assert int(nbr.mask.sum(-1).max()) < 40
    return nbr


def _jax_forces_virial(pos, h, nbr):
    jn = JNB.NeighborList(idx=jnp.asarray(nbr.idx.numpy(), jnp.int32),
                          mask=jnp.asarray(nbr.mask.numpy()))
    p, hh = jnp.asarray(pos), jnp.asarray(h)

    def e_of(f):
        m = jnp.eye(3) + f
        return JSW.SI.energy(p @ m.T, m @ hh, jn)

    F = -jax.grad(lambda q: JSW.SI.energy(q, hh, jn))(p)
    W = -jax.grad(e_of)(jnp.zeros((3, 3)))
    return np.asarray(F), np.asarray(W)


def _torch_forces_virial(pos, h, nbr):
    p = torch.as_tensor(pos).requires_grad_(True)
    f = torch.zeros((3, 3), dtype=torch.float64, requires_grad=True)
    m = torch.eye(3, dtype=torch.float64) + f
    e = TSW.SI.energy(p @ m.T, m @ torch.as_tensor(h), nbr)
    gp, gf = torch.autograd.grad(e, (p, f))
    return -gp.numpy(), -gf.numpy()


def _voigt(W):
    return np.array([W[0, 0], W[1, 1], W[2, 2], 0.5 * (W[0, 1] + W[1, 0]),
                     0.5 * (W[0, 2] + W[2, 0]), 0.5 * (W[1, 2] + W[2, 1])])


def test_lattice_matches_jax():
    for fn in ("diamond", "fcc"):
        tp, th = getattr(TL, fn)(5.431, 2, 3, 4)
        jp, jh = getattr(JL, fn)(5.431, 2, 3, 4)
        assert np.array_equal(tp, jp) and np.array_equal(th, jh)


@pytest.mark.parametrize("tilted", [False, True], ids=["cubic", "tilted"])
def test_energy_matches_jax(tilted):
    pos, h = _box(tilted)
    nbr = _nbr(pos, h)
    jn = JNB.NeighborList(idx=jnp.asarray(nbr.idx.numpy(), jnp.int32),
                          mask=jnp.asarray(nbr.mask.numpy()))
    e_t = float(TSW.SI.energy(torch.as_tensor(pos), torch.as_tensor(h), nbr))
    e_j = float(JSW.SI.energy(jnp.asarray(pos), jnp.asarray(h), jn))
    assert abs(e_t - e_j) <= 1e-12 * abs(e_j)
    # a batch of boxes gives each box's energy
    two = TSW.SI.energy(torch.as_tensor(np.stack([pos, pos])), torch.as_tensor(np.stack([h, h])),
                        TNB.NeighborList(idx=nbr.idx.expand(2, -1, -1),
                                         mask=nbr.mask.expand(2, -1, -1)))
    assert np.allclose(two.numpy(), e_t, rtol=1e-14)


@pytest.mark.parametrize("tilted", [False, True], ids=["cubic", "tilted"])
def test_k5_plain_forces_virial_match_autograd(tilted):
    pos, h = _box(tilted)
    nbr = _nbr(pos, h)
    runner = TMF.make_runner_sw(TSW.SI, torch.full((64,), 28.0855, dtype=torch.float64), REAL)
    before = TMF.md_forces_virial.launches_k5
    F, W = TMF.md_forces_virial(runner, torch.as_tensor(pos).T[None].contiguous(),
                                TMF.h6_of(torch.as_tensor(h))[None])
    assert TMF.md_forces_virial.launches_k5 == before  # CPU tensors: the plain version
    F, W = np64(F[0]).T, np64(W[0])
    for Fa, Wa in (_jax_forces_virial(pos, h, nbr), _torch_forces_virial(pos, h, nbr)):
        assert rel_err(F, Fa) < 1e-10
        assert np.abs(Wa - Wa.T).max() <= 1e-12 * np.abs(Wa).max()
        assert rel_err(W, _voigt(Wa)) < 1e-9


def test_k5_runner_matches_jax_spec():
    n = 64
    jspec = JM.MaterialSpec(name="si", force_field="sw", n_cells=2, use_fused=True)
    nspec = JNB.derive_spec(n, np.diag([10.862] * 3), cutoff=JSW.SI.cutoff, skin=1.0, k_max=20)
    jr = JM._build_fused_runner_sw(jspec, JSW.SI, jnp.full((n,), 28.0855), nspec, jnp.float64)
    tr = TMF.make_runner_sw(interop.sw(JSW.SI), torch.full((n,), 28.0855, dtype=torch.float64),
                            REAL)
    assert tr.spec.sw_params == jr.spec.sw_params
    assert tr.spec.ndof == jr.spec.ndof == 3 * n - 3
    assert tr.spec.cutoff2 == jr.spec.cutoff2
    assert (tr.spec.kernel, tr.spec.flags) == ("K5", "SW")
    assert tr.lj1 is None and tr.topo is None


def test_build_system_and_gate():
    sys_, st = TM.build_system(TM.MaterialSpec(name="si", force_field="sw"), device="cpu")
    jsys, jst = JM.build_system(JM.MaterialSpec(name="si", force_field="sw", use_fused=False))
    assert sys_.n_atoms == 216 and sys_.fused.spec.kernel == "K5"
    assert np.array_equal(np64(st.pos), np.asarray(jst.pos))
    assert np.array_equal(np64(st.h), np.asarray(jst.h))
    assert np.array_equal(np64(sys_.masses), np.asarray(jsys.masses))
    assert sys_.ndof == 3 * 216 - 3
    # the gate's largest cubic box still runs K5
    assert TM.build_system(TM.MaterialSpec(name="si", n_cells=4),
                           device="cpu")[0].fused.spec.n_atoms == 512
    # above the gate, or with the brick kernels, the unfused engine: the
    # list route (autograd of SW.energy) or the bricks (K6c/K6d)
    for kw, route in ((dict(n_cells_xyz=(4, 4, 6)), "list"), (dict(n_cells=5), "list"),
                      (dict(use_pallas_bricks=True), "bricks"),
                      (dict(sw=dataclasses.replace(TSW.SI, p=6.0)), "list")):
        big, st_big = TM.build_system(TM.MaterialSpec(name="si", **kw), device="cpu")
        assert big.fused is None
        assert (route == "bricks") == hasattr(big.ff, "slot_ids")
        # the list takes the spec derive_spec gives the box, which builds
        # dense at these sizes (<= 1024 atoms)
        assert route == "bricks" or (big.nspec == TNB.derive_spec(
            big.n_atoms, np64(st_big.h), TSW.SI.cutoff, 1.0, 20)
            and big.n_atoms <= big.nspec.n2_threshold)
    with pytest.raises(NotImplementedError):
        TM.build_system(TM.MaterialSpec(name="si", use_pallas_bricks=True,
                                        sw=dataclasses.replace(TSW.SI, p=6.0)), device="cpu")
    # spatial_shards builds a sharded box; two shards need two ranks (this
    # process has no group: one), as JAX's need two devices
    with pytest.raises(ValueError, match="spatial_shards=2 but only 1 ranks"):
        TM.build_system(TM.MaterialSpec(name="si", spatial_shards=2), device="cpu")
    # an lj box builds on K1 (no bonded terms), and on the unfused engine
    # with use_fused=False, as the JAX package's lj branch
    ar = dict(name="ar", force_field="lj", a0=5.26, n_cells=4, mass=39.948)
    lj, lj_st = TM.build_system(TM.MaterialSpec(**ar), device="cpu")
    jlj, jlj_st = JM.build_system(JM.MaterialSpec(**ar, use_fused=False))
    assert lj.fused.spec.kernel == "K1" and not bool(lj.fused.topo.any())
    assert np.array_equal(np64(lj_st.pos), np.asarray(jlj_st.pos))
    assert lj.nspec.k_max == jlj.nspec.k_max
    lj_u, _ = TM.build_system(TM.MaterialSpec(**ar, use_fused=False), device="cpu")
    assert lj_u.fused is None and lj_u.nspec.cells == (0, 0, 0)


def test_force_field_default_matches_jax():
    assert TM.MaterialSpec(name="x").force_field == JM.MaterialSpec(name="x").force_field


def test_lammps_restart_is_refused(monkeypatch, tmp_path):
    """A replica restart file that does not parse (here its magic is cut
    short) is refused as the JAX package refuses it (replica_data.py:
    93-101): a warning, and the replica is equilibrated on the device
    instead of seeded.  (Readable restarts seed the replica:
    tests/test_torch_lammps_restart.py.)"""
    (tmp_path / "init.g0_1.bin").write_bytes(b"LammpS RestartT")
    calls = []
    equilibrate = TM.equilibrate

    def spy(*a, **kw):
        calls.append(kw["equil_steps"])
        return equilibrate(*a, **kw)

    monkeypatch.setattr(TM, "equilibrate", spy)
    cfg = TCfg()
    cfg = cfg.replace(dirs=dataclasses.replace(cfg.dirs, nanoscale_input=str(tmp_path)),
                      mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=1),
                      md=dataclasses.replace(cfg.md, nsteps_sample=10), md_dtype="float64")
    with pytest.warns(UserWarning, match="skipping unreadable LAMMPS restart"):
        hmm = t_build_md_hmm(cfg, spec=TM.MaterialSpec(name="g0", n_cells=2), equil_steps=3,
                             minimize_steps=3, device="cpu")
    assert calls == [3] * cfg.material.number_of_replicas
    assert torch.isfinite(hmm.backend.initial_md_state.pos).all()


def test_sw_file_and_interop_match_jax(tmp_path):
    path = tmp_path / "Si.sw"
    path.write_text("# Stillinger-Weber\nSi Si Si 2.1683 2.0951 1.80 21.0 1.20 "
                    "-0.333333333333\n 7.049556277 0.6022245584 4.0 0.0 0.0\n")
    assert interop.sw(JSW.read_sw_file(str(path))) == TSW.read_sw_file(str(path)) == TSW.SI
    assert interop.sw(JSW.SI) == TSW.SI
    with pytest.raises(ValueError):
        TSW.read_sw_file(str(path), element="C")


def test_config_selects_sw():
    """The JAX CLI's selection: "force field": "sw", or a sisw scripts
    directory, gives the 216-atom SW box on K5; "reax" without a reax
    scripts directory finds no ffield, as the JAX package's does."""
    cfg = config_from_dict({"molecular dynamics parameters": {"force field": "sw"}})
    assert cfg.md.force_field == "sw"
    assert config_from_dict({"molecular dynamics parameters": {
        "scripts directory": "./lammps_scripts_sisw"}}).md.force_field == "sw"
    sys_, st = TM.build_system(TM.MaterialSpec(name="g0"), device="cpu")
    n_repl = cfg.material.number_of_replicas
    st_r = TE.MDState(*(x.expand((n_repl,) + tuple(x.shape)).clone()
                        for x in (st.pos, st.vel, st.h, st.vxi)))
    data = [TM.InitData(length=np.full(3, 16.293), stress=np.zeros(6),
                        stiff=np.eye(6) * 1e10, density=2329.0)] * n_repl
    hmm = t_build_md_hmm(cfg, device="cpu", prepared=[(st_r, data)])
    assert hmm.backend.sys.fused.spec.kernel == "K5" and hmm.backend.sys.n_atoms == 216
    with pytest.raises(FileNotFoundError, match="no ffield.reax"):
        t_build_md_hmm(cfg.replace(md=dataclasses.replace(cfg.md, force_field="reax")),
                       device="cpu")
