"""LAMMPS binary restarts (``init.<mat>_<n>.bin``) in the port against the
JAX package, float64 on the CPU.

The repository ships no restart, so tests/torch_file_util.py writes one in
the layout the reader decodes.  Checks:

* ``md/lammps_restart.read_restart`` of a written file (a tilted box, atoms
  in shuffled tag order, nonzero image counts) equals JAX's, field for
  field and exactly; garbage and a file without its atom payload raise
  ValueError in both;
* an SW dogbone of 1 x 1 x 2 cells (16 qps) whose nanoscale input holds a
  2 x 2 x 3-cell diamond restart (96 atoms, lattice constant 5.44 A, the
  box origin off zero): ``build_md_hmm`` without a spec sizes the lattice
  from the restart (cell counts and a0 as JAX's, 1e-12) and starts
  replica 1 from the restart's positions relative to its origin, its cell
  and velocities, exactly as JAX does (1e-12), also where ``prepared``
  offers another state;
* one macro-step from that state, the port on K5's plain version and JAX
  on its XLA engine, with JAX's replica data injected: stresses within
  1e-8 relative (the regime of tests/test_torch_hmm_sw.py).  JAX measures
  no replica here (``torch_port_util.fixed_replica_data``): the seeding is
  under test, not the stress sampling or the stiffness probe.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.hmm import md_coupling as JMC
from scema_tpu.hmm.problem import assign_materials
from scema_tpu.md import lammps_restart as JLR
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.hmm import md_coupling as TMC
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import lammps_restart as TLR
from scema_tpu_torch.md import lattice as TL
from scema_tpu_torch.md import material as TM

from torch_file_util import write_restart
from torch_port_util import fixed_replica_data, np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

A0, CELLS = 5.44, (2, 2, 3)
BOXLO = np.array([-1.5, 2.0, 0.5])
FIELDS = ("version", "units", "atom_style", "timestep", "natoms", "ntypes", "boxlo", "boxhi",
          "tilt", "triclinic", "pos", "vel", "types", "image")


def _diamond_restart(path, tilt=(0.0, 0.0, 0.0), seed: int = 0):
    """A perturbed diamond-Si box of CELLS at A0 with its origin at BOXLO,
    stored wrapped with its image counts, in shuffled record order; returns
    the unwrapped positions and the velocities."""
    rng = np.random.default_rng(seed)
    pos, h = TL.diamond(A0, *CELLS)
    L = np.diag(h)
    pos = pos + BOXLO + rng.normal(scale=0.05, size=pos.shape)
    image = np.floor((pos - BOXLO) / L).astype(np.int64)
    image[::7] += 1  # some atoms stored an image away
    vel = rng.normal(scale=0.003, size=pos.shape)
    write_restart(path, pos - image * L, vel, BOXLO, BOXLO + L, image=image, tilt=tilt,
                  timestep=1000, order=rng.permutation(len(pos)))
    return pos, vel


def test_read_restart_matches_jax(tmp_path):
    path = str(tmp_path / "init.sic_1.bin")
    pos, vel = _diamond_restart(path, tilt=(0.3, -0.2, 0.1))
    j, t = JLR.read_restart(path), TLR.read_restart(path)
    for f in FIELDS:
        a, b = getattr(t, f), getattr(j, f)
        assert type(a) is type(b) and np.array_equal(a, b), f
    assert np.array_equal(t.h, j.h)
    assert t.natoms == 96 and t.units == "metal" and t.triclinic
    assert np.abs(t.pos - pos).max() < 1e-12 and np.array_equal(t.vel, vel)


def test_garbage_raises_in_both(tmp_path):
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"this is not a LAMMPS restart file")
    good = tmp_path / "good.bin"
    _diamond_restart(str(good))
    cut = tmp_path / "cut.bin"
    cut.write_bytes(good.read_bytes()[:-8])  # the atom payload's last double gone
    for path, what in ((bad, "not a LAMMPS binary restart"), (cut, "atom payload")):
        for reader in (JLR.read_restart, TLR.read_restart):
            with pytest.raises(ValueError, match=what):
                reader(str(path))


def _cfg(cls, nano_dir):
    cfg = cls()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        md=cfg.md.__class__(temperature=300.0, timestep_length=2.0, strain_rate=1.0e-3,
                            nsteps_sample=20, force_field="sw"),
        dirs=dataclasses.replace(cfg.dirs, nanoscale_input=str(nano_dir)),
        material=dataclasses.replace(cfg.material, materials=("sic",)),
        md_dtype="float64")


@pytest.fixture(scope="module")
def seeded(tmp_path_factory):
    nano = tmp_path_factory.mktemp("nanoscale_input")
    _diamond_restart(str(nano / "init.sic_1.bin"))
    specs = []
    build = JM.build_system

    def recording(spec, *a, **k):  # the spec JAX's build_md_hmm adapted
        specs.append(spec)
        return build(spec, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(JMC.M, "build_system", recording)
    fixed_replica_data(mp, JMC)
    try:
        jcfg = _cfg(JCfg, nano)
        jh = JMC.build_md_hmm(jcfg)
    finally:
        mp.undo()
    return nano, jcfg, jh, specs[0]


def test_seeding_matches_jax(seeded):
    nano, _, jh, jspec = seeded
    micro = TLR.read_restart(str(nano / "init.sic_1.bin"))
    tspec = TMC._cells_from_restart(TM.MaterialSpec(name="sic"), micro)
    assert tspec.n_cells_xyz == jspec.n_cells_xyz == CELLS
    assert abs(tspec.a0 - jspec.a0) <= 1e-12 * A0 and abs(tspec.a0 - A0) < 1e-12
    jst = jh.backend.initial_md_state
    assert jh.backend.sys.n_atoms == 96
    # the port from the same files: the same lattice, replica 1 from the
    # restart, and the state ``prepared`` offers (shifted by 1 A) not taken
    be = jh.backend
    data = [interop.init_data(JM.InitData(
        length=be.ensemble.init_length[0, 0], stress=be.ensemble.init_stress[0, 0],
        stiff=be.ensemble.init_stiff[0, 0], density=be.ensemble.rho[0, 0]))]
    other = interop.md_state(jst)
    other = TE.MDState(pos=other.pos + 1.0, vel=other.vel, h=other.h, vxi=other.vxi + 0.5)
    th = TMC.build_md_hmm(_cfg(TCfg, nano), device="cpu", prepared=[(other, data)])
    tst = th.backend.initial_md_state
    assert th.backend.sys.n_atoms == 96 and th.backend.sys.route == "K5"
    for f in ("pos", "vel", "h", "vxi"):
        assert np.abs(np64(getattr(tst, f)) - np.asarray(getattr(jst, f))).max() < 1e-12, f
    assert np.abs(np64(tst.pos[0]) - (micro.pos - micro.boxlo)).max() < 1e-12
    assert np.array_equal(np64(tst.vel[0]), micro.vel)
    assert np.array_equal(np64(tst.h[0]), micro.h) and not tst.vxi.any()


def test_seeded_step_matches_jax(seeded):
    nano, jcfg, jh, _ = seeded
    be = jh.backend
    data = [interop.init_data(JM.InitData(
        length=be.ensemble.init_length[0, 0], stress=be.ensemble.init_stress[0, 0],
        stiff=be.ensemble.init_stiff[0, 0], density=be.ensemble.rho[0, 0]))]
    mat = assign_materials(jcfg, jh.geom, jh.base.dtype)
    th = TMC.build_md_hmm(_cfg(TCfg, nano), device="cpu",
                          prepared=[(interop.md_state(be.initial_md_state), data)],
                          material=interop.materials(mat))
    (jc, jo), (tc, to) = jax.jit(jh.step)(jh.init_state()), th.step(th.init_state())
    assert int(to.n_jobs) == int(jo.n_jobs) > 0
    assert rel_err(np64(to.md_stress_repl), np.asarray(jo.md_stress_repl)) < 1e-8
    assert rel_err(np64(tc[0].qp.new_stress), np.asarray(jc[0].qp.new_stress)) < 1e-8
    assert np.abs(np64(tc[1][0].pos) - np.asarray(jc[1][0].pos)).max() < 1e-8
