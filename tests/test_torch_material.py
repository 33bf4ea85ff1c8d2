"""The port's quick material prep against the JAX package, float64, on the
small united-atom melt of tests/test_md_fused.py (8 chains x 6 beads, 5 A
cutoff, validate=False): FIRE (``minimize_fire``), FIRE + NVT
(``equilibrate``, with JAX's Maxwell draw injected) and the residual
stress, stiffness probe and density of ``measure``.  The JAX side runs the
XLA engine (``use_fused=False``) with its default 10-step neighbor chunks;
the NVT run is one chunk long and the box does not deform, so both sides
integrate the same force history.

Tolerances: positions 1e-8 A, velocities and thermostat 1e-8 relative,
length/stress/stiffness/density 1e-8 relative — only the summation order
differs (measured in float64 on a CPU: ~1e-13).

Also: a topology that no ported kernel runs (an improper, which sends the
JAX package to its unported XLA bonded path) is refused, charged or not,
and a charged chain without one takes K3's cutoff Coulomb plane."""
import jax
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import homogenization as JH
from scema_tpu.md import material as JM

from scema_tpu_torch.md import data_io as TD
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import homogenization as TH
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.md.units import REAL
from scema_tpu_torch.ops import md_fused as TMF

from torch_port_util import np64, rel_err

SMALL = dict(name="m", force_field="opls", n_chains=8, chain_length=6,
             opls_lj_cutoff=5.0, opls_coul_cutoff=5.0, validate=False)
PARAMS = dict(temperature=300.0, dt=2.0, strain_rate=1e-4, nsteps_sample=20)
MIN_STEPS, EQUIL_STEPS = 20, 10


@pytest.fixture(scope="module")
def prep():
    jsys, jst0 = JM.build_system(JM.MaterialSpec(**SMALL, use_fused=False))
    jp = JH.MDParams(**PARAMS)
    key = jax.random.PRNGKey(3)
    jmin = jax.jit(lambda s: JE.minimize_fire(jsys, s, n_steps=MIN_STEPS, dt0=0.5))(jst0)
    jeq = JM.equilibrate(jsys, jst0, jp, key, minimize_steps=MIN_STEPS,
                         equil_steps=EQUIL_STEPS)
    jdata = JM.measure(jsys, jeq, jp)
    # equilibrate's own Maxwell draw, for the port to start from
    jvel = JE.maxwell_velocities(jsys, key, PARAMS["temperature"], dtype=jeq.pos.dtype)

    tsys, tst0 = TM.build_system(TM.MaterialSpec(**SMALL), device="cpu")
    tp = TH.MDParams(**PARAMS)
    tmin = TE.minimize_fire(tsys, tst0, n_steps=MIN_STEPS, dt0=0.5)
    teq = TM.equilibrate(tsys, tst0, tp, minimize_steps=MIN_STEPS, equil_steps=EQUIL_STEPS,
                         velocities=torch.as_tensor(np.array(jvel)))
    tdata = TM.measure(tsys, teq, tp)
    return (jst0, jmin, jeq, jdata), (tst0, tmin, teq, tdata)


def test_built_melt_matches_jax(prep):
    (jst0, *_), (tst0, *_) = prep
    assert np.array_equal(np64(tst0.pos), np.asarray(jst0.pos))
    assert np.array_equal(np64(tst0.h), np.asarray(jst0.h))


def test_minimize_fire_matches_jax(prep):
    (_, jmin, _, _), (_, tmin, _, _) = prep
    assert np.abs(np64(tmin.pos) - np.asarray(jmin.pos)).max() < 1e-8
    assert not np.array_equal(np.asarray(jmin.pos), np.asarray(prep[0][0].pos))


def test_equilibrate_matches_jax(prep):
    (_, _, jeq, _), (_, _, teq, _) = prep
    assert np.abs(np64(teq.pos) - np.asarray(jeq.pos)).max() < 1e-8
    assert rel_err(np64(teq.vel), np.asarray(jeq.vel)) < 1e-8
    assert rel_err(np64(teq.vxi), np.asarray(jeq.vxi)) < 1e-8


@pytest.mark.parametrize("field", ["length", "stress", "stiff", "density"])
def test_measure_matches_jax(prep, field):
    jd, td = prep[0][3], prep[1][3]
    j, t = np.asarray(getattr(jd, field)), np.asarray(getattr(td, field))
    assert t.shape == j.shape and np.isfinite(t).all()
    assert rel_err(t, j) < 1e-8


CHAIN_DATA = """LAMMPS data file

4 atoms
2 atom types
3 bonds
1 bond types
2 angles
1 angle types
1 dihedrals
1 dihedral types

0.0 30.0 xlo xhi
0.0 30.0 ylo yhi
0.0 30.0 zlo zhi

Masses

1 14.027
2 15.035

Pair Coeffs

1 0.118 3.905
2 0.175 3.905

Bond Coeffs

1 260.0 1.54

Angle Coeffs

1 63.0 112.0

Dihedral Coeffs

1 1.411 -0.271 3.145 0.0

Atoms

1 1 1 {q} 10.0 10.0 10.0
2 1 1 {mq} 11.5 10.0 10.0
3 1 2 0.0 12.0 11.4 10.0
4 1 2 0.0 13.5 11.4 10.5

Bonds

1 1 1 2
2 1 2 3
3 1 3 4

Angles

1 1 1 2 3
2 1 2 3 4

Dihedrals

1 1 1 2 3 4
"""


IMPROPER = """1 impropers
1 improper types
"""
IMPROPER_SECTIONS = """
Improper Coeffs

1 1.0 0.0

Impropers

1 1 1 2 3 4
"""


@pytest.mark.parametrize("q", [0.0, 0.1])
def test_charged_data_file_is_refused(tmp_path, q):
    """What no kernel of the port runs is refused rather than run with a
    term dropped: the chain with an improper raises NotImplementedError,
    charged or not.  Without it, the chain builds: uncharged on K1,
    charged on K3 with the cutoff Coulomb plane qqr2e q_i q_j w (zero
    here: every pair of a 4-atom chain is a 1-2, 1-3 or 1-4 pair, and
    ``special_coul`` = 0), or, with the Ewald sum requested, only together
    with its k-space remainder."""
    text = CHAIN_DATA.format(q=q, mq=-q)
    p = tmp_path / "chain.data"
    p.write_text(text.replace("1 dihedral types\n", "1 dihedral types\n" + IMPROPER)
                 + IMPROPER_SECTIONS)
    data = TD.read_data(str(p))
    assert len(data.impropers) == 1
    masses = torch.as_tensor(data.masses[data.types], dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="impropers"):
        TMF.make_runner(TD.to_opls(data, 10.0, 9.0, use_ewald=False), masses, REAL)

    p.write_text(text)
    data = TD.read_data(str(p))
    runner = TMF.make_runner(TD.to_opls(data, 10.0, 9.0, use_ewald=False), masses, REAL)
    assert runner.spec.n_atoms == 4 and runner.spec.coul == (q != 0.0)
    assert runner.spec.k3 == (q != 0.0) and not runner.spec.fext
    if q:
        assert runner.qq.shape == (4, 4) and not bool(runner.qq.any())
        with pytest.raises(ValueError, match="k-space"):
            TMF.make_runner(TD.to_opls(data, 10.0, 9.0, use_ewald=True), masses, REAL)
