"""K1m's path (J jobs per kernel block, the coupler's ``pack_jobs``) on the
CPU, where ``md_run_multi`` runs K1's plain version over the grouped batch,
against scema_tpu and against the port's unpacked path.  Float64.

Tolerances, each with its reason:
* ``strain_and_homogenize_multi`` against JAX's ``strain_and_homogenize``
  on the TPU kernel in interpret mode (one job per program) and against
  JAX's ``strain_and_homogenize_multi`` (two jobs per program, interpret
  mode): 1e-10 A in positions and velocities, 1e-10 relative in stress —
  the same algorithm step for step, only the summation order differs (as
  in tests/test_torch_md_fused.py);
* against the port's unpacked ``strain_and_homogenize``: 1e-12 (the same
  plain version on another batch shape);
* a dead job of a (live, dead) pair: bit-identical;
* the coupler's macro-step with ``pack_jobs=2`` (an odd job count padded
  with a zero-step job) against ``pack_jobs=1``: 1e-12."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scema_tpu.md import engine as JE
from scema_tpu.md import homogenization as JH
from scema_tpu.md import material as JM

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig
from scema_tpu_torch.hmm.md_coupling import MDBackend, build_md_hmm
from scema_tpu_torch.md import engine as TE
from scema_tpu_torch.md import homogenization as TH
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.ops import md_fused as MF

from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

SMALL = dict(name="m", force_field="opls", n_chains=8, chain_length=6,
             opls_lj_cutoff=5.0, opls_coul_cutoff=5.0, validate=False)
T_MD = 80.0
PARAMS = dict(temperature=T_MD, dt=1.0, strain_rate=1e-3, nsteps_sample=10)
DL_A = [0.01, -0.01, 0.02, 0.0, 0.004, 0.0]
DL_B = [0.05, 0.01, -0.04, 0.006, 0.0, 0.0]  # a longer deform run


@pytest.fixture(scope="module")
def melt():
    """JAX's fused system (the Pallas kernel, interpret mode on the CPU) and
    the port's from one prepared state, and JAX's two unpacked jobs."""
    jsys, jst = JM.build_system(JM.MaterialSpec(**SMALL, use_fused=True))
    jst = jax.jit(lambda s: JE.minimize_fire(jsys, s, 40, dt0=0.5))(jst)
    jst = jst._replace(vel=JE.maxwell_velocities(jsys, jax.random.PRNGKey(5), T_MD))
    tsys, _ = TM.build_system(TM.MaterialSpec(**SMALL), device="cpu")
    jp = JH.MDParams(**PARAMS)
    ref = [JH.strain_and_homogenize(jsys, jst, jnp.asarray(dl), jp) for dl in (DL_A, DL_B)]
    return jsys, jst, tsys, interop.md_state(jst), ref


def _pair(st):
    """One (G, J) = (1, 2) group of two copies of a state."""
    return TE.MDState(*(torch.stack([x, x])[None] for x in (st.pos, st.vel, st.h, st.vxi)))


def test_multi_matches_jax_and_unpacked(melt):
    jsys, jst, tsys, tst, ref = melt
    params = TH.MDParams(**PARAMS)
    dl = torch.tensor([[DL_A, DL_B]], dtype=torch.float64)
    before = MF.md_run_multi.launches_k1m
    out, sig = TH.strain_and_homogenize_multi(tsys, _pair(tst), dl, params)
    assert MF.md_run_multi.launches_k1m == before  # the plain version launches nothing
    for j, (jo, js) in enumerate(ref):
        assert np.abs(np64(out.pos[0, j]) - np.asarray(jo.pos)).max() < 1e-10
        assert np.abs(np64(out.vel[0, j]) - np.asarray(jo.vel)).max() < 1e-10
        assert np.abs(np64(out.h[0, j]) - np.asarray(jo.h)).max() < 1e-12
        assert rel_err(np64(sig[0, j]), np.asarray(js)) < 1e-10
    flat = TE.MDState(*(x[0] for x in (_pair(tst).pos, _pair(tst).vel, _pair(tst).h,
                                      _pair(tst).vxi)))
    o1, s1 = TH.strain_and_homogenize(tsys, flat, dl[0], params)
    for f in ("pos", "vel", "h", "vxi"):
        assert torch.allclose(getattr(out, f)[0], getattr(o1, f), rtol=0, atol=1e-12)
    assert torch.allclose(sig[0], s1, rtol=0, atol=1e-12 * float(s1.abs().max()))


@pytest.mark.slow
def test_multi_matches_jax_packed_kernel(melt):
    """JAX's own two-job program (FusedSpec.jobs = 2, interpret mode);
    slow: its interpret-mode compile (~20 s alone, ~60 s in the parallel
    suite) does not fit the suite's budget, and JAX's own slow test holds
    that program equal to the unpacked one, which the fast tests compare
    against."""
    jsys, jst, tsys, tst, _ = melt
    st2 = jax.tree_util.tree_map(lambda x: jnp.stack([x, x]), jst)
    jo, js = JH.strain_and_homogenize_multi(jsys, st2, jnp.asarray([DL_A, DL_B]),
                                            JH.MDParams(**PARAMS))
    out, sig = TH.strain_and_homogenize_multi(
        tsys, _pair(tst), torch.tensor([[DL_A, DL_B]], dtype=torch.float64),
        TH.MDParams(**PARAMS))
    assert np.abs(np64(out.pos[0]) - np.asarray(jo.pos)).max() < 1e-10
    assert np.abs(np64(out.vel[0]) - np.asarray(jo.vel)).max() < 1e-10
    assert rel_err(np64(sig[0]), np.asarray(js)) < 1e-10


def test_dead_job_is_bit_identical(melt):
    _, _, tsys, tst, ref = melt
    out, sig = TH.strain_and_homogenize_multi(
        tsys, _pair(tst), torch.tensor([[DL_A, DL_B]], dtype=torch.float64),
        TH.MDParams(**PARAMS), active=torch.tensor([[True, False]]))
    for f in ("pos", "vel", "h", "vxi"):
        assert torch.equal(getattr(out, f)[0, 1], getattr(tst, f))
    assert torch.equal(sig[0, 1], torch.zeros(6, dtype=sig.dtype))
    assert np.abs(np64(out.pos[0, 0]) - np.asarray(ref[0][0].pos)).max() < 1e-10


def test_unsupported_runners_raise(melt):
    tsys = melt[2]
    with pytest.raises(ValueError, match="K1m is built for"):
        MF.check_multi(tsys.fused, 3)
    charged = dataclasses.replace(tsys.fused, spec=dataclasses.replace(tsys.fused.spec,
                                                                       coul=True))
    with pytest.raises(ValueError, match="K3"):
        MF.check_multi(charged, 2)
    sw, sw_st = TM.build_system(TM.MaterialSpec(name="si", n_cells=2), device="cpu")
    assert sw.fused.spec.kernel == "K5"
    with pytest.raises(ValueError, match="K5"):
        MF.check_multi(sw.fused, 2)
    unfused, _ = TM.build_system(TM.MaterialSpec(**SMALL, use_fused=False), device="cpu")
    with pytest.raises(ValueError, match="unfused"):
        TH.strain_and_homogenize_multi(unfused, _pair(melt[3]),
                                       torch.zeros((1, 2, 6), dtype=torch.float64),
                                       TH.MDParams(**PARAMS))


@pytest.fixture(scope="module")
def coupled():
    """test_opls_hmm.py's 1x1x1 dogbone with the 27 x 4 melt, prepared once."""
    cfg = HMMConfig()
    cfg = cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=1),
        time=cfg.time.__class__(timestep_length=5.0e-7, start_timestep=1, end_timestep=2),
        material=cfg.material.__class__(number_of_replicas=1, materials=("g0",),
                                        proportions=(1.0,)),
        md=cfg.md.__class__(temperature=100.0, timestep_length=1.0, strain_rate=1.0e-3,
                            nsteps_sample=10, force_field="opls"),
        md_dtype="float64")
    spec = TM.MaterialSpec(name="g0", force_field="opls", n_chains=27, chain_length=4,
                           opls_lj_cutoff=6.0, opls_coul_cutoff=6.0, neighbor_k=48)
    return build_md_hmm(cfg, spec=spec, equil_steps=30, minimize_steps=80, device="cpu")


def test_coupler_pack_jobs_2_matches_1(coupled):
    hmm1 = coupled
    assert hmm1.backend.pack_jobs == 1
    hmm2 = dataclasses.replace(hmm1, backends=(dataclasses.replace(hmm1.backend, pack_jobs=2),))
    c1, o1 = hmm1.step(hmm1.init_state())
    c2, o2 = hmm2.step(hmm2.init_state())
    assert int(o1.n_jobs) == int(o2.n_jobs) > 0
    s1, s2 = c1[0].qp.new_stress, c2[0].qp.new_stress
    assert torch.allclose(s2, s1, rtol=0, atol=1e-12 * float(s1.abs().max()))
    assert float(s1.abs().max()) > 0
    for f in ("pos", "vel", "h", "vxi"):
        assert torch.allclose(getattr(c2[1][0], f), getattr(c1[1][0], f), rtol=0, atol=1e-12)


def test_odd_job_count_is_padded(coupled):
    """Three (job, replica) runs grouped in pairs: the last pair's pad job
    runs zero steps and is dropped."""
    be = coupled.backend
    st = TE.MDState(*(x.expand((3,) + x.shape) for x in (
        be.initial_md_state.pos, be.initial_md_state.vel, be.initial_md_state.h,
        be.initial_md_state.vxi)))
    dl = torch.tensor([[DL_A], [DL_B], [[0.0] * 6]], dtype=torch.float64) * 0.2
    o1, s1 = dataclasses.replace(be, pack_jobs=1)._run_jobs(st, dl)
    o2, s2 = dataclasses.replace(be, pack_jobs=2)._run_jobs(st, dl)
    assert s2.shape == s1.shape == (3, 1, 6)
    assert torch.allclose(s2, s1, rtol=0, atol=1e-12 * float(s1.abs().max()))
    assert torch.allclose(o2.pos, o1.pos, rtol=0, atol=1e-12)
    unfused, _ = TM.build_system(TM.MaterialSpec(**SMALL, use_fused=False), device="cpu")
    with pytest.raises(ValueError, match="unfused"):
        MDBackend(sys=unfused, params=be.params, ensemble=be.ensemble, n_repl=1, max_jobs=8,
                  initial_md_state=be.initial_md_state, pack_jobs=2)
