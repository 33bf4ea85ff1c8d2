"""The port's FE + Hooke-bridging slice against the JAX package.

Same inputs (the HMMConfig() dogbone, 576 qps) through both packages in
float64.  Tolerances: 1e-10 relative between the packages (both sum the
same terms; only XLA's vs PyTorch's reduction order differs, ~1e-15), and
1e-6 against the committed golden field (the reference's parity bar,
BASELINE.md)."""
import os

import jax
import numpy as np
import pytest
import torch

from scema_tpu.config import HMMConfig as JCfg
from scema_tpu.fem import assembly as JA
from scema_tpu.hmm.problem import build_hooke_hmm as j_build_hooke

from scema_tpu_torch import interop
from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.fem import assembly as TA
from scema_tpu_torch.hmm.problem import build_hooke_hmm as t_build_hooke

from torch_port_util import rel_err

N_STEPS = 10
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "dogbone_hooke_10step.npz")


def _hooke(cfg):
    return cfg.replace(bridging=cfg.bridging.__class__(
        stress_method=0, approx_md_with_hookes_law=True, use_pjm_scheduler=False))


@pytest.fixture(scope="module")
def runs():
    jh = j_build_hooke(_hooke(JCfg()))
    th = t_build_hooke(_hooke(TCfg()), device="cpu")
    js, ts = jh.init_state(), th.init_state()
    step = jax.jit(jh.step)
    out = {"j_sig": [], "t_sig": [], "j_out": [], "t_out": []}
    for _ in range(N_STEPS):
        js, jo = step(js)
        ts, to = th.step(ts)
        out["j_sig"].append(np.asarray(js.qp.new_stress))
        out["t_sig"].append(ts.qp.new_stress.numpy())
        out["j_out"].append(jo)
        out["t_out"].append(to)
    out.update(jh=jh, th=th, js=js, ts=ts)
    return out


def test_hooke_10_steps_match_jax(runs):
    assert rel_err(runs["t_sig"], runs["j_sig"]) < 1e-10
    assert rel_err(runs["ts"].u.numpy(), np.asarray(runs["js"].u)) < 1e-10
    assert rel_err(runs["ts"].v.numpy(), np.asarray(runs["js"].v)) < 1e-10
    for jo, to in zip(runs["j_out"], runs["t_out"]):
        assert int(jo.n_flagged) == int(to.n_flagged)
        assert int(jo.n_jobs) == int(to.n_jobs)
        for f in ("residual0", "residual1", "reaction_force"):
            assert abs(float(getattr(to, f)) - float(getattr(jo, f))) <= \
                1e-10 * abs(float(getattr(jo, f)))
    # the strain history the clustering layer reads
    assert rel_err(runs["ts"].hist.buffer.numpy(), np.asarray(runs["js"].hist.buffer)) < 1e-10


def test_hooke_matches_committed_golden(runs):
    """The golden npz, qp coordinates matched as tests/test_parity_golden.py
    does; needs nothing outside the repository."""
    d = np.load(GOLDEN)
    th = runs["th"]
    g = th.geom
    nodes = torch.as_tensor(th.problem.mesh.nodes)
    xyz = torch.einsum("qv,cvi->cqi", g.shapes, nodes[g.cells]).reshape(-1, 3).numpy()

    def order(x):
        key = np.round(x / 1e-9).astype(np.int64)
        return np.lexsort((key[:, 0], key[:, 1], key[:, 2]))

    ia, ib = order(xyz), order(d["qp_xyz"])
    assert np.allclose(xyz[ia], d["qp_xyz"][ib], atol=1e-9)
    sig = np.stack(runs["t_sig"])[:, ia, :]
    ref = d["sigma"][:, ib, :]
    assert np.abs(sig - ref).max() / np.abs(ref).max() < 1e-6


def test_assembly_blocks_match_jax(runs):
    """Gather/einsum/index_add assembly against segment_sum, on a random
    stress field (the building blocks of every step)."""
    jh, th = runs["jh"], runs["th"]
    rng = np.random.default_rng(0)
    sig = rng.standard_normal((th.geom.n_qp_total, 6)) * 1e6
    rho = 1000.0 + rng.random(th.geom.n_qp_total)
    u = rng.standard_normal(th.geom.n_nodes * 3) * 1e-4
    pairs = [
        (TA.internal_force(th.geom, torch.as_tensor(sig)), JA.internal_force(jh.geom, sig)),
        (TA.external_force(th.geom, torch.as_tensor(rho)), JA.external_force(jh.geom, rho)),
        (TA.lumped_mass_diag(th.geom, torch.as_tensor(rho)), JA.lumped_mass_diag(jh.geom, rho)),
        (TA.qp_strains(th.geom, torch.as_tensor(u)), JA.qp_strains(jh.geom, u)),
    ]
    for t, j in pairs:
        assert rel_err(t.numpy(), np.asarray(j)) < 1e-12


def test_injected_fe_state_steps_like_jax(runs):
    """A JAX FE state carried into the port (interop) steps identically."""
    jh, th = runs["jh"], runs["th"]
    ts = interop.fe_state(runs["js"])
    js2, _ = jax.jit(jh.step)(runs["js"])
    ts2, _ = th.step(ts)
    assert rel_err(ts2.qp.new_stress.numpy(), np.asarray(js2.qp.new_stress)) < 1e-10
    assert rel_err(ts2.u.numpy(), np.asarray(js2.u)) < 1e-10
