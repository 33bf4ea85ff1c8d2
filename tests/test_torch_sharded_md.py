"""The MD-coupled step with its job batch spread over ranks
(``build_md_hmm(..., device_mesh=)``, ``MDBackend._run_jobs``) on two gloo
CPU ranks (float64, one torch thread each; tests/torch_dist_util.py): the
64-atom SW ``sic`` dogbone of tests/test_sharding.py:73-112, 2 macro-steps
on K5's plain version.  Over 2 ranks it equals the port's own unsharded
step within 1e-10 relative (rank 0 prepares the replica and broadcasts
it); against JAX's unsharded ``build_md_hmm`` on JAX's prepared replica
it holds the port's parity tolerance, 1e-8 (marked slow, as JAX's own
sharded coupled step is)."""
import numpy as np
import pytest

from scema_tpu_torch.config import HMMConfig as TCfg
from scema_tpu_torch.hmm.md_coupling import build_md_hmm as t_build_md_hmm
from scema_tpu_torch.md import material as TM

import torch_dist_util as DU
from torch_port_util import np64, one_torch_thread, rel_err  # noqa: F401

WORLD = 2
N_STEPS = 2

pytestmark = pytest.mark.usefixtures("one_torch_thread")


def _port_unsharded(prepared=None, material=None):
    hmm = t_build_md_hmm(DU.sic_cfg(TCfg), spec=TM.MaterialSpec(**DU.SIC_SPEC),
                         equil_steps=0, minimize_steps=10, device="cpu", prepared=prepared,
                         material=material)
    carry = hmm.init_state()
    jobs = []
    for _ in range(N_STEPS):
        carry, out = hmm.step(carry)
        jobs.append(int(out.n_jobs))
    return hmm, carry, jobs


@pytest.fixture(scope="module")
def runs(tmp_path_factory, one_torch_thread):
    ranks = DU.run_ranks(DU.sharded_md_worker, WORLD, tmp_path_factory.mktemp("md"),
                         None, None, N_STEPS)
    return ranks, _port_unsharded()


def test_sharded_coupled_step_matches_unsharded(runs):
    ranks, (hmm, carry, jobs) = runs
    sig1 = np64(carry[0].qp.new_stress)
    for r in range(WORLD):
        got = ranks[r]
        assert got["kernel"] == "K5" and got["max_jobs"] == hmm.backend.max_jobs
        # every rank starts from rank 0's prepared replica
        for f in ("pos", "vel", "h"):
            assert np.array_equal(got["init"][f], ranks[0]["init"][f])
        assert got["jobs"] == jobs and jobs[-1] > 0
        assert rel_err(got["stress"], sig1) < 1e-10
        assert rel_err(got["u"], np64(carry[0].u)) < 1e-10
        assert np.abs(got["pos"] - np64(carry[1][0].pos)).max() < 1e-10


def test_sharded_packed_jobs_match_unsharded(runs):
    """With ``pack_jobs`` = 2 each rank's block of jobs splits into whole
    J-tuples on K1m (md_coupling.py:214-224): 5 LJ jobs over 2 ranks (3 +
    2, the second rank's block padded with a zero-step job) against the
    unpacked, unsharded runs."""
    ranks, _ = runs
    st, sig = DU.packed_jobs(None, pack_jobs=1)
    for r in range(WORLD):
        got = ranks[r]["packed"]
        assert np.abs(got["pos"] - np64(st.pos)).max() < 1e-10
        assert np.abs(got["vel"] - np64(st.vel)).max() < 1e-10
        assert rel_err(got["sig"], np64(sig)) < 1e-10


@pytest.mark.slow
def test_sharded_coupled_step_matches_jax(tmp_path):
    """Port over 2 ranks against JAX's unsharded step (JAX's own sharded
    one equals that within 1e-10, tests/test_sharding.py:73-112), both
    from JAX's prepared replica."""
    import jax

    from scema_tpu.config import HMMConfig as JCfg
    from scema_tpu.hmm.md_coupling import build_md_hmm as j_build_md_hmm
    from scema_tpu.md import material as JM

    jh = j_build_md_hmm(DU.sic_cfg(JCfg), spec=JM.MaterialSpec(**DU.SIC_SPEC), equil_steps=0,
                        minimize_steps=10)
    be = jh.backend
    st = {f: np.asarray(getattr(be.initial_md_state, f)) for f in ("pos", "vel", "h", "vxi")}
    rows = [dict(length=np.asarray(be.ensemble.init_length[0, r]),
                 stress=np.asarray(be.ensemble.init_stress[0, r]),
                 stiff=np.asarray(be.ensemble.init_stiff[0, r]),
                 density=float(be.ensemble.rho[0, r])) for r in range(be.n_repl)]
    ranks = DU.run_ranks(DU.sharded_md_worker, WORLD, tmp_path, (st, rows), None, N_STEPS)
    carry = jh.init_state()
    step = jax.jit(jh.step)
    for _ in range(N_STEPS):
        carry, out = step(carry)
    sig1 = np.asarray(carry[0].qp.new_stress)
    for r in range(WORLD):
        assert ranks[r]["jobs"][-1] == int(out.n_jobs) > 0
        assert rel_err(ranks[r]["stress"], sig1) < 1e-8


def _step_lines(text):
    """The per-step lines and the milestone of a ``cli run`` output, the
    step's wall time cut off."""
    return [line.split("  (")[0] for line in text.splitlines()
            if line.startswith(("Timestep", "Max displacement"))]


def test_cli_run_under_torchrun(tmp_path):
    """``cli run`` under ``torchrun --standalone --nproc-per-node=2`` (gloo
    with --cpu): the Hooke dogbone's qps spread over the two ranks, rank 0
    alone printing, and its lines those of the single-process run."""
    import contextlib
    import io
    import os
    import subprocess
    import sys

    from scema_tpu_torch import cli

    cfg = tmp_path / "cfg.json"
    cfg.write_text("{}")
    argv = ["run", str(cfg), "--hooke", "--cpu", "--steps", "3"]
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert cli.main(argv) == 0
    env = dict(os.environ, OMP_NUM_THREADS="1")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    proc = subprocess.run([sys.executable, "-m", "torch.distributed.run", "--standalone",
                           "--nproc-per-node=2", "-m", "scema_tpu_torch.cli", *argv],
                          capture_output=True, text=True, timeout=300, cwd=root, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert _step_lines(proc.stdout) == _step_lines(buf.getvalue())
    assert len(_step_lines(proc.stdout)) == 4  # three steps, one milestone: rank 0 alone
