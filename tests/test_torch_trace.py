"""The port's tracer (``scema_tpu_torch/utils/trace.py``) on the CPU: off,
the MD-coupled step enters no profiler range and counts nothing; on, its
spans form the step's tree under ``torch.profiler`` with the timestep in
``hmm.step``'s args, the step's results are bit for bit those of the
untraced step, the host syncs are counted at the sites the step passes,
``md.job_steps`` is the MD steps the jobs run, and ``cli run --profile``
writes the spans and each step's counters; on the card (a test that skips
without one) CUDA's sync debug mode reports the same syncs.  The dogbone is
1x1x2 cells (16 qps) of a 48-site united-atom melt, float64, prepared by
the quick prep."""
import json
import warnings

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from scema_tpu_torch import cli
from scema_tpu_torch.config import HMMConfig
from scema_tpu_torch.hmm import md_coupling as MC
from scema_tpu_torch.hmm.md_coupling import build_md_hmm
from scema_tpu_torch.md import engine as E
from scema_tpu_torch.md import homogenization as HZ
from scema_tpu_torch.md import material as TM
from scema_tpu_torch.utils import trace

from torch_port_util import leaves


SMALL = dict(name="g0", force_field="opls", n_chains=8, chain_length=6,
             opls_lj_cutoff=5.0, opls_coul_cutoff=5.0, validate=False)


def _cfg():
    cfg = HMMConfig()
    return cfg.replace(
        mesh=cfg.mesh.__class__(x_cells=1, y_cells=1, z_cells=2),
        md=cfg.md.__class__(temperature=300.0, timestep_length=2.0, strain_rate=1.0e-3,
                            nsteps_sample=20),
        md_dtype="float64")


# child -> parent of every span of one MD-coupled step on the K1 route
TREE = {
    "fe.begin": "hmm.step", "fe.solve": "hmm.step", "cluster": "hmm.step",
    "cluster.splines": "cluster", "cluster.distance": "cluster",
    "cluster.reduce": "cluster", "sync.cluster.reduce": "cluster.reduce",
    "md.update": "hmm.step", "md.pack": "md.update", "sync.md.job_list": "md.pack",
    "sync.md.n_valid": "md.pack", "md.bridge": "md.update", "md.run": "md.update",
    "md.strain": "md.run", "md.sample": "md.run", "md.average": "md.update",
    "md.scatter": "md.update",
    "fe.stress_update": "hmm.step",
    "fe.reaction": "hmm.step", "fe.end": "hmm.step",
}
# the points where the host waits for the device in one step, all reads of
# a device value (on the card CUDA's sync debug mode reports the same 3,
# test_card_step_synchronises_at_the_three_reads): the reduction's first
# pick, the job list and its count
SITES = {"host_syncs.cluster.reduce": 1, "host_syncs.md.job_list": 1,
         "host_syncs.md.n_valid": 1}


@pytest.fixture(scope="module")
def hmm_carry():
    hmm = build_md_hmm(_cfg(), spec=TM.MaterialSpec(**SMALL), device="cpu", equil_steps=10,
                       minimize_steps=20)
    carry = hmm.init_state()
    for _ in range(2):
        carry, _ = hmm.step(carry)
    return hmm, carry


@pytest.fixture
def traced():
    trace.reset()
    trace.enable()
    yield
    trace.disable()
    trace.reset()


@pytest.fixture(scope="module")
def profiled(hmm_carry):
    hmm, carry = hmm_carry
    trace.reset()
    trace.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
            hmm.step(carry)
    finally:
        trace.disable()
        trace.reset()
    return {e.name: e for e in prof.events() if e.is_user_annotation}, prof


def _raise(*a, **kw):
    raise AssertionError("a profiler range was entered with tracing off")


def test_off_enters_no_range_and_counts_nothing(hmm_carry, monkeypatch):
    hmm, carry = hmm_carry
    assert not trace.enabled()
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter", _raise)
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", _raise)
    trace.reset()
    hmm.step(carry)
    assert set(trace.counters()) == set(trace.launch_counters())


@pytest.mark.parametrize("child", sorted(TREE))
def test_span_tree(profiled, child):
    spans, _ = profiled
    assert spans[child].cpu_parent.name == TREE[child]


def test_step_spans_in_order_with_their_args(profiled, hmm_carry):
    spans, _ = profiled
    top = [n for n, p in TREE.items() if p == "hmm.step"]
    assert sorted(top, key=lambda n: spans[n].time_range.start) == [
        "fe.begin", "fe.solve", "cluster", "md.update", "fe.stress_update", "fe.reaction",
        "fe.end"]
    assert spans["hmm.step"].cpu_parent is None
    assert spans["hmm.step"].concrete_inputs == [hmm_carry[1][0].timestep + 1]
    assert spans["md.update"].concrete_inputs == [0]


def test_span_table_on_the_cpu(profiled):
    table = trace.span_table(profiled[1])
    assert set(TREE) | {"hmm.step"} <= set(table)
    assert {n for n in set(table) - set(TREE) - {"hmm.step"} if not n.startswith("sync.")} \
        == set()
    assert {n for n in table if n.startswith("sync.")} == {
        "sync." + k.removeprefix("host_syncs.") for k in SITES}
    assert table["sync.md.job_list"]["calls"] == 1
    assert table["hmm.step"]["calls"] == 1
    assert table["md.run"]["host_ms"] <= table["md.update"]["host_ms"]
    assert all(v["device_ms"] == 0 for v in table.values())
    assert trace.span_table(profiled[1], "md.")["md.run"] == table["md.run"]


def test_traced_step_is_bit_for_bit(hmm_carry):
    hmm, carry = hmm_carry
    plain = hmm.step(carry)
    trace.enable()
    try:
        traced = hmm.step(carry)
    finally:
        trace.disable()
        trace.reset()
    a, b = leaves(plain), leaves(traced)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert torch.equal(x, y) if torch.is_tensor(x) else x == y


@pytest.mark.parametrize("n_steps", [1, 2])
def test_host_syncs_at_the_sites_hit(hmm_carry, traced, n_steps):
    hmm, carry = hmm_carry
    for _ in range(n_steps):
        carry, _ = hmm.step(carry)
    got = trace.counters()
    assert {k: v for k, v in got.items() if k.startswith("host_syncs.")} == {
        k: n_steps * v for k, v in SITES.items()}
    assert got["host_syncs"] == n_steps * sum(SITES.values())
    assert got["md.jobs"] == n_steps * 16


def test_chunk_loop_syncs(traced):
    assert [(c, a.tolist(), f) for c, a, f in E._chunks(torch.tensor([2, 0, 1]))] == [
        (0, [0, 2], False), (1, [0], False)]
    assert trace.counters()["host_syncs.md.chunk_count"] == 1
    assert trace.counters()["host_syncs.md.chunk_jobs"] == 2


def test_job_steps_are_the_runs_steps(hmm_carry, traced, monkeypatch):
    hmm, carry = hmm_carry
    seen = []
    real = MC.strain_and_homogenize

    def spy(sys_, st, dl, params, active=None):
        seen.append((st.h, dl, active, params))
        return real(sys_, st, dl, params, active)

    monkeypatch.setattr(MC, "strain_and_homogenize", spy)
    hmm.step(carry)
    (h, dl, active, params), = seen
    nts = HZ.nts_for_strain(HZ.effective_strain(h, dl), params)
    runs = nts.numel() if active is None else int(active.sum())
    assert trace.counters()["md.job_steps"] == int(nts.sum()) + runs * params.nsteps_sample


def test_device_counter_accumulates_until_reset(traced):
    trace.count_device("x", torch.tensor(3))
    trace.count_device("x", torch.tensor([2, 5]).sum())
    trace.count("y", 4)
    assert trace.counters()["x"] == 10 and trace.counters()["y"] == 4
    trace.reset()
    assert "x" not in trace.counters() and "y" not in trace.counters()


def test_off_calls_are_one_shared_no_op():
    assert not trace.enabled()
    assert trace.span("a") is trace.span("b", 3) is trace.sync("c") \
        is trace.collective("all_gather", torch.zeros(3))
    trace.count("n", 1)
    trace.count_device("m", torch.tensor(1))
    assert not {"n", "m", "host_syncs", "collectives", "collective_bytes"} \
        & set(trace.counters())


def test_cli_profile_writes_spans_and_counters(tmp_path, capsys):
    cfg = tmp_path / "cfg.json"
    cfg.write_text("{}")
    prof = tmp_path / "prof"
    assert cli.main(["run", str(cfg), "--hooke", "--cpu", "--steps", "2",
                     "--profile", str(prof)]) == 0
    assert not trace.enabled()
    assert f"Step counters written to {prof / 'counters.json'}" in capsys.readouterr().out
    steps = json.loads((prof / "counters.json").read_text())
    assert [s["timestep"] for s in steps] == [1, 2]
    for s in steps:
        c = s["counters"]
        assert c["host_syncs.cluster.reduce"] == 1
        assert c["host_syncs"] == sum(v for k, v in c.items() if k.startswith("host_syncs."))
    names = {e["name"] for e in json.loads((prof / "trace.json").read_text())["traceEvents"]
             if e.get("cat") == "user_annotation"}
    assert {"hmm.step", "fe.solve", "cluster", "md.update", "fe.end"} <= names


@pytest.mark.requires_cuda
def test_card_step_synchronises_at_the_three_reads():
    """On the card, one coupled step after two warm ones makes exactly the
    synchronising calls of ``SITES``, as CUDA's sync debug mode reports
    them: no copy from host memory makes the host wait."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    # FE and MD in float32, as the CLI runs on the card (K2 takes float32)
    hmm = build_md_hmm(_cfg().replace(dtype="float32", md_dtype="float32"),
                       spec=TM.MaterialSpec(**SMALL), device=torch.device("cuda"),
                       equil_steps=10, minimize_steps=20)
    carry = hmm.init_state()
    for _ in range(2):
        carry, _ = hmm.step(carry)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            hmm.step(carry)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    calls = [f"{w.filename}:{w.lineno}" for w in caught if "synchroniz" in str(w.message)]
    assert len(calls) == sum(SITES.values()), calls
