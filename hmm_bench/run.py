"""Run one cell of the port's benchmark once.

    python3 -m hmm_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``workloads`` in BENCHMARK.json)
names a configuration (its ``file``) and a traffic mix
(``hmm_bench/traffic/<name>.json``).  Set-up builds the MD-coupled HMM as
``scema_tpu_torch``'s ``cli run`` does (``build_md_hmm``, the staged prep,
the configuration's seed replaced by ``--seed``), runs the traffic's
prefix of macro-steps and keeps that carry, and warms up one segment
from it.  The window then replays the segment of ``segment_steps``
consecutive macro-steps from the kept carry, each step ending in a device
synchronisation, until ``--seconds`` have passed.  With ``--trace 1`` the
window instead runs ``TRACE_SEGMENTS`` segments under ``torch.profiler``,
the MD backend's calls bracketed by synchronisations, and the per-layer
metrics are read from it by ``hmm_bench/metrics/<name>.py``.

After the window the benchmark checks the last segment against its plain
reference (``hmm_bench/reference``), prints each number compared with its
limit as the last lines of standard error, and prints one JSON line as
the last line of standard output.  It exits with 2, printing no result,
without a CUDA device (or with fewer than the cell asks for), and with 3
when ``jax``, ``jaxlib``, ``flax`` or ``scema_tpu`` is loaded once the
window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from hmm_bench import registry  # noqa: E402

# segments of the traced window
TRACE_SEGMENTS = 2
# the top-level module names that may not be loaded (the JAX package and JAX)
FORBIDDEN = ("jax", "jaxlib", "flax", "scema_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _sync(dev) -> None:
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _launch_counts() -> dict:
    """Every MD-layer launch counter of the port, by name."""
    from scema_tpu_torch.ops import md_fused as MF
    from scema_tpu_torch.ops import sw_bricks as SWB

    out = {}
    for owner, fn in (("md_run", MF.md_run), ("md_run_multi", MF.md_run_multi),
                      ("md_forces_virial", MF.md_forces_virial),
                      ("sw_moments_bricks", SWB.sw_moments_bricks),
                      ("sw_forces_bricks", SWB.sw_forces_bricks)):
        for k, v in vars(fn).items():
            if k.startswith("launches"):
                out[f"{owner}.{k}"] = int(v)
    return out


class Cell:
    """One cell's set-up and steps on one device (or one rank of several)."""

    def __init__(self, conf: dict, traffic: dict, seed: int, dev, mesh=None, rank: int = 0):
        import torch

        from scema_tpu_torch.config import config_from_dict, md_spec_kwargs
        from scema_tpu_torch.hmm.md_coupling import build_md_hmm
        from scema_tpu_torch.md.material import MaterialSpec

        self.conf, self.seed, self.dev, self.rank = conf, seed, dev, rank
        self.mesh = mesh
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        cfg = config_from_dict(conf["hmm"], dtype=conf["dtype"], md_dtype=conf["md_dtype"],
                               seed=int(seed))
        spec = None
        if conf.get("md box"):  # the box's cells or chains, where not the default
            box = {k: tuple(v) if isinstance(v, list) else v for k, v in conf["md box"].items()}
            spec = MaterialSpec(name=cfg.material.materials[0], **md_spec_kwargs(cfg), **box)
        self.hmm = build_md_hmm(cfg, spec=spec, staged=True,
                                ns_init=int(conf["prep"]["ns_init"]), device=dev,
                                device_mesh=mesh)
        self.seg = int(traffic["segment_steps"])
        carry = self.hmm.init_state()
        self.flagged = []
        for _ in range(int(traffic["prefix_steps"])):
            carry, out = self.hmm.step(carry)
            self.flagged.append(int(out.n_flagged))
        self.kept = carry
        _sync(dev)

    def segment(self, clock=None):
        """One segment from the kept carry; ``clock(c_in) -> (c_out, out)``
        wraps each step.  Yields (position, c_in, c_out, out)."""
        c = self.kept
        for i in range(self.seg):
            c2, out = clock(c) if clock else self.hmm.step(c)
            yield i, c, c2, out
            c = c2


def _stop_all(stop: bool, cell: Cell) -> bool:
    """Rank 0's decision to close the window, on every rank."""
    if cell.mesh is None:
        return stop
    import torch

    from scema_tpu_torch.parallel import mesh_utils as MU

    return bool(MU.broadcast(torch.tensor([float(stop)], device=cell.dev))[0] > 0.5)


class HostWatch:
    """Python's garbage collections (count, seconds and longest, by
    generation) and the process's context switches over a span, so that a
    slow step on the host can be told apart: ``gc_s`` is the collections'
    running total."""

    def __init__(self):
        self.gc = {g: [0, 0.0, 0.0] for g in range(3)}
        self.gc_s = 0.0
        self._t = 0.0

    def _collect(self, phase, info):
        if phase == "start":
            self._t = time.perf_counter()
            return
        d = time.perf_counter() - self._t
        g = self.gc[info["generation"]]
        g[0] += 1
        g[1] += d
        g[2] = max(g[2], d)
        self.gc_s += d

    def __enter__(self):
        import resource

        self._ru = resource.getrusage(resource.RUSAGE_SELF)
        gc.callbacks.append(self._collect)
        return self

    def __exit__(self, *exc):
        import resource

        gc.callbacks.remove(self._collect)
        ru = resource.getrusage(resource.RUSAGE_SELF)
        self.csw = (ru.ru_nvcsw - self._ru.ru_nvcsw, ru.ru_nivcsw - self._ru.ru_nivcsw)

    def line(self) -> str:
        return ("garbage collections by generation (count, s, longest s): " + "; ".join(
            f"{g} {n} {t:.6f} {m:.6f}" for g, (n, t, m) in self.gc.items())
            + f"; context switches voluntary {self.csw[0]} involuntary {self.csw[1]}")


def timed_window(cell: Cell, seconds: float):
    """(step walls, window seconds, last triple per segment position, the
    window's HostWatch, each step's seconds of garbage collection)."""
    dev = cell.dev
    walls, gcs, last = [], [], {}
    done = False
    with HostWatch() as watch:
        t0 = time.perf_counter()
        t_last = t0

        def clock(c):
            nonlocal t_last
            ts, g0 = time.perf_counter(), watch.gc_s
            r = cell.hmm.step(c)
            _sync(dev)
            t_last = time.perf_counter()
            walls.append(t_last - ts)
            gcs.append(watch.gc_s - g0)
            return r

        while not done:
            for i, c, c2, out in cell.segment(clock):
                last[i] = (c, c2, out)
                if _stop_all(t_last - t0 >= seconds, cell):
                    done = True
                    break
    return walls, t_last - t0, last, watch, gcs


def window_report(walls: list, window_s: float, watch: HostWatch, gcs: list, log) -> float:
    """Print the window's steps on ``log``: their count, spread, the mean
    step of each quarter of the window and where its slowest steps went;
    returns the 95th percentile (nearest rank) of the steps."""
    srt = sorted(walls)
    p95 = srt[min(len(srt) - 1, math.ceil(0.95 * len(srt)) - 1)]
    med = srt[len(srt) // 2]
    quarters = (walls[k * len(walls) // 4:(k + 1) * len(walls) // 4] for k in range(4))
    print(f"window {window_s:.6f} s, {len(walls)} macro-steps (p95 over {len(walls)} "
          f"samples, {len(walls) - math.ceil(0.95 * len(walls))} beyond it); step min "
          f"{srt[0]:.6f} median {med:.6f} max {srt[-1]:.6f} s; mean step by quarter of the "
          f"window " + " ".join(f"{sum(q) / len(q):.6f}" for q in quarters if q), file=log)
    slow = [k for k, w in enumerate(walls) if w > 2 * med]
    longest = sorted(range(len(walls)), key=walls.__getitem__)[-5:]
    print(f"{watch.line()}; {len(slow)} steps over twice the median, "
          f"{sum(walls[k] - med for k in slow):.6f} s over it, "
          f"{sum(gcs[k] for k in slow):.6f} s of it in collections; longest steps (s, of it "
          f"collections): " + " ".join(f"{walls[k]:.6f}/{gcs[k]:.6f}" for k in longest),
          file=log)
    return p95


def traced_window(cell: Cell):
    """The per-layer context of TRACE_SEGMENTS segments under the profiler,
    and the last triple per segment position."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from scema_tpu_torch.hmm.md_coupling import MDBackend

    from hmm_bench import trace as TR

    dev = cell.dev
    orig = MDBackend.update
    md_s, walls, last = [], [], {}

    def update(self, *a, **kw):
        _sync(dev)
        t = time.perf_counter()
        with record_function("md_update"):
            r = orig(self, *a, **kw)
            _sync(dev)
        md_s.append(time.perf_counter() - t)
        return r

    def clock(c):
        ts = time.perf_counter()
        with record_function("macro_step"):
            r = cell.hmm.step(c)
            _sync(dev)
        walls.append(time.perf_counter() - ts)
        return r

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    c0 = _launch_counts()
    MDBackend.update = update
    try:
        with profile(activities=acts) as prof:
            for _ in range(TRACE_SEGMENTS):
                for i, c, c2, out in cell.segment(clock):
                    last[i] = (c, c2, out)
    finally:
        MDBackend.update = orig
    c1 = _launch_counts()
    dev_ev, host_ev = TR.split_events(prof, ("macro_step", "md_update"))
    steps = TR.intervals(host_ev, "macro_step")
    window = (steps[0][0], steps[-1][1])
    dev_ev = [e for e in dev_ev if window[0] <= e.time_range.start <= window[1]]
    ctx = dict(steps=len(walls), step_s=walls, md_update_s=md_s,
               launches={k: c1[k] - c0.get(k, 0) for k in c1},
               window_s=(window[1] - window[0]) / 1e6,
               busy_s=TR.device_busy_us(dev_ev) / 1e6,
               md_device_s=TR.device_us_within(dev_ev, TR.intervals(host_ev, "md_update")) / 1e6,
               device_ops=TR.top_device_ops(dev_ev),
               idle_gaps=TR.idle_gaps(dev_ev, host_ev, window))
    return ctx, last


def md_work(cell: Cell, last: dict, segments: int) -> dict:
    """Operations and bytes of the MD work of ``segments`` segments: each
    job's strained steps (its step count from its strain, as the MD layer
    sets it) and sampling steps, at the live pairs of the kept carry's boxes
    (a sample of 32), counted by ``hmm_bench.roofline``."""
    import torch

    from hmm_bench import roofline as RL
    from hmm_bench.reference import fe as RF
    from hmm_bench.reference import md as RM

    be = cell.hmm.backend
    micro = cell.kept[1][0]
    n = micro.pos.shape[-2]
    sysr = ref_system(cell)
    kind = sysr.kind
    gen = torch.Generator().manual_seed(cell.seed)
    pick = torch.randperm(micro.pos.shape[0], generator=gen)[:32].to(micro.pos.device)
    pos = micro.pos[pick, 0].double()
    h = micro.h[pick, 0].double()
    if kind == "sw":
        live = RL.sw_live_pairs(pos, h, sysr.sw["rc2"])
    else:
        live = RL.pair_fractions(pos, h, sysr.cutoff2, skip=sysr.lj1.to(pos.device) == 0)[0]
    strain = jobs = 0
    for (fe_in, micros), _, out in last.values():
        job = torch.nonzero(out.md_ran).flatten()
        src = RF.job_sources(job, micros[0].has_run, fe_in.hist.id_to_get_results_from)
        dl = RF.length_variation(out.md_strain_cg[job].double(), be.ensemble.rotam[0].double(),
                                 be.ensemble.init_length[0].double())
        _, nts = RM.job_steps(micros[0].h[src].double().flatten(0, 1), dl.flatten(0, 1),
                              be.params.strain_rate, be.params.dt)
        strain += int(nts.sum())
        jobs += int(nts.numel())
    sample = jobs * be.params.nsteps_sample
    flops = segments * RL.md_work(kind, n, strain, sample, live)
    # each job's state and thermostat in and out, once per run and sampling
    # launch, in float32
    nbytes = segments * jobs * 2 * 2 * (6 * n + 3) * 4
    min_ms, by = RL.bound(nbytes, flops)
    return dict(kind=kind, live=live, strain_steps=strain * segments,
                sample_steps=sample * segments, flops=flops, bytes=nbytes,
                min_s=min_ms / 1e3, bound_by=by)


def ref_system(cell: Cell):
    """The reference's MD system of the cell's material, from its definition."""
    from hmm_bench.reference import md as RM

    box = cell.conf.get("md box", {})
    ff = cell.conf["hmm"]["molecular dynamics parameters"].get("force field", "opls")
    if ff == "sw":
        return RM.sw_system(tuple(box.get("n_cells_xyz") or (box.get("n_cells", 3),) * 3))
    return RM.g0_system(int(box.get("n_chains", 64)), int(box.get("chain_length", 8)),
                        float(box.get("opls_lj_cutoff", 10.0)))


def check(cell: Cell, last: dict, fp0: list, device, control: bool = False) -> dict:
    """The numbers compared, over the last segment; with ``control`` also the
    control's (the reference in bfloat16 in the program's place)."""
    import torch

    from hmm_bench.reference import check as CK

    be = cell.hmm.backend
    sysr = ref_system(cell)
    prepared = be.initial_md_state
    t0 = time.perf_counter()
    ref = CK.Reference(cell.conf, sysr, prepared, device)
    numbers = {"carry_unchanged": sum(a != b for a, b in zip(fp0, CK.fingerprint(cell.kept)))}
    start = CK.start_gaps(ref, cell.kept[0].qp.rho, be.ensemble.init_length[0],
                          be.ensemble.init_stress[0])
    steps, ctrl = [], []
    for i in sorted(last):
        c_in, c_out, out = last[i]
        jobs = ref.plan(c_in, i, cell.seed)
        r = ref.step(c_in, out.md_stress_repl, jobs)
        steps.append(CK.gaps(CK.program_outputs(c_in, c_out, out, jobs), r))
        if control:
            cr = ref.step(c_in, out.md_stress_repl, jobs, dtype=torch.bfloat16)
            ctrl.append(CK.gaps(cr, r))
    numbers.update(CK.worst(steps))
    numbers["prep"] = start["prep"]
    numbers["md_stress"] = max(numbers.get("md_stress", 0.0), start["init_stress"])
    out = {"numbers": numbers, "md_jobs_checked": sum(ref.checked.values()),
           "seconds": time.perf_counter() - t0}
    if control:
        cn = CK.worst(ctrl)
        cs = CK.start_gaps(ref, *ref.start(torch.bfloat16))
        cn["prep"] = cs["prep"]
        cn["md_stress"] = max(cn.get("md_stress", 0.0), cs["init_stress"])
        out["control"] = cn
    return out


def setup_cell(conf: dict, traffic: dict, seed: int, device):
    """The cell's set-up: ranks, build, prefix steps, one warm segment.
    Returns (cell, fingerprint of the kept carry, setup seconds)."""
    import torch

    from hmm_bench.reference import check as CK

    rank, mesh = 0, None
    if int(traffic.get("ranks", 1)) > 1:
        from hmm_bench.launcher import init_rank
        from scema_tpu_torch.parallel import mesh_utils as MU

        rank, _, rdev = init_rank(device.type)
        device = rdev or device
        mesh = MU.make_mesh()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    cell = Cell(conf, traffic, seed, device, mesh, rank)
    fp0 = CK.fingerprint(cell.kept)
    for _ in cell.segment():  # warm-up: every shape the window uses
        pass
    _sync(device)
    setup_s = time.perf_counter() - T_START
    if rank == 0:
        print(f"set-up {setup_s:.3f} s; flagged qps over the prefix steps {cell.flagged}; "
              f"route {cell.hmm.backend.sys.route}", file=sys.stderr)
    return cell, fp0, setup_s


def measure(cell: Cell, fp0: list, setup_s: float, seconds: float, trace: bool,
            per_layer: list, end_to_end: list, control: bool = False) -> dict:
    """The window, its metrics and the check of its last segment: the
    result object (without printing it); on a rank other than 0, only
    ``attempted`` and ``failed``."""
    import torch

    from hmm_bench.reference import check as CK

    device, log = cell.dev, sys.stderr
    ctx = None
    if trace:
        ctx, last = traced_window(cell)
        walls = ctx["step_s"]
    else:
        walls, window_s, last, watch, gcs = timed_window(cell, seconds)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    result = {"attempted": len(walls), "failed": 0}
    if cell.rank != 0:
        return result
    metrics = {}
    if trace:
        work = md_work(cell, last, TRACE_SEGMENTS)
        ctx.update(md_flops=work["flops"], md_bytes=work["bytes"], md_min_s=work["min_s"])
        print(f"MD work of the traced window: {work['flops']:.6e} operations, "
              f"{work['bytes']:.6e} bytes, {work['strain_steps']} strained and "
              f"{work['sample_steps']} sampling job-steps at live {work['live']:.6g} "
              f"({work['kind']}); least time {work['min_s']:.6e} s by {work['bound_by']}",
              file=log)
        for m in per_layer:
            v = registry.metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        p95 = window_report(walls, window_s, watch, gcs, log)
        values = {"macro_step_s": window_s / len(walls), "macro_step_p95_s": p95,
                  "setup_s": setup_s}
        for m in end_to_end:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}
    # the reference runs once the window's other states are freed
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    chk = check(cell, last, fp0, device, control=control)
    numbers = chk["numbers"]
    device_info = {"platform": "gpu" if device.type == "cuda" else "cpu",
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1 if cell.mesh is None else cell.mesh.size(),
                   "memory_peak_bytes": int(peak)}
    if trace:
        device_info.update(busy_s=ctx["busy_s"], window_s=ctx["window_s"])
    result.update(correct=CK.is_correct(numbers), metrics=metrics, device=device_info)
    if trace:
        result["breakdown"] = {"device_ops": ctx["device_ops"], "idle_gaps": ctx["idle_gaps"]}
    result["checked"] = {k: [numbers[k], CK.LIMITS[k]] for k in CK.LIMITS if k in numbers}
    if control:
        result["control"] = chk["control"]
        result["control_over"] = CK.over_limit(chk["control"])
    print(f"MD jobs rerun by the reference: {chk['md_jobs_checked']}; the check took "
          f"{chk['seconds']:.3f} s", file=log)
    return result


def run_cell(conf: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
             per_layer: list, end_to_end: list, control: bool = False) -> dict:
    """One run of a cell: set-up, then :func:`measure`."""
    cell, fp0, setup_s = setup_cell(conf, traffic, seed, device)
    return measure(cell, fp0, setup_s, seconds, trace, per_layer, end_to_end, control)


def result_line(result: dict) -> dict:
    """The last line's object: its fixed keys, then each number
    compared with its limit."""
    line = {k: result[k] for k in ("correct", "attempted", "failed", "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["checked"] = {k: {"value": v, "limit": lim} for k, (v, lim) in result["checked"].items()}
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hmm_bench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    root = os.getcwd()
    bench = registry.benchmark(root)
    cell = registry.cell(bench, args.workload)
    conf = registry.config(root, bench, cell["config"])
    traffic = registry.traffic(cell["traffic"])

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"error: the cell needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    ranks = int(traffic.get("ranks", 1))
    if ranks > 1 and "RANK" not in os.environ:
        from hmm_bench.launcher import spawn

        return spawn([sys.executable, "-m", "hmm_bench.run"] + list(argv or sys.argv[1:]),
                     ranks)
    card = _card_line()
    print(card, file=sys.stderr)
    dev = torch.device("cuda", torch.cuda.current_device())
    result = run_cell(conf, traffic, args.seed, args.seconds, bool(args.trace), dev,
                      registry.metrics_of(bench, args.workload, "per_layer"),
                      registry.metrics_of(bench, args.workload, "end_to_end"))
    if "correct" not in result:  # a rank other than 0
        return 0
    bad = forbidden_modules()
    if bad:
        print(f"error: modules of JAX or the JAX package loaded: {bad}", file=sys.stderr)
        return 3
    print(f"card {card}", file=sys.stderr)
    for k, (v, lim) in result["checked"].items():
        print(f"{k} {v:.6g} limit {lim:g}", file=sys.stderr)
    print(json.dumps(result_line(result)))
    return 0


def _card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    import subprocess

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    lines = smi.stdout.strip().splitlines()
    return lines[0] if smi.returncode == 0 and lines else "nvidia-smi failed"


if __name__ == "__main__":
    sys.exit(main())
