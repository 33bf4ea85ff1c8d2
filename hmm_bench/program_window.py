"""The program window: the coupled step read through the port's own spans.

    python3 -m hmm_bench.program_window --workload <name> --seed <n> [--segments 2]
        [--chrome out.json] [--sync-debug]

Set-up as ``hmm_bench.run`` makes it; then ``segments`` segments from the
kept carry with the port's tracer on (``scema_tpu_torch.utils.trace``)
under ``torch.profiler`` (CPU and CUDA), each step timed as the timed
window times it (the host clock, one synchronisation at its end) with no
other wrapper or synchronisation.  The tracer is turned off again whatever
happens.  :func:`program_window` returns the window's readings under
``prog_*`` keys, or nothing where the program has no tracer; :func:`read`
turns them into the per-layer numbers below, each per macro-step (None
where there is nothing to read):

* ``fe_idle_ms``, ``cluster_idle_ms``, ``md_idle_ms``: the device's idle
  time (the gaps in the union of the device intervals) under the ``fe.*``
  spans, the ``cluster`` span and the ``md.update`` spans;
* ``md_device_ms``: the device time of the kernels launched inside
  ``md.update``, each device event linked to the CUDA call that launched
  it by the profiler's correlation id (the trace's flow events);
* ``host_syncs`` (the counter), ``sync_wait_ms`` (the host time of the
  ``sync.*`` spans), ``md_job_steps`` (the ``md.job_steps`` counter).

The command prints one JSON line with these numbers, the window's idle
time under no step span and the MD job-steps a step that ``run.md_work``
counts from the strains.  With ``--chrome`` it writes the window's Chrome
trace; with ``--sync-debug`` it also runs one more step under
``torch.cuda.set_sync_debug_mode("warn")`` and prints each synchronising
call the card reports against the tracer's ``host_syncs`` of that step.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import warnings
from collections import defaultdict

from hmm_bench import registry

TRACE_SEGMENTS = 2


def _tracer():
    try:
        from scema_tpu_torch.utils import trace
    except ImportError:  # a program without the tracer: nothing to read
        return None
    return trace


def _union(iv: list) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _overlap(a: list, b: list) -> float:
    """Length of the intersection of two unions of intervals."""
    i = j = 0
    total = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0.0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def reduce_profile(prof, window: tuple) -> dict:
    """The program window's device numbers (seconds) from a finished
    profile: busy and idle time inside ``window`` (ns, the profiler's
    clock), idle time under each layer's spans, and the device time of the
    kernels launched inside ``md.update``."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans, launch, dev = defaultdict(list), {}, []
    for k in events:
        if k.device_type() == cuda:
            if not k.is_user_annotation():  # a kernel, copy or fill
                dev.append(k)
        elif k.is_user_annotation():
            spans[k.name()].append([k.start_ns(), k.end_ns()])
        elif k.name().startswith("cu"):  # the CUDA runtime or driver call
            launch[k.correlation_id()] = k.start_ns()
    dev = [k for k in dev if k.name() not in spans]  # the spans' copies on the device
    w0, w1 = window
    busy = _union([[max(k.start_ns(), w0), min(k.end_ns(), w1)] for k in dev
                   if k.end_ns() > w0 and k.start_ns() < w1])
    idle = _union([[a, b] for a, b in zip([w0] + [e for _, e in busy],
                                          [s for s, _ in busy] + [w1]) if b > a])

    def under(names) -> float:
        return _overlap(idle, _union([iv for n in names for iv in spans.get(n, [])])) / 1e9

    def launched_in(name: str) -> float:
        iv = _union(spans.get(name, []))
        total = 0
        for k in dev:  # linked to its launch by the correlation id (the flow events)
            t = launch.get(k.correlation_id())
            if t is not None and any(a <= t <= b for a, b in iv):
                total += k.end_ns() - k.start_ns()
        return total / 1e9

    steps = _union(spans.get("hmm.step", []))
    return dict(
        prog_busy_s=sum(e - s for s, e in busy) / 1e9,
        prog_idle_s=sum(e - s for s, e in idle) / 1e9,
        prog_idle_outside_steps_s=(sum(e - s for s, e in idle) / 1e9
                                   - _overlap(idle, steps) / 1e9),
        prog_idle_fe_s=under([n for n in spans if n.startswith("fe.")]),
        prog_idle_cluster_s=under(["cluster"]),
        prog_idle_md_s=under(["md.update"]),
        prog_md_device_s=launched_in("md.update"),
        prog_sync_s=sum(b - a for n, ivs in spans.items() if n.startswith("sync.")
                        for a, b in ivs) / 1e9)


def program_window(cell, segments: int = TRACE_SEGMENTS, chrome: str = "") -> dict:
    """The ``prog_*`` readings of ``segments`` segments from the kept
    carry, and the last triple per segment position under ``prog_last``;
    {} where the program has no tracer."""
    trace = _tracer()
    if trace is None:
        return {}
    import torch
    from torch.profiler import ProfilerActivity, profile

    from hmm_bench.run import _sync

    dev = cell.dev
    walls, last = [], {}

    def clock(c):
        ts = time.perf_counter()
        r = cell.hmm.step(c)
        _sync(dev)
        walls.append(time.perf_counter() - ts)
        return r

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    trace.reset()
    trace.enable()
    try:
        with profile(activities=acts) as prof:
            for _ in range(segments):
                for i, c, c2, out in cell.segment(clock):
                    last[i] = (c, c2, out)
    finally:
        trace.disable()
    counts = trace.counters()
    trace.reset()
    if chrome:
        prof.export_chrome_trace(chrome)
    step_iv = sorted((k.start_ns(), k.end_ns()) for k in prof.profiler.kineto_results.events()
                     if k.name() == "hmm.step" and k.is_user_annotation())
    window = (step_iv[0][0], step_iv[-1][1]) if step_iv else (0, 0)
    ctx = reduce_profile(prof, window)
    ctx.update(prog_steps=len(walls), prog_step_s=walls, prog_window_s=(window[1] - window[0])
               / 1e9, prog_counters=counts, prog_last=last)
    return ctx


def read(ctx: dict) -> dict:
    """{metric: value per macro-step or None} of a program window."""
    n = ctx.get("prog_steps")
    if not n:
        return {k: None for k in METRICS}
    cnt = ctx.get("prog_counters", {})

    def ms(key):
        return 1e3 * ctx[key] / n if key in ctx else None

    return {
        "fe_idle_ms": ms("prog_idle_fe_s"),
        "cluster_idle_ms": ms("prog_idle_cluster_s"),
        "md_idle_ms": ms("prog_idle_md_s"),
        "md_device_ms": ms("prog_md_device_s") if ctx.get("prog_md_device_s") else None,
        "host_syncs": cnt["host_syncs"] / n if "host_syncs" in cnt else None,
        "sync_wait_ms": ms("prog_sync_s"),
        "md_job_steps": cnt["md.job_steps"] / n if "md.job_steps" in cnt else None,
    }


METRICS = ("fe_idle_ms", "cluster_idle_ms", "md_idle_ms", "md_device_ms", "host_syncs",
           "sync_wait_ms", "md_job_steps")


def sync_debug_step(cell) -> dict:
    """One step from the kept carry under the card's sync debug mode with
    the tracer on: the synchronising calls the card reports (each with
    the Python line that made it), the tracer's host syncs and their
    sites.  The step's closing synchronisation is one of the calls."""
    import torch

    from hmm_bench.run import _sync

    trace = _tracer()
    trace.reset()
    trace.enable()
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            cell.hmm.step(cell.kept)
            _sync(cell.dev)
    finally:
        torch.cuda.set_sync_debug_mode(0)
        trace.disable()
    counts = trace.counters()
    trace.reset()
    calls = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message)]
    sites = {k: v for k, v in counts.items() if k.startswith("host_syncs")}
    return dict(reported=len(calls), calls=calls, host_syncs=counts.get("host_syncs", 0),
                sites=sites)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="hmm_bench.program_window")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--segments", type=int, default=TRACE_SEGMENTS)
    ap.add_argument("--chrome", default="", help="write the window's Chrome trace here")
    ap.add_argument("--sync-debug", action="store_true",
                    help="count the synchronising calls of one step under the card's "
                         "sync debug mode")
    args = ap.parse_args(argv)
    root = os.getcwd()
    bench = registry.benchmark(root)
    cell_e = registry.cell(bench, args.workload)
    conf = registry.config(root, bench, cell_e["config"])
    traffic = registry.traffic(cell_e["traffic"])

    import torch

    from hmm_bench import run as R

    if not torch.cuda.is_available() or int(traffic.get("ranks", 1)) > 1:
        print("error: the program window runs one-card cells on a CUDA device",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda", torch.cuda.current_device())
    cell, _, setup_s = R.setup_cell(conf, traffic, args.seed, dev)
    ctx = program_window(cell, args.segments, args.chrome)
    if not ctx:
        print("error: the program has no tracer", file=sys.stderr)
        return 3
    work = R.md_work(cell, ctx["prog_last"], args.segments)
    line = {"workload": args.workload, "seed": args.seed, "card": R._card_line(),
            "metrics": read(ctx), "steps": ctx["prog_steps"],
            "step_s_median": sorted(ctx["prog_step_s"])[len(ctx["prog_step_s"]) // 2],
            "window_s": ctx["prog_window_s"], "busy_s": ctx["prog_busy_s"],
            "idle_s": ctx["prog_idle_s"],
            "idle_outside_steps_s": ctx["prog_idle_outside_steps_s"],
            "md_work_job_steps_per_step": (work["strain_steps"] + work["sample_steps"])
            / ctx["prog_steps"], "setup_s": setup_s,
            "counters": ctx["prog_counters"]}
    if args.sync_debug:
        line["sync_debug"] = sync_debug_step(cell)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
