"""Steady-state timing and device-time breakdown of the port's main path.

    python -m scema_tpu_torch.profile_slice [--steps 8] [--repeats 10] [--trace out.json]
    python -m scema_tpu_torch.profile_slice --charged [--steps 3] [--repeats 3]

Builds the MD-coupled ``HMMConfig()`` dogbone on one CUDA card exactly as
``cli run <{}> --quick-prep`` does (FE and MD in float32, g0 boxes) — or,
with ``--charged``, the charged slice (the 1792-atom all-atom PE material
``material.PEAA`` at every flagged qp, at most 128 MD jobs per step,
``equil_steps=50``, ``minimize_steps=100``) — times
the first ``--steps`` macro-steps (all 576 qps are flagged from step 4 on),
then repeats the next step ``--repeats`` times from one fixed carry, so every
repeat runs the same jobs with the same strains.  One more repeat runs under
``torch.profiler``: the script prints the kernels by device time, the share
of the step's wall time in which the device was idle, and the peak device
memory.  The last line is one JSON object with these numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time


def _device_busy_us(events) -> float:
    """Length of the union of the device events' time intervals (us)."""
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in events):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    return busy


def _self_device_us(e) -> float:
    return getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scema_tpu_torch.profile_slice")
    ap.add_argument("--steps", type=int, default=8, help="macro-steps before the repeats")
    ap.add_argument("--repeats", type=int, default=10, help="repeats of the next step")
    ap.add_argument("--trace", default="", help="write the profiled step's Chrome trace here")
    ap.add_argument("--charged", action="store_true",
                    help="the charged all-atom PE slice (K3, PME) instead of the g0 slice")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    from .config import HMMConfig
    from .hmm.md_coupling import build_md_hmm

    if not torch.cuda.is_available():
        print("error: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip()
    print(card)

    cfg = HMMConfig().replace(dtype="float32")
    t0 = time.perf_counter()
    if args.charged:
        from .md.material import PEAA

        cfg = cfg.replace(md_dtype="float32", resources=dataclasses.replace(
            cfg.resources, max_md_jobs=128))
        hmm = build_md_hmm(cfg, spec=PEAA, equil_steps=50, minimize_steps=100, device=dev)
    else:
        hmm = build_md_hmm(cfg, staged=False, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    print(f"setup {setup_s:.3f}s (mesh + quick prep, kernel build included if not cached)")

    def timed_step(carry):
        t = time.perf_counter()
        carry, out = hmm.step(carry)
        torch.cuda.synchronize()
        return carry, out, time.perf_counter() - t

    carry = hmm.init_state()
    walls, jobs = [], []
    for k in range(args.steps):
        carry, out, w = timed_step(carry)
        walls.append(w)
        jobs.append(int(out.n_jobs))
        print(f"step {k + 1}: {w:.4f}s  md jobs {jobs[-1]}")

    rep = []
    for _ in range(args.repeats):
        _, out, w = timed_step(carry)
        rep.append(w)
    rep_jobs = int(out.n_jobs)
    print(f"step {args.steps + 1} x {args.repeats} from one carry ({rep_jobs} md jobs): "
          f"min {min(rep):.4f}s  median {statistics.median(rep):.4f}s  max {max(rep):.4f}s")

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, out, w = timed_step(carry)
    if args.trace:
        prof.export_chrome_trace(args.trace)
    ka = prof.key_averages()
    dev_total = sum(_self_device_us(e) for e in ka)
    print(f"profiled step: wall {w:.4f}s  device time {dev_total / 1e3:.3f} ms")
    for e in sorted(ka, key=lambda e: -_self_device_us(e))[:12]:
        t = _self_device_us(e)
        if t > 0:
            print(f"  {t / 1e3:10.3f} ms  {100 * t / dev_total:5.1f}%  n={e.count:5d}  {e.key[:80]}")
    groups = {"md kernels (K1/K3)": 0.0, "pairwise_l2 (K2)": 0.0, "everything else": 0.0}
    for e in ka:
        key = ("md kernels (K1/K3)" if "md_run_kernel" in e.key or "md_forces_kernel" in e.key
               else "pairwise_l2 (K2)" if "pairwise_l2" in e.key else "everything else")
        groups[key] += _self_device_us(e) / 1e3
    print("device time by group (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in groups.items()))
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = _device_busy_us(events)
    idle = 1.0 - busy / (w * 1e6)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"device busy {busy / 1e3:.3f} ms of {w * 1e3:.3f} ms: idle share {idle:.4f}; "
          f"{len(events)} device events; peak memory {peak:.1f} MiB")
    print(json.dumps({"card": card, "setup_s": setup_s, "step_s": walls, "md_jobs": jobs,
                      "repeat_s": rep, "repeat_md_jobs": rep_jobs, "profiled_step_s": w,
                      "device_ms": dev_total / 1e3, "device_ms_by_group": groups,
                      "idle_share": idle,
                      "peak_mem_mib": peak}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
