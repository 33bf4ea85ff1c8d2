"""Steady-state timing and device-time breakdown of the port's main path.

    python -m scema_tpu_torch.profile_slice [--steps 8] [--repeats 10] [--trace out.json]
    python -m scema_tpu_torch.profile_slice --charged [--steps 3] [--repeats 3]
    python -m scema_tpu_torch.profile_slice --charged --staged [--steps 3] [--repeats 3]
    python -m scema_tpu_torch.profile_slice --bigbox [--steps 3] [--repeats 3]
    python -m scema_tpu_torch.profile_slice --sw [--steps 8] [--repeats 10]
    python -m scema_tpu_torch.profile_slice --sw-bricks [--steps 8] [--repeats 10]
    python -m scema_tpu_torch.profile_slice --sw-list [--steps 2] [--repeats 2]

Builds the MD-coupled ``HMMConfig()`` dogbone on one CUDA card exactly as
``cli run <{}> --quick-prep`` does (FE and MD in float32, g0 boxes) — or,
with ``--charged``, the charged slice (the 1792-atom all-atom PE material
``material.PEAA`` at every flagged qp, at most 128 MD jobs per step,
``equil_steps=50``, ``minimize_steps=100``) or, with ``--bigbox``, the same
with the 2240-atom box ``material.PEAA2240`` on the gather-list kernel K4,
or, with ``--sw``, the config with ``"force field": "sw"`` (the 216-atom
diamond-Si Stillinger-Weber box on K5 at every flagged qp, 576 jobs) or,
with ``--sw-bricks`` / ``--sw-list``, the SW box above K5's gate (8^3
cells, 4096 atoms, at most 128 MD jobs per step) on the unfused engine with
the brick kernels K6c/K6d or on the list route (autograd of ``SW.energy``)
— times the setup (with ``--staged`` the reference's heatup/cooldown NPT
prep, ``equilibrate_staged`` at ns_init 100, in place of the quick prep;
then 20 MTK NPT steps from the prepared replica run once more under
``torch.profiler`` and the script prints their time per step, launches and
idle share), then
the first ``--steps`` macro-steps (all 576 qps are flagged from step 4 on),
then repeats the next step ``--repeats`` times from one fixed carry, so every
repeat runs the same jobs with the same strains.  One more repeat runs under
``torch.profiler``: the script prints the kernels by device time, the share
of the step's wall time in which the device was idle, and the peak device
memory.  On the charged slices the k-space remainder and (K4) the neighbor
list rebuilds are timed by CUDA events around each call, and on the SW
list route the list rebuilds, so the profiled step's device time splits
into the MD kernels, the rebuilds, PME and the rest.  The last line is one JSON object with these numbers.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
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


def _profile_npt(hmm, dev, n_steps: int = 20) -> dict:
    """The staged prep's NPT loop, profiled: ``n_steps`` MTK steps at the
    MD temperature from the first prepared replica, once untimed, then
    under ``torch.profiler``; prints and returns the time per step, the
    device launches per step and the idle share."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from .md import engine as E

    be = hmm.backend
    st = E.MDState(*(getattr(be.initial_md_state, f)[0] for f in ("pos", "vel", "h", "vxi")))
    T, dt = be.params.temperature, be.params.dt
    E.run_npt(be.sys, st, n_steps, T, T, dt)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        E.run_npt(be.sys, st, n_steps, T, T, dt)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda]
    busy = _device_busy_us(events)
    out = {"steps": n_steps, "s_per_step": wall / n_steps,
           "launches_per_step": len(events) / n_steps,
           "device_ms_per_step": busy / 1e3 / n_steps, "idle_share": 1.0 - busy / (wall * 1e6)}
    print(f"NPT loop ({n_steps} MTK steps at {T} K from the prepared replica, profiled): "
          f"{out['s_per_step'] * 1e3:.3f} ms per step, {out['launches_per_step']:.1f} device "
          f"launches per step, device busy {out['device_ms_per_step']:.3f} ms per step, "
          f"idle share {out['idle_share']:.4f}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="scema_tpu_torch.profile_slice")
    ap.add_argument("--steps", type=int, default=8, help="macro-steps before the repeats")
    ap.add_argument("--repeats", type=int, default=10, help="repeats of the next step")
    ap.add_argument("--trace", default="", help="write the profiled step's Chrome trace here")
    ap.add_argument("--charged", action="store_true",
                    help="the charged all-atom PE slice (K3, PME) instead of the g0 slice")
    ap.add_argument("--bigbox", action="store_true",
                    help="the charged 2240-atom slice on the list kernel (K4, PME)")
    ap.add_argument("--sw", action="store_true",
                    help="the Stillinger-Weber silicon slice (K5) instead of the g0 slice")
    ap.add_argument("--sw-bricks", action="store_true",
                    help="the 4096-atom SW slice on the brick kernels (K6c/K6d)")
    ap.add_argument("--sw-list", action="store_true",
                    help="the 4096-atom SW slice on the list route (autograd SW.energy)")
    ap.add_argument("--staged", action="store_true",
                    help="the staged heatup/cooldown NPT prep (ns_init 100) in place of "
                         "the quick prep, and a profile of its NPT loop")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from .config import HMMConfig
    from .hmm.md_coupling import build_md_hmm
    from .utils.device import card_line

    if not torch.cuda.is_available():
        print("error: no CUDA device available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", torch.cuda.current_device())
    card = card_line(dev)
    print(card)

    cfg = HMMConfig().replace(dtype="float32")
    t0 = time.perf_counter()
    if args.charged or args.bigbox or args.sw_bricks or args.sw_list:
        from .md.material import PEAA, PEAA2240, MaterialSpec

        cfg = cfg.replace(md_dtype="float32", resources=dataclasses.replace(
            cfg.resources, max_md_jobs=128))
        if args.sw_bricks or args.sw_list:
            hmm = build_md_hmm(cfg, spec=MaterialSpec(name="si", n_cells=8,
                                                      use_pallas_bricks=args.sw_bricks),
                               staged=args.staged, device=dev)
        else:
            hmm = build_md_hmm(cfg, spec=PEAA2240 if args.bigbox else PEAA, equil_steps=50,
                               minimize_steps=100, staged=args.staged, device=dev)
    else:
        if args.sw:
            cfg = cfg.replace(md=dataclasses.replace(cfg.md, force_field="sw"))
        hmm = build_md_hmm(cfg, staged=args.staged, device=dev)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    prep = "staged NPT prep" if args.staged else "quick prep"
    print(f"setup {setup_s:.3f}s (mesh + {prep}, kernel build included if not cached)")
    npt = _profile_npt(hmm, dev) if args.staged else None
    # CUDA events around the k-space remainder and the list rebuilds (the
    # fused runner's, or the unfused engine's build_neighbors)
    sys_ = hmm.backend.sys
    runner = sys_.fused if sys_.fused is not None else sys_
    spans = {"PME remainder": [], "neighbor build": []}
    hooks = ((("PME remainder", "kspace"), ("neighbor build", "channels"))
             if sys_.fused is not None else (("neighbor build", "build_neighbors"),))
    for key, name in hooks:
        fn = getattr(runner, name)
        if (name == "kspace" and fn is None or name == "channels" and not runner.spec.k
                or name == "build_neighbors" and hasattr(sys_.ff, "slot_ids")):
            continue

        def timed(*a, _fn=fn, _key=key, **kw):
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            with record_function(_key):
                res = _fn(*a, **kw)
            ev[1].record()
            spans[_key].append(ev)
            return res

        object.__setattr__(runner, name, timed)

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

    for m in spans.values():
        m.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, out, w = timed_step(carry)
    span_ms = {k: sum(a.elapsed_time(b) for a, b in m) for k, m in spans.items()}
    if args.trace:
        prof.export_chrome_trace(args.trace)
    ka = prof.key_averages()
    # device time from the device events themselves (the operators'
    # self device time in key_averages counts each kernel twice)
    cuda = torch.autograd.DeviceType.CUDA
    events = [e for e in prof.events() if e.device_type == cuda and e.name not in spans]
    dur = [(e.name, e.time_range.end - e.time_range.start) for e in events]
    dev_total = sum(d for _, d in dur)
    print(f"profiled step: wall {w:.4f}s  device time {dev_total / 1e3:.3f} ms")
    for e in sorted(ka, key=lambda e: -_self_device_us(e))[:12]:
        t = _self_device_us(e)
        if t > 0:
            print(f"  {t / 1e3:10.3f} ms  {100 * t / dev_total:5.1f}%  n={e.count:5d}  {e.key[:80]}")
    md = "md kernels (K1/K3/K4/K5/K6)"
    groups = {md: 0.0, "pairwise_l2 (K2)": 0.0, "everything else": 0.0}
    for name, d in dur:
        key = (md if any(k in name for k in ("md_run_kernel", "md_forces_kernel", "k1_run_kernel",
                                              "k1_forces_kernel", "k1_virial_kernel",
                                              "k34_run_kernel", "k34_forces_kernel",
                                              "k34_virial_kernel", "k1m_run_kernel",
                                              "k5_run_kernel", "k5_moments_kernel",
                                              "k5_forces_kernel", "k5_virial_kernel",
                                              "sw_moments_warp_kernel", "sw_spheres_kernel",
                                              "sw_forces_list_kernel"))
               else "pairwise_l2 (K2)" if "pairwise_l2" in name else "everything else")
        groups[key] += d / 1e3
    print("device time by group (ms): " + ", ".join(f"{k} {v:.3f}" for k, v in groups.items()))
    # the device time of the kernels launched inside each timed span
    span_dev = {k: 0.0 for k in spans}
    for e in prof.events():
        if e.device_type != cuda and e.name in spans:
            span_dev[e.name] += (e.device_time_total if hasattr(e, "device_time_total")
                                 else e.cuda_time_total) / 1e3
    if span_ms and any(span_ms.values()):
        rest = groups["everything else"] - sum(span_dev.values())
        print("profiled step, device time (ms): " + ", ".join(
            [f"md kernels {groups[md]:.3f}"]
            + [f"{k} {span_dev.get(k, 0.0):.3f} (stream span {v:.3f} by CUDA events)"
               for k, v in span_ms.items() if v]
            + [f"K2 {groups['pairwise_l2 (K2)']:.3f}", f"rest {rest:.3f}"]))
    busy = _device_busy_us(events)
    idle = 1.0 - busy / (w * 1e6)
    peak = torch.cuda.max_memory_allocated(dev) / 2**20
    print(f"device busy {busy / 1e3:.3f} ms of {w * 1e3:.3f} ms: idle share {idle:.4f}; "
          f"{len(events)} device events; peak memory {peak:.1f} MiB")
    print(json.dumps({"card": card, "setup_s": setup_s, "step_s": walls, "md_jobs": jobs,
                      "repeat_s": rep, "repeat_md_jobs": rep_jobs, "profiled_step_s": w,
                      "device_ms": dev_total / 1e3, "device_ms_by_group": groups,
                      "span_ms": span_ms, "span_device_ms": span_dev, "idle_share": idle,
                      "peak_mem_mib": peak, "staged": args.staged, "npt_loop": npt}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
