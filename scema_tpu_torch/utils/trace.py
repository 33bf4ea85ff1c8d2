"""The port's tracer: spans and counters at the coupled step's layer boundaries.

Off by default; :func:`enable` turns it on for the process and
:func:`disable` off again (no environment variable or config key does).
Off, :func:`span`, :func:`sync` and :func:`collective` return one shared
no-op context and :func:`count` / :func:`count_device` return at once: an
attribute check, no ``record_function``, no allocation, no
synchronisation.  On:

* ``span(name, args)`` enters a ``torch.profiler`` user annotation, so a
  span is an event of the same trace as the kernels, on the same clock,
  nested in the spans around it, and the kernels launched inside it are
  linked to it by the profiler's correlation ids; ``args`` (integers or
  floats) show in a profile taken with ``record_shapes=True``;
* ``sync(site)`` is the span ``sync.<site>`` around a point where the host
  waits for the device: a read of a device value (``int()``, ``bool()``,
  ``.item()`` of a CUDA tensor, ``torch.nonzero``, ...) or a blocking copy
  from the host (``torch.tensor(..., device=cuda)``), counted in
  ``host_syncs`` and ``host_syncs.<site>`` (also on the CPU, where
  nothing waits).  A K1 or K5 step has three, all reads:
  ``cluster.reduce`` (the first pick), ``md.job_list`` (the jobs'
  ``nonzero``) and ``md.n_valid`` (their count); the chunk loops add
  ``md.chunk_count`` and ``md.chunk_jobs``;
* ``collective(op, out)`` is the span ``coll.<op>`` around one collective
  of ``parallel/mesh_utils.py`` (``broadcast``, ``all_gather``,
  ``all_reduce``, ``reduce_scatter``), counted in ``collectives`` and
  ``collectives.<op>``, and the bytes of its output tensor on this rank
  (from its shape and item size, on the host) in ``collective_bytes`` and
  ``collective_bytes.<op>``; the NCCL kernel it launches is linked to the
  span by its correlation id, so :func:`span_table` gives its device time
  (the transfer and the wait for the slowest rank);
* ``count(name, n)`` adds a host integer; ``count_device(name, t)`` adds a
  device scalar into a device total without a sync, read once by
  :func:`counters`.

The spans of one MD-coupled macro-step (``hmm/md_coupling.MDHMMProblem.step``;
``hmm/problem.HMMProblem.step`` has the same FE and clustering spans and
one ``md.update`` around its update function)::

    hmm.step (args: the FE timestep)
      fe.begin  fe.solve  cluster  md.update ...  fe.stress_update  fe.reaction  fe.end
      cluster:   cluster.splines  cluster.distance (K2)  cluster.reduce
      md.update (one per backend, args: the material index)
        md.pack  md.bridge  md.run  md.average  md.scatter
        md.run:  md.strain  md.sample  (md.kspace, md.neighbors per chunk)

With the MD jobs spread over ranks (``MDBackend.device_mesh``) ``md.pack``
holds one ``coll.broadcast`` (rank 0's job inputs) and ``md.run`` five
``coll.all_gather`` (``pos``, ``vel``, ``h``, ``vxi``, the stresses).

Counters: ``md.jobs`` (valid job slots a step), ``md.job_steps`` (the
strained plus sampling MD steps of the active jobs, on the device),
``host_syncs``, ``collectives`` and ``collective_bytes``.  :func:`counters`
reports them with the ops' own launch counters (``md_run.launches*``,
``md_run_multi.launches_k1m``, ``md_forces_virial.launches*``, the SW
brick kernels', ``pairwise_l2``), which count whether the tracer is on or
not.

:func:`span_table` reduces a finished ``torch.profiler`` profile to each
span's host time, the device time of the kernels launched inside it, and
the device's idle time under it.
"""
from __future__ import annotations

import contextlib
from collections import defaultdict

import torch

_on = False
_NULL = contextlib.nullcontext()
_host: dict = {}
_device: dict = {}


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def reset() -> None:
    """Forget the tracer's counts (the ops' launch counters stay)."""
    _host.clear()
    _device.clear()


class _Span:
    __slots__ = ("name", "args", "handle")

    def __init__(self, name: str, args: tuple):
        self.name, self.args = name, args

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(self.name, *self.args)
        return self

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


def span(name: str, args=None):
    """The profiler range ``name`` (``args``: a number or a tuple of them)
    while tracing is on; a shared no-op context otherwise."""
    if not _on:
        return _NULL
    return _Span(name, () if args is None else args if isinstance(args, tuple) else (args,))


def sync(site: str):
    """The span ``sync.<site>`` around a point where the host waits for the
    device, counted in ``host_syncs`` and ``host_syncs.<site>``."""
    if not _on:
        return _NULL
    _host["host_syncs"] = _host.get("host_syncs", 0) + 1
    key = f"host_syncs.{site}"
    _host[key] = _host.get(key, 0) + 1
    return _Span(f"sync.{site}", ())


def collective(op: str, out: torch.Tensor):
    """The span ``coll.<op>`` around a collective whose output on this rank
    is ``out``, counted in ``collectives``, ``collectives.<op>``,
    ``collective_bytes`` and ``collective_bytes.<op>``."""
    if not _on:
        return _NULL
    nbytes = out.numel() * out.element_size()
    for key, n in (("collectives", 1), (f"collectives.{op}", 1),
                   ("collective_bytes", nbytes), (f"collective_bytes.{op}", nbytes)):
        _host[key] = _host.get(key, 0) + n
    return _Span(f"coll.{op}", ())


def count(name: str, n: int) -> None:
    """Add the host integer ``n`` to the counter ``name``."""
    if _on:
        _host[name] = _host.get(name, 0) + int(n)


def count_device(name: str, t: torch.Tensor) -> None:
    """Add the device scalar ``t`` to the counter ``name`` without a sync."""
    if not _on:
        return
    t = t.detach().to(torch.int64)
    acc = _device.get(name)
    _device[name] = t.clone() if acc is None else acc.add_(t)


def launch_counters() -> dict:
    """The ops' launch counters, by name (``md_run.launches`` ...)."""
    from ..ops import md_fused as MF
    from ..ops import pairwise_l2 as PL
    from ..ops import sw_bricks as SWB

    out = {}
    for owner, fn in (("md_run", MF.md_run), ("md_run_multi", MF.md_run_multi),
                      ("md_forces_virial", MF.md_forces_virial),
                      ("sw_moments_bricks", SWB.sw_moments_bricks),
                      ("sw_forces_bricks", SWB.sw_forces_bricks),
                      ("pairwise_l2", PL.pairwise_l2)):
        for k, v in vars(fn).items():
            if k.startswith("launches"):
                out[f"{owner}.{k}"] = int(v)
    return out


def counters() -> dict:
    """The launch counters and the tracer's counts since :func:`reset`
    (the device totals read here, once)."""
    out = launch_counters()
    out.update(_host)
    for k, v in _device.items():
        out[k] = out.get(k, 0) + int(v)
    return out


# -- a finished profile, by span


def _merge(iv: list) -> list:
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _covered(busy: list, a: float, b: float) -> float:
    return sum(max(0.0, min(e, b) - max(s, a)) for s, e in busy)


def span_table(prof, prefix: str = "") -> dict:
    """{span name: {"calls", "host_ms", "device_ms", "stream_ms",
    "idle_ms"}} of the spans named ``prefix``... in a finished
    ``torch.profiler`` profile: the host time of its calls, the device time
    of the kernels (and copies) launched inside them (each device event
    linked to the CUDA call that launched it by the profiler's correlation
    id), from the first such kernel's start to the last one's end per call,
    and the time under the calls in which no kernel ran."""
    cuda = torch.autograd.DeviceType.CUDA
    events = prof.profiler.kineto_results.events()
    spans, launch, dev = defaultdict(list), {}, []
    for k in events:
        if k.device_type() == cuda:
            if not k.is_user_annotation():
                dev.append(k)
        elif k.is_user_annotation():
            spans[k.name()].append((k.start_ns(), k.end_ns()))
        elif k.name().startswith("cu"):  # a CUDA runtime or driver call
            launch[k.correlation_id()] = k.start_ns()
    dev = [k for k in dev if k.name() not in spans]  # the spans' copies on the device
    busy = _merge([[k.start_ns(), k.end_ns()] for k in dev])
    # each device event and the host call that launched it share a
    # correlation id (the trace's flow events)
    launched = [(launch.get(k.correlation_id()), k.start_ns(), k.end_ns()) for k in dev]
    out = {}
    for name, iv in spans.items():
        if not name.startswith(prefix):
            continue
        host = sum(b - a for a, b in iv)
        d_ns = stream = 0
        for a, b in iv:
            mine = [(s, e) for t, s, e in launched if t is not None and a <= t <= b]
            d_ns += sum(e - s for s, e in mine)
            if mine:
                stream += max(e for _, e in mine) - min(s for s, _ in mine)
        idle = sum((b - a) - _covered(busy, a, b) for a, b in _merge(list(iv)))
        out[name] = dict(calls=len(iv), host_ms=host / 1e6, device_ms=d_ns / 1e6,
                         stream_ms=stream / 1e6, idle_ms=idle / 1e6)
    return out
