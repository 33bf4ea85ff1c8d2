"""Reduction of a ``torch.profiler`` trace to the traced run's numbers.

``device_busy_us`` is a frozen copy of ``scema_tpu_torch/profile_slice.
_device_busy_us`` at commit ce23eb3: the length of the union of the device
events' intervals.  The rest reads the same events: the device time inside
host intervals, the operations that took most device time, and the idle
gaps of the device with what the host was doing in each.
"""
from __future__ import annotations

import bisect
from collections import defaultdict


def device_busy_us(events) -> float:
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


def split_events(prof, annotations=()):
    """(device events, host events) of a finished profile; the device
    copies of the host's ``record_function`` ranges (named in
    ``annotations``) are neither."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        if e.device_type != cuda:
            host.append(e)
        elif e.name not in annotations and not getattr(e, "is_user_annotation", False):
            dev.append(e)
    return dev, host


def intervals(host_events, name: str) -> list:
    """(start, end) in us of the host events called ``name``."""
    return sorted((e.time_range.start, e.time_range.end) for e in host_events if e.name == name)


def device_us_within(dev_events, spans: list) -> float:
    """Device time (us) of the events that start inside one of ``spans``
    (host intervals bracketed by synchronisations, so every kernel launched
    inside one also runs inside it)."""
    total = 0.0
    for e in dev_events:
        s = e.time_range.start
        if any(a <= s <= b for a, b in spans):
            total += e.time_range.end - s
    return total


def top_device_ops(dev_events, k: int = 10) -> list:
    """[[name, seconds], ...] of the device operations that took most time."""
    by = defaultdict(float)
    for e in dev_events:
        by[e.name] += (e.time_range.end - e.time_range.start) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]


def idle_gaps(dev_events, host_events, window: tuple, k: int = 10) -> list:
    """[[host op, seconds], ...]: the device's idle time inside ``window``
    (us), by the innermost host operation under each gap's midpoint, the
    largest first."""
    w0, w1 = window
    busy = []
    for s, e in sorted((ev.time_range.start, ev.time_range.end) for ev in dev_events):
        if busy and s <= busy[-1][1]:
            busy[-1][1] = max(busy[-1][1], e)
        else:
            busy.append([s, e])
    gaps, cur = [], w0
    for s, e in busy:
        if s > cur:
            gaps.append((cur, min(s, w1)))
        cur = max(cur, e)
    if cur < w1:
        gaps.append((cur, w1))
    hosts = sorted((e.time_range.start, e.time_range.end, e.name) for e in host_events)
    starts = [h[0] for h in hosts]
    by = defaultdict(float)
    for a, b in gaps:
        if b <= a:
            continue
        mid = 0.5 * (a + b)
        name = "no host op"
        # the latest-starting host op that still runs at mid: the innermost
        for i in range(bisect.bisect_right(starts, mid) - 1, -1, -1):
            if hosts[i][1] >= mid:
                name = hosts[i][2]
                break
        by[name] += (b - a) / 1e6
    return [[n, s] for n, s in sorted(by.items(), key=lambda kv: -kv[1])[:k]]
