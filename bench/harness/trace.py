"""The device trace of the profiled steps, reduced to what the per-layer
readers and the breakdown read: the device's activities (kernels, copies,
sets) with their times, the union of their intervals, the host operation
that ran in each idle gap, and the profiled window itself.

The trace stays in memory; nothing is written to disk.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Any, Dict, List, Tuple

from torch.autograd import DeviceType

STEP_SPAN = "bench.step"
DEVICE_ACTIVITIES = ("kernel", "gpu_memcpy", "gpu_memset")
GAPS_NAMED = 5000          # the longest idle gaps that get a host name
TOP = 10


def _kind(e) -> str:
    """The event's activity: kineto's name where the event tells it, else
    worked out from its device and name."""
    if hasattr(e, "activity_type"):
        return e.activity_type()
    name = e.name()
    if e.device_type() == DeviceType.CUDA:
        if name == STEP_SPAN:
            return "gpu_user_annotation"
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "user_annotation" if name == STEP_SPAN else "cpu_op"


def _span_ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = int(e.start_us() * 1000)
    return start, start + int(e.duration_us() * 1000)


def events(prof) -> Dict[str, Any]:
    """The profiler's events as plain tuples: device activities
    ``(name, kind, start_ns, end_ns)``, host operations ``(start_ns,
    end_ns, name)`` sorted by start, and the steps' spans."""
    dev, host, steps = [], [], []
    for e in prof.profiler.kineto_results.events():
        kind = _kind(e)
        start, end = _span_ns(e)
        if kind in DEVICE_ACTIVITIES:
            dev.append((e.name(), kind, start, end))
        elif kind == "user_annotation" and e.name() == STEP_SPAN:
            steps.append((start, end))
        elif kind in ("cpu_op", "cuda_runtime", "cuda_driver"):
            host.append((start, end, e.name()))
    host.sort()
    steps.sort()
    return {"device": dev, "host": host, "steps": steps}


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[Tuple[int, int]] = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return merged


def _host_name(host: List[Tuple[int, int, str]], starts: List[int],
               t: int) -> str:
    """The innermost host operation running at ``t``, or what ran last."""
    i = bisect.bisect_right(starts, t) - 1
    last = None
    for j in range(i, max(-1, i - 400), -1):
        a, b, name = host[j]
        if b >= t:
            return name
        if last is None:
            last = name
    return f"after {last}" if last else "no host operation"


def device(ev: Dict[str, Any], window_s: float) -> Dict[str, Any]:
    """Over a profiled window of ``window_s`` host seconds: the union of
    the device's activities (busy seconds), kernel launches with their
    times, and the device operations that took most time."""
    dev = ev["device"]
    busy = _union([(a, b) for _, _, a, b in dev])
    by_name: Dict[str, float] = defaultdict(float)
    kernels: List[Tuple[str, int]] = []
    for name, kind, a, b in dev:
        by_name[name] += (b - a) / 1e9
        if kind == "kernel":
            kernels.append((name, b - a))
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {"busy_s": sum(b - a for a, b in busy) / 1e9,
            "window_s": window_s, "kernels": kernels,
            "device_ops": [[n, s] for n, s in top]}


def idle_gaps(ev: Dict[str, Any]) -> List[List[Any]]:
    """The device's idle time between the first step's start and the last
    activity's end, summed by the host operation that ran in the middle of
    each gap (the longest ``GAPS_NAMED`` gaps), most first."""
    if not ev["steps"] or not ev["device"]:
        return []
    lo = ev["steps"][0][0]
    busy = _union([(max(a, lo), b) for _, _, a, b in ev["device"] if b > lo])
    hi = max(ev["steps"][-1][1], busy[-1][1])
    gaps = [(lo, busy[0][0])] + [(b0, a1) for (_, b0), (a1, _)
                                 in zip(busy, busy[1:])] + [(busy[-1][1], hi)]
    gaps = sorted((g for g in gaps if g[1] > g[0]),
                  key=lambda g: g[0] - g[1])[:GAPS_NAMED]
    starts = [h[0] for h in ev["host"]]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        idle[_host_name(ev["host"], starts, (a + b) // 2)] += (b - a) / 1e9
    return [[n, s] for n, s in sorted(idle.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
