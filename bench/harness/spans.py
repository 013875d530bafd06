"""Device and idle time by the program's spans (``repro_torch.spans``), from
a profile with host and device activity taken while the spans were on.

Each kernel, copy and set is matched to the runtime call that launched it
through the correlation id, and put down to the innermost span open at that
call's start, on any thread: a kernel that autograd's thread launches
inside a checkpointed recompute goes to the recompute's ``moe.layer``, one
it launches for the backward alone to the main thread's ``model.backward``.
Everything from the first ``sparq.step`` on is counted; what no span holds
is put down to ``(outside spans)``. An idle gap of the device goes to the
innermost span open at its midpoint.

The record's keys: ``named_steps`` and ``named_syncs`` (the ``sparq.step``
and ``sparq.sync`` spans), ``counters`` (as handed in), ``span_device_s``
(device seconds by span name, ``self`` and ``inclusive``, and
``unlinked_s``: device time whose launch was not found; ``overlap_s``: the
activities' summed time less their union, near 0 on the one stream the
program uses (back-to-back activities' stamps overlap by a fraction of a
microsecond), so that more flags times the profiler got wrong) and the
breakdown's ``device_by_span`` (the top inclusive) and ``idle_by_span``.
"""
from __future__ import annotations

import bisect
import heapq
from collections import defaultdict
from typing import Any, Dict, List, Tuple

from torch.autograd import DeviceType

from harness.trace import (DEVICE_ACTIVITIES, STEP_SPAN, TOP, _kind,
                           _span_ns, _union)

OUTSIDE = "(outside spans)"
STEP, SYNC = "sparq.step", "sparq.sync"


def _annotation(e) -> bool:
    """Whether the event is a span, on the host or mirrored on the device's
    timeline (torch 2.11's events tell this, and no activity type)."""
    if hasattr(e, "activity_type"):
        return e.activity_type() in ("user_annotation", "gpu_user_annotation")
    return e.is_user_annotation()


def events(prof) -> Dict[str, Any]:
    """The profile as plain tuples: spans ``(name, start_ns, end_ns)`` (the
    harness's own step span left out), device activities ``(kind,
    start_ns, end_ns, correlation id)``, and the start of each CUDA API
    call on the host (``cu...``) by its correlation id, which the kernel,
    copy or set it launched shares."""
    spans, dev, launches = [], [], {}
    for e in prof.profiler.kineto_results.events():
        start, end = _span_ns(e)
        if _annotation(e):
            if e.device_type() != DeviceType.CUDA and e.name() != STEP_SPAN:
                spans.append((e.name(), start, end))
        elif e.device_type() == DeviceType.CUDA:
            kind = _kind(e)
            if kind in DEVICE_ACTIVITIES:
                dev.append((kind, start, end, e.correlation_id()))
        elif e.name().startswith("cu"):
            launches[e.correlation_id()] = start
    return {"spans": spans, "device": dev, "launches": launches}


class _Innermost:
    """The innermost open span at any time, from one sweep over the spans:
    of the spans open at ``t``, the one that began last, the shorter of two
    that began together (spans nest, on one thread and across autograd's).
    ``spans`` are sorted by start, the longer first."""

    def __init__(self, spans: List[Tuple[str, int, int]]) -> None:
        marks = sorted([(b, 0, i) for i, (_, _, b) in enumerate(spans)]
                       + [(a, 1, i) for i, (_, a, _) in enumerate(spans)])
        self.times: List[int] = []
        self.inner: List[int] = []
        self.parent = [-1] * len(spans)
        heap: List[Tuple[int, int]] = []
        closed = set()
        for t, opens, i in marks:
            if opens:
                self.parent[i] = self._top(heap, closed)
                heapq.heappush(heap, (-spans[i][1], -i))
            else:
                closed.add(i)
            self.times.append(t)
            self.inner.append(self._top(heap, closed))
        names = [name for name, _, _ in spans]
        self.chains: List[frozenset] = []
        for i in range(len(spans)):      # parents begin before children
            p = self.parent[i]
            self.chains.append(frozenset({names[i]}) | (
                self.chains[p] if p >= 0 else frozenset()))

    @staticmethod
    def _top(heap, closed) -> int:
        while heap and -heap[0][1] in closed:
            heapq.heappop(heap)
        return -heap[0][1] if heap else -1

    def at(self, t: int) -> int:
        """The innermost span open at ``t``, -1 for none."""
        k = bisect.bisect_right(self.times, t) - 1
        return self.inner[k] if k >= 0 else -1


def record(ev: Dict[str, Any], counters: Dict[str, float]
           ) -> Dict[str, Any]:
    """The record's span keys (see the module's docstring) from
    :func:`events`' tuples and the program's counters."""
    spans = sorted(ev["spans"], key=lambda s: (s[1], -s[2]))
    steps = [s for s in spans if s[0] == STEP]
    out: Dict[str, Any] = {
        "named_steps": len(steps),
        "named_syncs": sum(s[0] == SYNC for s in spans),
        "counters": dict(counters)}
    if not steps:
        return out
    lo = steps[0][1]
    tree = _Innermost(spans)
    self_s: Dict[str, float] = defaultdict(float)
    incl_s: Dict[str, float] = defaultdict(float)
    unlinked = 0.0
    busy = []
    for _, a, b, corr in ev["device"]:
        if a < lo:
            continue
        busy.append((a, b))
        sec = (b - a) / 1e9
        launch = ev["launches"].get(corr)
        i = -1 if launch is None else tree.at(launch)
        if launch is None:
            unlinked += sec
        if i < 0:
            self_s[OUTSIDE] += sec
            incl_s[OUTSIDE] += sec
            continue
        self_s[spans[i][0]] += sec
        for name in tree.chains[i]:
            incl_s[name] += sec
    merged = _union(busy)
    union_s = sum(b - a for a, b in merged) / 1e9
    out["span_device_s"] = {
        "self": dict(self_s), "inclusive": dict(incl_s),
        "unlinked_s": unlinked, "overlap_s": sum(self_s.values()) - union_s}
    out["device_by_span"] = _top(incl_s)
    out["idle_by_span"] = _top(_idle(tree, spans, merged, lo,
                                     max(s[2] for s in steps)))
    return out


def _idle(tree: _Innermost, spans, merged, lo: int, hi: int
          ) -> Dict[str, float]:
    """Idle seconds from ``lo`` to the later of ``hi`` and the last
    activity's end (``merged``: the union of the activities), by the span
    open at each gap's midpoint."""
    if not merged:
        return {}
    hi = max(hi, merged[-1][1])
    edges = [lo] + [x for ab in merged for x in ab] + [hi]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            i = tree.at((a + b) // 2)
            idle[spans[i][0] if i >= 0 else OUTSIDE] += (b - a) / 1e9
    return dict(idle)


def _top(by_name: Dict[str, float]) -> List[List[Any]]:
    return [[n, s] for n, s in sorted(by_name.items(),
                                      key=lambda kv: -kv[1])[:TOP]]


# what the readers of the span metrics share; each gives None where the
# record lacks what it reads (a run without the spans)

def per_step_ms(record, span, per):
    """Milliseconds of ``span``'s inclusive device time per ``record[per]``
    (``named_steps`` or ``named_syncs``)."""
    count = record.get(per)
    inclusive = (record.get("span_device_s") or {}).get("inclusive") or {}
    if not count or span not in inclusive:
        return None
    return 1e3 * inclusive[span] / count


def share_pct(record, part, whole):
    """100 x counter ``part`` / counter ``whole``."""
    counters = record.get("counters") or {}
    if not counters.get(whole) or part not in counters:
        return None
    return 100.0 * counters[part] / counters[whole]
