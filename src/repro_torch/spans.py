"""Spans and counters at the layer boundaries of the train step.

Tracing is off by default. Off, :func:`span` hands back one shared
``nullcontext`` after a single module-level check, and :func:`count` and
:func:`counting` do nothing: no allocation, no profiler call, no kernel.
On (inside :func:`enabled`), each span is a
``torch.profiler.record_function``:

* under ``torch.profiler.profile(activities=[CPU, CUDA])`` every span lands
  in the kineto trace on the clock of the device's kernels, copies and
  sets, and a kernel is traced back to the span that launched it through
  its launch's correlation id;
* under ``torch.autograd.profiler.emit_nvtx()`` every span is an NVTX range.

Kineto keeps no argument of a span, so the steps of a trace are told
apart by the order of their ``sparq.step`` spans.

Counters are summed in memory, on the device where a count is a tensor:
nothing is read back to the host inside a step. :func:`counters`
synchronizes once and returns them as floats.

The spans, their parents by nesting (``/``), and the counters::

    sparq.step                        one train_step (dist/sparq_dist.py)
    sparq.step/sparq.fwd_bwd          the gradient buffer and every node's
                                      forward and backward
      .../model.forward               lm_loss of one node and microbatch
      .../model.backward              its backward, recompute included
      .../moe.layer                   a MoE layer (forward or recompute)
      .../moe.layer/moe.route         its routing
    sparq.step/sparq.local_step       the optimizer's in-place update
    sparq.step/sparq.sync             a sync, in four parts:
      sparq.sync.diff                 diff, trigger norms, mask, on_sync
      sparq.sync.compress             the compressor over the rank's rows
      sparq.sync.mix                  the x_hat update and the mixing
      sparq.sync.mix/comm.fetch       the rows a mesh's rank fetches for a
                                      shift or dense plan
      .../comm.fetch/comm.fetch.wait  the launch of its sends and receives
                                      and the waits on them: the transfer
      sparq.sync.bits                 bits, rounds and triggers

    moe.choices, moe.dropped          routed choices (T k) and those past
                                      their expert's capacity, forward only
    moe.routed_kernel                 of them, those the routing kernel
                                      placed (kernels/moe_route.py: all on
                                      the card, none on the CPU)
    sparq.rows_compressed             rows the sync compressed
    sparq.rows_sent                   of them, the triggered rows
    sparq.rows_mixed_kernel           rows the sync mixed in one pass
                                      (kernels/xhat_mix.py: one rank)
    comm.fetch_bytes                  bytes a mesh's rank posts to send plus
                                      those it receives in the row
                                      exchanges (dist/comm.py; none on one
                                      rank)
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, Union

import torch

Count = Union[int, torch.Tensor]

_on = False
_off = contextlib.nullcontext()
_counts: Dict[str, Count] = {}


def span(name: str):
    """A context manager that marks ``name`` while tracing is on."""
    if not _on:
        return _off
    return torch.profiler.record_function(name)


def counting() -> bool:
    """Whether a count taken here is kept: tracing is on and the caller is
    not inside a backward pass, where a checkpointed forward runs again."""
    return _on and torch._C._current_graph_task_id() == -1


def count(name: str, value: Count) -> None:
    """Add ``value`` (an int or a 0-d tensor, left on its device) to the
    counter ``name`` while tracing is on."""
    if _on:
        _counts[name] = _counts.get(name, 0) + value


@contextlib.contextmanager
def enabled(on: bool = True) -> Iterator[None]:
    """Tracing on (or off) inside the block. The counters start empty and
    hold the block's counts after it."""
    global _on
    was = _on
    _on = on
    _counts.clear()
    try:
        yield
    finally:
        _on = was


def counters() -> Dict[str, float]:
    """The counters as floats, read back with one synchronization a
    device."""
    out = {k: float(v) for k, v in _counts.items()
           if not isinstance(v, torch.Tensor)}
    by_device: Dict[torch.device, list] = {}
    for k, v in _counts.items():
        if isinstance(v, torch.Tensor):
            by_device.setdefault(v.device, []).append((k, v))
    for items in by_device.values():
        values = torch.stack([v.to(torch.float64) for _, v in items])
        out.update(zip([k for k, _ in items], values.tolist()))
    return out
