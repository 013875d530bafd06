"""Experiment engine: run a step function for T steps and record a trace
(counterpart of ``repro/core/engine.py``).

Every experiment of the reference engine is "run step_fn for T steps,
record (t, bits, loss, sync_rounds, triggers) every ``record_every`` steps".
The reference puts the trajectory into one XLA program, a chunked
``lax.scan``; here it is a Python loop over eager PyTorch steps that keeps
the reference's key sequence, ``key, sub = split(key)`` per step, so both
engines draw the same minibatches and noise. The recorded values stay on
the state's device until the run ends and are copied to the host once.

``step_fn(state, key) -> state`` may be any function over a NamedTuple state
that carries ``.t`` and ``.bits``; ``sync_rounds`` and ``triggers`` are
recorded when present and 0 otherwise (the vanilla and centralized baselines
do not track them).

Not ported: the reference ``Runner``'s XLA audit hooks (``lower``,
``compiled``, ``trace_count``, ``donate``) and ``compiled_memory_stats``;
eager PyTorch has no lowered program to audit. ``timed_run`` reports the
card's peak allocation instead.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng


class Trace:
    """Columnar (t, bits, loss, sync_rounds, triggers) records.

    Behaves like a list of ``(t, bits, loss, sync_rounds, triggers)`` tuples
    of Python scalars (``len``, indexing, iteration) and keeps the columns
    as numpy arrays for ``to_dict``."""

    __slots__ = ("t", "bits", "loss", "sync_rounds", "triggers")

    def __init__(self, t: Any, bits: Any, loss: Any, sync_rounds: Any,
                 triggers: Any) -> None:
        self.t = np.asarray(t, np.int64)
        self.bits = np.asarray(bits, np.float64)
        self.loss = np.asarray(loss, np.float64)
        self.sync_rounds = np.asarray(sync_rounds, np.int64)
        self.triggers = np.asarray(triggers, np.int64)

    @classmethod
    def empty(cls) -> "Trace":
        z = np.zeros((0,))
        return cls(z, z, z, z, z)

    def __len__(self) -> int:
        return int(self.t.shape[0])

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        return (int(self.t[i]), float(self.bits[i]), float(self.loss[i]),
                int(self.sync_rounds[i]), int(self.triggers[i]))

    def __iter__(self):
        return (self[i] for i in range(len(self)))

    def to_dict(self) -> dict:
        """JSON-able columns."""
        return {"t": self.t.tolist(), "bits": self.bits.tolist(),
                "loss": self.loss.tolist(),
                "sync_rounds": self.sync_rounds.tolist(),
                "triggers": self.triggers.tolist()}


def _default_x_of(state: Any) -> torch.Tensor:
    return state.x


def mean_model(x: torch.Tensor) -> torch.Tensor:
    """x_bar for eval: node mean of an (n, d) ensemble, identity for (d,)."""
    return torch.mean(x, dim=0) if x.dim() == 2 else x


class Runner:
    """Callable ``(state, key) -> (final_state, Trace)`` for a fixed T."""

    __slots__ = ("step_fn", "T", "rec", "eval_fn", "x_of")

    def __init__(self, step_fn: Callable[[Any, torch.Tensor], Any], T: int,
                 rec: int, eval_fn: Optional[Callable], x_of: Callable
                 ) -> None:
        self.step_fn, self.T, self.rec = step_fn, T, rec
        self.eval_fn, self.x_of = eval_fn, x_of

    def __call__(self, state: Any, key: torch.Tensor) -> Tuple[Any, Trace]:
        rows = []
        for i in range(self.T):
            key, sub = prng.split(key)
            state = self.step_fn(state, sub)
            if self.rec and (i + 1) % self.rec == 0:
                rows.append(self._record(state))
        if not rows:
            return state, Trace.empty()
        t, sync_rounds, bits, loss, triggers = zip(*rows)
        # one device-to-host copy of every recorded tensor at the end
        return state, Trace(t, torch.stack(bits).double().cpu(),
                            torch.stack(loss).cpu(), sync_rounds,
                            torch.stack(triggers).cpu())

    def _record(self, state: Any) -> tuple:
        x = self.x_of(state)
        loss = torch.as_tensor(self.eval_fn(mean_model(x)),
                               dtype=torch.float32)
        triggers = getattr(state, "triggers", None)
        if triggers is None:
            triggers = torch.zeros((), dtype=torch.int64, device=x.device)
        return (int(state.t), int(getattr(state, "sync_rounds", 0)),
                state.bits.detach().clone(), loss.detach(),
                torch.as_tensor(triggers, dtype=torch.int64).clone())


def make_runner(step_fn: Callable[[Any, torch.Tensor], Any], T: int, *,
                record_every: int = 0,
                eval_fn: Optional[Callable[[torch.Tensor],
                                           torch.Tensor]] = None,
                x_of: Callable[[Any], torch.Tensor] = _default_x_of
                ) -> Runner:
    """``runner(state, key) -> (final_state, Trace)``: T steps, recording
    every ``record_every`` steps when ``eval_fn`` is given."""
    rec = int(record_every) if (record_every and eval_fn is not None) else 0
    return Runner(step_fn, int(T), rec, eval_fn, x_of)


def run_traced(step_fn: Callable[[Any, torch.Tensor], Any], state: Any,
               T: int, key: torch.Tensor, record_every: int = 0,
               eval_fn: Optional[Callable[[torch.Tensor],
                                          torch.Tensor]] = None,
               x_of: Callable[[Any], torch.Tensor] = _default_x_of
               ) -> Tuple[Any, Trace]:
    """One-shot :func:`make_runner`. The trace is empty unless both
    ``record_every > 0`` and ``eval_fn`` are given."""
    return make_runner(step_fn, T, record_every=record_every,
                       eval_fn=eval_fn, x_of=x_of)(state, key)


def timed_run(runner: Runner, make_state: Callable[[], Any],
              key: torch.Tensor, T: int
              ) -> Tuple[Any, Trace, float, Optional[dict]]:
    """Warm up with one whole run, then time a second one from a fresh state.

    Returns ``(final_state, trace, us_per_call, memory)``: ``us_per_call`` is
    the wall time per step, ended by ``torch.cuda.synchronize()`` when the
    state lies on the card; ``memory`` is ``{"peak_hbm_bytes":
    torch.cuda.max_memory_allocated()}`` over the timed run (the peak is
    reset just before it), or None on the CPU."""
    runner(make_state(), key)
    state0 = make_state()
    dev = runner.x_of(state0).device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    state, trace = runner(state0, key)
    if cuda:
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    mem = ({"peak_hbm_bytes": int(torch.cuda.max_memory_allocated(dev))}
           if cuda else None)
    return state, trace, dt / max(T, 1) * 1e6, mem
