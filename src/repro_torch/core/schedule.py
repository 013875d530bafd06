"""Synchronization-index sets I_T and learning-rate schedules (counterpart
of ``repro/core/schedule.py``).

An LR schedule maps the step counter, taken as a float32 scalar tensor, to a
float32 scalar tensor, so that ``decaying``'s ``b / (t + a)`` rounds exactly
as the reference's float32 ``jnp`` expression does.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Sequence

import torch


def periodic_sync_mask(T: int, H: int) -> torch.Tensor:
    """Bool mask ``m[t] = ((t + 1) in I_T)`` for t in [0, T)."""
    t = torch.arange(1, T + 1)
    return (t % H) == 0


def is_sync(t: int, H: int) -> bool:
    """(t+1) in I_T for periodic I_T with gap H."""
    return ((t + 1) % H) == 0


@dataclasses.dataclass(frozen=True)
class LRSchedule:
    fn: Callable[[torch.Tensor], torch.Tensor]
    name: str

    def __call__(self, t) -> torch.Tensor:
        return self.fn(torch.as_tensor(t, dtype=torch.float32))


def decaying(b: float, a: float) -> LRSchedule:
    # a true float32 division: ``b / tensor`` would take the reciprocal
    # first and round twice
    return LRSchedule(lambda t: torch.full_like(t, b) / (t + a),
                      f"decay(b={b},a={a})")


def theorem1_lr(mu: float, L: float, H: int, p: float) -> LRSchedule:
    a = max(5.0 * H / p, 32.0 * L / mu)
    return decaying(8.0 / mu, a)


def fixed(eta: float) -> LRSchedule:
    return LRSchedule(lambda t: torch.full_like(t, eta), f"fixed({eta})")


def theorem2_lr(n: int, T: int) -> LRSchedule:
    return fixed(math.sqrt(n / T))


def warmup_piecewise(base: float, warmup: int, milestones: Sequence[int],
                     factor: float = 0.2) -> LRSchedule:
    """Section 5.2: linear warmup then multiply by `factor` at each milestone."""
    ms = tuple(milestones)

    def fn(t):
        warm = base * torch.clamp((t + 1.0) / max(warmup, 1), max=1.0)
        mult = torch.ones_like(t)
        for m in ms:
            mult = torch.where(t >= m, mult * factor, mult)
        return warm * mult

    return LRSchedule(fn, f"warmup({warmup})+piecewise{ms}x{factor}")
