"""Event-trigger threshold schedules c_t and the trigger rule (counterpart
of ``repro/core/triggers.py``).

A node communicates at sync index t+1 iff
``||x_i^{t+1/2} - x_hat_i^t||^2 > c_t * eta_t^2``.

A schedule maps the step counter to a float32 scalar tensor, evaluated in
float32 like the reference's ``jnp`` functions, so the trigger decisions
agree exactly.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def _f32(t) -> torch.Tensor:
    return torch.as_tensor(t, dtype=torch.float32)


@dataclasses.dataclass(frozen=True)
class ThresholdSchedule:
    fn: Callable[[torch.Tensor], torch.Tensor]
    name: str

    def __call__(self, t) -> torch.Tensor:
        return self.fn(t)


def zero() -> ThresholdSchedule:
    return ThresholdSchedule(lambda t: torch.zeros_like(_f32(t)), "zero")


def constant(c0: float) -> ThresholdSchedule:
    return ThresholdSchedule(lambda t: torch.full_like(_f32(t), c0),
                             f"const({c0})")


def poly(c0: float, eps: float = 0.5) -> ThresholdSchedule:
    """Theorem 1: c_t = c0 * t^(1-eps), which must be o(t)."""
    if not 0.0 < eps < 1.0:
        raise ValueError(
            f"poly threshold needs eps in (0, 1) (Theorem 1: c_t = c0 * "
            f"t^(1-eps) must be o(t)), got eps={eps}")

    def fn(t):
        return c0 * torch.clamp(_f32(t), min=1.0) ** (1.0 - eps)
    return ThresholdSchedule(fn, f"poly(c0={c0},eps={eps})")


def piecewise(c0: float, step: float, every: int, until: int
              ) -> ThresholdSchedule:
    """Section 5.2: start at c0, add `step` every `every` steps until t=until."""
    if every < 1:
        raise ValueError(f"piecewise threshold needs every >= 1 steps "
                         f"between increments, got {every}")
    if until < 0:
        raise ValueError(f"piecewise threshold needs until >= 0, got {until}")

    def fn(t):
        inc = torch.floor_divide(torch.clamp(_f32(t), max=float(until)),
                                 float(every))
        return c0 + step * inc
    return ThresholdSchedule(fn, f"piecewise(c0={c0},+{step}/{every}<= {until})")


def should_trigger(x_half: torch.Tensor, x_hat: torch.Tensor, c_t, eta_t
                   ) -> torch.Tensor:
    """Squared-norm trigger over a flat vector: returns a bool scalar."""
    diff = x_half - x_hat
    return torch.sum(diff * diff) > c_t * eta_t * eta_t


def make_schedule(name: str, **kw) -> ThresholdSchedule:
    schedules = {"zero": zero, "constant": constant, "poly": poly,
                 "piecewise": piecewise}
    if name not in schedules:
        raise ValueError(f"unknown threshold schedule {name!r}; "
                         f"have {sorted(schedules)}")
    return schedules[name](**kw)
