"""Optimizers over the flat node-stacked parameter buffer (counterpart of
``repro/optim/sgd.py``).

Unlike the reference's pure ``(init, update)`` pairs, ``update`` works IN
PLACE: ``update(grads, state, params, lr)`` overwrites ``params`` with the
new iterate and the tensors of ``state`` with the new optimizer state, uses
``grads`` as scratch (its contents are gone afterwards), and returns the
state. At full model width every ``(n, D_pad)`` float32 buffer is about
10 GB, so the flat-buffer engine cannot afford the reference's fresh
outputs. ``lr`` is a Python float holding a float32 value.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

OptState = Any
UpdateFn = Callable[[torch.Tensor, OptState, torch.Tensor, float], OptState]


class Optimizer(NamedTuple):
    init: Callable[[torch.Tensor], OptState]
    update: UpdateFn       # (grads, state, params, lr) -> state, in place
    name: str


def sgd(weight_decay: float = 0.0) -> Optimizer:
    def init(params):
        return ()

    def update(grads, state, params, lr):
        if weight_decay:
            grads.add_(params, alpha=weight_decay)
        params.sub_(grads.mul_(lr))            # p - lr * g
        return state

    return Optimizer(init, update, "sgd")


def momentum(beta: float = 0.9, weight_decay: float = 0.0,
             nesterov: bool = False) -> Optimizer:
    def init(params):
        return torch.zeros_like(params, dtype=torch.float32)

    def update(grads, m, params, lr):
        if weight_decay:
            grads.add_(params, alpha=weight_decay)
        m.mul_(beta).add_(grads)               # m2 = beta * m + g
        if nesterov:
            grads.add_(m, alpha=beta)          # step = g + beta * m2
        else:
            grads.copy_(m)                     # step = m2
        params.sub_(grads.mul_(lr))
        return m

    return Optimizer(init, update, f"momentum({beta})")


class AdamState(NamedTuple):
    mu: torch.Tensor
    nu: torch.Tensor
    count: int


def adamw(b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    def init(params):
        return AdamState(torch.zeros_like(params, dtype=torch.float32),
                         torch.zeros_like(params, dtype=torch.float32), 0)

    def update(grads, state, params, lr):
        c = state.count + 1
        f32 = torch.float32
        bc1 = 1 - torch.tensor(b1, dtype=f32) ** c
        bc2 = 1 - torch.tensor(b2, dtype=f32) ** c
        mu, nu = state.mu, state.nu
        mu.mul_(b1).add_(grads, alpha=1 - b1)
        nu.mul_(b2).add_(grads.mul_(grads), alpha=1 - b2)
        # step = (mu/bc1) / (sqrt(nu/bc2) + eps) + wd * p, built in grads
        torch.div(nu, bc2.item(), out=grads).sqrt_().add_(eps)
        torch.div(mu / bc1.item(), grads, out=grads)
        grads.add_(params, alpha=weight_decay)
        params.sub_(grads.mul_(lr))
        return AdamState(mu, nu, c)

    return Optimizer(init, update, "adamw")


def make_optimizer(name: str, **kw) -> Optimizer:
    return {"sgd": sgd, "momentum": momentum, "adamw": adamw}[name](**kw)


def resolve_optimizer(optimizer, beta: float = 0.0,
                      nesterov: bool = False) -> Optimizer:
    """The reference's resolution rule: ``optimizer`` wins when given; else
    a nonzero ``beta`` means heavyball (or Nesterov) momentum, and 0 plain
    SGD. Passing both is ambiguous and rejected."""
    if optimizer is not None:
        if beta:
            raise ValueError(
                "pass either optimizer= or the momentum shorthand, not both")
        if nesterov:
            raise ValueError(
                "nesterov belongs to the momentum shorthand; configure it on "
                "the explicit optimizer instead (optim.momentum(nesterov=True))")
        return optimizer
    if beta:
        return momentum(beta, nesterov=nesterov)
    if nesterov:
        raise ValueError("nesterov=True needs a nonzero momentum beta "
                         "(plain SGD has no velocity to look ahead on)")
    return sgd()
