"""Baselines the paper compares against, Section 5 and Figure 1
(counterpart of ``repro/core/baselines.py``).

* CHOCO-SGD: compressed gossip every iteration, which is SPARQ-SGD with
  H = 1 and c_t = 0; it reuses the SPARQ engine.
* Vanilla decentralized SGD: exact 32-bit gossip every step,
  ``X^{t+1} = W (X^t - eta_t dF)``.
* Centralized minibatch SGD: every step averages the n nodes' gradients;
  bits are those of a ring all-reduce, ``2 (n-1)/n * 32 d`` per node.

As in :mod:`repro_torch.core.sparq`, ``t`` is a host integer and a step
returns a new state and leaves the one it is given as it was. CHOCO and
vanilla take the same ``faults=`` plan as SPARQ; vanilla gossips every
step, so its link stream is indexed by ``t``.
"""
from __future__ import annotations

from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bits as bits_mod
from repro_torch.core import engine, prng
from repro_torch.core.compression import Compressor
from repro_torch.core.faults import FaultPlan, resolve_faults
from repro_torch.core.schedule import LRSchedule
from repro_torch.core.sparq import GradFn, SparqConfig, local_update
from repro_torch.core.topology import Topology
from repro_torch.core.triggers import zero
from repro_torch.optim.sgd import Optimizer, resolve_optimizer


def choco_config(topology: Topology, compressor: Compressor, lr: LRSchedule,
                 gamma: Optional[float] = None, momentum: float = 0.0,
                 optimizer: Optional[Optimizer] = None,
                 faults: Optional[FaultPlan] = None) -> SparqConfig:
    """CHOCO-SGD == SPARQ-SGD(H=1, c_t=0), under the same ``faults``."""
    return SparqConfig(topology=topology, compressor=compressor,
                       threshold=zero(), lr=lr, H=1, gamma=gamma,
                       momentum=momentum, optimizer=optimizer, faults=faults)


class VanillaState(NamedTuple):
    x: torch.Tensor
    opt: Any
    t: int
    bits: torch.Tensor
    bits_c: torch.Tensor


def make_vanilla_step(topology: Topology, lr: LRSchedule, grad_fn: GradFn,
                      momentum: float = 0.0,
                      optimizer: Optional[Optimizer] = None,
                      faults: Optional[FaultPlan] = None
                      ) -> Callable[[VanillaState, torch.Tensor],
                                    VanillaState]:
    """Decentralized vanilla SGD: exact neighbour averaging every step;
    an active ``faults`` plan skips local steps, drops links at every step
    and charges only live links."""
    opt = resolve_optimizer(optimizer, momentum)
    n = topology.n
    w32 = torch.as_tensor(topology.w, dtype=torch.float32)
    deg_sum = torch.sum(torch.as_tensor(topology.degrees,
                                        dtype=torch.float32))
    flt = resolve_faults(faults)
    if flt is not None:
        flt.validate_for(n)
    ws = {}

    def step(state: VanillaState, key: torch.Tensor) -> VanillaState:
        d = state.x.shape[-1]
        dev = state.x.device
        if dev not in ws:
            ws[dev] = w32.to(dev)
        g = grad_fn(state.x, state.t, key)
        x_half, opt_new = local_update(opt, g, state.opt, state.x,
                                       lr(state.t))
        if flt is None:
            W, sent = ws[dev], deg_sum
        else:
            act = flt.step_mask(state.t, n).to(dev)
            x_half = torch.where(act[:, None], x_half, state.x)
            opt_new = flt.gate_update(act, opt_new, state.opt)
            W, deg, _ = flt.apply(w32, state.t, state.t)
            W, sent = W.to(dev), torch.sum(deg)
        bits, bits_c = bits_mod.acc_add(
            state.bits, state.bits_c, sent * bits_mod.dense_bits(d))
        return VanillaState(x=W @ x_half, opt=opt_new, t=state.t + 1,
                            bits=bits, bits_c=bits_c)

    return step


def init_vanilla(x0: torch.Tensor, n: int,
                 optimizer: Optional[Optimizer] = None) -> VanillaState:
    x = (x0.expand(n, x0.shape[-1]) if x0.dim() == 1 else x0).clone()
    bits0, bits_c0 = bits_mod.acc_init(x.device)
    opt = (optimizer or resolve_optimizer(None)).init(x)
    return VanillaState(x=x, opt=opt, t=0, bits=bits0, bits_c=bits_c0)


class CentralState(NamedTuple):
    x: torch.Tensor          # (d,)
    opt: Any
    t: int
    bits: torch.Tensor
    bits_c: torch.Tensor


def make_central_step(n: int, lr: LRSchedule, grad_fn: GradFn,
                      momentum: float = 0.0,
                      optimizer: Optional[Optimizer] = None
                      ) -> Callable[[CentralState, torch.Tensor],
                                    CentralState]:
    """Centralized minibatch SGD over the same n data shards."""
    opt = resolve_optimizer(optimizer, momentum)

    def step(state: CentralState, key: torch.Tensor) -> CentralState:
        d = state.x.shape[-1]
        xs = state.x.expand(n, d)
        g = torch.mean(grad_fn(xs, state.t, key), dim=0)
        x_new, opt_new = local_update(opt, g, state.opt, state.x,
                                      lr(state.t))
        # ring all-reduce: each node sends 2(n-1)/n * 32d bits
        bits, bits_c = bits_mod.acc_add(
            state.bits, state.bits_c,
            torch.tensor(n * 2.0 * (n - 1) / n * bits_mod.dense_bits(d)))
        return CentralState(x=x_new, opt=opt_new, t=state.t + 1, bits=bits,
                            bits_c=bits_c)

    return step


def init_central(x0: torch.Tensor,
                 optimizer: Optional[Optimizer] = None) -> CentralState:
    x = x0.clone()
    bits0, bits_c0 = bits_mod.acc_init(x.device)
    opt = (optimizer or resolve_optimizer(None)).init(x)
    return CentralState(x=x, opt=opt, t=0, bits=bits0, bits_c=bits_c0)


def run_generic(step: Callable[[Any, torch.Tensor], Any], state: Any, T: int,
                key: torch.Tensor, record_every: int = 0,
                eval_fn: Optional[Callable[[torch.Tensor],
                                           torch.Tensor]] = None,
                x_of: Callable[[Any], torch.Tensor] = lambda s: s.x
                ) -> Tuple[Any, engine.Trace]:
    """Any baseline step through :func:`repro_torch.core.engine.run_traced`."""
    return engine.run_traced(step, state, T, key, record_every=record_every,
                             eval_fn=eval_fn, x_of=x_of)


def run_generic_loop(step: Callable[[Any, torch.Tensor], Any], state: Any,
                     T: int, key: torch.Tensor, record_every: int = 0,
                     eval_fn: Optional[Callable[[torch.Tensor],
                                                torch.Tensor]] = None,
                     x_of: Callable[[Any], torch.Tensor] = lambda s: s.x
                     ) -> Tuple[Any, List[tuple]]:
    """The reference's legacy per-step loop, what :func:`run_generic` is
    tested against: a list of (t, bits, loss) tuples."""
    trace = []
    for t in range(T):
        key, sub = prng.split(key)
        state = step(state, sub)
        if record_every and eval_fn is not None and \
                (t + 1) % record_every == 0:
            xbar = engine.mean_model(x_of(state))
            trace.append((t + 1, float(state.bits), float(eval_fn(xbar))))
    return state, trace
