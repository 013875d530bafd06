"""SPARQ-SGD reference engine: Algorithm 1 on dense (n, d) node ensembles,
and the primitives it shares with the flat-buffer engine (counterpart of
``repro/core/sparq.py``).

One step, in the matrix form of Appendix A.3:

    X^{t+1/2} = X^t - eta_t dF(X^t, xi^t)          (through optim/sgd.py)
    X_hat^{t+1} = X_hat^t + C((X^{t+1/2} - X_hat^t) P^t)   (P^t: triggers)
    X^{t+1}   = X^{t+1/2} + gamma X_hat^{t+1} (W - I)

at every sync index (t+1) % H == 0; other steps are local. Heavyball or
Nesterov momentum in the local update gives SQuARM-SGD (``squarm_config``).

The reference's ``jit``/``lax.cond``/``scan`` program becomes eager PyTorch
with the sync decided on the host. Keys come from :mod:`repro_torch.core.prng`
and are split exactly as the reference splits them, so the minibatches and
the compressor noise are the reference's. A step does not modify the state
it is given: it returns a new one. ``t`` and ``sync_rounds`` are host
integers; ``triggers`` and the float32 Kahan bit pair live on the ensemble's
device.

A time-varying plan gossips over ``ws[sync_rounds % R]`` and charges that
round's degrees. An active fault plan (:mod:`repro_torch.core.faults`)
freezes skipped nodes' iterates and optimizer state, repairs the round's
matrix over the surviving links, mutes offline nodes and charges bits on
live links only; its masks are built on the host and copied to the
ensemble's device.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from repro_torch.core import bits as bits_mod
from repro_torch.core import engine, prng
from repro_torch.core.compression import BlockTopFrac, Compressor, Identity
from repro_torch.core.faults import FaultPlan, resolve_faults
from repro_torch.core.schedule import LRSchedule, fixed
from repro_torch.core.topology import GossipPlan, Topology
from repro_torch.core.triggers import ThresholdSchedule, zero
from repro_torch.kernels import ops as kernel_ops
from repro_torch.optim.sgd import Optimizer, momentum as momentum_opt
from repro_torch.optim.sgd import resolve_optimizer

GradFn = Callable[[torch.Tensor, int, torch.Tensor], torch.Tensor]
# grad_fn(x: (n, d), t: int, key) -> (n, d) stochastic gradients


def trigger_mask(sq_dist: torch.Tensor, c_t, eta) -> torch.Tensor:
    """Line 7 event trigger: ||x^{t+1/2} - x_hat||^2 > c_t eta_t^2, per node
    (all float32)."""
    return sq_dist > c_t * eta * eta


def gossip_mix(W: torch.Tensor, x_hat: torch.Tensor) -> torch.Tensor:
    """Line 15 consensus term sum_j w_ij x_hat_j - x_hat_i, contracting the
    leading node axis of ``x_hat``."""
    return torch.tensordot(W, x_hat, dims=1) - x_hat


def sync_message_bits(trig: torch.Tensor, deg: torch.Tensor,
                      payload_bits: float) -> torch.Tensor:
    """Bits all nodes send at one sync index: flag + trig * payload to each
    of deg_i neighbors, summed in float32 as the reference does."""
    msg = bits_mod.FLAG_BITS + trig.to(torch.float32) * payload_bits
    return torch.sum(msg * deg)


@dataclasses.dataclass(frozen=True)
class SparqConfig:
    topology: Optional[Topology] = None    # static graph (shorthand for a
                                           # one-round GossipPlan)
    compressor: Compressor = Identity()
    threshold: ThresholdSchedule = zero()
    lr: LRSchedule = fixed(0.1)
    H: int = 1                      # gap(I_T): sync every H steps
    gamma: Optional[float] = None   # None -> gamma* from Lemma 6
    momentum: float = 0.0           # shorthand for optimizer=momentum(beta)
    optimizer: Optional[Optimizer] = None  # local-update rule; None -> sgd()
    plan: Optional[GossipPlan] = None      # time-varying gossip plan; wins
                                           # over (and excludes) topology=
    faults: Optional[FaultPlan] = None     # link-drop / straggler / dropout
                                           # injection; None or a null plan
                                           # is fault-free

    def resolved_plan(self) -> GossipPlan:
        """``plan=`` verbatim, or the static single-round plan of
        ``topology=``."""
        if self.plan is not None:
            if self.topology is not None:
                raise ValueError(
                    "pass either topology= or plan=, not both (a static "
                    "topology IS the one-round plan GossipPlan.from_topology)")
            return self.plan
        if self.topology is None:
            raise ValueError("SparqConfig needs topology= or plan=")
        return GossipPlan.from_topology(self.topology)

    @property
    def n(self) -> int:
        return self.resolved_plan().n

    def resolved_optimizer(self) -> Optimizer:
        return resolve_optimizer(self.optimizer, self.momentum)

    def resolved_gamma(self, d: Optional[int] = None) -> float:
        """Consensus stepsize: ``gamma``, else Lemma 6's gamma* at the model
        dimension ``d`` (omega depends on d)."""
        if self.gamma is not None:
            return float(self.gamma)
        if not d:
            raise ValueError(
                "resolved_gamma() needs the model dimension d when gamma is "
                "None: Lemma-6 gamma* depends on the compressor's omega(d)")
        return self.resolved_plan().gamma_star(self._omega(d))

    def _omega(self, d: int) -> float:
        # sign-type operators report the worst case 1/d: floor it so gamma*
        # does not collapse to 0 at large d
        return max(self.compressor.omega(d), 1e-3)

    def init_state(self, x0: torch.Tensor) -> "SparqState":
        """State matching this config's optimizer."""
        return init_state(x0, self.n, self.resolved_optimizer())


class SparqState(NamedTuple):
    x: torch.Tensor            # (n, d) local models
    x_hat: torch.Tensor        # (n, d) public estimates
    opt: Any                   # optimizer state (() for SGD, (n, d) momentum)
    t: int                     # step counter
    bits: torch.Tensor         # () float32 total bits sent (all links)
    bits_c: torch.Tensor       # () Kahan compensation for `bits`
    sync_rounds: int           # sync indices so far
    triggers: torch.Tensor     # () int64 (node, sync) trigger events


def copy_opt(state: Any) -> Any:
    """A copy of an optimizer state whose tensors the in-place optimizers
    of ``optim/sgd.py`` may overwrite."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, tuple):
        items = [copy_opt(v) for v in state]
        return type(state)(*items) if hasattr(state, "_fields") else \
            tuple(items)
    return state


def local_update(opt: Optimizer, g: torch.Tensor, opt_state: Any,
                 x: torch.Tensor, eta: torch.Tensor
                 ) -> Tuple[torch.Tensor, Any]:
    """The reference's pure ``opt.update(g, state, x, eta)`` on top of the
    port's in-place optimizers: x, the state and g are left as they were."""
    x_half = x.clone()
    new_state = opt.update(g.clone(), copy_opt(opt_state), x_half,
                           float(eta))
    return x_half, new_state


def init_state(x0: torch.Tensor, n: int,
               optimizer: Optional[Optimizer] = None) -> SparqState:
    """x0: (d,) shared init or (n, d) per-node init, on the ensemble's
    device. ``optimizer`` must match the one the step was built with."""
    x = (x0.expand(n, x0.shape[-1]) if x0.dim() == 1 else x0).clone()
    bits0, bits_c0 = bits_mod.acc_init(x.device)
    opt = (optimizer or resolve_optimizer(None)).init(x)
    return SparqState(x=x, x_hat=torch.zeros_like(x), opt=opt, t=0,
                      bits=bits0, bits_c=bits_c0, sync_rounds=0,
                      triggers=torch.zeros((), dtype=torch.int64,
                                           device=x.device))


def make_step(cfg: SparqConfig, grad_fn: GradFn
              ) -> Callable[[SparqState, torch.Tensor], SparqState]:
    """step(state, key) -> state: Algorithm 1, or SQuARM-SGD when the
    config's optimizer carries momentum (``sparq.py:170``)."""
    plan = cfg.resolved_plan()
    n = plan.n
    comp = cfg.compressor
    opt = cfg.resolved_optimizer()
    H = int(cfg.H)
    flt = resolve_faults(cfg.faults)
    if flt is not None:
        flt.validate_for(n)
    # the plan's float32 support, (R, n, n), and per-round degrees, (R, n)
    ws = torch.as_tensor(plan.ws, dtype=torch.float32)
    degs = torch.as_tensor(plan.degrees, dtype=torch.float32)
    consts, gammas = {}, {}

    def on(dev: torch.device):
        if dev not in consts:
            consts[dev] = (ws.to(dev), degs.to(dev))
        return consts[dev]

    def step(state: SparqState, key: torch.Tensor) -> SparqState:
        d = state.x.shape[-1]
        dev = state.x.device
        if d not in gammas:
            gammas[d] = cfg.resolved_gamma(d)
        gamma = gammas[d]
        kg, kc = prng.split(key)
        g = grad_fn(state.x, state.t, kg)
        eta = cfg.lr(state.t)
        x_half, opt_new = local_update(opt, g, state.opt, state.x, eta)
        if flt is not None:
            # stragglers and offline nodes skip this local step: iterate and
            # optimizer state freeze
            act = flt.step_mask(state.t, n).to(dev)
            x_half = torch.where(act[:, None], x_half, state.x)
            opt_new = flt.gate_update(act, opt_new, state.opt)
        if (state.t + 1) % H != 0:
            return state._replace(x=x_half, opt=opt_new, t=state.t + 1)
        r = state.sync_rounds % plan.R
        diff = x_half - state.x_hat                           # (n, d)
        sq = torch.sum(diff * diff, dim=-1)                   # (n,)
        trig = trigger_mask(sq, cfg.threshold(state.t), eta)  # (n,) bool
        if flt is None:
            W_all, deg_all = on(dev)
            W, deg = W_all[r], deg_all[r]
        else:
            # the round's matrix repaired over the surviving links, offline
            # nodes muted, bits charged on live links only
            W, deg, live = flt.apply(ws[r], state.t, state.sync_rounds)
            W, deg = W.to(dev), deg.to(dev)
            trig = trig & live.to(dev)
        if isinstance(comp, BlockTopFrac):
            # one kernel launch over the whole (n, d) ensemble
            q = kernel_ops.sign_topk_ensemble(diff, comp._k_b())
        elif comp.deterministic:
            q = comp(diff)
        else:
            q = comp(diff, prng.split(kc, n))
        q = q * trig[:, None].to(q.dtype)                     # line 11
        x_hat_new = state.x_hat + q                           # line 13
        x_new = x_half + gamma * gossip_mix(W, x_hat_new)     # line 15
        bits, bits_c = bits_mod.acc_add(
            state.bits, state.bits_c,
            sync_message_bits(trig, deg, comp.bits(d)))
        return SparqState(x=x_new, x_hat=x_hat_new, opt=opt_new,
                          t=state.t + 1, bits=bits, bits_c=bits_c,
                          sync_rounds=state.sync_rounds + 1,
                          triggers=state.triggers + trig.sum())

    return step


def run(cfg: SparqConfig, grad_fn: GradFn, x0: torch.Tensor, T: int,
        key: torch.Tensor, record_every: int = 0,
        eval_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
        ) -> Tuple[SparqState, engine.Trace]:
    """Run T steps through :func:`repro_torch.core.engine.run_traced`:
    (final_state, trace of (t, bits, eval(x_bar), sync_rounds, triggers)
    every ``record_every`` steps when ``eval_fn`` is given)."""
    step = make_step(cfg, grad_fn)
    state = init_state(x0, cfg.n, cfg.resolved_optimizer())
    return engine.run_traced(step, state, T, key, record_every=record_every,
                             eval_fn=eval_fn)


def run_loop(cfg: SparqConfig, grad_fn: GradFn, x0: torch.Tensor, T: int,
             key: torch.Tensor, record_every: int = 0,
             eval_fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None
             ) -> Tuple[SparqState, List[tuple]]:
    """The reference's legacy per-step loop, kept as what :func:`run` is
    tested against: the trace is a list of (t, bits, loss, sync_rounds,
    triggers) tuples."""
    step = make_step(cfg, grad_fn)
    state = init_state(x0, cfg.n, cfg.resolved_optimizer())
    trace = []
    for t in range(T):
        key, sub = prng.split(key)
        state = step(state, sub)
        if record_every and eval_fn is not None and \
                (t + 1) % record_every == 0:
            xbar = torch.mean(state.x, dim=0)
            trace.append((t + 1, float(state.bits), float(eval_fn(xbar)),
                          state.sync_rounds, int(state.triggers)))
    return state, trace


def run_scan(cfg: SparqConfig, grad_fn: GradFn, x0: torch.Tensor, T: int,
             key: torch.Tensor) -> SparqState:
    """The whole trajectory with no trace."""
    return run(cfg, grad_fn, x0, T, key)[0]


def squarm_config(topology: Topology, compressor: Compressor, lr: LRSchedule,
                  *, H: int = 1, threshold: ThresholdSchedule = zero(),
                  beta: float = 0.9, nesterov: bool = False,
                  gamma: Optional[float] = None) -> SparqConfig:
    """SQuARM-SGD (Singh et al., 2020): SPARQ's event-triggered compressed
    gossip with heavyball (or Nesterov) momentum local steps; ``beta=0``
    reproduces SPARQ-SGD exactly."""
    return SparqConfig(topology=topology, compressor=compressor,
                       threshold=threshold, lr=lr, H=H, gamma=gamma,
                       optimizer=momentum_opt(beta, nesterov=nesterov))
