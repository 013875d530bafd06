"""Fault injection and node heterogeneity (counterpart of
``repro/core/faults.py``; the dataclasses and stream tags are re-declared
here, since the port imports nothing of ``repro``).

Three failure modes, threaded through both engines:

* **Link drops**: at each sync round every edge of the active ``W_r`` dies
  independently with probability ``link_drop``; each dropped edge's weight
  folds onto both endpoints' diagonals (lazy repair), which keeps the
  matrix symmetric doubly stochastic and nonnegative.
* **Stragglers**: the nodes in ``stragglers`` skip each local step with
  probability ``straggler_frac``; a skipped step freezes the iterate and
  the node's optimizer state. They still gossip.
* **Dropout windows**: ``DropoutWindow(node, start, end)`` takes a node
  offline for ``start <= t < end``: no local steps, no sends (its trigger is
  forced off), no receives (its row of the repaired matrix is ``e_i``), no
  bits.

Every mask is a pure function of ``(seed, t, sync_round, n)`` drawn from
the reference's threefry stream (:mod:`repro_torch.core.prng`, in whichever
layout is set), so the masks equal the reference's bit for bit and both
engines of the port see the same faults. ``t`` and ``sync_round`` are host
integers; the masks are built on the host, on the CPU, and are small (n x n),
so an engine copies them to its device once per sync.

``W_eff`` and ``deg_eff`` are float32, as the reference computes them
(``1 - sum(off)`` in float32). As in the reference, a message sent while a
link is down still lands in the one shared ``x_hat`` (delivery is deferred,
not lost).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng

_LINK_STREAM = 0       # fold_in tags: one substream per fault kind, so the
_STRAGGLER_STREAM = 1  # link and straggler draws never collide
COMPRESS_STREAM = 2    # the flat-buffer engine's stochastic-compressor draw


@dataclasses.dataclass(frozen=True)
class DropoutWindow:
    """Node ``node`` is offline for local steps ``start <= t < end``."""

    node: int
    start: int
    end: int

    def __post_init__(self):
        if self.node < 0:
            raise ValueError(
                f"DropoutWindow.node must be >= 0, got {self.node}")
        if not 0 <= self.start < self.end:
            raise ValueError(
                f"DropoutWindow needs 0 <= start < end, got "
                f"[{self.start}, {self.end})")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """Composable fault model over any static or time-varying
    :class:`~repro_torch.core.topology.GossipPlan`."""

    link_drop: float = 0.0                      # iid per-edge, per-sync-round
    stragglers: Tuple[int, ...] = ()            # nodes that straggle
    straggler_frac: float = 0.0                 # per-step skip probability
    dropout: Tuple[DropoutWindow, ...] = ()     # offline windows (step units)
    seed: int = 0                               # fault-stream PRNG seed
    # per-stream base keys fold_in(PRNGKey(seed), stream), built once (the
    # same in both threefry layouts); left out of eq and hash
    _bases: Tuple[torch.Tensor, ...] = dataclasses.field(
        init=False, repr=False, compare=False)

    def __post_init__(self):
        if not 0.0 <= self.link_drop < 1.0:
            raise ValueError(
                f"link_drop must be in [0, 1), got {self.link_drop} "
                f"(dropping every link every round never mixes)")
        if not 0.0 <= self.straggler_frac <= 1.0:
            raise ValueError(
                f"straggler_frac must be in [0, 1], got {self.straggler_frac}")
        if self.straggler_frac > 0.0 and not self.stragglers:
            raise ValueError(
                "straggler_frac > 0 needs a nonempty stragglers= node list")
        object.__setattr__(self, "stragglers",
                           tuple(int(i) for i in self.stragglers))
        if any(i < 0 for i in self.stragglers):
            raise ValueError(f"straggler indices must be >= 0, "
                             f"got {self.stragglers}")
        object.__setattr__(
            self, "dropout",
            tuple(w if isinstance(w, DropoutWindow) else DropoutWindow(*w)
                  for w in self.dropout))
        base = prng.PRNGKey(self.seed)
        object.__setattr__(self, "_bases", tuple(
            prng.fold_in(base, s) for s in (_LINK_STREAM, _STRAGGLER_STREAM)))

    @property
    def is_null(self) -> bool:
        """True when this plan injects nothing."""
        return (self.link_drop == 0.0
                and not (self.stragglers and self.straggler_frac > 0.0)
                and not self.dropout)

    def validate_for(self, n: int) -> None:
        """Check node indices against the ensemble size ``n``."""
        bad = [i for i in self.stragglers if i >= n]
        if bad:
            raise ValueError(f"straggler nodes {bad} out of range for n={n}")
        bad = [w.node for w in self.dropout if w.node >= n]
        if bad:
            raise ValueError(f"dropout-window nodes {bad} out of range "
                             f"for n={n}")

    def _key(self, stream: int, counter: int) -> torch.Tensor:
        """fold_in(fold_in(PRNGKey(seed), stream), counter), on the host."""
        return prng.fold_in(self._bases[stream], int(counter))

    def live_mask(self, t: int, n: int) -> torch.Tensor:
        """(n,) bool: node is up (outside every dropout window) at step t."""
        live = torch.ones((n,), dtype=torch.bool)
        for w in self.dropout:
            if w.start <= t < w.end:
                live[w.node] = False
        return live

    def step_mask(self, t: int, n: int) -> torch.Tensor:
        """(n,) bool: node takes its local gradient step at step t."""
        active = self.live_mask(t, n)
        if self.stragglers and self.straggler_frac > 0.0:
            u = prng.uniform(self._key(_STRAGGLER_STREAM, t), (n,))
            is_straggler = torch.zeros((n,), dtype=torch.bool)
            is_straggler[list(self.stragglers)] = True
            active = active & ~(is_straggler & (u < self.straggler_frac))
        return active

    def link_mask(self, sync_round: int, n: int) -> torch.Tensor:
        """(n, n) symmetric float32 0/1 keep mask of sync round
        ``sync_round``: each undirected edge survives w.p. 1 - link_drop."""
        return torch.from_numpy(self._link_mask(sync_round, n))

    def _link_mask(self, sync_round: int, n: int) -> np.ndarray:
        if self.link_drop == 0.0:
            return np.ones((n, n), np.float32)
        u = prng.uniform(self._key(_LINK_STREAM, sync_round), (n, n))
        keep = np.triu(u.numpy() >= np.float32(self.link_drop), k=1)
        return (keep | keep.T).astype(np.float32)

    def apply(self, W_r: torch.Tensor, t: int, sync_round: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The faulty view of the active round's float32 mixing matrix:
        ``(W_eff, deg_eff, live)`` on the host: the repaired matrix, the
        (n,) float32 surviving-neighbour counts the bits are charged on, and
        the (n,) bool liveness that gates the trigger. The arithmetic is the
        reference's float32 expressions, in numpy (small matrices: a numpy
        operation costs less than a torch one)."""
        w = W_r.to(device="cpu", dtype=torch.float32).numpy()
        n = w.shape[0]
        live = self.live_mask(t, n)
        livef = live.numpy().astype(np.float32)
        keep = self._link_mask(sync_round, n) * livef[:, None] * livef[None, :]
        off = w * keep * (np.float32(1.0) - np.eye(n, dtype=np.float32))
        # the row sums added left to right in float32, the order of the
        # reference's reduction on the CPU
        acc = np.zeros(n, np.float32)
        for j in range(n):
            acc += off[:, j]
        W_eff = off + np.diag(np.float32(1.0) - acc)
        deg_eff = np.sum(off > 0, axis=1).astype(np.float32)
        return torch.from_numpy(W_eff), torch.from_numpy(deg_eff), live

    def gate_update(self, active: torch.Tensor, new_tree: Any,
                    old_tree: Any) -> Any:
        """Freeze skipped nodes: ``new`` where the node stepped, ``old``
        elsewhere, per node-stacked tensor; anything without a leading node
        axis (a shared step count) passes through unchanged."""
        n = active.shape[0]
        if isinstance(new_tree, torch.Tensor):
            if new_tree.dim() == 0 or new_tree.shape[0] != n:
                return new_tree
            a = active.to(new_tree.device).reshape(
                (n,) + (1,) * (new_tree.dim() - 1))
            return torch.where(a, new_tree, old_tree.to(new_tree.dtype))
        if isinstance(new_tree, tuple):
            items = [self.gate_update(active, a, b)
                     for a, b in zip(new_tree, old_tree, strict=True)]
            return type(new_tree)(*items) if hasattr(new_tree, "_fields") \
                else tuple(items)
        return new_tree


def resolve_faults(faults: Optional[FaultPlan]) -> Optional[FaultPlan]:
    """``None`` for no-fault configs, an explicitly null plan included, so
    an engine keeps its fault-free path exactly."""
    if faults is None or faults.is_null:
        return None
    return faults
