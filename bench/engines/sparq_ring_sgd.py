"""The plain SPARQ-SGD loop over a ring with plain SGD, for a
configuration whose ``engine.reference`` is ``sparq_ring_sgd``: each step
every node's loss and gradient and its local SGD step; every H-th step the
event trigger, blockwise SignTopK of x - x_hat, the x_hat update, the
mixing ``x += gamma (W x_hat - x_hat)`` with the ring's uniform W and
gamma* of Lemma 6, and the bits. A later topology, optimizer or schedule
is an engine file of its own (it may import this one's parts).

Imports nothing of the program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from harness import sizes
from harness.reference import (LeafReader, MixReading, consensus_step,
                               leaf_views, readings, sign_topk_plain,
                               sq_norm)
from harness.sizes import BLOCK
from harness.weights import draw_x0

TILE_CHUNK = 1 << 18          # SignTopK tiles per plain pass


def ring_mixing(n: int) -> np.ndarray:
    """The uniform mixing matrix of a ring: weight 1/(max degree + 1) on
    each neighbour, the rest on the diagonal."""
    adj = np.zeros((n, n))
    if n > 1:
        for i in range(n):
            adj[i, (i + 1) % n] = adj[i, (i - 1) % n] = 1.0
    w = adj / (adj.sum(1).max() + 1.0)
    np.fill_diagonal(w, 1.0 - w.sum(1))
    return w


@dataclasses.dataclass(frozen=True)
class Engine:
    """The SPARQ-SGD knobs of a configuration file's ``engine``."""

    n: int
    H: int
    frac: float
    lr: float
    lr_decay: float
    threshold: float

    @classmethod
    def of(cls, config: Dict[str, Any], H: int) -> "Engine":
        e = config["engine"]
        if (e["topology"], e["optimizer"], e["lr"][0], e["threshold"][0]
                ) != ("ring", "sgd", "decaying", "constant") or \
                not e["use_kernel"]:
            raise ValueError("this engine follows a ring with plain SGD at "
                             "b / (t + a), a constant threshold and "
                             "blockwise SignTopK")
        return cls(n=int(config["n_nodes"]), H=int(H), frac=float(e["frac"]),
                   lr=float(e["lr"][1]), lr_decay=float(e["lr"][2]),
                   threshold=float(e["threshold"][1]))

    @property
    def k_b(self) -> int:
        return max(1, min(BLOCK, int(math.ceil(self.frac * BLOCK))))

    def eta(self, t: int) -> torch.Tensor:
        """The step size b / (t + a), divided in float32."""
        return torch.tensor(self.lr, dtype=torch.float32) / (
            torch.tensor(float(t), dtype=torch.float32) + self.lr_decay)

    def syncs(self, t: int) -> bool:
        return (t + 1) % self.H == 0

    def mixing(self) -> Tuple[np.ndarray, float]:
        """W and gamma*, with omega the kept share of a tile (at most
        2 / pi)."""
        w = ring_mixing(self.n)
        return w, consensus_step(w, min(self.k_b / BLOCK, 2.0 / math.pi))

    def payload_bits(self, D: int) -> float:
        """A triggered message: per tile k sign bits, k indices of
        log2(1024) bits and one float32 scale."""
        tiles = max(1, -(-D // BLOCK))
        return tiles * (self.k_b + self.k_b * math.ceil(math.log2(BLOCK))
                        + 32.0)


def _node_step(model, row: torch.Tensor, reader: LeafReader,
               tokens: torch.Tensor, labels: torch.Tensor, eta: torch.Tensor,
               read: bool) -> Tuple[float, Any]:
    """One node's loss and gradient at ``row``, then ``row -= eta g`` in
    place. Returns the loss and, with ``read``, the gradient's leaf
    readings. The family says how many rows one backward takes."""
    tree, parts = leaf_views(row, reader.leaves)
    rows, seq = tokens.shape
    step = model.s.rows_per_backward(rows, seq)
    total = 0.0
    for lo in range(0, rows, step):
        part = model.loss_sum(tree, tokens[lo:lo + step],
                              labels[lo:lo + step]) / tokens.numel()
        part.backward()
        total += float(part.detach())
    with torch.no_grad():
        views_of = {leaf.path: views for leaf, views in parts}

        def grad(leaf) -> torch.Tensor:
            return torch.cat([(v.grad if v.grad is not None else
                               torch.zeros_like(v)).reshape(-1)
                              for v in views_of[leaf.path]])
        got = reader.read(grad) if read else None
        for leaf, views in parts:
            for v in views:
                if v.grad is not None:      # a leaf the loss reads
                    v.sub_(v.grad * eta)
    return total, got


def run(config: Dict[str, Any], workload: Dict[str, Any], seed: int,
        batches: Sequence[Dict[str, np.ndarray]], device, precision: str
        ) -> Dict[str, Any]:
    """See :func:`harness.reference.run`."""
    s = sizes.of(config)
    eng = Engine.of(config, workload["H"])
    model = s.model(precision)
    leaves, D, D_pad = sizes.layout(s)
    n = eng.n
    x0, _ = draw_x0(s, seed, device)
    x = torch.zeros((n, D_pad), dtype=torch.float32, device=device)
    x[:, :D] = x0
    del x0
    x_hat = torch.zeros_like(x)
    w, gamma = eng.mixing()
    W = torch.tensor(w, dtype=torch.float32, device=device)
    mix = MixReading(leaves, D_pad, w, gamma, device)
    deg = [int(np.count_nonzero(w[i]) - (w[i, i] > 0)) for i in range(n)]
    payload = eng.payload_bits(D)
    reader = LeafReader(leaves, device)
    losses: List[float] = []
    grad0 = []
    bits, triggers, synced = 0.0, 0, False
    for t, batch in enumerate(batches):
        eta = eng.eta(t).to(device)
        tok = torch.as_tensor(batch["tokens"], device=device).long()
        lab = torch.as_tensor(batch["labels"], device=device).long()
        step_losses = []
        for i in range(n):
            loss, got = _node_step(model, x[i], reader, tok[i], lab[i], eta,
                                   t == 0)
            step_losses.append(loss)
            if t == 0:
                grad0.append(got)
        losses.append(float(np.mean(step_losses)))
        if not eng.syncs(t):
            continue
        with torch.no_grad():
            trig = []
            for i in range(n):
                diff = x[i] - x_hat[i]
                sq = sq_norm(diff)
                fired = sq > float(eng.threshold * eta * eta)
                trig.append(fired)
                if fired:
                    for lo in range(0, D_pad, TILE_CHUNK * BLOCK):
                        hi = min(D_pad, lo + TILE_CHUNK * BLOCK)
                        x_hat[i, lo:hi] += sign_topk_plain(
                            diff[lo:hi].view(-1, BLOCK), eng.k_b).view(-1)
                del diff
            for j, c in mix.chunks():
                before = x[:, c].clone() if not synced else None
                x[:, c] += gamma * (W @ x_hat[:, c] - x_hat[:, c])
                if before is not None and j is not None:
                    mix.add(j, before, x[:, c], x_hat[:, c])
            synced = True
            bits += sum((1.0 + (payload if trig[i] else 0.0)) * deg[i]
                        for i in range(n))
            triggers += sum(trig)
    x0, _ = draw_x0(s, seed, device)

    def row(buf, i):
        return lambda leaf: buf[i, leaf.offset:leaf.offset + leaf.size]
    with torch.no_grad():
        change = [reader.read(row(x, i), x0) for i in range(n)]
        xhat = [reader.read(row(x_hat, i)) for i in range(n)]
    return readings(losses, grad0, change, xhat, bits, triggers, leaves,
                    mix.result())
