"""Synthetic data (counterpart of ``repro/data/synthetic.py``).

1. ``TokenPipeline``: a deterministic, shardable LM token stream (numpy
   only, bit for bit the reference's batches); a rank draws only its own
   nodes' batches (``rows_batch``). Each node draws from its own
   bigram "grammar" (next = (a*tok + b) mod v, with 10% noise), seeded per
   (seed, node, step), so the data are heterogeneous across nodes.
2. ``convex_dataset`` and ``logistic_loss_and_grad``: the paper's Section
   5.1 analog, multinomial logistic regression on Gaussian-mixture features
   with class skew across nodes. The dataset is the reference's numpy code,
   so the same seed gives the same arrays; the minibatch draws come from
   :mod:`repro_torch.core.prng`, so the same key gives the same indices.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Iterator, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    batch_per_node: int
    n_nodes: int
    seed: int = 0
    n_modes: int = 8   # latent bigram modes; nodes mix them heterogeneously

    def batch(self, node: int, step: int) -> Dict[str, np.ndarray]:
        """Deterministic batch for (node, step), reproducible across restarts."""
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, node, step]))
        v = self.vocab_size
        mode = node % self.n_modes
        a = 3 + 2 * mode
        b = 17 * (mode + 1)
        toks = np.empty((self.batch_per_node, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.integers(0, v, self.batch_per_node)
        noise = rng.random((self.batch_per_node, self.seq_len)) < 0.1
        rand = rng.integers(0, v, (self.batch_per_node, self.seq_len))
        for t in range(self.seq_len):
            nxt = (a * toks[:, t] + b) % v
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def node_batches(self, node: int) -> Iterator[Dict[str, np.ndarray]]:
        """Node ``node``'s batches for steps 0, 1, 2, ..., without end."""
        step = 0
        while True:
            yield self.batch(node, step)
            step += 1

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """(n_nodes, batch_per_node, seq) stacked batch for the train step."""
        return self.rows_batch(step, 0, self.n_nodes)

    def rows_batch(self, step: int, lo: int, hi: int
                   ) -> Dict[str, np.ndarray]:
        """Rows ``[lo, hi)`` of :meth:`global_batch`: a rank draws only its
        own nodes' batches, each as the one-process run draws it (the
        engine takes the rank's fsdp slice of each)."""
        per = [self.batch(i, step) for i in range(lo, hi)]
        return {k: np.stack([b[k] for b in per]) for k in per[0]}


def convex_dataset(n_nodes: int, samples_per_node: int = 200,
                   n_features: int = 784, n_classes: int = 10, seed: int = 0,
                   skew: float = 0.8) -> Tuple[np.ndarray, np.ndarray]:
    """Heterogeneous multinomial-logit data: (X (n, m, f) float32, Y (n, m)
    int32). Each node draws ``skew`` of its samples from 2 'home' classes."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_classes, n_features)) * 2.0
    X = np.empty((n_nodes, samples_per_node, n_features), np.float32)
    Y = np.empty((n_nodes, samples_per_node), np.int32)
    for i in range(n_nodes):
        home = np.array([i % n_classes, (i + 1) % n_classes])
        for m in range(samples_per_node):
            if rng.random() < skew:
                c = int(rng.choice(home))
            else:
                c = int(rng.integers(0, n_classes))
            X[i, m] = centers[c] + rng.normal(size=n_features)
            Y[i, m] = c
    return X, Y


def logistic_loss_and_grad(n_classes: int):
    """(loss_fn, make_grad_fn, full_loss) for flat (f*c,) parameters.

    ``loss(x_flat, X (m, f), Y (m,))`` is the mean cross-entropy.
    ``make_grad_fn(X (n, m, f), Y (n, m), minibatch)`` gives the engines'
    ``grad_fn(x (n, d), t, key)``: per node, ``minibatch`` indices from
    ``randint(split(key, n)[i], (minibatch,), 0, m)``, drawn for all nodes
    in one batched call, then the closed-form gradient of the softmax
    cross-entropy, ``X_b^T (softmax(X_b W) - onehot) / minibatch``. The
    data tensors' device is where the gradient is computed; the keys may
    lie elsewhere."""

    def loss(x_flat: torch.Tensor, Xb: torch.Tensor, Yb: torch.Tensor
             ) -> torch.Tensor:
        logits = Xb @ x_flat.reshape(Xb.shape[-1], n_classes)
        lp = F.log_softmax(logits, dim=-1)
        return -torch.mean(torch.gather(lp, -1, Yb[..., None].long()))

    def make_grad_fn(X: torch.Tensor, Y: torch.Tensor, minibatch: int
                     ) -> Callable[[torch.Tensor, int, torch.Tensor],
                                   torch.Tensor]:
        n, m, f = X.shape
        Y = Y.long()

        def grad_fn(x_nd: torch.Tensor, t: int, key: torch.Tensor
                    ) -> torch.Tensor:
            idx = prng.randint(prng.split(key, n), (minibatch,), 0, m)
            idx = idx.to(X.device)                             # (n, mb)
            Xb = torch.gather(X, 1, idx[..., None].expand(n, minibatch, f))
            Yb = torch.gather(Y, 1, idx)
            logits = torch.bmm(Xb, x_nd.reshape(n, f, n_classes))
            err = torch.softmax(logits, dim=-1)
            err.scatter_add_(-1, Yb[..., None],
                             torch.full_like(err[..., :1], -1.0))
            g = torch.bmm(Xb.transpose(1, 2), err / minibatch)
            return g.reshape(n, f * n_classes)

        return grad_fn

    def full_loss(x_flat: torch.Tensor, X: torch.Tensor, Y: torch.Tensor
                  ) -> torch.Tensor:
        logits = X @ x_flat.reshape(X.shape[-1], n_classes)   # (n, m, c)
        lp = F.log_softmax(logits, dim=-1)
        per_node = -torch.mean(torch.gather(lp, -1, Y[..., None].long())
                               [..., 0], dim=-1)
        return torch.mean(per_node)

    return loss, make_grad_fn, full_loss
