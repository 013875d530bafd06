"""Synthetic LM token stream (counterpart of ``TokenPipeline`` in
``repro/data/synthetic.py``; numpy only, and bit for bit the same batches).

Deterministic and shardable: each node draws from its own bigram "grammar"
(next = (a*tok + b) mod v, with 10% noise), seeded per (seed, node, step), so
the data are heterogeneous across nodes and the loss can fall. The convex
dataset of the reference is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np


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

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """(n_nodes, batch_per_node, seq) stacked batch for the train step."""
        per = [self.batch(i, step) for i in range(self.n_nodes)]
        return {k: np.stack([b[k] for b in per]) for k in per[0]}
