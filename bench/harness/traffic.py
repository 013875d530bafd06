"""The one traffic generator: per-node heterogeneous bigram token streams,
a frozen copy of the program's ``data/synthetic.TokenPipeline`` with the
seed taken from ``--seed``, and the ring of steps the window cycles
through, made before the window and held on the device.

Node ``i`` draws from its own bigram "grammar" (next = (a tok + b) mod V
with a and b from mode ``i % n_modes``, a ``noise`` share of uniform
tokens), seeded per (seed, node, step): every seed gives the same shapes,
and every row of every step differs.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipeline:
    vocab_size: int
    seq_len: int
    batch_per_node: int
    n_nodes: int
    seed: int = 0
    n_modes: int = 8
    noise: float = 0.1

    def batch(self, node: int, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, node, step]))
        v = self.vocab_size
        mode = node % self.n_modes
        a = 3 + 2 * mode
        b = 17 * (mode + 1)
        toks = np.empty((self.batch_per_node, self.seq_len + 1), np.int64)
        toks[:, 0] = rng.integers(0, v, self.batch_per_node)
        noise = rng.random((self.batch_per_node, self.seq_len)) < self.noise
        rand = rng.integers(0, v, (self.batch_per_node, self.seq_len))
        for t in range(self.seq_len):
            nxt = (a * toks[:, t] + b) % v
            toks[:, t + 1] = np.where(noise[:, t], rand[:, t], nxt)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def global_batch(self, step: int) -> Dict[str, np.ndarray]:
        """(n_nodes, batch_per_node, seq_len) tokens and labels."""
        per = [self.batch(i, step) for i in range(self.n_nodes)]
        return {k: np.stack([b[k] for b in per]) for k in per[0]}


def pipeline(workload: Dict, vocab: int, n_nodes: int, seed: int
             ) -> TokenPipeline:
    return TokenPipeline(vocab_size=vocab, seq_len=int(workload["seq_len"]),
                         batch_per_node=int(workload["batch_per_node"]),
                         n_nodes=n_nodes, seed=seed,
                         n_modes=int(workload["n_modes"]),
                         noise=float(workload["noise"]))


class Ring:
    """Steps ``0 .. len - 1`` of a pipeline as int64 tensors on a device;
    step ``i`` of a run reads entry ``i % len``. It has the pipeline's
    ``rows_batch(step, lo, hi)``, which the program's train loop calls."""

    def __init__(self, pipe: TokenPipeline, steps: int, device) -> None:
        import torch
        self.pipe = pipe
        self.batches: List[Dict[str, "torch.Tensor"]] = []
        for i in range(steps):
            b = pipe.global_batch(i)
            self.batches.append({k: torch.from_numpy(v).to(device)
                                 for k, v in b.items()})

    def __len__(self) -> int:
        return len(self.batches)

    def host_batch(self, step: int) -> Dict[str, np.ndarray]:
        """The step's batch as the generator drew it (the reference's)."""
        return self.pipe.global_batch(step % len(self))

    def rows_batch(self, step: int, lo: int, hi: int):
        b = self.batches[step % len(self)]
        return {k: v[lo:hi] for k, v in b.items()}
