"""The plain SPARQ-SGD loop of ``sparq_ring_sgd`` with one node a rank, for a
configuration whose ``engine.reference`` is ``sparq_ring_sgd_node``: rank r
of a process group holds node r's x and x_hat alone, on its own device, and
runs that node's loss, gradient and local SGD step, its event trigger and
blockwise SignTopK; at a sync it takes the new x_hat of every node from an
all-gather over the group, a column block at a time, and mixes its own row
with the ring's uniform W and gamma* of Lemma 6. Its readings are node r's;
``harness.rows.merge`` makes the readings of all n nodes from them.

Each backward takes the model's blocks again one at a time
(``torch.utils.checkpoint``): the same products in the same order, with one
block's activations held at a time, so that a node's row, its x_hat and its
gradient (48.4 GB at deepseek-moe-16b's depth 7) leave the card room for the
control's float8 copy of each weight.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import Any, Dict, List, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from harness import sizes, spec
from harness.reference import (LeafReader, readings, sign_topk_plain,
                               sq_norm)
from harness.rows import RowsMixReading, gather_rows
from harness.sizes import BLOCK
from harness.weights import draw_x0

base = spec.module("engines", "sparq_ring_sgd")
Engine = base.Engine


class Blockwise:
    """The family's model with each block's forward run again in the
    backward: ``loss_sum`` is ``Model.loss_sum``'s sums in its order."""

    def __init__(self, model) -> None:
        self.model, self.s = model, model.s

    def _block(self, kind: str, bp, x: torch.Tensor):
        m = self.model
        x = x + m.attention(bp["attn"], m.norm(bp["norm1"], x))
        h = m.norm(bp["norm2"], x)
        if kind == "moe":
            y, a = m.moe(bp["moe"], h)
            return x + y, a
        return x + m.mlp(bp["mlp"], h), torch.zeros((), device=x.device)

    def loss_sum(self, params, tokens: torch.Tensor, labels: torch.Tensor
                 ) -> torch.Tensor:
        m, s = self.model, self.s
        x = params["embed"]["embedding"][tokens]
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for si, (kind, _) in enumerate(s.segments()):
            for bp in params[f"seg{si}"]:
                x, a = checkpoint(self._block, kind, bp, x,
                                  use_reentrant=False,
                                  preserve_rng_state=False)
                if kind == "moe":
                    aux = aux + a
        h = m.norm(params["final_norm"], x)
        head = (params["embed"]["embedding"].T if s.tie
                else params["embed"]["lm_head"])
        logits = m.mm(h, head)
        ce = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, labels[..., None])[..., 0]
        return ce.sum() + s.aux_coef * aux * labels.numel()


def run_node(config: Dict[str, Any], workload: Dict[str, Any], seed: int,
             batches: Sequence[Dict[str, np.ndarray]], device, precision: str,
             group) -> Dict[str, Any]:
    """Node ``r`` (this rank of ``group``, whose size is the ensemble's) for
    the first ``len(batches)`` steps from x^0 of ``seed``, on its own
    ``(per_node, seq)`` batches, in float32 with TF32 off (or in float8 for
    the control). Returns :func:`harness.reference.readings` of node r:
    its losses, bits and triggers, and its row's readings."""
    s = sizes.of(config)
    eng = Engine.of(config, workload["H"])
    r, n = dist.get_rank(group), dist.get_world_size(group)
    if n != eng.n:
        raise ValueError(f"{n} ranks for {eng.n} nodes: one node a rank")
    model = Blockwise(s.model(precision))
    leaves, D, D_pad = sizes.layout(s)
    x0, _ = draw_x0(s, seed, device)
    x = torch.zeros((1, D_pad), dtype=torch.float32, device=device)
    x[0, :D] = x0
    del x0
    x_hat = torch.zeros_like(x)
    w, gamma = eng.mixing()
    W = torch.tensor(w[r:r + 1], dtype=torch.float32, device=device)
    mix = RowsMixReading(leaves, D_pad, w, gamma, device, (r, r + 1))
    deg = int(np.count_nonzero(w[r]) - (w[r, r] > 0))
    payload = eng.payload_bits(D)
    reader = LeafReader(leaves, device)
    losses: List[float] = []
    grad0 = None
    bits, triggers, synced = 0.0, 0, False
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        for t, batch in enumerate(batches):
            eta = eng.eta(t).to(device)
            tok = torch.as_tensor(batch["tokens"], device=device).long()
            lab = torch.as_tensor(batch["labels"], device=device).long()
            loss, got = base._node_step(model, x[0], reader, tok, lab, eta,
                                        t == 0)
            losses.append(loss)
            if t == 0:
                grad0 = got
            if not eng.syncs(t):
                continue
            with torch.no_grad():
                diff = x[0] - x_hat[0]
                fired = sq_norm(diff) > float(eng.threshold * eta * eta)
                if fired:
                    for lo in range(0, D_pad, base.TILE_CHUNK * BLOCK):
                        hi = min(D_pad, lo + base.TILE_CHUNK * BLOCK)
                        x_hat[0, lo:hi] += sign_topk_plain(
                            diff[lo:hi].view(-1, BLOCK), eng.k_b).view(-1)
                del diff
                for j, c in mix.chunks():
                    every = gather_rows(x_hat[:, c], group)
                    before = x[:, c].clone() if not synced else None
                    x[:, c] += gamma * (W @ every - x_hat[:, c])
                    if before is not None and j is not None:
                        mix.add(j, before, x[:, c], every)
                    del every
                synced = True
                bits += (1.0 + (payload if fired else 0.0)) * deg
                triggers += int(fired)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old
    x0, _ = draw_x0(s, seed, device)
    with torch.no_grad():
        change = reader.read(
            lambda leaf: x[0, leaf.offset:leaf.offset + leaf.size], x0)
        xhat = reader.read(
            lambda leaf: x_hat[0, leaf.offset:leaf.offset + leaf.size])
    return readings(losses, [grad0], [change], [xhat], bits, triggers,
                    leaves, mix.result())
