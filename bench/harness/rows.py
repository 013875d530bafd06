"""A node's rows on a rank of their own: every rank's block of a column
range, gathered over a plain ``torch.distributed`` group, and the reading of
the mixing of some of the n rows. The plain reference of one node a rank
(``bench/engines/sparq_ring_sgd_node.py``) and the runner's readings of the
program's rows (``harness/ranks.py``) both use them, each over the runner's
own group, never through the program's collectives; and the merge of the
ranks' readings into the readings of all n nodes.

Imports nothing of the program.
"""
from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from harness.reference import MixReading


def gather_rows(block: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``(m, c)`` block of ``group``, stacked in rank order
    into the ``(n, c)`` block of all n rows."""
    parts = [torch.empty_like(block) for _ in
             range(dist.get_world_size(group))]
    dist.all_gather(parts, block.contiguous(), group=group)
    return torch.cat(parts)


class RowsMixReading(MixReading):
    """:class:`harness.reference.MixReading` of rows ``lo:hi`` of the n
    nodes: ``add`` takes x before and after the mixing in those rows
    (``(m, c)``) and the new x_hat of every node (``(n, c)``)."""

    def __init__(self, leaves, D_pad: int, w: np.ndarray, gamma: float,
                 device, rows: Tuple[int, int]) -> None:
        super().__init__(leaves, D_pad, w, gamma, device)
        lo, hi = rows
        self.M = self.M[lo:hi]
        self.dist2 = self.dist2[lo:hi].clone()
        self.norm2 = self.norm2[lo:hi].clone()


NODE_LISTS = ("grad0", "grad0_s", "change", "change_s", "xhat", "xhat_s",
              "mix", "mix_norm")


def merge(parts: List[Dict[str, Any]], own: bool) -> Dict[str, Any]:
    """The readings of all n nodes (``harness.reference.readings``' keys)
    from each rank's readings of its own rows, in rank order. With
    ``own`` each rank read its own nodes' losses, bits and triggers (the
    plain reference's ranks): a step's loss is the mean over the nodes, as
    ``numpy.mean`` takes it, and the bits and triggers are summed. Without
    it each rank read the ensemble's (the program's, which gathers them):
    rank 0's are taken, and :func:`agree` tells whether every rank's are
    the same."""
    out = {"leaves": parts[0]["leaves"]}
    for key in NODE_LISTS:
        out[key] = [row for p in parts for row in p[key]]
    if own:
        out["losses"] = [float(np.mean(step)) for step in
                         zip(*(p["losses"] for p in parts), strict=True)]
        out["bits"] = float(sum(p["bits"] for p in parts))
        out["triggers"] = int(sum(p["triggers"] for p in parts))
    else:
        out.update({k: parts[0][k] for k in ("losses", "bits", "triggers")})
    return out


def agree(parts: List[Dict[str, Any]]) -> bool:
    """Whether every rank read the same losses, bits and triggers."""
    return all(p[k] == parts[0][k] for p in parts
               for k in ("losses", "bits", "triggers"))
