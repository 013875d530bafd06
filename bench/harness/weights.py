"""x^0 drawn from ``--seed`` on the device: one truncated-normal draw over
a node's whole flat row with a ``torch.Generator`` on that device, each
leaf then scaled (norm scales set to 1, biases to 0). Both sides get the
same draw: the program through ``init_fn(params=...)``, the reference by
drawing again.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Tuple

import torch

from harness.sizes import Leaf, layout

X0_STREAM = 0x5EED0


def x0_seed(seed: int) -> int:
    """The generator seed of x^0 for a run's ``--seed`` (any whole number
    below 2**63)."""
    return (int(seed) * 1_000_003 + X0_STREAM) % (1 << 63)


def draw_x0(s, seed: int, device) -> Tuple[torch.Tensor, List[Leaf]]:
    """One node's x^0 as a flat (D,) float32 tensor, and the leaves'
    layout in it."""
    leaves, D, _ = layout(s)
    gen = torch.Generator(device=device)
    gen.manual_seed(x0_seed(seed))
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))
    flat = torch.empty((D,), dtype=torch.float32, device=device)
    # inverse CDF of the standard normal, truncated to [-2, 2]
    flat.uniform_(lo, 1.0 - lo, generator=gen)
    flat.mul_(2.0).sub_(1.0).erfinv_().mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
    for leaf in leaves:
        scale = s.init_scale(leaf.path)
        view = flat[leaf.offset:leaf.offset + leaf.size]
        if scale == 1.0:
            view.fill_(1.0)
        elif scale == 0.0:
            view.zero_()
        else:
            view.mul_(scale)
    return flat, leaves


def as_tree(flat: torch.Tensor, leaves: List[Leaf]) -> Dict[str, Any]:
    """The parameter tree of views into a flat row."""
    tree: Dict[str, Any] = {}
    for leaf in leaves:
        node = tree
        for k in leaf.path[:-1]:
            node = node.setdefault(k, {})
        node[leaf.path[-1]] = flat[leaf.offset:leaf.offset + leaf.size].view(
            leaf.shape)
    return tree
