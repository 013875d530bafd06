"""A configuration's model as the harness lays it out: the sizes object
of the family its file names (``reference``: ``bench/references/<name>.py``),
each leaf's place in a node's flat row, and the fixed coordinates of each
leaf that the comparison samples.

A family's sizes object gives ``param_shapes()``, ``init_scale(path)``,
``flops_per_token(seq_len)``, ``rows_per_backward(rows, seq_len)`` and
``model(precision)``; nothing here names a family. Imports nothing of the
program.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Tuple

from harness import spec

Shape = Tuple[int, ...]
BLOCK = 1024            # SignTopK's tile


def of(config: Dict[str, Any]):
    """The sizes of a configuration file, by its family's module."""
    return spec.module("references", config["reference"]).sizes(config)


def leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
           ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) with dict keys sorted at every level: the order in
    which the flat buffer holds the leaves."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@dataclasses.dataclass(frozen=True)
class Leaf:
    path: Tuple[str, ...]
    offset: int
    size: int
    shape: Shape

    @property
    def name(self) -> str:
        return "/".join(self.path)


def layout(s) -> Tuple[List[Leaf], int, int]:
    """Each leaf's place in one node's flat row, D and D_pad (D rounded up
    to whole SignTopK tiles)."""
    out, off = [], 0
    for path, shape in leaves(s.param_shapes()):
        size = math.prod(shape)
        out.append(Leaf(path, off, size, tuple(shape)))
        off += size
    return out, off, max(1, -(-off // BLOCK)) * BLOCK


SAMPLE = 16384          # coordinates of each leaf whose values are compared


def sample_index(leaf_index: int, size: int):
    """Fixed coordinates of a leaf (the same for every seed and both
    sides): ``min(size, SAMPLE)`` draws from a generator seeded by the
    leaf's place in the tree, sorted."""
    import torch
    if size <= SAMPLE:
        return torch.arange(size)
    gen = torch.Generator().manual_seed(0xC0FFEE + leaf_index)
    return torch.randint(0, size, (SAMPLE,), generator=gen).sort().values
