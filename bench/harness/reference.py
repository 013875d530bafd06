"""The plain reference's common parts: the float8 rounding of the
control, a node's row as a tree of leaves that take gradients, the leaf
readings both sides give, a frozen plain SignTopK, gamma* of Lemma 6, the
reading of the sync's mixing, and ``run``, which hands a configuration to
the plain SPARQ-SGD loop its ``engine.reference`` names
(``bench/engines/<name>.py``) over the model of its family
(``bench/references/<name>.py``). Everything runs in float32 with TF32
off, or in float8 for the control.

It imports nothing of the program and takes nothing that the program made:
it reads the configuration file, draws x^0 from the seed itself
(:mod:`harness.weights`) and reads the batches the generator drew.
"""
from __future__ import annotations

import math
from typing import (Any, Dict, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from harness import spec
from harness.sizes import Leaf, sample_index

Tree = Dict[str, Any]
FP8_MAX = 448.0
COLUMN_CHUNK = 1 << 24        # columns per pass over a whole buffer


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under a per-tensor scale; the gradient
    passes straight through."""
    xd = x.detach()
    s = FP8_MAX / xd.abs().amax().clamp(min=1e-30)
    q = (xd * s).to(torch.float8_e4m3fn).to(torch.float32) / s
    return x + (q - xd)


def leaf_views(row: torch.Tensor, leaves: List[Leaf]
               ) -> Tuple[Tree, List[Tuple[Leaf, List[torch.Tensor]]]]:
    """A tree of views of ``row`` that require grad, stacked leaves split
    into one view per layer, and the views of each leaf."""
    tree: Tree = {}
    parts = []
    for leaf in leaves:
        base = row[leaf.offset:leaf.offset + leaf.size]
        if leaf.path[0].startswith("seg"):
            n = leaf.shape[0]
            per = leaf.size // n
            views = [base[i * per:(i + 1) * per].view(leaf.shape[1:])
                     .detach().requires_grad_(True) for i in range(n)]
            layers = tree.setdefault(leaf.path[0], [{} for _ in range(n)])
            for li, v in enumerate(views):
                node = layers[li]
                for key in leaf.path[1:-1]:
                    node = node.setdefault(key, {})
                node[leaf.path[-1]] = v
        else:
            views = [base.view(leaf.shape).detach().requires_grad_(True)]
            node = tree
            for key in leaf.path[:-1]:
                node = node.setdefault(key, {})
            node[leaf.path[-1]] = views[0]
        parts.append((leaf, views))
    return tree, parts


def sq_norm(x: torch.Tensor) -> float:
    """The squared Euclidean norm of ``x``, summed in float64 a chunk of
    2**24 elements at a time."""
    flat = x.reshape(-1)
    return sum(float(torch.sum(flat[lo:lo + (1 << 24)].double() ** 2))
               for lo in range(0, flat.numel(), 1 << 24))


class LeafReader:
    """Per leaf of a node's row: its norm and its values at the leaf's
    fixed sample coordinates (on the host, float64)."""

    def __init__(self, leaves: List[Leaf], device) -> None:
        self.leaves = leaves
        self.index = [sample_index(j, leaf.size).to(device)
                      for j, leaf in enumerate(leaves)]

    def read(self, values, x0: torch.Tensor = None, scale: float = 1.0
             ) -> Tuple[List[float], List[torch.Tensor]]:
        """``values(leaf)`` gives a leaf's values as a flat tensor; with
        ``x0`` the readings are of ``values - x0`` (x0 a flat row)."""
        norms, samples = [], []
        for leaf, idx in zip(self.leaves, self.index, strict=True):
            v = values(leaf)
            if x0 is not None:
                v = v - x0[leaf.offset:leaf.offset + leaf.size]
            norms.append(math.sqrt(sq_norm(v)) * scale)
            samples.append(v[idx].double().cpu() * scale)
        return norms, samples


def sign_topk_plain(tiles: torch.Tensor, k: int) -> torch.Tensor:
    """Blockwise SignTopK of (m, 1024) float32 tiles: per tile the k
    largest |x| (ties to the lower index, zeros never), each replaced by
    sign(x) times the mean of the selected |x|; the rest 0."""
    av = tiles.abs()
    vals = torch.sort(av, dim=1, descending=True, stable=True).values
    thr = vals[:, k - 1:k]
    nonzero = av > 0
    gt = (av > thr) & nonzero
    tie = (av == thr) & nonzero
    quota = k - gt.sum(1, keepdim=True)
    mask = gt | (tie & (torch.cumsum(tie.to(torch.int64), 1) <= quota))
    nsel = mask.sum(1, keepdim=True).to(torch.float32)
    scale = torch.where(mask, av, 0.0).sum(1, keepdim=True) / nsel.clamp(
        min=1.0)
    sign = torch.where(tiles >= 0, 1.0, -1.0)
    return torch.where(mask, scale * sign, 0.0)


def consensus_step(w: np.ndarray, omega: float) -> float:
    """gamma* of Lemma 6 of the SPARQ-SGD paper from W's spectral gap
    delta, beta = ||W - I||_2 and the compressor's omega."""
    ev = np.sort(np.linalg.eigvalsh(w))[::-1]
    delta = 1.0 - max(abs(ev[1]), abs(ev[-1])) if len(ev) > 1 else 1.0
    beta = 1.0 - ev[-1]
    denom = (64 * delta + delta * delta + 16 * beta * beta
             + 8 * delta * beta * beta - 16 * delta * omega)
    return 2.0 * delta * omega / denom


class MixReading:
    """The mixing of a sync, read from what it did: per node and leaf, how
    far the change that the mixing made to x lies from
    ``gamma (W - I) x_hat`` of the new x_hat, worked out in float64 from a
    plain W and gamma, beyond one float32 spacing of x at each coordinate
    (what storing x in float32 may take from or add to the term), and the
    term's norm. Both sides read their own first sync so, each from its
    own x_hat (the x_hat itself is compared apart)."""

    def __init__(self, leaves: List[Leaf], D_pad: int, w: np.ndarray,
                 gamma: float, device) -> None:
        self.leaves, self.D_pad = leaves, D_pad
        n = w.shape[0]
        self.M = torch.tensor(gamma * (w - np.eye(n)), dtype=torch.float64,
                              device=device)
        self.dist2 = torch.zeros((n, len(leaves)), dtype=torch.float64,
                                 device=device)
        self.norm2 = torch.zeros_like(self.dist2)

    def chunks(self) -> Iterator[Tuple[Optional[int], slice]]:
        """Column blocks of a whole buffer, each inside one leaf (``None``:
        the padding past the last)."""
        for j, leaf in enumerate(self.leaves):
            end = leaf.offset + leaf.size
            for lo in range(leaf.offset, end, COLUMN_CHUNK):
                yield j, slice(lo, min(end, lo + COLUMN_CHUNK))
        last = self.leaves[-1]
        if last.offset + last.size < self.D_pad:
            yield None, slice(last.offset + last.size, self.D_pad)

    def add(self, j: int, before: torch.Tensor, after: torch.Tensor,
            x_hat: torch.Tensor) -> None:
        """x (float32) before and after the mixing, and the new x_hat, in a
        (n, c) block of leaf ``j``."""
        want = self.M @ x_hat.double()
        big = torch.maximum(before.abs(), after.abs())
        spacing = torch.nextafter(big, torch.full_like(big, math.inf)) - big
        excess = ((after - before).double() - want).abs() - spacing.double()
        self.dist2[:, j] += (excess.clamp(min=0.0) ** 2).sum(1)
        self.norm2[:, j] += (want * want).sum(1)

    def result(self) -> Tuple[List[List[float]], List[List[float]]]:
        return (self.dist2.sqrt().tolist(), self.norm2.sqrt().tolist())


def run(config: Dict[str, Any], workload: Dict[str, Any], seed: int,
        batches: Sequence[Dict[str, np.ndarray]], device,
        precision: str = "float32") -> Dict[str, Any]:
    """The first ``len(batches)`` steps from x^0 of ``seed`` on the
    (n, per_node, seq) ``batches``, by the configuration's engine, with
    float32 products run with TF32 off. Returns :func:`readings`."""
    engine = spec.module("engines", config["engine"]["reference"])
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return engine.run(config, workload, seed, batches, device, precision)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def readings(losses, grad0, change, xhat, bits, triggers, leaves, mix
             ) -> Dict[str, Any]:
    """The readings of a side, as the comparison takes them: per node and
    leaf a norm (``grad0``, ``change``, ``xhat``) and the sampled values
    (the same keys with ``_s``), and the first sync's mixing (``mix``: per
    node and leaf its distance, ``mix_norm`` the norm of the term it is
    held to)."""
    out = {"losses": list(losses), "bits": float(bits),
           "triggers": int(triggers),
           "leaves": [leaf.name for leaf in leaves],
           "mix": mix[0], "mix_norm": mix[1]}
    for key, per_node in (("grad0", grad0), ("change", change),
                          ("xhat", xhat)):
        out[key] = [norms for norms, _ in per_node]
        out[key + "_s"] = [samples for _, samples in per_node]
    return out
