"""Tensor parallelism over the ``model`` axis of a serve mesh: the products
of a model whose parameter and cache leaves each rank holds only its block
of (counterpart of what GSPMD inserts for ``repro/dist/serve.py``), and the
interface of the collectives the model code calls (:class:`Collectives`).

Every leaf is placed as the reference places it
(:func:`repro_torch.dist.sharding.param_specs`, ``cache_specs``): the
``model`` axis on a leaf's rightmost dimension that it divides, on the
expert dimension of the MoE leaves, on the vocab or d_model dimension of
the embedding. A rank's block of a dimension of length ``n`` is ``[rank *
n / size, (rank + 1) * n / size)``, as :func:`sharding.local_index` cuts
it.

The model code calls the functions here with ``tp=None`` in one process,
where each is the plain product, so the one-process numbers do not move.
With a :class:`TP`, a product's placement is read off the local block's
shape against the whole width the caller names:

* **output dimension split** (the common case under rightmost-fit: the
  attention and MLP projections, the SSM's ``w_in``/``w_out``, the LM head
  in ``vocab`` mode): the rank computes its column block and an all-gather
  along the last dimension rebuilds the activation, or, where the next
  operation runs per head, the block stays local (:meth:`TP.keeps_heads`);
* **contraction dimension split** (the LM head in ``dmodel`` mode, the MoE
  shared experts, whose leaves split on their dimension 1): the rank
  multiplies its slice of the input by its rows, and an all-reduce sums the
  partial products (in float32);
* **replicated** (no dimension divides): the plain product.

Small leaves (norm scales and biases, the router, the conv weights) are
gathered on use (:meth:`TP.whole`); a large matrix never is. The embedding
in ``vocab`` mode is a masked lookup of the rank's rows and an all-reduce
(one nonzero term per entry, so exact); in ``dmodel`` mode a lookup of the
rank's columns and an all-gather.

Why explicit collectives and not DTensor's propagation: the serve path
runs ops DTensor does not shard (the stable sort and ``index_put`` of the
routing, the in-place slot writes of the caches, the SSD scan's
``cumsum``), and under gloo on a card every collective has to be staged
through pinned host buffers (NCCL refuses two ranks on one card); one
:class:`repro_torch.dist.comm.GroupComm` does that for all of them, and
the placements stay the reference's specs, so ``local_index`` cuts and
checks every block.

The model package only names the :class:`Collectives` it needs; the
distribution layer (``repro_torch.dist``), which is built on the models,
hands in its ``GroupComm``, so imports run one way, from ``dist`` to
``models``.
"""
from __future__ import annotations

from typing import Optional, Protocol, Tuple

import torch

ROADMAP_ITEM = "ROADMAP.md A.13, tensor-parallel serve"


class Collectives(Protocol):
    """The collectives of one process group that the models call (the MoE
    routing's fsdp sums, the serve mesh's ``model`` axis): this process's
    ``rank`` in a group of ``size``."""

    rank: int
    size: int

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group (sum or max), a new tensor."""
        ...

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` joined along ``dim`` in rank order."""
        ...


class TP:
    """The ``model`` group of one serve rank: its collectives, its index
    and the size of the axis."""

    def __init__(self, comm: Collectives):
        self.comm = comm
        self.size, self.rank = comm.size, comm.rank

    # ----------------------------------------------------------- collectives
    def gather(self, t: torch.Tensor, dim: int = -1) -> torch.Tensor:
        """The ranks' blocks of ``t`` joined along ``dim`` in rank order."""
        return self.comm.all_gather(t, dim)

    def reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` summed (or maxed) over the ranks, in float32, cast back."""
        return self.comm.all_reduce(t.to(torch.float32), op).to(t.dtype)

    # ------------------------------------------------------------ placement
    def block(self, n: int) -> Tuple[int, int]:
        """This rank's range of a dimension of length ``n``."""
        step = n // self.size
        return self.rank * step, (self.rank + 1) * step

    def split(self, local: int, n: int, what: str) -> bool:
        """Whether a dimension of whole length ``n`` holds the rank's block
        (``local == n / size``) rather than the whole (``local == n``)."""
        if local == n:
            return False
        if local * self.size != n:
            raise ValueError(f"{what}: local length {local} is neither the "
                             f"whole {n} nor its block over {self.size} "
                             f"model ranks")
        return True

    def whole(self, w: torch.Tensor, n: int, dim: int = -1) -> torch.Tensor:
        """A small leaf (a norm scale or bias, the router, a conv weight)
        made whole along ``dim`` for one use."""
        if not self.split(w.shape[dim], n, "small leaf"):
            return w
        return self.gather(w, dim)

    def keeps_heads(self, *pairs: Tuple[torch.Tensor, int, int]) -> bool:
        """Whether every ``(weight, heads, head_width)`` is split by output
        columns into whole heads, so a per-head operation can run on the
        rank's heads with no gather."""
        for w, heads, width in pairs:
            if heads % self.size or not self.split(
                    w.shape[-1], heads * width, "per-head projection"):
                return False
        return True

    # ------------------------------------------------------------- products
    def matmul(self, x: torch.Tensor, w: torch.Tensor, n_out: int
               ) -> torch.Tensor:
        """The whole ``x @ W`` from the rank's block ``w`` of ``W`` (K,
        ``n_out``); ``x`` is whole."""
        if self.split(w.shape[-1], n_out, "output columns"):
            return self.gather(x @ w, -1)
        k = x.shape[-1]
        if self.split(w.shape[-2], k, "contraction rows"):
            lo, hi = self.block(k)
            return self.reduce(x[..., lo:hi] @ w)
        return x @ w

    def embed(self, table: torch.Tensor, tokens: torch.Tensor, vocab: int,
              d: int) -> torch.Tensor:
        """``table[tokens]`` of the whole ``(vocab, d)`` table from the
        rank's block."""
        rows = table.shape[0]
        if self.split(rows, vocab, "embedding rows"):
            local = tokens.to(torch.int64) - self.rank * rows
            inside = (local >= 0) & (local < rows)
            out = table[local.clamp(0, rows - 1)] * inside[..., None].to(
                table.dtype)
            return self.reduce(out)
        if self.split(table.shape[1], d, "embedding columns"):
            return self.gather(table[tokens], -1)
        return table[tokens]


def refuse(what: str) -> NotImplementedError:
    """The error for a placement the port does not run, naming the leaf."""
    return NotImplementedError(f"{what}: not ported ({ROADMAP_ITEM})")


# ------------------------------------------------ the model code's entries

def matmul(x: torch.Tensor, w: torch.Tensor, n_out: int,
           tp: Optional[TP]) -> torch.Tensor:
    """``x @ w`` in one process; the whole product from the rank's block
    with a ``tp``."""
    return x @ w if tp is None else tp.matmul(x, w, n_out)


def whole(w: torch.Tensor, n: int, tp: Optional[TP], dim: int = -1
          ) -> torch.Tensor:
    """A small leaf as it is in one process, made whole with a ``tp``."""
    return w if tp is None else tp.whole(w, n, dim)
