"""Compression operators (Definition 1 of the paper; counterpart of
``repro/core/compression.py``).

A compression operator C satisfies, for some omega in (0, 1]:
``E_C ||x - C(x)||^2 <= (1 - omega) ||x||^2`` and ``C(0) = 0``.

Ported so far: the ``Compressor`` base, ``TopFrac``'s payload and omega
(``_k``, ``omega``, ``bits``) and ``BlockTopFrac``, the blockwise exact-k
SignTopK that the flat-buffer engine's kernel path runs. Applying
``TopFrac`` itself and the rest of the registry (TopK, RandK, Sign, QSGD,
SignTopK, QsTopK) are not ported yet (ROADMAP.md, "Compressors").
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.core import bits as bits_mod
from repro_torch.kernels.sign_topk import BLOCK, _block_compress


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class. Subclasses implement __call__(x, generator) and omega(d)."""

    name: str = "identity"

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        return x

    def omega(self, d: int) -> float:
        return 1.0

    def bits(self, d: int) -> float:
        """Bits transmitted for one compressed d-dim message."""
        return 32.0 * d


@dataclasses.dataclass(frozen=True)
class TopFrac(Compressor):
    """SignTopK with k = ceil(frac * d) over the whole flat vector."""

    frac: float = 0.1
    name: str = "signtop_frac"

    def __post_init__(self):
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"TopFrac needs 0 < frac <= 1, got {self.frac!r}")

    def _k(self, d: int) -> int:
        return max(1, int(math.ceil(self.frac * d)))

    def omega(self, d: int) -> float:
        # isotropic proxy k/d, capped at the 2/pi retention of full sign
        # quantization (the reference's reasoning, compression.py:271-279)
        return min(self._k(d) / d, 2.0 / math.pi)

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        raise NotImplementedError(
            "the global TopFrac operator is not ported yet (ROADMAP.md, "
            "compressors); the flat-buffer engine runs BlockTopFrac through "
            "use_kernel=True")

    def bits(self, d: int) -> float:
        return bits_mod.signtopk_bits(d, self._k(d))


@dataclasses.dataclass(frozen=True)
class BlockTopFrac(TopFrac):
    """Blockwise exact-k SignTopK over BLOCK=1024 tiles: the kernel seam.

    The flat vector is zero-padded to whole tiles and each tile keeps its own
    k_b = ceil(frac * BLOCK) support with a per-tile scale, the math of
    ``_block_compress``, so one ``ops.sign_topk_ensemble`` launch over an
    (n, D_pad) buffer equals applying this operator row by row. Padding
    emits nothing. Deterministic."""

    name: str = "signtopk_block"

    def _k_b(self) -> int:
        return max(1, min(BLOCK, int(math.ceil(self.frac * BLOCK))))

    def __call__(self, x: torch.Tensor,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
        d = x.shape[-1]
        nb = max(1, -(-d // BLOCK))
        xp = F.pad(x, (0, nb * BLOCK - d)).reshape(nb, BLOCK)
        q, _ = _block_compress(xp.to(torch.float32), 1.0, self._k_b())
        return q.to(x.dtype).reshape(-1)[:d]

    def omega(self, d: int) -> float:
        return min(self._k_b() / BLOCK, 2.0 / math.pi)

    def bits(self, d: int) -> float:
        # per tile: k_b sign bits and indices, plus the shared scale
        nb = max(1, -(-int(d) // BLOCK))
        return nb * bits_mod.signtopk_bits(BLOCK, self._k_b())
