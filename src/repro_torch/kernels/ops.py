"""Flat-vector wrappers around the blockwise SignTopK and QSGD kernels
(counterpart of ``repro/kernels/ops.py``).

They pad flat vectors to whole BLOCK=1024 tiles, the interface the engines
consume. Each reaches its kernel through
:func:`repro_torch.kernels.sign_topk.sign_topk_blocks` or
:func:`repro_torch.kernels.qsgd.qsgd_blocks`, which launch the CUDA kernel
for CUDA tensors and run the plain version for CPU tensors.

Payload contract: per tile the exact-k support has at most k_b nonzeros, so
a (vals, idx) payload of k_b entries per tile, gathered from the dense q in
``jax.lax.top_k`` order (descending |q|, lowest index first among equals),
rebuilds q exactly, ties and short tiles included.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.kernels import sign_topk as sign_topk_mod
from repro_torch.kernels.qsgd import qsgd_blocks
from repro_torch.kernels.sign_topk import BLOCK


def _to_blocks(x: torch.Tensor) -> Tuple[torch.Tensor, int, int]:
    d = x.shape[0]
    n = max(1, -(-d // BLOCK))
    return F.pad(x, (0, n * BLOCK - d)).reshape(n, BLOCK), d, n


def sign_topk(flat: torch.Tensor, k: int
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Blockwise SignTopK of a flat vector, k in all (ceil-split over the
    tiles). Returns (q (d,), vals (n*k_b,), idx (n*k_b,) global int32)."""
    xb, d, n = _to_blocks(flat)
    k_b = max(1, -(-k // n))
    # x_hat = 0: the ensemble mode computes the same q without a zero x_hat
    q, _, _ = sign_topk_mod.sign_topk_blocks(xb, None, 1.0, k_b)
    # every nonzero |q| of a tile is the tile's scale, so the payload order
    # is one tie broken by index: a stable descending sort gives top_k's
    order = torch.sort(q.to(torch.float32).abs(), dim=1, descending=True,
                       stable=True).indices[:, :k_b]
    vals = torch.gather(q, 1, order)
    gidx = (torch.arange(n, device=flat.device)[:, None] * BLOCK + order)
    return (q.reshape(-1)[:d], vals.reshape(-1),
            gidx.reshape(-1).to(torch.int32))


def trigger_compress_update(x_half: torch.Tensor, x_hat: torch.Tensor,
                            threshold: Union[float, torch.Tensor], k_b: int
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The fused sync compute for one flat vector:
    trig = [||x_half - x_hat||^2 > threshold]; q = trig * SignTopK_b(diff);
    x_hat_new = x_hat + q. Returns (q, x_hat_new, trig)."""
    xh, d, _ = _to_blocks(x_half)
    xe, _, _ = _to_blocks(x_hat)
    diff = (x_half - x_hat).to(torch.float32)
    trig = (torch.sum(diff * diff) > threshold).to(torch.float32)
    q, xe_new, _ = sign_topk_mod.sign_topk_blocks(xh, xe, trig, k_b)
    return q.reshape(-1)[:d], xe_new.reshape(-1)[:d], trig


def sign_topk_ensemble(diff: torch.Tensor, k_b: int) -> torch.Tensor:
    """One kernel launch over a whole node ensemble.

    diff: (n_nodes, d), one row per node's flat parameter difference. Each
    row is padded to whole tiles and nothing more (the reference also grows
    the tile count until its TPU grid divides; the extra tiles are zero and
    emit zero, so the result is the same). When d is already a whole number
    of tiles, as the flat-buffer engine's D_pad is, the rows are viewed in
    place: no copy, no zero x_hat, no x_hat_new. trig is 1; the caller gates
    q per node. Returns q: (n_nodes, d), same dtype as diff."""
    n, d = diff.shape
    nb = max(1, -(-d // BLOCK))
    if nb * BLOCK == d and diff.is_contiguous():
        xb = diff.view(n * nb, BLOCK)
    else:
        xb = F.pad(diff, (0, nb * BLOCK - d)).reshape(n * nb, BLOCK)
    q, _, _ = sign_topk_mod.sign_topk_blocks(xb, None, 1.0, k_b)
    q = q.view(n, nb * BLOCK)
    return q if nb * BLOCK == d else q[:, :d]


def qsgd(flat: torch.Tensor, key: torch.Tensor, s: int = 16) -> torch.Tensor:
    """Blockwise QSGD of a flat vector (``ops.py:108``): the noise is
    ``prng.uniform(key, (n_tiles, BLOCK))``, the reference's draw bit for
    bit, moved to ``flat``'s device."""
    xb, d, _ = _to_blocks(flat)
    u = prng.uniform(key, xb.shape).to(flat.device)
    return qsgd_blocks(xb, u, s).reshape(-1)[:d]
