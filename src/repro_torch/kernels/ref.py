"""Plain PyTorch oracles for the port's kernels (counterpart of
``repro/kernels/ref.py``).

Semantics are the blockwise operators: inputs are processed in tiles of
``block`` elements, and Top-k selection, scales and thresholds are per tile.
Ties at the threshold keep the lowest-index elements, like
``jax.lax.top_k``; here a stable descending sort gives that order, because
``torch.topk`` promises none.
"""
from __future__ import annotations

from typing import Tuple, Union

import torch
import torch.nn.functional as F

BLOCK = 1024  # elements per tile


def pad_to_blocks(x: torch.Tensor, block: int = BLOCK
                  ) -> Tuple[torch.Tensor, int]:
    """Zero-pad a flat vector to whole tiles: (padded, n_tiles)."""
    d = x.shape[0]
    n = -(-d // block)
    return F.pad(x, (0, n * block - d)), n


def sqdiff_partials_ref(x: torch.Tensor, y: torch.Tensor, block: int = BLOCK
                        ) -> torch.Tensor:
    """Per-block partial sums of (x-y)^2. x, y: (n*block,). -> (n,) f32."""
    n = x.shape[0] // block
    d = (x.to(torch.float32) - y.to(torch.float32)).reshape(n, block)
    return torch.sum(d * d, dim=1)


def sign_topk_ref(x_half: torch.Tensor, x_hat: torch.Tensor,
                  trig: Union[float, torch.Tensor], k_b: int,
                  block: int = BLOCK
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                             torch.Tensor]:
    """Fused blockwise exact-k SignTopK of diff = x_half - x_hat, gated by
    trig: the support is the first k_b indices of a stable descending sort
    of |diff| (top_k's index set) restricted to nonzero lanes. Returns
    (q, x_hat_new, vals (n, k_b), idx (n, k_b) block-local int32)."""
    n = x_half.shape[0] // block
    diff = (x_half.to(torch.float32)
            - x_hat.to(torch.float32)).reshape(n, block)
    av = diff.abs()
    pos = av > 0.0
    top_vals, top_idx = torch.sort(av, dim=1, descending=True, stable=True)
    top_idx = top_idx[:, :k_b]
    thr = top_vals[:, k_b - 1:k_b]
    gt = (av > thr) & pos
    tie = (av >= thr) & ~gt & pos
    quota = k_b - gt.sum(dim=1, keepdim=True, dtype=torch.int32)
    rank = torch.cumsum(tie.to(torch.int32), dim=1, dtype=torch.int32)
    mask = gt | (tie & (rank <= quota))
    nsel = mask.sum(dim=1, keepdim=True, dtype=torch.float32)
    scale = (torch.where(mask, av, 0.0).sum(dim=1, keepdim=True)
             / torch.clamp(nsel, min=1.0))
    signs = torch.where(diff >= 0, 1.0, -1.0)
    t = torch.as_tensor(trig, dtype=torch.float32, device=diff.device)
    q = torch.where(mask, t * scale * signs, 0.0).to(x_half.dtype)
    x_hat_new = x_hat + q.reshape(-1)
    vals = torch.gather(q, 1, top_idx)
    return q.reshape(-1), x_hat_new, vals, top_idx.to(torch.int32)


def qsgd_ref(x: torch.Tensor, u: torch.Tensor, s: int, block: int = BLOCK
             ) -> torch.Tensor:
    """Blockwise QSGD with s levels (``ref.py:74``); u: uniform [0, 1)
    noise of x's shape. Per block: norm = ||x_b||; |x|/norm * s rounded
    stochastically; out = norm * sign(x) * level / s (unbiased)."""
    n = x.shape[0] // block
    xb = x.reshape(n, block).to(torch.float32)
    ub = u.reshape(n, block).to(torch.float32)
    norm = torch.sqrt(torch.sum(xb * xb, dim=1, keepdim=True))
    safe = torch.where(norm > 0, norm, 1.0)
    level = xb.abs() / safe * s
    low = torch.floor(level)
    q = (low + (ub < (level - low)).to(torch.float32)) / s
    out = norm * torch.sign(xb) * q
    return out.reshape(-1).to(x.dtype)
