"""Shared layers: norms, RoPE, MLPs, embeddings (counterpart of
``repro/models/layers.py``). Plain functions over dicts of tensors; the
numerics (casts to the compute dtype, float32 norms and RoPE angles) follow
the reference step by step so the two can be compared.

Initialization draws from the reference's threefry keys
(:mod:`repro_torch.core.prng`): the same uniform bits, and values within a
few ulps of the reference's (its ``erfinv`` is XLA's polynomial, rounded
per operation here).

Each layer takes an optional ``tp`` (:class:`repro_torch.models.parallel.TP`):
with it the parameters are the rank's blocks over a serve mesh's ``model``
axis, the activations stay whole, and every product goes through
:mod:`repro_torch.models.parallel`; without it (one process) nothing changes.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.models import parallel as tpm
from repro_torch.models.config import ModelConfig

Params = Dict[str, torch.Tensor]


def dtype_of(name: str) -> torch.dtype:
    """torch dtype of a config dtype name (``"float32"``, ``"bfloat16"``)."""
    return getattr(torch, name)


def dense_init(key: torch.Tensor, shape: Tuple[int, ...],
               dtype: torch.dtype, scale: float = 0.02,
               out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``(scale * truncated_normal(key, -2, 2, shape)).astype(dtype)``, on
    the key's device, or written into ``out`` (any float dtype, e.g. a view
    of a flat float32 buffer) on its device."""
    if out is not None and out.dtype == torch.float32 == dtype:
        return prng.truncated_normal(key, -2.0, 2.0, shape, out=out).mul_(
            scale)
    dev = key.device if out is None else out.device
    t = prng.truncated_normal(key, -2.0, 2.0, shape,
                              out=torch.empty(shape, device=dev))
    t = t.mul_(scale).to(dtype)
    return t if out is None else out.copy_(t)


# ---------------------------------------------------------------- norms

def apply_norm(cfg: ModelConfig, p: Params, x: torch.Tensor,
               tp: Optional[tpm.TP] = None) -> torch.Tensor:
    eps = cfg.norm_eps
    xf = x.to(torch.float32)
    d = x.shape[-1]
    scale = tpm.whole(p["scale"], d, tp).to(torch.float32)
    if cfg.norm == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * scale + tpm.whole(p["bias"], d, tp).to(torch.float32)
    else:
        ms = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(ms + eps) * scale
    return y.to(x.dtype)


def rms_norm_vec(x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Scale-free RMS norm over the last dim, in float32 and cast back
    (chameleon's per-head qk-norm)."""
    xf = x.to(torch.float32)
    ms = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(ms + eps)).to(x.dtype)


# ---------------------------------------------------------------- rope

def rope_frequencies(head_dim: int, rope_pct: float, theta: float,
                     device: torch.device) -> Tuple[torch.Tensor, int]:
    rot = int(head_dim * rope_pct)
    rot -= rot % 2
    exps = torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot
    return 1.0 / (theta ** exps), rot


def apply_rope(x: torch.Tensor, positions: torch.Tensor, rope_pct: float,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, hd); positions: (..., S) int."""
    inv, rot = rope_frequencies(x.shape[-1], rope_pct, theta, x.device)
    if rot == 0:
        return x
    ang = positions[..., :, None].to(torch.float32) * inv   # (..., S, rot/2)
    cos = torch.cos(ang)[..., :, None, :]
    sin = torch.sin(ang)[..., :, None, :]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape)
    return torch.cat([yr.to(x.dtype), xp], dim=-1)


# ---------------------------------------------------------------- mlp

def apply_mlp(cfg: ModelConfig, p: Params, x: torch.Tensor,
              tp: Optional[tpm.TP] = None) -> torch.Tensor:
    """With a ``tp`` whose ``w_in`` (and ``w_gate``) are split by output
    columns, the hidden's column block is activated on its rank and
    gathered once."""
    cd = dtype_of(cfg.compute_dtype)
    x = x.to(cd)
    f, d = cfg.d_ff, x.shape[-1]
    ins = [p[k] for k in ("w_gate", "w_in") if k in p]
    local = tp is not None and all(tp.split(w.shape[-1], f, "mlp")
                                   for w in ins)

    def up(w):
        w = w.to(cd)
        return x @ w if local else tpm.matmul(x, w, f, tp)
    if cfg.act == "swiglu":
        h = F.silu(up(p["w_gate"])) * up(p["w_in"])
    elif cfg.act == "relu2":
        h = torch.square(F.relu(up(p["w_in"])))
    else:
        h = F.gelu(up(p["w_in"]), approximate="tanh")
    if local:
        h = tp.gather(h, -1)
    return tpm.matmul(h, p["w_out"].to(cd), d, tp)


# ---------------------------------------------------------------- embeddings

def embed_tokens(cfg: ModelConfig, p: Params, tokens: torch.Tensor,
                 tp: Optional[tpm.TP] = None) -> torch.Tensor:
    # the whole table is cast before the gather, as in the reference, so the
    # backward accumulates repeated tokens in the compute dtype too
    table = p["embedding"].to(dtype_of(cfg.compute_dtype))
    if tp is None:
        return table[tokens]
    return tp.embed(table, tokens, cfg.vocab_size, cfg.d_model)


def lm_logits(cfg: ModelConfig, p: Params, h: torch.Tensor,
              tp: Optional[tpm.TP] = None) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    return tpm.matmul(h, w.to(cd), cfg.vocab_size, tp)
