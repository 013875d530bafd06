"""Causal GQA attention for training (counterpart of the dense part of
``repro/models/attention.py``): the QKV projections with their bias and
per-head qk-norm, the memory-linear chunked attention, and the causal-parts
split.

``chunked_attention`` is plain PyTorch with the reference's numerics, not
``scaled_dot_product_attention``: scores and softmax weights in bfloat16,
row statistics and the output accumulator in float32, masked scores at
-3e38 in bfloat16 (``attention.py:108-131``), so that the two packages stay
comparable. Decode caches and MLA are not ported yet.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dtype_of, rms_norm_vec

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor):
    cd = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = x @ p["wq"].to(cd)
    k = x @ p["wk"].to(cd)
    v = x @ p["wv"].to(cd)
    if cfg.qkv_bias:
        q = q + p["bq"].to(cd)
        k = k + p["bk"].to(cd)
        v = v + p["bv"].to(cd)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, kv, hd)
    v = v.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q, k = rms_norm_vec(q), rms_norm_vec(k)
    return q, k, v


def _divisor_chunk(s: int, target: int) -> int:
    c = min(target, s)
    while s % c:
        c -= 1
    return c


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: torch.Tensor, k_pos: torch.Tensor,
                      window: Optional[int] = None, q_chunk: int = 1024,
                      k_chunk: int = 2048,
                      score_dtype: torch.dtype = torch.bfloat16
                      ) -> torch.Tensor:
    """Memory-linear causal attention with a running softmax.

    q: (B, Sq, H, hd); k: (B, Sk, Hkv, hd); v: (B, Sk, Hkv, hdv); H a
    multiple of Hkv. Mask: k_pos <= q_pos (and > q_pos - window). Returns
    (B, Sq, H, hdv) in q's dtype. A product the reference asks for in
    bfloat16 is taken in float32 and rounded once; one it asks for in
    float32 is taken in float32 on the bfloat16-rounded operands."""
    b, sq, h, hd = q.shape
    _, sk, hkv, hdv = v.shape
    g = h // hkv
    qc, kc = _divisor_chunk(sq, q_chunk), _divisor_chunk(sk, k_chunk)
    nq, nk = sq // qc, sk // kc
    f32 = torch.float32
    # the reference multiplies by the scale rounded to the score dtype
    scale = float(torch.tensor(1.0 / math.sqrt(hd), dtype=score_dtype))
    neg = torch.tensor(-3e38 if score_dtype == torch.bfloat16 else NEG_INF,
                       dtype=score_dtype, device=q.device)

    qg = q.reshape(b, nq, qc, hkv, g, hd).to(score_dtype)
    kg = k.reshape(b, nk, kc, hkv, hd).to(score_dtype)
    vg = v.reshape(b, nk, kc, hkv, hdv).to(score_dtype).to(f32)
    qp = q_pos.reshape(nq, qc)
    kp = k_pos.reshape(nk, kc)
    outs = []
    for qi in range(nq):
        m = torch.full((b, qc, hkv, g), NEG_INF, dtype=f32, device=q.device)
        l = torch.zeros((b, qc, hkv, g), dtype=f32, device=q.device)
        acc = torch.zeros((b, qc, hkv, g, hdv), dtype=f32, device=q.device)
        qpos = qp[qi][None, :, None, None, None]
        for ki in range(nk):
            s = torch.einsum("bqhgd,bkhd->bqhgk", qg[:, qi],
                             kg[:, ki]) * scale
            kpos = kp[ki][None, None, None, None, :]
            mask = (kpos <= qpos) & (kpos >= 0)
            if window is not None:
                mask = mask & (kpos > qpos - window)
            s = torch.where(mask, s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1).to(f32))
            p = torch.exp(s - m_new[..., None].to(score_dtype))
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1, dtype=f32)
            acc = acc * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(f32), vg[:, ki])
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=1).reshape(b, sq, h, hdv)
    return out.to(q.dtype)


def causal_parts_attention(cfg: ModelConfig, q, k, v, positions):
    """Causal attention in P query parts, part i attending only its kv
    prefix [0, (i+1)S/P); one part when S does not split."""
    P = cfg.causal_parts
    s = q.shape[1]
    if P <= 1 or s % P or s // P < 128:
        return chunked_attention(q, k, v, positions, positions,
                                 window=cfg.sliding_window)
    part = s // P
    outs = []
    for i in range(P):
        kv_end = (i + 1) * part
        outs.append(chunked_attention(
            q[:, i * part:kv_end], k[:, :kv_end], v[:, :kv_end],
            positions[i * part:kv_end], positions[:kv_end],
            window=cfg.sliding_window))
    return torch.cat(outs, dim=1)


def attention_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                      positions: torch.Tensor) -> torch.Tensor:
    """Training path. x: (B, S, D); positions: (S,)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x)
    q = apply_rope(q, positions[None, :], cfg.rope_pct, cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_pct, cfg.rope_theta)
    out = causal_parts_attention(cfg, q, k, v, positions)
    cd = dtype_of(cfg.compute_dtype)
    return out.reshape(b, s, -1) @ p["wo"].to(cd)
