"""Attention (counterpart of ``repro/models/attention.py``): causal GQA
with its QKV bias and per-head qk-norm, the memory-linear chunked attention
and the causal-parts split for training and prefill; the cached one-token
decode; and DeepSeek-V3's MLA (latent attention) with its absorbed decode.

``chunked_attention`` is plain PyTorch with the reference's numerics, not
``scaled_dot_product_attention``: scores and softmax weights in bfloat16,
row statistics and the output accumulator in float32, masked scores at
-3e38 in bfloat16 (``attention.py:108-131``), so that the two packages stay
comparable. The decode paths score in float32 and mask at ``NEG_INF``
(``attention.py:218-224``), as the reference's.

Caches carry absolute positions (-1 for an empty slot), so full-window and
sliding-window decode share one path: the new token goes to slot ``pos %
C``, a ring buffer when C is the window. Decode writes the cache in place
(one slot per layer) and returns the same tensors, which then hold what the
reference's functional update returns.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

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


# ------------------------------------------------------------------ KV cache

def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  n_layers: Optional[int] = None,
                  device: torch.device | str = "cpu") -> Params:
    """``k``, ``v``: (L, B, C, Hkv, hd) in the compute dtype, zero; ``pos``:
    (L, C) int32, -1."""
    kv, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    L = cfg.n_layers if n_layers is None else n_layers
    cd = dtype_of(cfg.compute_dtype)
    return {
        "k": torch.zeros((L, batch, cache_len, kv, hd), dtype=cd,
                         device=device),
        "v": torch.zeros((L, batch, cache_len, kv, hd), dtype=cd,
                         device=device),
        "pos": torch.full((L, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def _write_slot(pos: int, caches, news) -> int:
    """Write each new (B, 1, ...) entry and the position at slot ``pos %
    C`` in place; returns the slot."""
    slot = pos % caches[0].shape[1]
    for cache, new in zip(caches, news, strict=True):
        cache[:, slot] = new[:, 0]
    return slot


def _valid(cfg: ModelConfig, cache_pos: torch.Tensor, pos: int
           ) -> torch.Tensor:
    valid = (cache_pos >= 0) & (cache_pos <= pos)
    if cfg.sliding_window is not None:
        valid = valid & (cache_pos > pos - cfg.sliding_window)
    return valid


def decode_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cache_pos: torch.Tensor, pos: int
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One-token decode. x: (B, 1, D); cache_k/v: (B, C, Hkv, hd);
    cache_pos: (C,); pos: the new token's absolute position. Every one of
    the C slots is scored; the empty and out-of-window ones are masked."""
    pos = int(pos)
    b = x.shape[0]
    q, k, v = _qkv(cfg, p, x)
    pos_arr = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_pct, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_pct, cfg.rope_theta)
    slot = _write_slot(pos, (cache_k, cache_v), (k, v))
    cache_pos[slot] = pos

    h, kv_h, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    f32 = torch.float32
    qg = q.reshape(b, kv_h, h // kv_h, hd)
    s = torch.einsum("bhgd,bchd->bhgc", qg.to(f32),
                     cache_k.to(f32)) / math.sqrt(hd)
    s = torch.where(_valid(cfg, cache_pos, pos)[None, None, None, :], s,
                    NEG_INF)
    a = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgc,bchd->bhgd", a, cache_v.to(f32))
    cd = dtype_of(cfg.compute_dtype)
    o = o.reshape(b, 1, h * hd).to(cd) @ p["wo"].to(cd)
    return o, (cache_k, cache_v, cache_pos)


# ------------------------------------------------------ MLA (DeepSeek-V3)

# the reference's init_mla draws leaf i from split(key, 8)[i]
MLA_KEY_INDEX = {"w_dkv": 0, "w_kr": 1, "w_uk": 2, "w_uv": 3, "wo": 4,
                 "w_dq": 5, "w_uq": 6, "w_q": 7}


def mla_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """One MLA block's leaves and shapes (the reference's ``init_mla``):
    ``w_dq``/``w_uq`` with a ``q_lora_rank``, else a full-rank ``w_q``."""
    d, h = cfg.d_model, cfg.n_heads
    r, dr, dn, dv = (cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.qk_nope_dim,
                     cfg.v_head_dim)
    out = {"w_dkv": (d, r), "w_kr": (d, dr), "w_uk": (r, h * dn),
           "w_uv": (r, h * dv), "wo": (h * dv, d)}
    if cfg.q_lora_rank:
        out.update(w_dq=(d, cfg.q_lora_rank),
                   w_uq=(cfg.q_lora_rank, h * (dn + dr)))
    else:
        out["w_q"] = (d, h * (dn + dr))
    return out


def _mla_q(cfg: ModelConfig, p: Params, x: torch.Tensor):
    cd = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        q = (x @ p["w_dq"].to(cd)) @ p["w_uq"].to(cd)
    else:
        q = x @ p["w_q"].to(cd)
    q = q.reshape(b, s, h, dn + dr)
    return q[..., :dn], q[..., dn:]


def mla_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    """Training and prefill: the latent expanded into per-head keys
    (``dn + dr`` wide, the rope part shared by the heads) and values
    (``dv`` wide), then the chunked attention, scaled by
    ``1/sqrt(dn + dr)``."""
    cd = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    q_nope, q_rope = _mla_q(cfg, p, x)
    q_rope = apply_rope(q_rope, positions[None, :], 1.0, cfg.rope_theta)
    c_kv = x @ p["w_dkv"].to(cd)                                  # (B,S,r)
    k_rope = (x @ p["w_kr"].to(cd)).reshape(b, s, 1, dr)
    k_rope = apply_rope(k_rope, positions[None, :], 1.0, cfg.rope_theta)
    k_nope = (c_kv @ p["w_uk"].to(cd)).reshape(b, s, h, dn)
    v = (c_kv @ p["w_uv"].to(cd)).reshape(b, s, h, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, dr)], dim=-1)
    out = causal_parts_attention(cfg, q, k, v, positions)
    return out.reshape(b, s, -1) @ p["wo"].to(cd)


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   n_layers: Optional[int] = None,
                   device: torch.device | str = "cpu") -> Params:
    """The compressed cache: ``ckv`` (L, B, C, r) and ``kr`` (L, B, C, dr)
    in the compute dtype, zero; ``pos`` (L, C) int32, -1."""
    L = cfg.n_layers if n_layers is None else n_layers
    cd = dtype_of(cfg.compute_dtype)
    return {
        "ckv": torch.zeros((L, batch, cache_len, cfg.kv_lora_rank),
                           dtype=cd, device=device),
        "kr": torch.zeros((L, batch, cache_len, cfg.qk_rope_dim), dtype=cd,
                          device=device),
        "pos": torch.full((L, cache_len), -1, dtype=torch.int32,
                          device=device),
    }


def mla_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
               cache_ckv: torch.Tensor, cache_kr: torch.Tensor,
               cache_pos: torch.Tensor, pos: int):
    """Absorbed MLA decode: the per-head up-projections are folded into the
    query (``q_lat``) and the output (``o_lat``), so attention runs in the
    r-wide latent space and the cache stays compressed. x: (B, 1, D);
    cache_ckv: (B, C, r); cache_kr: (B, C, dr). The two absorption products
    the reference takes in the compute dtype are taken in float32 and
    rounded once."""
    pos = int(pos)
    cd = dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    b = x.shape[0]
    h, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    q_nope, q_rope = _mla_q(cfg, p, x)                        # (B,1,H,dn/dr)
    pos_arr = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, pos_arr, 1.0, cfg.rope_theta)
    ckv_new = x @ p["w_dkv"].to(cd)                           # (B,1,r)
    kr_new = (x @ p["w_kr"].to(cd)).reshape(b, 1, 1, dr)
    kr_new = apply_rope(kr_new, pos_arr, 1.0, cfg.rope_theta)[:, :, 0]
    slot = _write_slot(pos, (cache_ckv, cache_kr), (ckv_new, kr_new))
    cache_pos[slot] = pos

    w_uk = p["w_uk"].to(cd).reshape(r, h, dn)
    # q_lat[b,h,r] = sum_dn q_nope[b,h,dn] * w_uk[r,h,dn]
    q_lat = torch.einsum("bhd,rhd->bhr", q_nope[:, 0].to(f32),
                         w_uk.to(f32)).to(cd)
    s_lat = torch.einsum("bhr,bcr->bhc", q_lat.to(f32), cache_ckv.to(f32))
    s_rope = torch.einsum("bhd,bcd->bhc", q_rope[:, 0].to(f32),
                          cache_kr.to(f32))
    s = (s_lat + s_rope) / math.sqrt(dn + dr)
    s = torch.where(_valid(cfg, cache_pos, pos)[None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1)
    o_lat = torch.einsum("bhc,bcr->bhr", a, cache_ckv.to(f32))   # (B,H,r)
    w_uv = p["w_uv"].to(cd).reshape(r, h, dv)
    o = torch.einsum("bhr,rhd->bhd", o_lat.to(cd).to(f32),
                     w_uv.to(f32)).to(cd)
    o = o.reshape(b, 1, h * dv) @ p["wo"].to(cd)
    return o, (cache_ckv, cache_kr, cache_pos)
