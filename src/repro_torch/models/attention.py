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

With a ``tp`` (:mod:`repro_torch.models.parallel`) the weights and the cache are
the rank's blocks over the ``model`` axis. Where ``wq``/``wk``/``wv`` (MLA:
``w_uq``/``w_q``, ``w_uk``, ``w_uv``) split into whole heads, each rank
attends over its own heads and the head outputs are gathered before
``wo``; otherwise q, k and v are made whole. A decode cache is read as
``cache_specs`` placed it: its kv heads split (the rank's heads against
its cache shard), its slots split (each rank scores its slots and the
partial softmaxes are combined by log-sum-exp: an all-reduce of the max,
then of the sums and of the weighted values), or MLA's latent split (the
scores a partial sum over the latent, all-reduced; the latent-weighted
values gathered before ``w_uv``).
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from repro_torch.device import resolve_or_meta
from repro_torch.models import parallel as tpm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_rope, dtype_of, rms_norm_vec

Params = Dict[str, torch.Tensor]

NEG_INF = -1e30


def _qkv(cfg: ModelConfig, p: Params, x: torch.Tensor,
         tp: Optional[tpm.TP] = None, local: bool = False):
    """q (B, S, H, hd), k and v (B, S, Hkv, hd); with ``local`` (a ``tp``
    whose projections split into whole heads) the rank's heads only."""
    cd = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    outs = []
    for w, bias, n in (("wq", "bq", h), ("wk", "bk", kv), ("wv", "bv", kv)):
        if local:
            y = x @ p[w].to(cd)
            if cfg.qkv_bias:
                y = y + p[bias].to(cd)
            outs.append(y.reshape(b, s, n // tp.size, hd))
            continue
        y = tpm.matmul(x, p[w].to(cd), n * hd, tp)
        if cfg.qkv_bias:
            y = y + tpm.whole(p[bias], n * hd, tp).to(cd)
        outs.append(y.reshape(b, s, n, hd))
    q, k, v = outs
    if cfg.qk_norm:
        q, k = rms_norm_vec(q), rms_norm_vec(k)
    return q, k, v


def _heads_local(cfg: ModelConfig, p: Params, tp: Optional[tpm.TP]
                 ) -> bool:
    """Whether q, k and v can stay as the rank's whole heads."""
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    return tp is not None and tp.keeps_heads(
        (p["wq"], h, hd), (p["wk"], kv, hd), (p["wv"], kv, hd))


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
                      positions: torch.Tensor,
                      tp: Optional[tpm.TP] = None) -> torch.Tensor:
    """Training path. x: (B, S, D); positions: (S,)."""
    b, s, d = x.shape
    local = _heads_local(cfg, p, tp)
    q, k, v = _qkv(cfg, p, x, tp, local)
    q = apply_rope(q, positions[None, :], cfg.rope_pct, cfg.rope_theta)
    k = apply_rope(k, positions[None, :], cfg.rope_pct, cfg.rope_theta)
    out = causal_parts_attention(cfg, q, k, v, positions).reshape(b, s, -1)
    if local:
        out = tp.gather(out, -1)
    cd = dtype_of(cfg.compute_dtype)
    return tpm.matmul(out, p["wo"].to(cd), d, tp)


# ------------------------------------------------------------------ KV cache

def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  n_layers: Optional[int] = None,
                  device: torch.device | str | None = "cuda") -> Params:
    """``k``, ``v``: (L, B, C, Hkv, hd) in the compute dtype, zero; ``pos``:
    (L, C) int32, -1; on the card unless ``device`` names another."""
    device = resolve_or_meta(device)
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


def _cache_split(tp: Optional[tpm.TP], local: torch.Tensor,
                 whole: Tuple[int, ...], inner: Tuple[str, ...],
                 name: str) -> Optional[str]:
    """Where a decode cache layer's ``model`` axis falls, read off its
    block ``local`` (B, C, ...) against the whole ``(C, ...)``: on one of
    the ``inner`` dims (returned by name), on the slots (``"slots"``), or
    nowhere (None). A placement the port does not run raises."""
    if tp is None:
        return None
    got = tuple(local.shape[1:])
    for d, (g, w) in enumerate(zip(got, whole, strict=True)):
        if not tp.split(g, w, name):
            continue
        if d == 0:
            return "slots"
        if d <= len(inner):
            return inner[d - 1]
        raise tpm.refuse(f"{name} with model on its dimension {d + 2} "
                         f"(whole {w})")
    return None


def _lse(s: torch.Tensor, weighted, tp: tpm.TP) -> torch.Tensor:
    """softmax(s) applied by ``weighted`` over slots split across the
    ranks: the partial softmaxes combined by log-sum-exp (an all-reduce of
    the max, then of the sums and of the weighted values)."""
    m = tp.reduce(s.amax(dim=-1, keepdim=True), "max")
    e = torch.exp(s - m)
    total = tp.reduce(e.sum(dim=-1, keepdim=True))
    return tp.reduce(weighted(e)) / total


def _write_owned(tp: tpm.TP, pos: int, whole_len: int, caches, news
                 ) -> None:
    """Write the new entries at slot ``pos % whole_len`` into the caches'
    slot blocks, on the rank whose block holds it."""
    slot = pos % whole_len
    c_loc = caches[0].shape[1]
    if slot // c_loc == tp.rank:
        for cache, new in zip(caches, news, strict=True):
            cache[:, slot - tp.rank * c_loc] = new[:, 0]


def decode_attention(cfg: ModelConfig, p: Params, x: torch.Tensor,
                     cache_k: torch.Tensor, cache_v: torch.Tensor,
                     cache_pos: torch.Tensor, pos: int,
                     tp: Optional[tpm.TP] = None
                     ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, ...]]:
    """One-token decode. x: (B, 1, D); cache_k/v: (B, C, Hkv, hd);
    cache_pos: (C,); pos: the new token's absolute position. Every one of
    the C slots is scored; the empty and out-of-window ones are masked.
    With a ``tp`` the caches are the rank's blocks (kv heads, slots, or
    every head's block of ``hd``, as ``cache_specs`` puts ``model`` on
    head_dim where it does not divide the kv heads) and ``cache_pos`` is
    whole. Split over head_dim, q, k and v are made whole, the rank keeps
    its block of k and v, the scores are its partial sums all-reduced, and
    the values' blocks are gathered after the softmax."""
    pos = int(pos)
    b, _, d = x.shape
    h, kv_h, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    C = cache_pos.shape[-1]
    split = _cache_split(tp, cache_k, (C, kv_h, hd), ("heads", "head_dim"),
                         "kv cache")
    local = split == "heads"
    if local and not _heads_local(cfg, p, tp):
        raise tpm.refuse("a kv cache split by heads with wq/wk/wv not "
                         "split into whole heads")
    q, k, v = _qkv(cfg, p, x, tp, local)
    pos_arr = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, pos_arr, cfg.rope_pct, cfg.rope_theta)
    k = apply_rope(k, pos_arr, cfg.rope_pct, cfg.rope_theta)
    if split == "head_dim":
        lo_d, hi_d = tp.block(hd)
        q, k, v = q[..., lo_d:hi_d], k[..., lo_d:hi_d], v[..., lo_d:hi_d]
    if split == "slots":
        _write_owned(tp, pos, C, (cache_k, cache_v), (k, v))
        cache_pos[pos % C] = pos
        lo = tp.rank * cache_k.shape[1]
        valid = _valid(cfg, cache_pos, pos)[lo:lo + cache_k.shape[1]]
    else:
        slot = _write_slot(pos, (cache_k, cache_v), (k, v))
        cache_pos[slot] = pos
        valid = _valid(cfg, cache_pos, pos)

    hl, kvl = q.shape[2], k.shape[2]
    f32 = torch.float32
    qg = q.reshape(b, kvl, hl // kvl, q.shape[-1])
    s = torch.einsum("bhgd,bchd->bhgc", qg.to(f32), cache_k.to(f32))
    if split == "head_dim":
        s = tp.reduce(s)
    s = s / math.sqrt(hd)
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    if split == "slots":
        o = _lse(s, lambda e: torch.einsum("bhgc,bchd->bhgd", e,
                                           cache_v.to(f32)), tp)
    else:
        a = torch.softmax(s, dim=-1)
        o = torch.einsum("bhgc,bchd->bhgd", a, cache_v.to(f32))
    if split == "head_dim":
        o = tp.gather(o, -1)
    cd = dtype_of(cfg.compute_dtype)
    o = o.reshape(b, 1, hl * hd).to(cd)
    if local:
        o = tp.gather(o, -1)
    o = tpm.matmul(o, p["wo"].to(cd), d, tp)
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


def _mla_q(cfg: ModelConfig, p: Params, x: torch.Tensor,
           tp: Optional[tpm.TP] = None, local: bool = False):
    """q's no-rope and rope parts (B, S, H, dn / dr); with ``local`` the
    rank's heads only."""
    cd = dtype_of(cfg.compute_dtype)
    b, s, _ = x.shape
    h, dn, dr = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim
    if cfg.q_lora_rank:
        x = tpm.matmul(x, p["w_dq"].to(cd), cfg.q_lora_rank, tp)
        w = p["w_uq"]
    else:
        w = p["w_q"]
    if local:
        q = (x @ w.to(cd)).reshape(b, s, h // tp.size, dn + dr)
    else:
        q = tpm.matmul(x, w.to(cd), h * (dn + dr), tp).reshape(b, s, h,
                                                               dn + dr)
    return q[..., :dn], q[..., dn:]


def _mla_heads_local(cfg: ModelConfig, p: Params, tp: Optional[tpm.TP]
                     ) -> bool:
    """Whether MLA's per-head up-projections split into whole heads."""
    h, dn, dr, dv = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                     cfg.v_head_dim)
    wq = p["w_uq"] if cfg.q_lora_rank else p["w_q"]
    return tp is not None and tp.keeps_heads(
        (wq, h, dn + dr), (p["w_uk"], h, dn), (p["w_uv"], h, dv))


def mla_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor,
                tp: Optional[tpm.TP] = None) -> torch.Tensor:
    """Training and prefill: the latent expanded into per-head keys
    (``dn + dr`` wide, the rope part shared by the heads) and values
    (``dv`` wide), then the chunked attention, scaled by
    ``1/sqrt(dn + dr)``."""
    cd = dtype_of(cfg.compute_dtype)
    b, s, d = x.shape
    h, dn, dr, dv = cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim, \
        cfg.v_head_dim
    local = _mla_heads_local(cfg, p, tp)
    hl = h // tp.size if local else h
    q_nope, q_rope = _mla_q(cfg, p, x, tp, local)
    q_rope = apply_rope(q_rope, positions[None, :], 1.0, cfg.rope_theta)
    c_kv = tpm.matmul(x, p["w_dkv"].to(cd), cfg.kv_lora_rank, tp)  # (B,S,r)
    k_rope = tpm.matmul(x, p["w_kr"].to(cd), dr, tp).reshape(b, s, 1, dr)
    k_rope = apply_rope(k_rope, positions[None, :], 1.0, cfg.rope_theta)
    if local:
        k_nope = c_kv @ p["w_uk"].to(cd)
        v = c_kv @ p["w_uv"].to(cd)
    else:
        k_nope = tpm.matmul(c_kv, p["w_uk"].to(cd), h * dn, tp)
        v = tpm.matmul(c_kv, p["w_uv"].to(cd), h * dv, tp)
    k_nope = k_nope.reshape(b, s, hl, dn)
    v = v.reshape(b, s, hl, dv)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope.expand(b, s, hl, dr)], dim=-1)
    out = causal_parts_attention(cfg, q, k, v, positions).reshape(b, s, -1)
    if local:
        out = tp.gather(out, -1)
    return tpm.matmul(out, p["wo"].to(cd), d, tp)


def init_mla_cache(cfg: ModelConfig, batch: int, cache_len: int,
                   n_layers: Optional[int] = None,
                   device: torch.device | str | None = "cuda") -> Params:
    """The compressed cache: ``ckv`` (L, B, C, r) and ``kr`` (L, B, C, dr)
    in the compute dtype, zero; ``pos`` (L, C) int32, -1; on the card
    unless ``device`` names another."""
    device = resolve_or_meta(device)
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


def _per_head(tp: Optional[tpm.TP], lat: torch.Tensor, w: torch.Tensor,
              r: int, width: int, h: int, eq: str) -> torch.Tensor:
    """The whole ``einsum(eq, lat, w)`` in float32 for all ``h`` heads,
    ``w`` (r, H * width) given as the rank's block: split by heads (the
    rank's heads, gathered) or whole."""
    f32 = torch.float32
    if tp is not None and tp.split(w.shape[1], h * width, "mla up-proj"):
        lo, hi = tp.block(h)
        y = torch.einsum(eq, lat[:, lo:hi].to(f32),
                         w.reshape(r, hi - lo, width).to(f32))
        return tp.gather(y, 1)
    if tp is not None and tp.split(w.shape[0], r, "mla up-proj"):
        raise tpm.refuse(f"an mla up-projection {tuple(w.shape)} split over "
                         f"its latent")
    return torch.einsum(eq, lat.to(f32), w.reshape(r, h, width).to(f32))


def mla_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
               cache_ckv: torch.Tensor, cache_kr: torch.Tensor,
               cache_pos: torch.Tensor, pos: int,
               tp: Optional[tpm.TP] = None):
    """Absorbed MLA decode: the per-head up-projections are folded into the
    query (``q_lat``) and the output (``o_lat``), so attention runs in the
    r-wide latent space and the cache stays compressed. x: (B, 1, D);
    cache_ckv: (B, C, r); cache_kr: (B, C, dr). The two absorption products
    the reference takes in the compute dtype are taken in float32 and
    rounded once. With a ``tp`` the caches are the rank's blocks of the
    latent (and the rope dims) or of the slots."""
    pos = int(pos)
    cd = dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    b, _, d = x.shape
    h, dn, dr, dv, r = (cfg.n_heads, cfg.qk_nope_dim, cfg.qk_rope_dim,
                        cfg.v_head_dim, cfg.kv_lora_rank)
    C = cache_pos.shape[-1]
    split = _cache_split(tp, cache_ckv, (C, r), ("latent",), "mla ckv cache")
    kr_split = _cache_split(tp, cache_kr, (C, dr), ("rope",), "mla kr cache")
    if (split, kr_split) not in ((None, None), ("latent", "rope"),
                                 ("latent", None), ("slots", "slots")):
        raise tpm.refuse(f"an mla cache with ckv split by {split} and kr "
                         f"by {kr_split}")
    q_nope, q_rope = _mla_q(cfg, p, x, tp)                    # (B,1,H,dn/dr)
    pos_arr = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q_rope = apply_rope(q_rope, pos_arr, 1.0, cfg.rope_theta)
    ckv_new = tpm.matmul(x, p["w_dkv"].to(cd), r, tp)         # (B,1,r)
    kr_new = tpm.matmul(x, p["w_kr"].to(cd), dr, tp).reshape(b, 1, 1, dr)
    kr_new = apply_rope(kr_new, pos_arr, 1.0, cfg.rope_theta)[:, :, 0]
    lat = rope = slice(None)
    if split == "slots":
        _write_owned(tp, pos, C, (cache_ckv, cache_kr), (ckv_new, kr_new))
        cache_pos[pos % C] = pos
        lo = tp.rank * cache_ckv.shape[1]
        valid = _valid(cfg, cache_pos, pos)[lo:lo + cache_ckv.shape[1]]
    else:
        if split == "latent":
            lat = slice(*tp.block(r))
        if kr_split == "rope":
            rope = slice(*tp.block(dr))
        slot = _write_slot(pos, (cache_ckv, cache_kr),
                           (ckv_new[..., lat], kr_new[..., rope]))
        cache_pos[slot] = pos
        valid = _valid(cfg, cache_pos, pos)

    # q_lat[b,h,r] = sum_dn q_nope[b,h,dn] * w_uk[r,h,dn]
    q_lat = _per_head(tp, q_nope[:, 0], p["w_uk"].to(cd), r, dn, h,
                      "bhd,rhd->bhr").to(cd)
    s_lat = torch.einsum("bhr,bcr->bhc", q_lat[..., lat].to(f32),
                         cache_ckv.to(f32))
    s_rope = torch.einsum("bhd,bcd->bhc", q_rope[:, 0, :, rope].to(f32),
                          cache_kr.to(f32))
    if split == "latent":
        # partial sums over the latent (and the rope dims when split)
        if kr_split == "rope":
            s_lat = tp.reduce(s_lat + s_rope)
            s_rope = torch.zeros_like(s_rope)
        else:
            s_lat = tp.reduce(s_lat)
    s = (s_lat + s_rope) / math.sqrt(dn + dr)
    s = torch.where(valid[None, None, :], s, NEG_INF)
    if split == "slots":
        o_lat = _lse(s, lambda e: torch.einsum("bhc,bcr->bhr", e,
                                               cache_ckv.to(f32)), tp)
    else:
        a = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhc,bcr->bhr", a, cache_ckv.to(f32))  # (B,H,r)
        if split == "latent":
            o_lat = tp.gather(o_lat, -1)
    o = _per_head(tp, o_lat.to(cd), p["w_uv"].to(cd), r, dv, h,
                  "bhr,rhd->bhd").to(cd)
    o = tpm.matmul(o.reshape(b, 1, h * dv), p["wo"].to(cd), d, tp)
    return o, (cache_ckv, cache_kr, cache_pos)
