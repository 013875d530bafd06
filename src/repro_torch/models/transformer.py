"""Dense-family model assembly and loss (counterpart of the dense parts of
``repro/models/transformer.py``).

Parameters are nested dicts of tensors with the reference's tree: ``embed``
{``embedding``, ``lm_head``}, ``final_norm`` {``scale``}, and ``seg0``
holding the ``n_layers`` blocks stacked on a leading axis (``attn`` {wq, wk,
wv, wo, bq, bk, bv}, ``mlp`` {w_in, w_gate, w_out}, ``norm1``, ``norm2``).
The reference scans over the stack; here a Python loop walks it, and with
``cfg.remat`` each block runs under ``torch.utils.checkpoint``, as
``jax.checkpoint`` wraps the scan body (``transformer.py:179``).

MoE, SSM, hybrid, MLA, MTP and decoding are not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       dtype_of, embed_tokens, lm_logits)

Params = Dict[str, Any]
LOSS_CHUNK = 256  # sequence chunk for the streamed cross-entropy


def _check_dense(cfg: ModelConfig) -> None:
    if (cfg.family not in ("dense", "audio", "vlm") or cfg.use_mla
            or cfg.use_mtp or cfg.n_experts):
        raise NotImplementedError(
            f"{cfg.arch_id}: only the dense family is ported (ROADMAP.md, "
            f"remaining models: MoE, SSM, hybrid, MLA, MTP)")


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree as nested dicts of shapes (the reference's
    ``jax.eval_shape(init_params)``)."""
    _check_dense(cfg)
    d, f, L = cfg.d_model, cfg.d_ff, cfg.n_layers
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    embed = {"embedding": (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = (d, cfg.vocab_size)
    a = {"wq": (L, d, h * hd), "wk": (L, d, kv * hd), "wv": (L, d, kv * hd),
         "wo": (L, h * hd, d)}
    if cfg.qkv_bias:
        a.update(bq=(L, h * hd), bk=(L, kv * hd), bv=(L, kv * hd))
    mlp = {"w_in": (L, d, f), "w_out": (L, f, d)}
    if cfg.act == "swiglu":
        mlp["w_gate"] = (L, d, f)
    norm = {"scale": (L, d)}
    if cfg.norm == "layernorm":
        norm["bias"] = (L, d)
    top_norm = {k: v[1:] for k, v in norm.items()}
    return {"embed": embed, "final_norm": top_norm,
            "seg0": {"attn": a, "mlp": mlp, "norm1": dict(norm),
                     "norm2": dict(norm)}}


def init_keys(cfg: ModelConfig, key: torch.Tensor
              ) -> Dict[Tuple[str, ...], torch.Tensor]:
    """The reference's threefry key of every drawn leaf, hashed on the host:
    ``split(key, 8)``; the embedding and LM head from ``split(keys[0])``;
    the stacked layers from ``split(fold_in(keys[2], 0), n_layers)``, each
    block ``split(k, 6)`` with the attention in ``split(ks[2], 4)`` and the
    MLP in ``split(ks[3], 3)``. A stacked leaf's entry holds one key per
    layer, (n_layers, 2)."""
    _check_dense(cfg)
    keys = prng.split(key.cpu(), 8)
    k_embed = prng.split(keys[0])
    out = {("embed", "embedding"): k_embed[0]}
    if not cfg.tie_embeddings:
        out[("embed", "lm_head")] = k_embed[1]
    blocks = prng.split(prng.split(prng.fold_in(keys[2], 0), cfg.n_layers), 6)
    ka, km = prng.split(blocks[:, 2], 4), prng.split(blocks[:, 3], 3)
    for i, name in enumerate(("wq", "wk", "wv", "wo")):
        out[("seg0", "attn", name)] = ka[:, i]
    for i, name in enumerate(("w_in", "w_gate", "w_out")):
        if name != "w_gate" or cfg.act == "swiglu":
            out[("seg0", "mlp", name)] = km[:, i]
    return out


def init_params(cfg: ModelConfig, key: torch.Tensor,
                out: Optional[Params] = None) -> Params:
    """The reference's ``init_params(cfg, key)``: the leaves of
    :func:`init_keys` drawn with ``dense_init`` (``wo`` at 0.02/sqrt(2L),
    every other matrix at 0.02), norm scales 1, biases 0.

    Without ``out`` the weights land on the key's device; with ``out``, a
    tree of tensors of :func:`param_shapes` (e.g. views of one row of a flat
    buffer), each layer's draw is written into its slice of the stacked leaf
    and ``out`` is returned."""
    _check_dense(cfg)
    dt = dtype_of(cfg.param_dtype)
    if out is None:
        def empty(tree):
            return {k: empty(v) if isinstance(v, dict) else
                    torch.empty(v, dtype=dt, device=key.device)
                    for k, v in tree.items()}
        out = empty(param_shapes(cfg))
    for path, leaf in _tree_items(out):
        if path[-1] == "scale":
            leaf.fill_(1.0)
        elif path[-1] in ("bias", "bq", "bk", "bv"):
            leaf.zero_()
    wo_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    for path, k in init_keys(cfg, key).items():
        leaf = out
        for p in path:
            leaf = leaf[p]
        scale = wo_scale if path[-1] == "wo" else 0.02
        if path[0] != "seg0":
            dense_init(k, tuple(leaf.shape), dt, scale, out=leaf)
            continue
        for li in range(cfg.n_layers):
            dense_init(k[li], tuple(leaf.shape[1:]), dt, scale, out=leaf[li])
    return out


def _tree_items(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()):
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _tree_items(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def params_from_jax(cfg: ModelConfig, tree: Mapping[str, Any],
                    device: torch.device | str = "cpu") -> Params:
    """The reference's parameters, given as a nested dict of numpy arrays,
    as the port's tree of float32 tensors on ``device``. Keys and shapes are
    checked against :func:`param_shapes`."""
    def walk(shapes, sub, path):
        if set(shapes) != set(sub):
            raise ValueError(f"{path or 'params'}: keys {sorted(sub)} != "
                             f"{sorted(shapes)}")
        out = {}
        for k, want in shapes.items():
            if isinstance(want, dict):
                out[k] = walk(want, sub[k], f"{path}/{k}")
                continue
            arr = np.asarray(sub[k], dtype=np.float32)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(f"{path}/{k}: shape {arr.shape} != {want}")
            out[k] = torch.tensor(arr, device=device)
        return out
    return walk(param_shapes(cfg), tree, "")


def _layer(tree: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _dense_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                 positions: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, bp["norm1"], x)
    x = x + attn.attention_forward(cfg, bp["attn"], h, positions)
    h2 = apply_norm(cfg, bp["norm2"], x)
    return x + apply_mlp(cfg, bp["mlp"], h2)


def forward_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor
                   ) -> torch.Tensor:
    """Backbone forward. tokens: (B, S) int -> final-normed hidden (B, S, D)
    in the compute dtype."""
    _check_dense(cfg)
    x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(tokens.shape[1], dtype=torch.int32,
                             device=tokens.device)
    seg = params["seg0"]
    # seg0 is the stacked tree, or a list of per-layer trees (the flat
    # engine's: one leaf per layer, so that backward never materializes a
    # zero gradient of the whole stack per layer)
    blocks = (seg if isinstance(seg, (list, tuple))
              else [_layer(seg, i) for i in range(cfg.n_layers)])
    for bp in blocks:
        if cfg.remat:
            x = checkpoint(_dense_block, cfg, bp, x, positions,
                           use_reentrant=False)
        else:
            x = _dense_block(cfg, bp, x, positions)
    return apply_norm(cfg, params["final_norm"], x)


def _ce_sum(cfg: ModelConfig, embed_params: Params, h: torch.Tensor,
            labels: torch.Tensor) -> torch.Tensor:
    logits = lm_logits(cfg, embed_params, h).to(torch.float32)
    lse = torch.logsumexp(logits, dim=-1)
    tgt = torch.gather(logits, -1, labels[..., None])[..., 0]
    return torch.sum(lse - tgt)


def chunked_ce(cfg: ModelConfig, embed_params: Params, h: torch.Tensor,
               labels: torch.Tensor, chunk: int = LOSS_CHUNK) -> torch.Tensor:
    """Mean next-token CE without materializing (B, S, V) logits: the LM
    head and the logsumexp run per sequence chunk under checkpointing, so
    peak memory is one (B, chunk, V) tile. A ragged tail is dropped, as in
    the reference."""
    b, s, _ = h.shape
    if s <= chunk:
        return _ce_sum(cfg, embed_params, h, labels) / (b * s)
    nc = s // chunk
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(nc):
        sl = slice(c * chunk, (c + 1) * chunk)
        total = total + checkpoint(_ce_sum, cfg, embed_params, h[:, sl],
                                   labels[:, sl], use_reentrant=False)
    return total / (b * nc * chunk)


def lm_loss(cfg: ModelConfig, params: Params, batch: Mapping[str, Any]
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE. batch: tokens (B, S), labels (B, S)."""
    hidden = forward_hidden(cfg, params, batch["tokens"])
    loss = chunked_ce(cfg, params["embed"], hidden, batch["labels"])
    return loss, {"ce": loss, "loss": loss}
