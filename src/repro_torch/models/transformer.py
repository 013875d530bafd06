"""Model assembly and loss for the dense, MoE, SSM and hybrid families
(counterpart of ``repro/models/transformer.py``).

A model is a sequence of homogeneous segments (:func:`segments`), each a
stack of identical blocks: the dense family is ``[("dense", L)]``, the MoE
family ``[("dense", first_k_dense), ("moe", L - first_k_dense)]``, the SSM
family ``[("ssm", L)]`` and the hybrid ``[("hybrid", L)]``: Mamba2 blocks
with one shared attention block (one parameter set) applied after every
``attn_every``-th layer (Zamba2, arXiv:2411.15242).
Parameters are nested dicts of tensors with the reference's tree: ``embed``
{``embedding``, ``lm_head``}, ``final_norm`` {``scale``, ``bias``},
``seg{i}`` holding segment i's blocks stacked on a leading axis (``attn``
{wq, wk, wv, wo, bq, bk, bv}, ``mlp`` {w_in, w_gate, w_out} or ``moe``
(:mod:`repro_torch.models.moe`), ``norm1``, ``norm2``; or an SSM block's
``norm`` and ``ssm`` (:mod:`repro_torch.models.ssm`)), and the hybrid's
``shared_attn`` {``norm1``, ``norm2``, ``attn``, ``mlp``}. The reference
scans over each stack; here a Python loop walks it, and with ``cfg.remat``
each block runs under ``torch.utils.checkpoint``, as ``jax.checkpoint``
wraps the scan body (``transformer.py:179``); a hybrid layer's body holds
its SSM block and, where it applies, the shared block.

MLA, MTP and decoding are not ported yet.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import ssm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (apply_mlp, apply_norm, dense_init,
                                       dtype_of, embed_tokens, lm_logits)

Params = Dict[str, Any]
LOSS_CHUNK = 256  # sequence chunk for the streamed cross-entropy


def segments(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """The (kind, n_layers) of each stacked segment ``seg{i}``."""
    if cfg.family in ("ssm", "hybrid"):
        return [(cfg.family, cfg.n_layers)]
    if cfg.family == "moe":
        segs = [("dense", cfg.first_k_dense)] if cfg.first_k_dense else []
        return segs + [("moe", cfg.n_layers - cfg.first_k_dense)]
    return [("dense", cfg.n_layers)]


def _check_ported(cfg: ModelConfig) -> None:
    waiting = [name for name, hit in (
        ("MLA", cfg.use_mla), ("MTP", cfg.use_mtp)) if hit]
    if waiting:
        raise NotImplementedError(
            f"{cfg.arch_id}: {', '.join(waiting)} not ported yet (ROADMAP.md "
            f"A.11; the port runs the dense, MoE, SSM and hybrid families)")


def _norm_shapes(cfg: ModelConfig, lead: Tuple[int, ...]) -> Params:
    norm = {"scale": lead + (cfg.d_model,)}
    if cfg.norm == "layernorm":
        norm["bias"] = lead + (cfg.d_model,)
    return norm


def _attn_mlp_shapes(cfg: ModelConfig, lead: Tuple[int, ...]) -> Params:
    """An attention block's leaves (``attn``, ``mlp``, ``norm1``,
    ``norm2``), each with the leading dims ``lead``."""
    d, f = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    a = {"wq": lead + (d, h * hd), "wk": lead + (d, kv * hd),
         "wv": lead + (d, kv * hd), "wo": lead + (h * hd, d)}
    if cfg.qkv_bias:
        a.update(bq=lead + (h * hd,), bk=lead + (kv * hd,),
                 bv=lead + (kv * hd,))
    mlp = {"w_in": lead + (d, f), "w_out": lead + (f, d)}
    if cfg.act == "swiglu":
        mlp["w_gate"] = lead + (d, f)
    return {"attn": a, "mlp": mlp, "norm1": _norm_shapes(cfg, lead),
            "norm2": _norm_shapes(cfg, lead)}


def _block_shapes(cfg: ModelConfig, kind: str, L: int) -> Params:
    """One segment's leaves, each with the leading stack axis ``L``. An
    SSM block has no attention, so its shapes never read the head dim
    (mamba2-370m has ``n_heads = 0``)."""
    if kind in ("ssm", "hybrid"):
        return {"norm": _norm_shapes(cfg, (L,)),
                "ssm": {k: (L,) + v for k, v in ssm.param_shapes(cfg).items()}}
    out = _attn_mlp_shapes(cfg, (L,))
    if kind == "moe":
        del out["mlp"]
        out["moe"] = {k: (L,) + v for k, v in moe.param_shapes(cfg).items()}
    return out


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree as nested dicts of shapes (the reference's
    ``jax.eval_shape(init_params)``)."""
    _check_ported(cfg)
    d = cfg.d_model
    embed = {"embedding": (cfg.vocab_size, d)}
    if not cfg.tie_embeddings:
        embed["lm_head"] = (d, cfg.vocab_size)
    top_norm = {"scale": (d,)}
    if cfg.norm == "layernorm":
        top_norm["bias"] = (d,)
    out = {"embed": embed, "final_norm": top_norm}
    for si, (kind, n) in enumerate(segments(cfg)):
        out[f"seg{si}"] = _block_shapes(cfg, kind, n)
    if cfg.family == "hybrid":
        out["shared_attn"] = _attn_mlp_shapes(cfg, ())
    return out


def init_keys(cfg: ModelConfig, key: torch.Tensor
              ) -> Dict[Tuple[str, ...], torch.Tensor]:
    """The reference's threefry key of every drawn leaf, hashed on the host:
    ``split(key, 8)``; the embedding and LM head from ``split(keys[0])``;
    segment i's layers from ``split(fold_in(keys[2], i), n_i)``, each block
    ``split(k, 6)`` with the attention in ``split(ks[2], 4)`` and the MLP in
    ``split(ks[3], 3)`` or the MoE in ``split(ks[3], 7)``, or an SSM block's
    ``init_ssm`` in ``split(ks[1], 5)``; the hybrid's shared attention from
    ``split(keys[5], 4)`` and its MLP from ``split(keys[6], 3)``. A stacked
    leaf's entry holds one key per layer, (n_i, 2)."""
    _check_ported(cfg)
    keys = prng.split(key.cpu(), 8)
    k_embed = prng.split(keys[0])
    out = {("embed", "embedding"): k_embed[0]}
    if not cfg.tie_embeddings:
        out[("embed", "lm_head")] = k_embed[1]

    def attn_keys(prefix, k):
        ka = prng.split(k, 4)
        for i, name in enumerate(("wq", "wk", "wv", "wo")):
            out[prefix + ("attn", name)] = ka[..., i, :]

    def mlp_keys(prefix, k):
        km = prng.split(k, 3)
        for i, name in enumerate(("w_in", "w_gate", "w_out")):
            if name != "w_gate" or cfg.act == "swiglu":
                out[prefix + ("mlp", name)] = km[..., i, :]

    for si, (kind, n) in enumerate(segments(cfg)):
        seg = f"seg{si}"
        blocks = prng.split(prng.split(prng.fold_in(keys[2], si), n), 6)
        if kind in ("ssm", "hybrid"):
            for name, k in ssm.init_keys(cfg, blocks[:, 1]).items():
                out[(seg, "ssm", name)] = k
            continue
        attn_keys((seg,), blocks[:, 2])
        if kind == "moe":
            for name, k in moe.init_keys(cfg, blocks[:, 3]).items():
                out[(seg, "moe", name)] = k
        else:
            mlp_keys((seg,), blocks[:, 3])
    if cfg.family == "hybrid":
        attn_keys(("shared_attn",), keys[5])
        mlp_keys(("shared_attn",), keys[6])
    return out


def _init_scale(cfg: ModelConfig, path: Tuple[str, ...]) -> float:
    if "moe" in path:
        return moe.init_scale(cfg, path[-1])
    if "ssm" in path:
        return ssm.init_scale(cfg, path[-1])
    return 0.02 / math.sqrt(2 * cfg.n_layers) if path[-1] == "wo" else 0.02


def init_params(cfg: ModelConfig, key: torch.Tensor,
                out: Optional[Params] = None) -> Params:
    """The reference's ``init_params(cfg, key)``: the leaves of
    :func:`init_keys` drawn with ``dense_init`` (``wo``, the MoE output
    projections and the SSM ``w_out`` at 0.02/sqrt(2L), the SSM ``conv_w``
    at 0.5, every other matrix at 0.02), norm scales 1, biases 0, and the
    SSM constants of :func:`repro_torch.models.ssm.constant_leaves`.

    Without ``out`` the weights land on the key's device; with ``out``, a
    tree of tensors of :func:`param_shapes` (e.g. views of one row of a flat
    buffer), each layer's draw is written into its slice of the stacked leaf
    and ``out`` is returned."""
    _check_ported(cfg)
    dt = dtype_of(cfg.param_dtype)
    if out is None:
        def empty(tree):
            return {k: empty(v) if isinstance(v, dict) else
                    torch.empty(v, dtype=dt, device=key.device)
                    for k, v in tree.items()}
        out = empty(param_shapes(cfg))
    ssm_consts = (ssm.constant_leaves(cfg)
                  if cfg.family in ("ssm", "hybrid") else {})
    for path, leaf in _tree_items(out):
        if "ssm" in path and path[-1] in ssm_consts:
            # one (d,) constant broadcast over the stacked layers
            leaf.copy_(torch.from_numpy(ssm_consts[path[-1]]))
        elif path[-1] == "scale":
            leaf.fill_(1.0)
        elif path[-1] in ("bias", "bq", "bk", "bv"):
            leaf.zero_()
    for path, k in init_keys(cfg, key).items():
        leaf = out
        for p in path:
            leaf = leaf[p]
        scale = _init_scale(cfg, path)
        if not path[0].startswith("seg"):
            dense_init(k, tuple(leaf.shape), dt, scale, out=leaf)
            continue
        for li in range(leaf.shape[0]):
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


def _moe_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
               positions: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    h = apply_norm(cfg, bp["norm1"], x)
    x = x + attn.attention_forward(cfg, bp["attn"], h, positions)
    h2 = apply_norm(cfg, bp["norm2"], x)
    y, aux = moe.moe_forward(cfg, bp["moe"], h2)
    return x + y, aux


def _ssm_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
    h = apply_norm(cfg, bp["norm"], x)
    return x + ssm.ssm_forward(cfg, bp["ssm"], h, positions)


def _hybrid_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                  positions: torch.Tensor, shared: Optional[Params]
                  ) -> torch.Tensor:
    """One hybrid layer: the SSM block, then the shared attention block
    (norm1, attention, norm2, MLP: a dense block's tree) when ``shared`` is
    given."""
    x = _ssm_block(cfg, bp, x, positions)
    return x if shared is None else _dense_block(cfg, shared, x, positions)


def forward_hidden(cfg: ModelConfig, params: Params,
                   tokens: Optional[torch.Tensor] = None,
                   embeds: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward. tokens: (B, S) int, or ``embeds`` (B, S, D)
    precomputed frontend embeddings (the audio and VLM configs' stub) ->
    (final-normed hidden (B, S, D) in the compute dtype, the MoE layers'
    summed aux loss, float32)."""
    _check_ported(cfg)
    if embeds is not None:
        x = embeds.to(dtype_of(cfg.compute_dtype))
    else:
        x = embed_tokens(cfg, params["embed"], tokens)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (kind, n) in enumerate(segments(cfg)):
        seg = params[f"seg{si}"]
        # a stacked tree, or a list of per-layer trees (the flat engine's:
        # one leaf per layer, so that backward never materializes a zero
        # gradient of the whole stack per layer)
        blocks = (seg if isinstance(seg, (list, tuple))
                  else [_layer(seg, i) for i in range(n)])
        block = {"moe": _moe_block, "ssm": _ssm_block,
                 "hybrid": _hybrid_block}.get(kind, _dense_block)
        auxs = []
        for li, bp in enumerate(blocks):
            args = (cfg, bp, x, positions)
            if kind == "hybrid":
                # the shared block after every attn_every-th layer, inside
                # the layer's checkpointed body as in the reference's scan
                every = cfg.attn_every
                args += (params["shared_attn"] if li % every == every - 1
                         else None,)
            if cfg.remat:
                out = checkpoint(block, *args, use_reentrant=False)
            else:
                out = block(*args)
            if kind == "moe":
                x, aux = out
                auxs.append(aux)
            else:
                x = out
        if auxs:
            aux_total = aux_total + torch.stack(auxs).sum()
    return apply_norm(cfg, params["final_norm"], x), aux_total


def forward(cfg: ModelConfig, params: Params,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward with the LM head: -> (logits (B, S, V), aux)."""
    h, aux = forward_hidden(cfg, params, tokens, embeds=embeds)
    return lm_logits(cfg, params["embed"], h), aux


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
    """Next-token CE, plus ``router_aux_coef * aux`` for a MoE config.
    batch: tokens (B, S) or embeds (B, S, D), and labels (B, S)."""
    hidden, aux = forward_hidden(cfg, params, batch.get("tokens"),
                                 embeds=batch.get("embeds"))
    loss = chunked_ce(cfg, params["embed"], hidden, batch["labels"])
    metrics = {"ce": loss, "aux": aux}
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux
    metrics["loss"] = loss
    return loss, metrics
