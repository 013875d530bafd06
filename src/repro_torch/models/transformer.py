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

With ``use_mla`` (deepseek-v3-671b) every block's attention is MLA
(:func:`repro_torch.models.attention.mla_forward`); with ``use_mtp`` the tree
has an ``mtp`` head {``proj``, ``block``, ``norm``}, one more dense block over
``[h_t ; emb(x_{t+1})]`` predicting ``x_{t+2}``, whose loss joins
:func:`lm_loss` times ``mtp_coef``.

Decoding (:func:`init_cache`, :func:`decode_step`) runs one token through
the whole stack against a cache: per-layer KV or MLA slices across the
segments, the SSM stack's state and conv window, and the hybrid's shared
block with one KV cache per use. The reference's ``lax.scan`` and
``lax.cond`` are a Python loop here; the cache is written in place.

Two optional arguments carry a mesh into the model. ``group`` (training,
:func:`lm_loss`): the fsdp group whose ranks hold the rest of a node's
(micro)batch, over which every MoE layer routes (:func:`moe.route`).
``tp`` (serving, :func:`forward` and :func:`decode_step`): the ``model``
axis of a serve mesh, the parameters and the cache the rank's blocks
(:mod:`repro_torch.models.parallel`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.core import prng
from repro_torch.device import resolve_or_meta
from repro_torch.models import attention as attn
from repro_torch.models import moe
from repro_torch.models import parallel as tpm
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


def _norm_shapes(cfg: ModelConfig, lead: Tuple[int, ...]) -> Params:
    norm = {"scale": lead + (cfg.d_model,)}
    if cfg.norm == "layernorm":
        norm["bias"] = lead + (cfg.d_model,)
    return norm


def _attn_mlp_shapes(cfg: ModelConfig, lead: Tuple[int, ...],
                     mla: bool = False) -> Params:
    """An attention block's leaves (``attn``, ``mlp``, ``norm1``,
    ``norm2``), each with the leading dims ``lead``; ``attn`` is MLA's with
    ``mla``."""
    d, f = cfg.d_model, cfg.d_ff
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if mla:
        a = {k: lead + v for k, v in attn.mla_shapes(cfg).items()}
    else:
        a = {"wq": lead + (d, h * hd), "wk": lead + (d, kv * hd),
             "wv": lead + (d, kv * hd), "wo": lead + (h * hd, d)}
    if cfg.qkv_bias and not mla:
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
    out = _attn_mlp_shapes(cfg, (L,), mla=cfg.use_mla)
    if kind == "moe":
        del out["mlp"]
        out["moe"] = {k: (L,) + v for k, v in moe.param_shapes(cfg).items()}
    return out


def param_shapes(cfg: ModelConfig) -> Params:
    """The parameter tree as nested dicts of shapes (the reference's
    ``jax.eval_shape(init_params)``)."""
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
    if cfg.use_mtp:
        out["mtp"] = {"proj": (2 * d, d),
                      "block": _attn_mlp_shapes(cfg, (), mla=cfg.use_mla),
                      "norm": _norm_shapes(cfg, ())}
    return out


def init_keys(cfg: ModelConfig, key: torch.Tensor
              ) -> Dict[Tuple[str, ...], torch.Tensor]:
    """The reference's threefry key of every drawn leaf, hashed on the host:
    ``split(key, 8)``; the embedding and LM head from ``split(keys[0])``;
    segment i's layers from ``split(fold_in(keys[2], i), n_i)``, each block
    ``split(k, 6)`` with the attention in ``split(ks[2], 4)`` (MLA's in
    ``split(ks[2], 8)``) and the MLP in ``split(ks[3], 3)`` or the MoE in
    ``split(ks[3], 7)``, or an SSM block's ``init_ssm`` in ``split(ks[1],
    5)``; the hybrid's shared attention from ``split(keys[5], 4)`` and its
    MLP from ``split(keys[6], 3)``; the MTP head from ``split(keys[7], 3)``:
    ``proj``, then a dense block from ``split(k7[1], 6)``. A stacked leaf's
    entry holds one key per layer, (n_i, 2)."""
    keys = prng.split(key.cpu(), 8)
    k_embed = prng.split(keys[0])
    out = {("embed", "embedding"): k_embed[0]}
    if not cfg.tie_embeddings:
        out[("embed", "lm_head")] = k_embed[1]

    def attn_keys(prefix, k, mla=False):
        if mla:
            ka = prng.split(k, 8)
            for name in attn.mla_shapes(cfg):
                out[prefix + ("attn", name)] = \
                    ka[..., attn.MLA_KEY_INDEX[name], :]
            return
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
        attn_keys((seg,), blocks[:, 2], cfg.use_mla)
        if kind == "moe":
            for name, k in moe.init_keys(cfg, blocks[:, 3]).items():
                out[(seg, "moe", name)] = k
        else:
            mlp_keys((seg,), blocks[:, 3])
    if cfg.family == "hybrid":
        attn_keys(("shared_attn",), keys[5])
        mlp_keys(("shared_attn",), keys[6])
    if cfg.use_mtp:
        k7 = prng.split(keys[7], 3)
        out[("mtp", "proj")] = k7[0]
        kb = prng.split(k7[1], 6)
        attn_keys(("mtp", "block"), kb[2], cfg.use_mla)
        mlp_keys(("mtp", "block"), kb[3])
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
                    device: torch.device | str = "cpu",
                    dtype: torch.dtype = torch.float32) -> Params:
    """The reference's parameters, given as a nested dict of numpy arrays,
    as the port's tree of ``dtype`` tensors on ``device`` (float32 by
    default; ``dtype_of(cfg.param_dtype)`` serves a bfloat16 model in
    bfloat16). Keys and shapes are checked against :func:`param_shapes`."""
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
            out[k] = torch.tensor(arr, device=device).to(dtype)
        return out
    return walk(param_shapes(cfg), tree, "")


def _layer(tree: Params, i: int) -> Params:
    return {k: _layer(v, i) if isinstance(v, dict) else v[i]
            for k, v in tree.items()}


def _attention(cfg: ModelConfig, p: Params, h: torch.Tensor,
               positions: torch.Tensor, tp: Optional[tpm.TP] = None
               ) -> torch.Tensor:
    if cfg.use_mla:
        return attn.mla_forward(cfg, p, h, positions, tp)
    return attn.attention_forward(cfg, p, h, positions, tp)


def _dense_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                 positions: torch.Tensor, tp: Optional[tpm.TP] = None
                 ) -> torch.Tensor:
    h = apply_norm(cfg, bp["norm1"], x, tp=tp)
    x = x + _attention(cfg, bp["attn"], h, positions, tp)
    h2 = apply_norm(cfg, bp["norm2"], x, tp=tp)
    return x + apply_mlp(cfg, bp["mlp"], h2, tp)


def _moe_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
               positions: torch.Tensor, group: Optional[tpm.Collectives] = None,
               tp: Optional[tpm.TP] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    h = apply_norm(cfg, bp["norm1"], x, tp=tp)
    x = x + _attention(cfg, bp["attn"], h, positions, tp)
    h2 = apply_norm(cfg, bp["norm2"], x, tp=tp)
    y, aux = moe.moe_forward(cfg, bp["moe"], h2, group, tp)
    return x + y, aux


def _ssm_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
               positions: torch.Tensor, tp: Optional[tpm.TP] = None
               ) -> torch.Tensor:
    h = apply_norm(cfg, bp["norm"], x, tp=tp)
    return x + ssm.ssm_forward(cfg, bp["ssm"], h, positions, tp)


def _hybrid_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                  positions: torch.Tensor, shared: Optional[Params],
                  tp: Optional[tpm.TP] = None) -> torch.Tensor:
    """One hybrid layer: the SSM block, then the shared attention block
    (norm1, attention, norm2, MLP: a dense block's tree) when ``shared`` is
    given."""
    x = _ssm_block(cfg, bp, x, positions, tp)
    return x if shared is None else _dense_block(cfg, shared, x, positions,
                                                 tp)


def _stack_layers(seg: Any, n: int) -> List[Params]:
    """A segment as per-layer trees: a stacked tree, or already a list of
    per-layer trees (the flat engine's: one leaf per layer, so that
    backward never materializes a zero gradient of the whole stack per
    layer)."""
    if isinstance(seg, (list, tuple)):
        return list(seg)
    return [_layer(seg, i) for i in range(n)]


def forward_hidden(cfg: ModelConfig, params: Params,
                   tokens: Optional[torch.Tensor] = None,
                   embeds: Optional[torch.Tensor] = None,
                   group: Optional[tpm.Collectives] = None,
                   tp: Optional[tpm.TP] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Backbone forward. tokens: (B, S) int, or ``embeds`` (B, S, D)
    precomputed frontend embeddings (the audio and VLM configs' stub) ->
    (final-normed hidden (B, S, D) in the compute dtype, the MoE layers'
    summed aux loss, float32). ``group`` and ``tp``: see the module doc."""
    if embeds is not None:
        x = embeds.to(dtype_of(cfg.compute_dtype))
    else:
        x = embed_tokens(cfg, params["embed"], tokens, tp)
    positions = torch.arange(x.shape[1], dtype=torch.int32, device=x.device)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, (kind, n) in enumerate(segments(cfg)):
        blocks = _stack_layers(params[f"seg{si}"], n)
        block = {"moe": _moe_block, "ssm": _ssm_block,
                 "hybrid": _hybrid_block}.get(kind, _dense_block)
        auxs = []
        for li, bp in enumerate(blocks):
            args = (cfg, bp, x, positions)
            if kind == "moe":
                args += (group,)
            elif kind == "hybrid":
                # the shared block after every attn_every-th layer, inside
                # the layer's checkpointed body as in the reference's scan
                every = cfg.attn_every
                args += (params["shared_attn"] if li % every == every - 1
                         else None,)
            if cfg.remat:
                # with a group, a MoE block's recomputation issues its
                # routing collectives again; every rank of the group runs
                # the same graph (the same layers, the same microbatch
                # shapes), and autograd recomputes its checkpointed blocks
                # in one order (the reverse of the forward's), so the
                # ranks meet in each recomputed collective in the same
                # order and none waits on a block its peers do not redo
                out = checkpoint(block, *args, use_reentrant=False, tp=tp)
            else:
                out = block(*args, tp=tp)
            if kind == "moe":
                x, aux = out
                auxs.append(aux)
            else:
                x = out
        if auxs:
            aux_total = aux_total + torch.stack(auxs).sum()
    return apply_norm(cfg, params["final_norm"], x, tp=tp), aux_total


def forward(cfg: ModelConfig, params: Params,
            tokens: Optional[torch.Tensor] = None,
            embeds: Optional[torch.Tensor] = None,
            tp: Optional[tpm.TP] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full forward with the LM head: -> (logits (B, S, V), aux)."""
    h, aux = forward_hidden(cfg, params, tokens, embeds=embeds, tp=tp)
    return lm_logits(cfg, params["embed"], h, tp), aux


def mtp_hidden(cfg: ModelConfig, params: Params, tokens: torch.Tensor,
               h_final: torch.Tensor) -> torch.Tensor:
    """DeepSeek-V3's MTP head: position i predicts ``tokens[i + 2]``.
    h_final: (B, S, D) final-normed hidden states -> (B, S - 1, D)."""
    mp = params["mtp"]
    cd = dtype_of(cfg.compute_dtype)
    emb_next = embed_tokens(cfg, params["embed"], tokens[:, 1:])
    h = torch.cat([h_final[:, :-1], emb_next], dim=-1) @ mp["proj"].to(cd)
    positions = torch.arange(h.shape[1], dtype=torch.int32, device=h.device)
    h = _dense_block(cfg, mp["block"], h, positions)
    return apply_norm(cfg, mp["norm"], h)


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


def lm_loss(cfg: ModelConfig, params: Params, batch: Mapping[str, Any],
            group: Optional[tpm.Collectives] = None
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Next-token CE, plus ``router_aux_coef * aux`` for a MoE config and
    ``mtp_coef`` times the MTP head's CE on ``labels[:, 2:]`` with
    ``use_mtp``. batch: tokens (B, S) or embeds (B, S, D), and labels
    (B, S). With ``group`` (an fsdp group, each rank holding one block of
    the batch's rows) the MoE layers route the group's whole batch and
    ``aux`` is the group's: the CE is this rank's, so the group's mean of
    the losses and of their gradients is the whole batch's."""
    tokens, labels = batch.get("tokens"), batch["labels"]
    hidden, aux = forward_hidden(cfg, params, tokens,
                                 embeds=batch.get("embeds"), group=group)
    loss = chunked_ce(cfg, params["embed"], hidden, labels)
    metrics = {"ce": loss, "aux": aux}
    if cfg.n_experts:
        loss = loss + cfg.router_aux_coef * aux
    if cfg.use_mtp:
        mh = mtp_hidden(cfg, params, tokens, hidden)          # (B, S-1, D)
        mtp_loss = chunked_ce(cfg, params["embed"], mh[:, :-1], labels[:, 2:])
        metrics["mtp"] = mtp_loss
        loss = loss + cfg.mtp_coef * mtp_loss
    metrics["loss"] = loss
    return loss, metrics


# ------------------------------------------------------------------ decode

def init_cache(cfg: ModelConfig, batch: int, cache_len: int,
               device: torch.device | str | None = "cuda") -> Params:
    """The decode cache, the reference's tree: ``cache_len`` is the full
    context under full attention, the window under a sliding window. The SSM
    stack holds ``ssm`` {state, conv}; the hybrid adds ``attn``, one KV
    cache per use of its shared block; MLA holds ``mla`` {ckv, kr, pos},
    every other config ``kv`` {k, v, pos}. On the card unless ``device``
    names another; ``device="meta"`` gives the shapes and dtypes without
    memory."""
    device = resolve_or_meta(device)
    if cfg.family == "ssm":
        return {"ssm": ssm.init_ssm_cache(cfg, batch, device=device)}
    if cfg.family == "hybrid":
        n_apps = cfg.n_layers // cfg.attn_every
        return {"ssm": ssm.init_ssm_cache(cfg, batch, device=device),
                "attn": attn.init_kv_cache(cfg, batch, cache_len,
                                           n_layers=n_apps, device=device)}
    if cfg.use_mla:
        return {"mla": attn.init_mla_cache(cfg, batch, cache_len,
                                           device=device)}
    return {"kv": attn.init_kv_cache(cfg, batch, cache_len, device=device)}


def _decode_attn_block(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                       kv: Params, pos: int, tp: Optional[tpm.TP] = None
                       ) -> torch.Tensor:
    """norm1, cached attention on one layer's cache slice ``kv`` (written
    in place), norm2, then the MLP or the MoE."""
    h = apply_norm(cfg, bp["norm1"], x, tp=tp)
    if cfg.use_mla:
        o, _ = attn.mla_decode(cfg, bp["attn"], h, kv["ckv"], kv["kr"],
                               kv["pos"], pos, tp)
    else:
        o, _ = attn.decode_attention(cfg, bp["attn"], h, kv["k"], kv["v"],
                                     kv["pos"], pos, tp)
    x = x + o
    h2 = apply_norm(cfg, bp["norm2"], x, tp=tp)
    if "moe" in bp:
        return x + moe.moe_forward(cfg, bp["moe"], h2, tp=tp)[0]
    return x + apply_mlp(cfg, bp["mlp"], h2, tp)


def _ssm_decode_layer(cfg: ModelConfig, bp: Params, x: torch.Tensor,
                      sc: Params, li: int, tp: Optional[tpm.TP] = None
                      ) -> torch.Tensor:
    hh = apply_norm(cfg, bp["norm"], x, tp=tp)
    o, (st, cv) = ssm.ssm_decode(cfg, bp["ssm"], hh, sc["state"][li],
                                 sc["conv"][li], tp)
    sc["state"][li].copy_(st)
    sc["conv"][li].copy_(cv)
    return x + o


def decode_step(cfg: ModelConfig, params: Params, cache: Params,
                tokens: Optional[torch.Tensor], pos: int,
                embeds: Optional[torch.Tensor] = None,
                tp: Optional[tpm.TP] = None
                ) -> Tuple[torch.Tensor, Params]:
    """One decode step for the whole stack. tokens: (B, 1), or ``embeds``
    (B, 1, D) for the audio and VLM configs; pos: the token's absolute
    position. Returns (logits (B, 1, V), ``cache``), its tensors written in
    place: they now hold the reference's new cache. With ``tp`` the
    parameters and the cache are the rank's blocks."""
    pos = int(pos)
    if embeds is not None:
        x = embeds.to(dtype_of(cfg.compute_dtype))
    else:
        x = embed_tokens(cfg, params["embed"], tokens, tp)
    if cfg.family in ("ssm", "hybrid"):
        sc = cache["ssm"]
        every = cfg.attn_every
        for li, bp in enumerate(_stack_layers(params["seg0"],
                                              cfg.n_layers)):
            x = _ssm_decode_layer(cfg, bp, x, sc, li, tp)
            if cfg.family == "hybrid" and li % every == every - 1:
                app = li // every
                kv = {k: v[app] for k, v in cache["attn"].items()}
                x = _decode_attn_block(cfg, params["shared_attn"], x, kv,
                                       pos, tp)
    else:
        # dense and MoE: the segments' layers in order, each on its slice
        # of the one stacked cache
        cc = cache["mla" if cfg.use_mla else "kv"]
        li = 0
        for si, (_, n) in enumerate(segments(cfg)):
            for bp in _stack_layers(params[f"seg{si}"], n):
                kv = {k: v[li] for k, v in cc.items()}
                x = _decode_attn_block(cfg, bp, x, kv, pos, tp)
                li += 1
    x = apply_norm(cfg, params["final_norm"], x, tp=tp)
    return lm_logits(cfg, params["embed"], x, tp), cache
