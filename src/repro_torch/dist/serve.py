"""Serve-view engines on one device: batched prefill and cached decode
(counterpart of ``repro/dist/serve.py``).

Where the reference's builders take a mesh and return ``(step_fn,
shardings_fn)``, these take a device and return the step function: the
``shardings`` half, and with it the placement options ``embed_mode`` and
``cache_mode``, waits for the port's sharding slice. The steps run under
``torch.no_grad()`` and move their token or embedding inputs to the device;
the parameters and the cache are the caller's, already there.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional, Tuple, Union

import torch

from repro_torch.device import resolve_device
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            param_shapes)

Device = Union[str, torch.device, None]


def _meta(shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def serve_shapes(cfg: ModelConfig, shape: InputShape, cache_len: int
                 ) -> Tuple[Any, Any, Optional[torch.Tensor],
                            Optional[torch.Tensor], torch.Tensor]:
    """One serve workload's ``(params, cache, tokens, embeds, pos)`` as
    meta tensors: the shapes and dtypes with no memory behind them.

    The audio and VLM configs take frontend ``embeds`` (float32) instead of
    ``tokens`` (int32); the unused one is None. ``cache`` is sized for
    decode; prefill callers ignore it."""
    B = shape.global_batch
    S = 1 if shape.is_decode else shape.seq_len
    pdt = dtype_of(cfg.param_dtype)

    def tree(shapes: Dict[str, Any]) -> Dict[str, Any]:
        return {k: tree(v) if isinstance(v, dict) else _meta(v, pdt)
                for k, v in shapes.items()}
    cshape = init_cache(cfg, B, cache_len, device="meta")
    if cfg.family in ("audio", "vlm"):
        tok, emb = None, _meta((B, S, cfg.d_model), torch.float32)
    else:
        tok, emb = _meta((B, S), torch.int32), None
    return tree(param_shapes(cfg)), cshape, tok, emb, \
        _meta((), torch.int32)


def _inputs(dev: torch.device, tokens, embeds):
    if tokens is not None:
        tokens = torch.as_tensor(tokens).to(device=dev, dtype=torch.int64)
    if embeds is not None:
        embeds = torch.as_tensor(embeds).to(dev)
    return tokens, embeds


def build_prefill(cfg: ModelConfig, device: Device = "cuda"
                  ) -> Callable[..., torch.Tensor]:
    """Full-sequence forward: ``prefill(params, tokens, embeds) -> logits``
    (B, S, V). No backward runs, so nothing is recomputed."""
    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg, remat=False)

    def prefill(params, tokens=None, embeds=None) -> torch.Tensor:
        tokens, embeds = _inputs(dev, tokens, embeds)
        with torch.no_grad():
            return forward(cfg, params, tokens, embeds=embeds)[0]
    return prefill


def build_decode(cfg: ModelConfig, device: Device = "cuda"
                 ) -> Callable[..., Tuple[torch.Tensor, Any]]:
    """One-token cached decode: ``decode(params, cache, tokens, embeds,
    pos) -> (logits (B, 1, V), cache)``, the cache written in place."""
    dev = resolve_device(device)

    def decode(params, cache, tokens=None, embeds=None, pos=0):
        tokens, embeds = _inputs(dev, tokens, embeds)
        with torch.no_grad():
            return decode_step(cfg, params, cache, tokens, pos,
                               embeds=embeds)
    return decode
