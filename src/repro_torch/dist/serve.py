"""Serve-view engines over the ``(data, model)`` mesh: batched prefill and
cached decode (counterpart of ``repro/dist/serve.py``).

Both builders take a mesh and return ``(step_fn, shardings_fn)``, as the
reference's do. ``mesh`` is a ``("data", "model")`` ``DeviceMesh``, a
device (a one-device mesh; ``meta`` for shapes without memory), or a
mapping of axis sizes (an abstract mesh: ``shardings_fn`` only).
``shardings_fn`` maps shape trees (from :func:`serve_shapes`) to
:class:`NamedSharding` trees, each leaf placed as the reference places it:
parameters over ``model`` only by the train view's rules (with
``embed_mode``'s embedding rewrite), cache leaves by
``sharding.cache_specs`` (``cache_mode``), the batch over ``data`` when it
divides.

The steps run under ``torch.no_grad()`` on the rank's device. Each takes
the global ``tokens`` or ``embeds`` and computes on its own ``data`` slice
of the batch; the parameters and the decode cache are the rank's shards, as
:func:`local_shard` cuts them from the trees ``shardings_fn`` places: over
``data`` the cache's batch rows, over ``model`` the block of every leaf the
reference's specs put on that axis, so that no rank holds a whole copy of
such a leaf. A ``model`` axis larger than 1 runs tensor-parallel
(:mod:`repro_torch.models.parallel`): the activations stay whole on every rank of
the axis, each product runs on the rank's block with the collective its
placement needs, and a placement the port does not run raises, naming the
leaf. Logits come back whole over ``model`` for the rank's ``data`` slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch.device import resolve_or_meta
from repro_torch.dist import sharding as sh
from repro_torch.models import parallel as tpm
from repro_torch.dist.comm import GroupComm
from repro_torch.models.config import InputShape, ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import (decode_step, forward, init_cache,
                                            param_shapes)

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


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A leaf's placement: its ``spec`` (per dimension, the mesh axis or
    None) on ``mesh`` (a ``DeviceMesh``, or the axis sizes)."""

    mesh: Any
    spec: sh.Spec

    def placements(self) -> tuple:
        """The DTensor placements (needs a ``DeviceMesh``)."""
        return sh.placements(self.spec, self.mesh)


class _Mesh:
    """A builder's mesh: its axis sizes, and this rank's device, data
    coordinate and ``model`` group (None for an abstract mesh, and the
    group None when the axis has one rank)."""

    def __init__(self, mesh: Any):
        self.mesh, self.device, self.data_index = mesh, None, 0
        self._tp: Optional[tpm.TP] = None
        if isinstance(mesh, Mapping):
            self.sizes = sh.axis_sizes(mesh)
        elif hasattr(mesh, "mesh_dim_names"):
            self.sizes = sh.axis_sizes(mesh)
            self.device = resolve_or_meta(mesh.device_type)
            self.data_index = sh.coordinates(mesh).get("data", 0)
        else:
            self.device = resolve_or_meta(mesh)
            self.sizes = {"data": 1, "model": 1}

    def checked(self) -> torch.device:
        if self.device is None:
            raise ValueError("an abstract mesh (axis sizes) gives shardings "
                             "only; build with a DeviceMesh or a device to "
                             "run the step")
        return self.device

    @property
    def tp(self) -> Optional[tpm.TP]:
        """The ``model`` axis's :class:`tp.TP` (made on first use), or None
        with one rank on it. A mesh with a ``collectives(axis)`` method
        (the dry run's counted rank) hands in its own."""
        if self.sizes.get("model", 1) > 1 and self._tp is None:
            if hasattr(self.mesh, "collectives"):
                comm = self.mesh.collectives("model")
            else:
                comm = GroupComm(self.mesh.get_group("model"), self.checked())
            self._tp = tpm.TP(comm)
        return self._tp

    def check_blocks(self, cfg: ModelConfig, params: Any, embed_mode: str
                     ) -> None:
        """Every parameter leaf is the rank's block of its placement: a
        whole leaf where the spec splits it is refused (cut the trees with
        :func:`local_shard`), and so is a stacked leaf split over its
        layers, which the port does not run."""
        if self.sizes.get("model", 1) == 1:
            return
        pshape = param_shapes(cfg)
        specs = _serve_param_specs(pshape, self.sizes, embed_mode)

        def walk(shapes, spec, got, path):
            if isinstance(shapes, dict):
                for k in shapes:
                    walk(shapes[k], spec[k], got[k], f"{path}/{k}")
                return
            stacked = path.startswith("/seg")
            if stacked and spec and spec[0] == "model":
                raise tpm.refuse(f"{path[1:]} {tuple(shapes)} split over "
                                 f"its stacked layers")
            block = tuple(
                n // self.sizes[ax] if ax == "model" else n
                for n, ax in zip(shapes, spec + (None,) * len(shapes)))
            if tuple(got.shape) != block:
                raise ValueError(f"{path[1:]}: got {tuple(got.shape)}, this "
                                 f"rank's block is {block}; cut the trees "
                                 f"with serve.local_shard")
        walk(pshape, specs, params, "")

    def batch_spec(self, shape) -> Optional[sh.Spec]:
        """``_batch_sharding``'s spec: the batch dim over ``data`` when it
        divides, else replicated."""
        if shape is None:
            return None
        data = self.sizes.get("data", 1)
        lead = "data" if data > 1 and shape[0] % data == 0 else None
        return (lead,) + (None,) * (len(shape) - 1)

    def sharding(self, spec: Optional[sh.Spec]) -> Optional[NamedSharding]:
        return None if spec is None else NamedSharding(self.mesh, spec)

    def inputs(self, tokens, embeds):
        """The rank's data slice of the global batch, on its device."""
        dev = self.checked()
        out = []
        for x, dtype in ((tokens, torch.int64), (embeds, None)):
            if x is not None:
                x = torch.as_tensor(x)
                spec = self.batch_spec(tuple(x.shape))
                x = x[sh.local_index(spec, tuple(x.shape), self.sizes,
                                     {"data": self.data_index})]
                x = x.to(device=dev) if dtype is None else \
                    x.to(device=dev, dtype=dtype)
            out.append(x)
        return out


def _serve_param_specs(pshape: Any, sizes: Dict[str, int],
                       embed_mode: str) -> Any:
    """The train view's per-leaf rules (no fsdp axis), with the embedding
    on ``model`` along the vocab (``"vocab"``) or d_model (``"dmodel"``)
    dimension, the LM head transposed to match."""
    specs = sh.param_specs(pshape, sizes)
    model = sizes.get("model", 1)
    if model > 1 and "embed" in specs:
        emb = sh.leaf_shape(pshape["embed"]["embedding"])        # (V, D)
        vocab_fits, d_fits = emb[0] % model == 0, emb[1] % model == 0
        if embed_mode == "vocab" and vocab_fits:
            specs["embed"]["embedding"] = ("model", None)
            if "lm_head" in specs["embed"]:
                specs["embed"]["lm_head"] = (None, "model")
        elif embed_mode == "dmodel" and d_fits:
            specs["embed"]["embedding"] = (None, "model")
            if "lm_head" in specs["embed"]:
                specs["embed"]["lm_head"] = ("model", None)
    return specs


def _shardings(m: _Mesh, specs: Any) -> Any:
    if isinstance(specs, dict):
        return {k: _shardings(m, v) for k, v in specs.items()}
    return m.sharding(specs)


def _shape_of(leaf) -> Optional[Tuple[int, ...]]:
    return None if leaf is None else sh.leaf_shape(leaf)


def local_shard(tree: Any, shardings: Any, mesh: Any) -> Any:
    """This rank's block of every leaf of a global ``tree`` (tensors), as
    the matching ``shardings`` place it on the ``DeviceMesh`` ``mesh``: a
    copy of its own, so the whole tree can be freed."""
    sizes, coords = sh.axis_sizes(mesh), sh.coordinates(mesh)
    if isinstance(tree, dict):
        return {k: local_shard(v, shardings[k], mesh)
                for k, v in tree.items()}
    return tree[sh.local_index(shardings.spec, tuple(tree.shape), sizes,
                               coords)].clone()


def build_prefill(cfg: ModelConfig, mesh: Any = "cuda", *,
                  embed_mode: str = "vocab"
                  ) -> Tuple[Callable[..., torch.Tensor], Callable]:
    """Full-sequence forward: ``prefill(params, tokens, embeds) -> logits``
    (the rank's ``(B / data, S, V)``); no backward runs, so nothing is
    recomputed. ``embed_mode`` picks which embedding dim lives on
    ``model`` (``"vocab"`` or ``"dmodel"``)."""
    m = _Mesh(mesh)
    cfg = dataclasses.replace(cfg, remat=False)

    def prefill(params, tokens=None, embeds=None) -> torch.Tensor:
        tokens, embeds = m.inputs(tokens, embeds)
        m.check_blocks(cfg, params, embed_mode)
        with torch.no_grad():
            return forward(cfg, params, tokens, embeds=embeds, tp=m.tp)[0]

    def shardings(pshape, tok, emb):
        ps = _shardings(m, _serve_param_specs(pshape, m.sizes, embed_mode))
        return (ps, m.sharding(m.batch_spec(_shape_of(tok))),
                m.sharding(m.batch_spec(_shape_of(emb))))

    return prefill, shardings


def build_decode(cfg: ModelConfig, mesh: Any = "cuda", *,
                 cache_mode: str = "auto"
                 ) -> Tuple[Callable[..., Tuple[torch.Tensor, Any]],
                            Callable]:
    """One-token cached decode: ``decode(params, cache, tokens, embeds,
    pos) -> (logits (B / data, 1, V), cache)``, the rank's cache shard
    written in place. ``cache_mode`` picks the model-axis placement of the
    cache leaves (``sharding.cache_specs``)."""
    m = _Mesh(mesh)

    def decode(params, cache, tokens=None, embeds=None, pos=0):
        tokens, embeds = m.inputs(tokens, embeds)
        m.check_blocks(cfg, params, "vocab")
        with torch.no_grad():
            return decode_step(cfg, params, cache, tokens, pos,
                               embeds=embeds, tp=m.tp)

    def shardings(pshape, cshape, tok, emb):
        ps = _shardings(m, _serve_param_specs(pshape, m.sizes, "vocab"))
        cs = _shardings(m, sh.cache_specs(cshape, m.sizes,
                                          cache_mode=cache_mode))
        return (ps, cs, m.sharding(m.batch_spec(_shape_of(tok))),
                m.sharding(m.batch_spec(_shape_of(emb))), m.sharding(()))

    return decode, shardings
