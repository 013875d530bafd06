"""Mesh factoring and sharding rules (counterpart of
``repro/dist/sharding.py``).

The production mesh is a plain grid of ranks (``(data, model)`` or
``(pod, data, model)``, :mod:`repro_torch.launch.mesh`); the runtime
re-views it:

* :func:`train_mesh` -- ``(node, fsdp, model)``, a pure reshape of the
  production ranks;
* :func:`serve_mesh` -- ``(data, model)``; a pod axis folds into data.

The spec rules are plain functions of shape trees and the mesh's axis
sizes, so they can be held against the reference at its own abstract sizes
with no devices. A spec is a tuple with one entry per dimension: the mesh
axis that dimension is split over, or ``None`` (replicated), as a
``PartitionSpec`` reads. The rules are the reference's:

* an axis is only assigned to a dimension it divides; size-1 axes are never
  named;
* stacked MoE expert tensors ``(L, E, ...)`` put the expert dim on
  ``model``; everything else puts ``model`` on the rightmost dimension it
  divides and ``fsdp`` on the largest remaining one;
* :func:`param_specs` computes within-node specs on the un-stacked
  parameter tree; ``node_dim=True`` prepends the ``node`` axis of the
  node-stacked train state.

:func:`placements` turns a spec into DTensor placements (``Shard(d)`` or
``Replicate()`` per mesh dimension) for a ``DeviceMesh``.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, Mapping, Optional, Tuple

import torch

Spec = Tuple[Optional[str], ...]
Sizes = Mapping[str, int]
TRAIN_AXES = ("node", "fsdp", "model")
SERVE_AXES = ("data", "model")


def axis_sizes(mesh: Any) -> Dict[str, int]:
    """``{axis: size}`` of a ``DeviceMesh`` or of a mapping of sizes (an
    abstract mesh)."""
    if isinstance(mesh, Mapping):
        return {str(k): int(v) for k, v in mesh.items()}
    return dict(zip(mesh.mesh_dim_names, (int(s) for s in mesh.shape),
                    strict=True))


# ------------------------------------------------------------------ mesh views

def train_mesh_shape(prod_shape: Tuple[int, ...], n_nodes: int,
                     pod_axis_to: str = "node") -> Tuple[int, int, int]:
    """``(node, fsdp, model)`` of the reference's ``train_mesh`` for a
    production grid of ``prod_shape``: the model axis keeps the grid's minor
    axis; a pod axis multiplies nodes (``pod_axis_to == "node"``) or fsdp;
    the node axis is the largest factor of the non-model grid that divides
    the ensemble size."""
    model = int(prod_shape[-1])
    if len(prod_shape) == 3 and pod_axis_to == "node":
        n_nodes *= int(prod_shape[0])
    data_total = math.prod(prod_shape) // model
    node_ax = math.gcd(max(int(n_nodes), 1), data_total)
    return node_ax, data_total // node_ax, model


def serve_mesh_shape(prod_shape: Tuple[int, ...]) -> Tuple[int, int]:
    """``(data, model)`` of the reference's ``serve_mesh``."""
    model = int(prod_shape[-1])
    return math.prod(prod_shape) // model, model


def _reshaped(prod, shape: Tuple[int, ...], names: Tuple[str, ...]):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(prod.device_type, prod.mesh.reshape(shape),
                      mesh_dim_names=names)


def train_mesh(prod, cfg):
    """The ``(node, fsdp, model)`` view of a production ``DeviceMesh``.
    Every rank of the mesh must call it (it creates the axes' groups)."""
    shape = train_mesh_shape(tuple(prod.shape), cfg.n_nodes,
                             cfg.pod_axis_to)
    return _reshaped(prod, shape, TRAIN_AXES)


def serve_mesh(prod):
    """The ``(data, model)`` view of a production ``DeviceMesh``."""
    return _reshaped(prod, serve_mesh_shape(tuple(prod.shape)), SERVE_AXES)


def cli_factoring(ndev: int, n_nodes: int) -> Tuple[int, int]:
    """The reference train CLI's factoring of ``ndev`` devices
    (``repro/launch/train.py:125-140``): ``(n_nodes, model_par)``, with
    ``n_nodes = min(n_nodes, ndev)`` lowered until it divides ``ndev`` and
    the model axis the largest of 16, 8, 4, 2, 1 that divides the rest. The
    production grid is then ``(ndev // model_par, model_par)``."""
    n = min(int(n_nodes), int(ndev))
    while ndev % n:
        n -= 1
    rest = ndev // n
    model_par = next(m for m in (16, 8, 4, 2, 1) if rest % m == 0)
    return n, model_par


# ------------------------------------------------------------------ spec rules

def _fits(dim: int, size: int) -> bool:
    return size > 1 and dim % size == 0


def leaf_shape(leaf: Any) -> Tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else tuple(leaf)


def _map(fn: Callable[[Tuple[str, ...], Any], Any], tree: Any,
         path: Tuple[str, ...] = ()) -> Any:
    """``fn(path, leaf)`` over a tree of dicts; anything else is a leaf."""
    if isinstance(tree, Mapping):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _leaf_param_spec(path_keys: Tuple[str, ...], shape: Tuple[int, ...],
                     fsdp: int, model: int) -> Spec:
    ndim = len(shape)
    spec: list = [None] * ndim
    mdim = None
    if "moe" in path_keys and ndim >= 3 and _fits(shape[1], model):
        mdim = 1                          # expert parallelism
    else:
        for d in range(ndim - 1, -1, -1):  # tensor parallel: rightmost fit
            if _fits(shape[d], model):
                mdim = d
                break
    if mdim is not None:
        spec[mdim] = "model"
    fcands = [d for d in range(ndim) if d != mdim and _fits(shape[d], fsdp)]
    if fcands:
        spec[max(fcands, key=lambda d: shape[d])] = "fsdp"
    return tuple(spec)


def param_specs(pshape: Any, mesh: Any, *, node_dim: bool = False) -> Any:
    """A spec per parameter leaf (leaves: shapes or anything with
    ``.shape``). ``node_dim=True`` prepends ``"node"`` for the node-stacked
    train state."""
    sizes = axis_sizes(mesh)
    fsdp, model = sizes.get("fsdp", 1), sizes.get("model", 1)

    def spec_of(path, leaf):
        s = _leaf_param_spec(path, leaf_shape(leaf), fsdp, model)
        return ("node",) + s if node_dim else s

    return _map(spec_of, pshape)


def _is_integer(dtype: torch.dtype) -> bool:
    return not (dtype.is_floating_point or dtype.is_complex
                or dtype == torch.bool)


def cache_specs(cshape: Any, mesh: Any, *, cache_mode: str = "auto") -> Any:
    """Decode-cache specs over the serve mesh. Cache leaves are ``(L, B,
    ...)``: batch over ``data``; ``model`` on an inner dim (heads, head_dim,
    latent: ``"inner"``) or on the sequence dim (``"seq"``); ``"auto"``
    prefers inner. Integer leaves (position rings) and leaves of rank < 3
    are replicated."""
    if cache_mode not in ("auto", "inner", "seq"):
        raise ValueError(f"unknown cache_mode {cache_mode!r}")
    sizes = axis_sizes(mesh)
    data, model = sizes.get("data", 1), sizes.get("model", 1)

    def spec_of(_, leaf):
        shape = leaf_shape(leaf)
        ndim = len(shape)
        spec: list = [None] * ndim
        if _is_integer(leaf.dtype) or ndim < 3:
            return tuple(spec)
        if _fits(shape[1], data):
            spec[1] = "data"
        inner = next((d for d in range(3, ndim) if _fits(shape[d], model)),
                     None)
        if cache_mode in ("auto", "inner") and inner is not None:
            spec[inner] = "model"
        elif cache_mode in ("auto", "seq") and _fits(shape[2], model):
            spec[2] = "model"
        return tuple(spec)

    return _map(spec_of, cshape)


def train_batch_specs(bshape: Any, mesh: Any) -> Any:
    """Node-stacked train batches ``(n_nodes, per_node, ...)``: the node
    axis over ``node``, the per-node batch over ``fsdp`` when it divides."""
    fsdp = axis_sizes(mesh).get("fsdp", 1)

    def spec_of(_, leaf):
        shape = leaf_shape(leaf)
        per = shape[1] if len(shape) > 1 else 0
        f = "fsdp" if per and per % fsdp == 0 else None
        return ("node", f) + (None,) * (len(shape) - 2)

    return _map(spec_of, bshape)


# ------------------------------------------------------- specs on a DeviceMesh

def placements(spec: Spec, mesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: per mesh dimension,
    ``Shard(d)`` for the tensor dim ``d`` the spec puts on it, else
    ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec) if ax == name]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def local_index(spec: Spec, shape: Tuple[int, ...], sizes: Sizes,
                coords: Mapping[str, int]) -> Tuple[slice, ...]:
    """The index of one rank's block of a tensor of ``shape`` placed by
    ``spec``, the rank at ``coords`` on a mesh of ``sizes``."""
    index = []
    for d, ax in enumerate(spec + (None,) * (len(shape) - len(spec))):
        if ax is None:
            index.append(slice(None))
            continue
        step = shape[d] // sizes[ax]
        index.append(slice(coords[ax] * step, (coords[ax] + 1) * step))
    return tuple(index)


def coordinates(mesh) -> Dict[str, int]:
    """This rank's coordinate on each axis of a ``DeviceMesh``."""
    return dict(zip(mesh.mesh_dim_names, mesh.get_coordinate(), strict=True))


def fsdp_split(per: int, fsdp: int) -> int:
    """How many parts the per-node batch splits into over ``fsdp``
    (:func:`train_batch_specs`'s rule): ``fsdp`` when it divides, else 1
    (the batch is replicated over the axis)."""
    return fsdp if fsdp > 1 and per % fsdp == 0 else 1
