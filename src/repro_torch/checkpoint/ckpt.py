"""Full-state checkpoints of the flat-buffer engine (counterpart of
``repro/checkpoint/ckpt.py``: ``save``, ``latest_step``, ``restore``).

Same semantics as the reference: ``<dir>/step_<N>/``, written into a
``.tmp_ckpt_*`` directory beside it and renamed into place; an existing
``step_<N>`` is replaced; :func:`latest_step` is the largest ``step_*`` and
ignores the temp directories; :func:`restore` checks every key, shape and
dtype against the live state and raises on a mismatch.

Another encoding: ``manifest.json`` holds the step, the keys (``/``-joined
paths of the state's leaves, e.g. ``opt/mu``), each leaf's dtype and shape,
and ``extra``; each leaf is one raw little-endian file, ``<key>.bin`` with
``/`` as ``.``. A Python int leaf (``t``, ``sync_rounds``, a step count) is
stored as one int64 and comes back as an int. Each file is written and read
in chunks of one row's consecutive columns at a time, through one reusable
pinned host buffer: a ``(n, D_pad)`` buffer (9.9 GB at Qwen1.5-0.5B width
and 4 nodes) is never copied to the host whole, and no in-memory blob of the
state is built. The reference's msgpack files are not read (it is not a
goal, and the port does not depend on ``msgpack``).

A sharded state (each rank holding rows ``[lo, lo + m)`` of the ``(n,
D_pad)`` buffers, :class:`Rows`) is written to the same format: each rank
writes its row range of every node-stacked file at the rows' byte offset
(one replica of each range writes), rank 0 writes the other leaves and the
manifest and renames ``step_<N>/`` into place after a barrier. Restoring
reads the rank's own rows, so a checkpoint saved at one world size
restores at another, and in one process.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
import shutil
import sys
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import torch

CHUNK_BYTES = 64 << 20     # bytes per transfer through the host buffer
MANIFEST = "manifest.json"

if sys.byteorder != "little":   # the files are raw little-endian bytes
    raise ImportError("repro_torch.checkpoint needs a little-endian host")


def _leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(key, leaf) of a train state: dicts by sorted key, NamedTuples by
    field, tuples by index; tensors and ints are leaves."""
    if isinstance(tree, dict):
        items = sorted(tree.items())
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    elif isinstance(tree, (tuple, list)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from _leaves(v, f"{prefix}/{k}" if prefix else str(k))


def _rebuild(like: Any, values: Dict[str, Any], prefix: str = "") -> Any:
    """``like`` with every leaf replaced by ``values[key]``."""
    def key(k):
        return f"{prefix}/{k}" if prefix else str(k)
    if isinstance(like, dict):
        return {k: _rebuild(v, values, key(k)) for k, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_rebuild(v, values, key(f))
                            for f, v in zip(like._fields, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(_rebuild(v, values, key(i))
                          for i, v in enumerate(like))
    return values[prefix]


@dataclasses.dataclass(frozen=True)
class Rows:
    """This rank's share of a sharded state: rows ``[lo, lo + m)`` of the
    ``n`` rows of every node-stacked leaf (a 2-D tensor of ``m`` rows).
    ``writer``: this rank writes its rows (one replica of each range does);
    ``lead``: this rank writes the other leaves and the manifest."""

    lo: int
    m: int
    n: int
    writer: bool
    lead: bool

    @classmethod
    def of(cls, step: Any) -> "Rows":
        """The share of the engine ``step`` (``build_sparq``'s
        ``train_step`` over a mesh): the replica at fsdp and model index 0
        writes each row range, rank 0 leads."""
        import torch.distributed as dist
        lo, hi = step.rows
        c = step.comm
        return cls(lo, hi - lo, step.n_nodes,
                   writer=c.fsdp_index == 0 and c.model_index == 0,
                   lead=dist.get_rank() == 0)

    @classmethod
    def whole(cls) -> "Rows":
        """One process holding the whole state: it writes every leaf
        whole."""
        return cls(0, 0, 0, writer=True, lead=True)

    def stacked(self, leaf: Any) -> bool:
        return self.n > 0 and isinstance(leaf, torch.Tensor) and \
            leaf.dim() == 2 and leaf.shape[0] == self.m


def _spec(leaf: Any, rows: Optional[Rows] = None) -> Dict[str, Any]:
    if isinstance(leaf, torch.Tensor):
        shape = list(leaf.shape)
        if rows is not None and rows.stacked(leaf):
            shape[0] = rows.n
        return {"dtype": str(leaf.dtype).replace("torch.", ""),
                "shape": shape}
    if isinstance(leaf, int) and not isinstance(leaf, bool):
        return {"dtype": "int", "shape": []}
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


def _as_tensor(leaf: Any) -> torch.Tensor:
    if isinstance(leaf, torch.Tensor):
        return leaf.contiguous()
    return torch.tensor([int(leaf)], dtype=torch.int64)


def _file(key: str) -> str:
    return key.replace("/", ".") + ".bin"


def _ranges(t: torch.Tensor, chunk_elems: int) -> Iterator[Tuple[int, int]]:
    """Flat [lo, hi) ranges over ``t``: row by row along its first axis,
    each row's consecutive columns ``chunk_elems`` at a time."""
    n = t.numel()
    rows = t.shape[0] if t.dim() >= 2 else 1
    width = n // rows if rows else 0
    for r in range(rows):
        for lo in range(r * width, (r + 1) * width, chunk_elems):
            yield lo, min((r + 1) * width, lo + chunk_elems)


class _Staging:
    """One host buffer of CHUNK_BYTES, pinned when a tensor is on a GPU."""

    def __init__(self, tensors: List[torch.Tensor]):
        pin = any(t.is_cuda for t in tensors)
        self.buf = torch.empty(CHUNK_BYTES, dtype=torch.uint8,
                               pin_memory=pin)
        self.np = self.buf.numpy()

    def elems(self, t: torch.Tensor) -> int:
        return CHUNK_BYTES // t.element_size()

    def host(self, t: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        return self.buf[:(hi - lo) * t.element_size()].view(t.dtype)

    def bytes(self, t: torch.Tensor, lo: int, hi: int):
        return memoryview(self.np[:(hi - lo) * t.element_size()])


def _write_rows(f, t: torch.Tensor, stage: _Staging, base: int = 0) -> None:
    """``t``'s elements, a row's column chunk at a time, written at element
    ``base`` of the file ``f`` onwards."""
    flat = t.view(-1)
    for lo, hi in _ranges(t, stage.elems(t)):
        stage.host(t, lo, hi).copy_(flat[lo:hi])
        f.seek((base + lo) * t.element_size())
        f.write(stage.bytes(t, lo, hi))


def save(directory: str, step: int, state: Any,
         extra: Optional[dict] = None, rows: Optional[Rows] = None) -> str:
    """Write ``state`` to ``<directory>/step_<step>``; returns that path.
    With ``rows``, every rank of the default process group calls it with
    its own share (:class:`Rows`); without, this process writes the whole
    state and waits for no other."""
    import torch.distributed as dist
    barrier = dist.barrier if rows is not None else (lambda: None)
    rows = rows or Rows.whole()
    final = os.path.join(directory, f"step_{step}")
    tmp = os.path.join(directory, f".tmp_ckpt_step_{step}")
    leaves = list(_leaves(state))
    tensors = [_as_tensor(v) for _, v in leaves]
    try:
        if rows.lead:
            os.makedirs(directory, exist_ok=True)
            shutil.rmtree(tmp, ignore_errors=True)
            os.makedirs(tmp)
            for (key, leaf), t in zip(leaves, tensors):
                if rows.stacked(leaf):
                    with open(os.path.join(tmp, _file(key)), "wb") as f:
                        f.truncate(rows.n * t[0].numel() * t.element_size())
        barrier()
        stage = _Staging(tensors)
        for (key, leaf), t in zip(leaves, tensors):
            path = os.path.join(tmp, _file(key))
            if rows.stacked(leaf) and rows.writer:
                with open(path, "r+b") as f:
                    _write_rows(f, t, stage, rows.lo * t[0].numel())
            elif not rows.stacked(leaf) and rows.lead:
                with open(path, "wb") as f:
                    _write_rows(f, t, stage)
        barrier()
        if rows.lead:
            manifest = {"step": int(step), "keys": [k for k, _ in leaves],
                        "leaves": {k: _spec(v, rows) for k, v in leaves},
                        "extra": extra or {}}
            with open(os.path.join(tmp, MANIFEST), "w") as f:
                json.dump(manifest, f, indent=1)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
        barrier()
    except BaseException:
        if rows.lead:
            shutil.rmtree(tmp, ignore_errors=True)
        raise
    return final


def latest_step(directory: str) -> Optional[int]:
    """The largest N of the ``step_<N>`` directories, or None."""
    if not os.path.isdir(directory):
        return None
    steps = [int(d.split("_", 1)[1]) for d in os.listdir(directory)
             if d.startswith("step_") and d.split("_", 1)[1].isdigit()]
    return max(steps) if steps else None


def _manifest(path: str) -> Dict[str, Any]:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def _checked(directory: str, step: int, like: Any,
             rows: Optional[Rows] = None
             ) -> Tuple[str, List[Tuple[str, Any]]]:
    """The step's path and ``like``'s leaves, after every key, dtype, shape
    and file size was checked against the manifest."""
    path = os.path.join(directory, f"step_{step}")
    man = _manifest(path)
    leaves = list(_leaves(like))
    keys = [k for k, _ in leaves]
    if sorted(keys) != sorted(man["keys"]):
        missing = sorted(set(keys) - set(man["keys"]))
        unknown = sorted(set(man["keys"]) - set(keys))
        raise ValueError(f"checkpoint {path}: keys differ from the live "
                         f"state (missing {missing}, unknown {unknown})")
    for key, leaf in leaves:
        want, got = _spec(leaf, rows), man["leaves"][key]
        if want != got:
            raise ValueError(f"checkpoint {path}: {key} is {got['dtype']} "
                             f"{got['shape']}, the live state has "
                             f"{want['dtype']} {want['shape']}")
        t = _as_tensor(leaf)
        size = os.path.getsize(os.path.join(path, _file(key)))
        want_size = math.prod(want["shape"]) * t.element_size()
        if size != want_size:
            raise ValueError(f"checkpoint {path}: {key} holds {size} bytes, "
                             f"want {want_size}")
    return path, leaves


def _read(path: str, key: str, t: torch.Tensor, stage: _Staging,
          base: int = 0) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """(lo, hi, host chunk) of ``t``'s elements, read from element ``base``
    of the key's file onwards; each chunk is valid until the next one."""
    with open(os.path.join(path, _file(key)), "rb") as f:
        for lo, hi in _ranges(t, stage.elems(t)):
            f.seek((base + lo) * t.element_size())
            if f.readinto(stage.bytes(t, lo, hi)) != (hi - lo) * \
                    t.element_size():
                raise ValueError(f"checkpoint {path}: {key} is short")
            yield lo, hi, stage.host(t, lo, hi)


def restore(directory: str, step: int, like: Any,
            rows: Optional[Rows] = None) -> Any:
    """The state saved at ``step``, read into ``like``'s tensors in place
    (they keep their devices; no second copy of a buffer is made) and with
    its ints replaced. ``like`` is a live state of the same structure, e.g.
    the engine's zero state; with ``rows``, this rank's share of it (the
    checkpoint may have been saved at any world size)."""
    path, leaves = _checked(directory, step, like, rows)
    stage = _Staging([v for _, v in leaves if isinstance(v, torch.Tensor)])
    values: Dict[str, Any] = {}
    for key, leaf in leaves:
        t = _as_tensor(leaf)
        target = leaf if isinstance(leaf, torch.Tensor) else t
        flat = target.view(-1)
        base = rows.lo * t[0].numel() if rows is not None and \
            rows.stacked(leaf) else 0
        for lo, hi, host in _read(path, key, t, stage, base):
            flat[lo:hi].copy_(host)
        values[key] = leaf if isinstance(leaf, torch.Tensor) else \
            int(target[0])
    return _rebuild(like, values)


def compare(directory: str, step: int, state: Any,
            visit: Callable[[str, int, int, torch.Tensor, torch.Tensor],
                            None],
            keys: Optional[List[str]] = None) -> None:
    """Read the saved state back chunk by chunk beside the live ``state``:
    ``visit(key, lo, hi, live_chunk, saved_chunk)`` for every flat range
    ``[lo, hi)`` of each leaf (in ``keys`` order when given), with the saved
    chunk on the live tensor's device. Keys, dtypes and shapes are checked
    first, as in :func:`restore`."""
    path, leaves = _checked(directory, step, state)
    by_key = dict(leaves)
    stage = _Staging([v for _, v in leaves if isinstance(v, torch.Tensor)])
    for key in keys or [k for k, _ in leaves]:
        t = _as_tensor(by_key[key])
        flat = t.view(-1)
        for lo, hi, host in _read(path, key, t, stage):
            visit(key, lo, hi, flat[lo:hi], host.to(t.device))


def nbytes(state: Any) -> int:
    """Bytes a checkpoint of ``state`` writes (the manifest aside)."""
    return sum(t.numel() * t.element_size()
               for t in (_as_tensor(v) for _, v in _leaves(state)))
