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
"""
from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
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


def _spec(leaf: Any) -> Dict[str, Any]:
    if isinstance(leaf, torch.Tensor):
        return {"dtype": str(leaf.dtype).replace("torch.", ""),
                "shape": list(leaf.shape)}
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


def save(directory: str, step: int, state: Any,
         extra: Optional[dict] = None) -> str:
    """Write ``state`` to ``<directory>/step_<step>``; returns that path."""
    final = os.path.join(directory, f"step_{step}")
    os.makedirs(directory, exist_ok=True)
    tmp = tempfile.mkdtemp(dir=directory, prefix=".tmp_ckpt_")
    try:
        leaves = list(_leaves(state))
        tensors = [_as_tensor(v) for _, v in leaves]
        stage = _Staging(tensors)
        for (key, _), t in zip(leaves, tensors):
            flat = t.view(-1)
            with open(os.path.join(tmp, _file(key)), "wb") as f:
                for lo, hi in _ranges(t, stage.elems(t)):
                    stage.host(t, lo, hi).copy_(flat[lo:hi])
                    f.write(stage.bytes(t, lo, hi))
        manifest = {"step": int(step), "keys": [k for k, _ in leaves],
                    "leaves": {k: _spec(v) for k, v in leaves},
                    "extra": extra or {}}
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
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


def _checked(directory: str, step: int, like: Any
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
        want, got = _spec(leaf), man["leaves"][key]
        if want != got:
            raise ValueError(f"checkpoint {path}: {key} is {got['dtype']} "
                             f"{got['shape']}, the live state has "
                             f"{want['dtype']} {want['shape']}")
        t = _as_tensor(leaf)
        size = os.path.getsize(os.path.join(path, _file(key)))
        if size != t.numel() * t.element_size():
            raise ValueError(f"checkpoint {path}: {key} holds {size} bytes, "
                             f"want {t.numel() * t.element_size()}")
    return path, leaves


def _read(path: str, key: str, t: torch.Tensor, stage: _Staging
          ) -> Iterator[Tuple[int, int, torch.Tensor]]:
    """(lo, hi, host chunk) of the key's file, valid until the next one."""
    with open(os.path.join(path, _file(key)), "rb") as f:
        for lo, hi in _ranges(t, stage.elems(t)):
            f.seek(lo * t.element_size())
            if f.readinto(stage.bytes(t, lo, hi)) != (hi - lo) * \
                    t.element_size():
                raise ValueError(f"checkpoint {path}: {key} is short")
            yield lo, hi, stage.host(t, lo, hi)


def restore(directory: str, step: int, like: Any) -> Any:
    """The state saved at ``step``, read into ``like``'s tensors in place
    (they keep their devices; no second copy of a buffer is made) and with
    its ints replaced. ``like`` is a live state of the same structure, e.g.
    the engine's zero state."""
    path, leaves = _checked(directory, step, like)
    stage = _Staging([v for _, v in leaves if isinstance(v, torch.Tensor)])
    values: Dict[str, Any] = {}
    for key, leaf in leaves:
        t = _as_tensor(leaf)
        target = leaf if isinstance(leaf, torch.Tensor) else t
        flat = target.view(-1)
        for lo, hi, host in _read(path, key, t, stage):
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
