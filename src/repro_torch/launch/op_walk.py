"""Cost walk of one eager PyTorch step (counterpart of ``analyse_hlo``,
``repro/launch/hlo_walk.py:359``).

The reference parses the optimized HLO and has to recover how often each
computation runs: a ``while`` body's trip count from its loop condition, a
``conditional``'s heavier branch. Eager PyTorch executes every iteration of
a Python loop and only the branch it takes, so :class:`OpWalk`, a
``TorchDispatchMode``, sees each operation as often as it runs: the walk is
trip-count-aware by construction. Run the step under it, on ``meta``
tensors (shapes and dtypes, no memory; what the dry run does) or on the
card; the counts are the same.

Per operation that touches a tensor on the walk's device type (host-side
bookkeeping on the CPU, such as the learning-rate schedule, is not device
traffic and is left out):

* ``dot_flops``: the matrix products, by ``torch.utils.flop_counter``'s
  registered formulas for ``mm``, ``addmm``, ``bmm`` and ``baddbmm``
  (``einsum``, ``tensordot`` and ``matmul`` reach these through their
  decomposition); the chunked attention's score and value products
  count, as in the reference.
* ``hbm_bytes``: the bytes of each non-view operation's distinct tensor
  inputs plus its outputs (an ``out=`` argument counts as an output only;
  the destination of ``copy_``, ``fill_`` and ``zero_`` is written, not
  read). Eager PyTorch does not fuse, so this is the traffic the port
  really makes, not the least a fused program could make. Views and
  allocations (``empty*``, ``_unsafe_view``) move nothing.
* ``collective_bytes`` and ``collectives`` by kind: what a counting stand-in
  of the collectives reports through :meth:`OpWalk.charge_collective` (the
  dry run's; see :mod:`repro_torch.launch.dryrun`): the reference's
  result-type bytes of each collective.
* the hand-written kernels: a launch is invisible to the dispatcher (it
  goes through ``ctypes``), so each wrapper charges its closed-form bytes
  (``kernels.sign_topk.work_bytes``, ``kernels.qsgd.work_bytes``) to the
  walks in ``kernels.COST_WALKS``, on ``meta`` as on the card; ``kernels``
  holds the launches and bytes by kernel, and the bytes are in
  ``hbm_bytes``.
* ``peak_live_bytes``: the largest sum, over the walk, of the outputs of
  non-view operations whose result tensors were still referenced (a view
  that outlives its base is not counted), on the walk's device type. The
  dry run adds the state, the batch or the cache that the step was given.

Not ported, and why: the rest of ``hlo_walk.py`` (``parse_alias_map``,
``entry_parameters``, ``entry_parameter_shardings``, ``collective_ops``,
``parse_replica_groups``, ``while_reachable``) reads the compiled module's
aliasing, shardings and replica groups, and feeds only ``hlo_lint`` and
``spmd_lint``, whose rules (R1, R4, R11, P1-P4) are not applicable to the
port (``repro_torch.analysis.rules``).
"""
from __future__ import annotations

import weakref
from typing import Any, Dict, Iterator, Tuple, Union

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import kernels

_aten = torch.ops.aten
# the products whose registered flop formulas count as dot FLOPs
_DOTS = ("mm", "addmm", "bmm", "baddbmm")
# operations that move no data: allocations and aliases not marked as views
_FREE = {_aten.empty.memory_format, _aten.empty_like.default,
         _aten.empty_strided.default, _aten.new_empty.default,
         _aten._unsafe_view.default}
# written, not read: the destination (argument 0) counts once
_WRITE_ONLY = {_aten.copy_.default, _aten.fill_.Scalar, _aten.fill_.Tensor,
               _aten.zero_.default}


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    """The tensors of an operation's arguments or results (tensors, and
    tuples, lists and dicts of them)."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _tensors(v)
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class OpWalk(TorchDispatchMode):
    """Counts what one step does (module doc). ``device`` is the device type
    whose operations are charged (``"meta"`` for a dry run, ``"cuda"`` on
    the card). Use as a context manager; the counts are read after."""

    def __init__(self, device: Union[str, torch.device] = "meta"):
        super().__init__()
        self.device_type = torch.device(device).type
        self.dot_flops = 0
        self.hbm_bytes = 0
        self.collectives: Dict[str, int] = {}
        self.kernels: Dict[str, Dict[str, int]] = {}
        self.dot_flops_by_op: Dict[str, int] = {}
        self.ops = 0
        self.live_bytes = 0
        self.peak_live_bytes = 0
        self._kinds: Dict[Any, Tuple[Any, bool, bool, frozenset]] = {}

    # ------------------------------------------------------------ results
    @property
    def collective_bytes(self) -> int:
        return sum(self.collectives.values())

    def result(self) -> Dict[str, Any]:
        """The reference's keys (``analyse_hlo``), with the kernels' charges
        and the live-set watermark beside them."""
        return {"dot_flops": self.dot_flops, "hbm_bytes": self.hbm_bytes,
                "collective_bytes": self.collective_bytes,
                "collectives": dict(self.collectives),
                "kernels": {k: dict(v) for k, v in self.kernels.items()},
                "dot_flops_by_op": dict(self.dot_flops_by_op),
                "ops": self.ops, "peak_live_bytes": self.peak_live_bytes}

    # ------------------------------------------------------------ charges
    def charge_collective(self, kind: str, nbytes: int) -> None:
        """A collective's result bytes (called by a counting stand-in)."""
        self.collectives[kind] = self.collectives.get(kind, 0) + int(nbytes)

    def charge_kernel(self, name: str, nbytes: int) -> None:
        """One launch of a hand-written kernel and its closed-form bytes
        (called by the kernel wrappers through ``kernels.charge``)."""
        rec = self.kernels.setdefault(name, {"launches": 0, "bytes": 0})
        rec["launches"] += 1
        rec["bytes"] += int(nbytes)
        self.hbm_bytes += int(nbytes)

    def __enter__(self):
        kernels.COST_WALKS.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        kernels.COST_WALKS.remove(self)
        return super().__exit__(*exc)

    # ------------------------------------------------------------ dispatch
    def _on_device(self, tensors) -> bool:
        return any(t.device.type == self.device_type for t in tensors)

    def _freed(self, nbytes: int) -> None:
        self.live_bytes -= nbytes

    def _kind(self, func) -> Tuple[Any, bool, bool, frozenset]:
        """Per operator, once: its flop formula (a dot) or None, whether it
        moves no data, whether its destination is written only, and the
        names of its ``out=`` arguments."""
        kind = self._kinds.get(func)
        if kind is None:
            from torch.utils.flop_counter import flop_registry
            packet = func.overloadpacket
            kind = (flop_registry[packet] if packet.__name__ in _DOTS
                    else None, func.is_view or func in _FREE,
                    func in _WRITE_ONLY,
                    frozenset(a.name for a in func._schema.arguments
                              if a.is_out))
            self._kinds[func] = kind
        return kind

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        flop_fn, free, write_only, out_names = self._kind(func)
        outs = list(_tensors(out))
        ins = list(_tensors(args))
        if kwargs:
            ins += _tensors([v for k, v in kwargs.items()
                             if k not in out_names])
        if not self._on_device(ins + outs):
            return out
        self.ops += 1
        if flop_fn is not None:
            flops = int(flop_fn(*args, **kwargs, out_val=out))
            name = func.overloadpacket.__name__
            self.dot_flops += flops
            self.dot_flops_by_op[name] = \
                self.dot_flops_by_op.get(name, 0) + flops
        if free:
            return out
        seen = set()
        read = 0
        for t in ins[1:] if write_only else ins:
            if id(t) not in seen:
                seen.add(id(t))
                read += _nbytes(t)
        written = sum(_nbytes(t) for t in outs)
        self.hbm_bytes += read + written
        # the live set: fresh outputs (not aliases of an input)
        for t in outs:
            if t.device.type != self.device_type or \
                    any(t is i for i in ins):
                continue
            nb = _nbytes(t)
            self.live_bytes += nb
            weakref.finalize(t, self._freed, nb)
        self.peak_live_bytes = max(self.peak_live_bytes, self.live_bytes)
        return out


def tree_bytes(tree: Any) -> int:
    """Bytes of the tensors of a tree of tuples, lists and dicts."""
    return sum(_nbytes(t) for t in _tensors(tree))
