"""The collectives of the sharded flat-buffer engine, and the bring-up of
its ranks.

Where the reference lets GSPMD insert collectives along the ``node`` and
``fsdp`` axes of its mesh (the per-shift ``jnp.roll`` becomes a
collective-permute, the per-node batch's gradient an all-reduce), the port
calls them by hand, over the groups of a ``(node, fsdp, model)``
``DeviceMesh``. :class:`NodeComm` holds the few the engine needs:

* :meth:`NodeComm.gather_rows`: an ``(m, chunk)`` block of every node-axis
  rank into the ``(n, chunk)`` block of all n rows;
* :meth:`NodeComm.fetch_shifts`: for each shift ``s``, the rows ``(i + s)
  mod n`` of the rank's rows ``i``, from the one or two ranks that hold
  them, every shift's sends and receives posted together;
* :meth:`NodeComm.gather_vec`: a small per-node float32 vector (squared
  norms, losses) of every node-axis rank;
* :meth:`NodeComm.sum_fsdp`: the sum over the fsdp group, in place.

:class:`GroupComm` holds the collectives of one group that the models
call: the fsdp group's routing sums of a MoE layer
(:func:`repro_torch.models.moe.route`) and the ``model`` axis of a serve
mesh (:mod:`repro_torch.models.parallel`): an out-of-place all-reduce and an
all-gather along a dimension.

With one rank on an axis, its functions are the identity (the vector gather
still goes through the group's collective). Gloo cannot send, receive or
gather CUDA tensors, so under gloo a CUDA block is staged through pinned
host buffers that are allocated once and reused; that is decided once, from
the group's backend and the device (``transport``), never as a reaction to
a failure.

:func:`spawn` runs a function in N fresh processes joined by a process
group over a ``FileStore`` in a temporary directory, with a deadline on
each of the group's collectives (a hung rank fails its peers fast) and, if
the caller asks, on the whole join; :func:`init_rank` joins one process
(also under ``torchrun``). The backend is NCCL when every rank has a card of its own,
and gloo when ranks share a card or run on the CPU.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch import spans

TIMEOUT_S = 900.0      # a group's deadline on each collective, seconds
STAGE_ELEMS = 1 << 22  # elements per staged chunk of the fsdp sum
# the row exchanges' counter and span (repro_torch.spans): the bytes a rank
# posts to send plus those it receives, and the ops' launch and waits
FETCH_BYTES = "comm.fetch_bytes"
FETCH_WAIT = "comm.fetch.wait"


def backend_for(device_type: str, ranks_per_host: int) -> str:
    """NCCL when each rank on a host has a card of its own, else gloo."""
    if device_type == "cuda" and \
            ranks_per_host <= torch.cuda.device_count():
        return "nccl"
    return "gloo"


def ranks_per_card(device_type: str, ranks_per_host: int) -> int:
    if device_type != "cuda":
        return 0
    return math.ceil(ranks_per_host / torch.cuda.device_count())


def rank_device(device_type: str, local_rank: int) -> torch.device:
    """``cuda:{local_rank % cards}``, or the CPU."""
    if device_type == "cuda":
        return torch.device("cuda", local_rank % torch.cuda.device_count())
    return torch.device("cpu")


def init_rank(rank: int, world: int, backend: str, device: torch.device,
              store: Optional[dist.Store] = None,
              timeout_s: float = TIMEOUT_S) -> None:
    """Join this process to the default group as ``rank`` of ``world``,
    with its device made current first. ``store=None`` reads the
    rendezvous from the environment (``torchrun``)."""
    if device.type == "cuda":
        torch.cuda.set_device(device)
        torch.empty(0, device=device)          # the context, before the mesh
    kw: Dict[str, Any] = {"timeout": datetime.timedelta(seconds=timeout_s)}
    if store is not None:
        kw.update(store=store, rank=rank, world_size=world)
    dist.init_process_group(backend, **kw)


@contextlib.contextmanager
def single_rank_group(backend: str, device: torch.device,
                      timeout_s: float = TIMEOUT_S) -> Iterator[None]:
    """A default group of this one process (e.g. NCCL's own path on one
    card), destroyed on exit."""
    with tempfile.TemporaryDirectory() as tmp:
        init_rank(0, 1, backend, device,
                  dist.FileStore(os.path.join(tmp, "store"), 1), timeout_s)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _rank_entry(local_rank: int, fn: Callable, args: Sequence, world: int,
                backend: str, device_type: str, tmp: str,
                timeout_s: float) -> None:
    torch.set_num_threads(1)        # the ranks share the host's cores
    device = rank_device(device_type, local_rank)
    init_rank(local_rank, world, backend, device,
              dist.FileStore(os.path.join(tmp, "store"), world), timeout_s)
    try:
        out = fn(local_rank, *args)
    finally:
        dist.destroy_process_group()
    torch.save(out, os.path.join(tmp, f"rank{local_rank}.pt"))


def spawn(fn: Callable[..., Any], nprocs: int, args: Sequence = (), *,
          device_type: str = "cpu", timeout_s: float = TIMEOUT_S,
          deadline_s: Optional[float] = None) -> List[Any]:
    """``fn(rank, *args)`` in ``nprocs`` fresh processes (spawn start
    method, one intra-op thread each), each joined to one process group
    first (``timeout_s``: its deadline on each collective), its device made
    current; returns each rank's return value (saved with ``torch.save``:
    keep it on the host and small). Raises when any rank fails, or, when
    ``deadline_s`` is given, when the ranks are not all done within it: a
    failed rank fails the run. A run without ``deadline_s`` may last as
    long as its ranks keep their collectives within ``timeout_s``."""
    import torch.multiprocessing as mp
    backend = backend_for(device_type, nprocs)
    with tempfile.TemporaryDirectory() as tmp:
        ctx = mp.start_processes(
            _rank_entry, args=(fn, tuple(args), nprocs, backend, device_type,
                               tmp, timeout_s),
            nprocs=nprocs, join=False, start_method="spawn")
        deadline = None if deadline_s is None else \
            time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=1.0):
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"{nprocs} ranks not done within "
                                       f"{deadline_s:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join()
        return [torch.load(os.path.join(tmp, f"rank{r}.pt"),
                           weights_only=False) for r in range(nprocs)]


class _Staged:
    """Reusable host buffers for staging a CUDA block under gloo (pinned,
    allocated once per key and grown when a larger block comes)."""

    staged = False
    _host: Dict[str, torch.Tensor]

    def _buffer(self, key: str, like: torch.Tensor, numel: int
                ) -> torch.Tensor:
        """A reusable host buffer of ``numel`` elements of ``like``'s dtype
        (pinned, for staging a CUDA block)."""
        buf = self._host.get(key)
        if buf is None or buf.dtype != like.dtype or buf.numel() < numel:
            buf = torch.empty(numel, dtype=like.dtype, pin_memory=True)
            self._host[key] = buf
        return buf[:numel]

    def _stage_out(self, x: torch.Tensor, key: str) -> torch.Tensor:
        if not self.staged:
            return x
        return self._buffer(key, x, x.numel()).view(x.shape).copy_(x)

    def _landing(self, out: torch.Tensor, key: str) -> torch.Tensor:
        if not self.staged:
            return out
        return self._buffer(key, out, out.numel()).view(out.shape)


class GroupComm(_Staged):
    """The collectives of one process group on ``device``, for the models:
    an out-of-place all-reduce and an all-gather along a dimension. Under
    gloo on a card they go through pinned host buffers (``_Staged``); every
    call returns after its collective is done, so a buffer is free again
    for the next call."""

    def __init__(self, group: Any, device: torch.device):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.staged = device.type == "cuda" and \
            dist.get_backend(group) == "gloo"
        self._host = {}

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group (``op``: sum or max), a new
        tensor on ``t``'s device."""
        rop = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}[op]
        if not self.staged:
            out = t.contiguous().clone()
            dist.all_reduce(out, op=rop, group=self.group)
            return out
        host = self._stage_out(t.contiguous(), "reduce")
        dist.all_reduce(host, op=rop, group=self.group)
        return host.to(t.device)

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes, at least one dimension),
        concatenated along ``dim`` in rank order. The bytes are moved as
        they are (gloo gathers no 16-bit integers)."""
        raw = t.contiguous().view(torch.uint8)
        src = self._stage_out(raw, "gather_out")
        land = torch.empty((self.size,) + tuple(raw.shape),
                           dtype=torch.uint8, device=t.device)
        land_h = self._landing(land, "gather_in")
        dist.all_gather(list(land_h.unbind(0)), src, group=self.group)
        if self.staged:
            land.copy_(land_h)
        return torch.cat(land.view(t.dtype).unbind(0), dim=dim)


class NodeComm(_Staged):
    """The engine's collectives over a ``(node, fsdp, model)`` mesh (None:
    one process, every function the identity). Rows ``[node_index * m,
    (node_index + 1) * m)`` of every node-stacked buffer live on this rank;
    ``seconds`` accumulates the host time spent in the row exchanges. Under
    NCCL that is the posting alone: a wait there orders the device's stream
    behind the transfer and returns at once, so the transfer's own time is
    the device time of the ``comm.fetch.wait`` span (:data:`FETCH_WAIT`).

    With tracing on, each exchange adds to the counter
    :data:`FETCH_BYTES` the bytes this rank posts to send plus the bytes
    it receives, counted where the ops are built (nothing on one rank), and
    runs the launch of its ops and the waits on them inside the span
    :data:`FETCH_WAIT`: NCCL launches a group's transfer kernel when
    ``batch_isend_irecv`` closes the group, and a kernel's device time
    belongs to the span open at its launch."""

    def __init__(self, mesh: Any, device: torch.device):
        self.device = device
        self.seconds = 0.0
        self._host: Dict[str, torch.Tensor] = {}
        if mesh is None:
            self.node_ax = self.fsdp = 1
            self.node_index = self.fsdp_index = self.model_index = 0
            self.node_group = self.fsdp_group = None
            self.fsdp_comm = None
            self.staged = False
            self.backend, self.transport = "none", "none"
            return
        from repro_torch.dist.sharding import axis_sizes, coordinates
        sizes, coords = axis_sizes(mesh), coordinates(mesh)
        if tuple(mesh.mesh_dim_names) != ("node", "fsdp", "model"):
            raise ValueError(f"the engine needs a (node, fsdp, model) mesh, "
                             f"got {mesh.mesh_dim_names}")
        self.node_ax, self.fsdp = sizes["node"], sizes["fsdp"]
        self.node_index, self.fsdp_index, self.model_index = (
            coords["node"], coords["fsdp"], coords["model"])
        self.node_group = mesh.get_group("node")
        self.fsdp_group = mesh.get_group("fsdp")
        # the MoE layers' routing sums over the fsdp group
        self.fsdp_comm = (GroupComm(self.fsdp_group, device)
                          if self.fsdp > 1 else None)
        # the global rank of node k's row block at this rank's (fsdp, model)
        self.peers = [int(r) for r in
                      mesh.mesh[:, self.fsdp_index, self.model_index]]
        if dist.get_process_group_ranks(self.node_group) != self.peers:
            raise ValueError("the node group's ranks are not in node order")
        self.backend = dist.get_backend(self.node_group)
        self.staged = device.type == "cuda" and self.backend == "gloo"
        self.transport = ("pinned host buffers" if self.staged else
                          "host" if device.type == "cpu" else "device")

    # ---------------------------------------------------------- collectives
    def gather_vec(self, v: torch.Tensor) -> torch.Tensor:
        """``(m,)`` float32 of every node-axis rank -> ``(n,)``."""
        if self.node_group is None:
            return v
        src = v.cpu() if self.staged else v.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.node_ax)]
        dist.all_gather(parts, src, group=self.node_group)
        return torch.cat(parts).to(v.device)

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """``(m, C)`` of every node-axis rank -> ``(n, C)`` in row order."""
        if self.node_ax == 1:
            return x
        t0 = time.perf_counter()
        m, c = x.shape
        out = torch.empty((self.node_ax * m, c), dtype=x.dtype,
                          device=x.device)
        land = self._landing(out, "gather_in")
        src = self._stage_out(x.contiguous(), "gather_out")
        # the block to each of the other ranks, and theirs from each
        spans.count(FETCH_BYTES, 2 * (self.node_ax - 1) * src.numel()
                    * src.element_size())
        with spans.span(FETCH_WAIT):
            dist.all_gather(list(land.view(self.node_ax, m, c).unbind(0)),
                            src, group=self.node_group)
        if self.staged:
            out.copy_(land)
        self.seconds += time.perf_counter() - t0
        return out

    def fetch_shifts(self, x: torch.Tensor, shifts: Sequence[int]
                     ) -> List[torch.Tensor]:
        """For each shift ``s``: the ``(m, C)`` block whose row ``j`` is
        global row ``(lo + j + s) mod n`` (``lo`` the rank's first row),
        i.e. ``torch.roll(x_all, -s, 0)``'s rows of this rank."""
        if self.node_ax == 1:
            return [torch.roll(x, -s, dims=0) for s in shifts]
        t0 = time.perf_counter()
        A, r = self.node_ax, self.node_index
        m = x.shape[0]
        x = x.contiguous()
        src = self._stage_out(x, "shift_out")
        outs = [torch.empty_like(x) for _ in shifts]
        lands = [self._landing(o, f"shift_in{i}") for i, o in
                 enumerate(outs)]
        ops = []
        for i, s in enumerate(shifts):
            q, off = (s // m) % A, s % m
            # (result rows, source rows, the node they come from, the node
            # this rank's source rows go to, tag); the two nodes are this
            # rank together, and then the rows are copied here
            runs = [(slice(0, m - off), slice(off, m), (r + q) % A,
                     (r - q) % A, 2 * i)]
            if off:
                runs.append((slice(m - off, m), slice(0, off),
                             (r + q + 1) % A, (r - q - 1) % A, 2 * i + 1))
            for dst_rows, src_rows, frm, to, tag in runs:
                if frm == r:
                    lands[i][dst_rows].copy_(src[src_rows])
                    continue
                ops.append(dist.P2POp(dist.irecv, lands[i][dst_rows],
                                      self.peers[frm], self.node_group,
                                      tag=tag))
                ops.append(dist.P2POp(dist.isend, src[src_rows],
                                      self.peers[to], self.node_group,
                                      tag=tag))
        if ops:
            spans.count(FETCH_BYTES, sum(op.tensor.numel()
                                         * op.tensor.element_size()
                                         for op in ops))
            with spans.span(FETCH_WAIT):
                for work in dist.batch_isend_irecv(ops):
                    work.wait()
        if self.staged:
            for o, land in zip(outs, lands, strict=True):
                o.copy_(land)
        self.seconds += time.perf_counter() - t0
        return outs

    def sum_fsdp(self, t: torch.Tensor) -> None:
        """``t`` summed over the fsdp group, in place (staged
        ``STAGE_ELEMS`` elements at a time through a pinned buffer under
        gloo)."""
        if self.fsdp == 1:
            return
        if not self.staged:
            dist.all_reduce(t, group=self.fsdp_group)
            return
        flat = t.view(-1)
        for lo in range(0, flat.numel(), STAGE_ELEMS):
            part = flat[lo:lo + STAGE_ELEMS]
            host = self._stage_out(part, "fsdp")
            dist.all_reduce(host, group=self.fsdp_group)
            part.copy_(host)

    def describe(self) -> str:
        """Backend, ranks per card and transport, for the mesh line."""
        if self.node_group is None:
            return "one process"
        local = int(os.environ.get("LOCAL_WORLD_SIZE",
                                   dist.get_world_size()))
        per_card = ranks_per_card(self.device.type, local)
        where = (f"{per_card} rank(s) per card" if per_card else
                 f"{local} rank(s) on the CPU")
        return f"backend {self.backend}, {where}, transport {self.transport}"
