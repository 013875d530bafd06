"""SPARQ-SGD over ONE flat node-stacked parameter buffer on one device
(counterpart of ``repro/dist/sparq_dist.py``).

The model tree is raveled once into a contiguous ``(n, D_pad)`` float32
buffer, one row per node; ``D_pad`` pads the model dimension ``D`` to whole
1024-element kernel tiles, and the ``[D, D_pad)`` tail is zero and stays zero.
The ravel order is the reference's ``jax.tree.flatten`` order (dict keys
sorted at every level), so the 1024-element tiles, and with them the
selection and the bits, are the reference's. Per sync index (every H steps):

    x^{t+1/2} = x^t - eta_t (m^t or g^t)                       (local step)
    trig_i    = [ ||x_i^{t+1/2} - x_hat_i||^2 > c_t eta_t^2 ]  (row norms)
    q_i       = trig_i * C(x_i^{t+1/2} - x_hat_i)              (flat rows)
    x_hat'    = x_hat + q                                      (line 13)
    x^{t+1}   = x^{t+1/2} + gamma (W_r x_hat' - x_hat')        (line 15)

``C`` is, with ``use_kernel=True``, the blockwise SignTopK kernel in one
launch over the whole buffer; otherwise the registry operator (``TopFrac``
by default, or ``compressor=``) over each node's true D columns, one row at
a time, with the reference's keys ``split(fold_in(fold_in(PRNGKey(seed),
COMPRESS_STREAM), t), n)``; its result overwrites ``diff`` in place.

``W_r`` is round ``sync_rounds % R`` of the gossip plan; a static
circulant plan (ring, complete, ...) with no faults mixes by row rolls,
anything else by the dense product. When one rank holds every node (2 to
16 of them), lines 13 and 15 run in one pass over the rows
(:mod:`repro_torch.kernels.xhat_mix`: the CUDA kernel on the card, its
plain version on the CPU); otherwise column chunk by column chunk (at
least ``COLUMN_CHUNK`` columns and ``MIX_CHUNK_ELEMS`` elements of the
rank's rows a chunk). A fault plan (:mod:`repro_torch.core.faults`)
freezes the rows of skipped nodes in the iterate and the optimizer state
(the old rows are kept across the in-place update and put back), repairs
``W_r`` over the surviving links, mutes offline nodes and charges live
links only. Every node's forward and backward still run: the reported loss
is the mean over all n nodes.

Without a mesh the whole node ensemble lives on the one device. With a
``(node, fsdp, model)`` mesh (:mod:`repro_torch.dist.sharding`) the
ensemble is ``n = lcm(cfg.n_nodes, node)``, as the reference stretches it,
and each rank holds rows ``[r m, (r + 1) m)`` of every node-stacked buffer
(``m = n / node``, ``r`` its node coordinate), replicated over ``fsdp``
and ``model`` as the reference's ``P("node")`` rows are. Each rank runs the
forward and backward of its rows on its fsdp slice of each per-node batch
(the f-th block of rows of each of the reference's microbatches; the loss
and gradients summed over the fsdp group, and every MoE layer routing the
group's whole microbatch as the reference does), the local step, the
trigger norms, the compression of its rows and the x_hat update; the
trigger vector, the fault masks and the repaired ``W_r``, the bits, the
trigger count and the reported loss come from gathered ``(n,)`` vectors
and are the same on every rank. Mixing fetches, per column chunk, the
rolled rows of a shift plan from the ranks that hold them
(:class:`repro_torch.dist.comm.NodeComm`), and keeps the one-process
expression order, so that with ``fsdp = 1`` every row is bit for bit what
one process gives; a dense plan gathers the chunk's n rows and takes its
own rows of the full product.

Memory is the design constraint: at Qwen1.5-0.5B width each ``(4, D_pad)``
float32 buffer is 9.9 GB, so at most five are live (params, x_hat, grads,
the kernel's q, and the optimizer's momentum when there is one) and
everything else is done in place, in column chunks or one row at a time:

* gradients are written straight into the grads buffer: each node's leaves
  are detached views of its params row whose ``.grad`` is the matching view
  of the grads row, so backward accumulates in place;
* the optimizer steps in place and leaves the grads buffer free, which then
  holds ``diff``;
* the trigger norms run over column chunks, and so do the x_hat update and
  the mixing where no one pass takes them (every expression is elementwise
  per column, so chunking keeps the reference's float32 expressions);
* the kernel runs in its ensemble mode on ``diff`` viewed as tiles: no zero
  x_hat and no x_hat_new are allocated;
* the generic operator's temporaries are one row's, and its q overwrites
  ``diff``: no q buffer;
* under faults, only the skipped nodes' rows are copied across the update.

Train state is a dict of tensors updated in place; ``train_step`` returns
the same dict.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import (Any, Callable, Dict, Iterator, List, Mapping, Optional,
                    Tuple, Union)

import torch

from repro_torch import spans
from repro_torch.core import bits as bits_mod
from repro_torch.core import prng
from repro_torch.core.compression import BlockTopFrac, Compressor, TopFrac
from repro_torch.core.faults import COMPRESS_STREAM, FaultPlan, resolve_faults
from repro_torch.core.schedule import LRSchedule, decaying, is_sync
from repro_torch.core.sparq import gossip_mix, sync_message_bits, trigger_mask
from repro_torch.core.topology import (GossipPlan, Topology, circulant_row,
                                       make_plan)
from repro_torch.core.triggers import ThresholdSchedule, zero
from repro_torch.device import resolve_or_meta
from repro_torch.dist.comm import NodeComm
from repro_torch.dist.sharding import fsdp_split
from repro_torch.kernels import ops as kernel_ops
from repro_torch.kernels.sign_topk import BLOCK
from repro_torch.kernels.xhat_mix import MAX_NODES as XHAT_MIX_MAX_NODES
from repro_torch.kernels.xhat_mix import xhat_mix
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of
from repro_torch.models.transformer import init_params, lm_loss, param_shapes
from repro_torch.optim.sgd import Optimizer, resolve_optimizer

State = Dict[str, Any]
Slice = Tuple[Tuple[str, ...], int, int, Tuple[int, ...]]
COLUMN_CHUNK = 1 << 22   # columns per chunk of the sync's elementwise passes
# elements of the rank's rows per chunk of the chunked x_hat update and
# mixing: a mesh's rank of one row exchanges 64 MB messages, not 16 MB (NCCL
# moved 16 MB ones far below NVLink's rate), and m >= 4 rows keep
# COLUMN_CHUNK
MIX_CHUNK_ELEMS = 1 << 24


@dataclasses.dataclass(frozen=True)
class DistSparqConfig:
    """Runtime knobs of the flat-buffer engine (the reference's fields)."""

    H: int = 1                       # gap(I_T): sync every H steps
    variant: str = "dense"           # dense | shift (alias ring): mixing impl
    frac: float = 1.0                # SignTopK fraction (per tile or global)
    use_kernel: bool = False         # the fused blockwise kernel path
    threshold: ThresholdSchedule = zero()
    lr: LRSchedule = decaying(0.5, 10.0)
    momentum: float = 0.0            # shorthand for optimizer=momentum(beta)
    nesterov: bool = False
    optimizer: Optional[Optimizer] = None  # local-update rule; None -> sgd()
    gamma: Optional[float] = None    # None -> gamma* from Lemma 6
    microbatches: int = 1            # grad accumulation within a node
    xhat_dtype: str = "float32"      # public-estimate storage dtype
    topology: Union[str, Topology, None] = None   # kind string, Topology,
                                                  # or None -> "ring"
    deg: int = 4                     # expander degree (kind strings only)
    mixing: str = "uniform"          # uniform | metropolis (kind strings)
    dynamic: str = "none"            # none | matchings | edges | cycle
    rounds: int = 8                  # dynamic support size R
    edge_frac: float = 0.5           # edge keep-probability (dynamic=edges)
    topo_seed: int = 0               # graph / plan sampling seed
    plan: Optional[GossipPlan] = None  # full override (its n must match)
    compressor: Optional[Compressor] = None  # flat-vector operator; None ->
                                             # TopFrac(frac)
    seed: int = 0                    # PRNG seed of stochastic compressors
    faults: Optional[FaultPlan] = None  # link-drop / straggler / dropout

    def resolved_optimizer(self) -> Optimizer:
        return resolve_optimizer(self.optimizer, self.momentum,
                                 nesterov=self.nesterov)

    def resolved_plan(self, n: int) -> GossipPlan:
        """The communication plan at ensemble size ``n``: ``plan=``, an
        explicit Topology as a static plan, or a kind string built here."""
        if self.plan is not None:
            if self.plan.n != n:
                raise ValueError(f"plan {self.plan.name!r} has n="
                                 f"{self.plan.n} but the ensemble has {n}")
            return self.plan
        if isinstance(self.topology, Topology):
            if self.dynamic not in ("none", "static", ""):
                raise ValueError(
                    f"dynamic={self.dynamic!r} with an explicit Topology is "
                    f"ambiguous: pass plan= or a kind string instead")
            if self.topology.n != n:
                raise ValueError(
                    f"topology {self.topology.name!r} has n="
                    f"{self.topology.n} but the ensemble has {n}")
            return GossipPlan.from_topology(self.topology)
        return make_plan(self.topology or "ring", n, deg=self.deg,
                         seed=self.topo_seed, mixing=self.mixing,
                         dynamic=self.dynamic, rounds=self.rounds,
                         edge_frac=self.edge_frac)

    def resolved_compressor(self) -> Compressor:
        if self.compressor is not None:
            if self.use_kernel:
                raise ValueError(
                    "use_kernel=True hard-wires the fused blockwise SignTopK "
                    "operator; a custom compressor= cannot ride it")
            return self.compressor
        return TopFrac(frac=self.frac)

    def effective_compressor(self) -> Compressor:
        """The operator the sync applies: the blockwise kernel's under
        ``use_kernel=True``, else ``resolved_compressor()``. The payload
        bits and gamma* derive from it."""
        if self.use_kernel:
            return BlockTopFrac(frac=self.frac)
        return self.resolved_compressor()

    def resolved_gamma(self, plan: Union[GossipPlan, Topology],
                       d: Optional[int] = None) -> float:
        if self.gamma is not None:
            return float(self.gamma)
        comp = self.effective_compressor()
        if d:
            om = comp.omega(d)
        elif self.compressor is None and not self.use_kernel:
            om = min(self.frac, 2.0 / math.pi)   # TopFrac's d -> inf limit
        elif self.use_kernel:
            om = comp.omega(BLOCK)               # per tile
        else:
            raise ValueError(
                "resolved_gamma() needs the model dimension d when gamma is "
                "None and a custom compressor= is set: its contraction "
                "omega(d) is dimension-dependent")
        return float(plan.gamma_star(max(om, 1e-3)))


def _leaves(tree: Mapping[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in ``jax.tree.flatten`` order: dict keys sorted."""
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, Mapping):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _flatten_spec(shapes: Mapping[str, Any]) -> Tuple[Tuple[Slice, ...], int]:
    """Static ravel plan: per-leaf (path, offset, size, shape), and D."""
    slices, off = [], 0
    for path, shape in _leaves(shapes):
        size = math.prod(shape)
        slices.append((path, off, size, tuple(shape)))
        off += size
    return tuple(slices), off


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value: Any) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def _get(tree: Mapping[str, Any], path: Tuple[str, ...]) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def unravel(flat: torch.Tensor, slices: Tuple[Slice, ...]) -> Dict[str, Any]:
    """One node row, (D_pad,) or (D,), as the model tree of views into it
    (the ravel plan ``slices`` of :func:`_flatten_spec`)."""
    tree: Dict[str, Any] = {}
    for path, off, size, shape in slices:
        _set(tree, path, flat[off:off + size].view(shape))
    return tree


def grad_views(row: torch.Tensor, grad_row: torch.Tensor,
               slices: Tuple[Slice, ...],
               dtype: torch.dtype = torch.float32) -> Dict[str, Any]:
    """One node's model tree for a backward pass: detached views of ``row``
    that require grad, each with the matching view of ``grad_row`` as its
    ``.grad``, so backward accumulates straight into ``grad_row``. Each
    stack ``seg{i}`` is one tree per layer, so that backward never
    materializes a zero gradient of the whole stack per layer. A leaf
    outside the stacks (the embedding, the final norm, a hybrid's
    ``shared_attn``, the MTP head ``mtp``) is one view, and backward adds
    the gradient of every use of it into that view: the embedding's holds
    both the input's lookup and the MTP head's next-token lookup.

    With a ``dtype`` other than float32 (a bfloat16 ``param_dtype``) the
    tree holds each view cast to it, as the reference's ``unravel`` casts
    each leaf (``sparq_dist.py:284-288``): the loss reads the rounded
    weights and the gradient comes back through the cast."""
    def leaf(lo: int, size: int, shape) -> torch.Tensor:
        out = row[lo:lo + size].view(shape).detach()
        out.requires_grad_(True)
        out.grad = grad_row[lo:lo + size].view(shape)
        return out if dtype == torch.float32 else out.to(dtype)

    tree: Dict[str, Any] = {}
    for path, off, size, shape in slices:
        if not path[0].startswith("seg"):
            _set(tree, path, leaf(off, size, shape))
            continue
        n_layers = shape[0]
        layers = tree.setdefault(path[0], [{} for _ in range(n_layers)])
        per = size // n_layers
        for li in range(n_layers):
            _set(layers[li], path[1:], leaf(off + li * per, per, shape[1:]))
    return tree


def _column_chunks(width: int, cols: int = COLUMN_CHUNK) -> Iterator[slice]:
    for lo in range(0, width, cols):
        yield slice(lo, min(width, lo + cols))


def build_sparq(cfg: ModelConfig, dcfg: DistSparqConfig,
                device: Union[str, torch.device, None] = "cuda",
                on_sync: Optional[Callable[[torch.Tensor, Dict[str, Any]],
                                           None]] = None,
                mesh: Any = None, comm: Optional[NodeComm] = None
                ) -> Tuple[Callable[..., State], Callable, Dict[str, Any]]:
    """Build the flat-buffer engine for one model on one device, or on this
    rank's device of a ``(node, fsdp, model)`` ``DeviceMesh``.

    Returns ``(init_fn, train_step, pshape)``:

    * ``init_fn(key=PRNGKey(0), params=None) -> state``: identical x^0 on
      every node, x_hat = 0. x^0 is the reference's
      ``init_params(cfg, key)`` (the same threefry draws on every device),
      drawn once into row 0 and tiled, or the given parameter tree (e.g.
      ``params_from_jax``);
    * ``train_step(state, batch) -> (state, metrics)``: one Algorithm 1
      step, updating ``state`` in place; ``batch`` holds ``(n, per_node,
      seq)`` integer arrays or tensors ``labels`` and ``tokens``, or, for
      the audio and VLM configs, ``labels`` and float ``(n, per_node, seq,
      d_model)`` frontend ``embeds``;
    * ``pshape``: the single-node parameter tree as nested dicts of shapes.

    The ensemble size is ``n = lcm(cfg.n_nodes, node)`` (``cfg.n_nodes``
    without a mesh). With a mesh, the state holds this rank's ``m`` rows,
    ``train_step.rows`` is their range ``(lo, lo + m)``, and ``batch`` is
    either the global ``(n, per_node, seq)`` batch or the rank's rows of it
    ``(m, per_node, seq)``; the engine takes its fsdp slice itself (the
    per-node batch splits over ``fsdp`` when it divides). ``on_sync``, when
    given, is called at every sync before compression with the rank's ``(m,
    D_pad)`` float32 ``diff`` (it must not modify it) and a dict of the
    sync's ``t``, ``sync_round``, mixing matrix ``W`` and degrees ``deg``
    (repaired under faults), ``live`` (None without faults), the gated
    triggers ``trig`` of all n nodes and the rank's ``rows``.
    ``train_step.exchange_s`` lists each sync's host seconds in the row
    exchanges (under NCCL the posting: see ``NodeComm``). With tracing on
    (:mod:`repro_torch.spans`) each step and its parts are spans, and each
    sync counts the rows it compressed and sent.

    ``device="meta"`` builds the engine on shapes without memory (the dry
    run, :mod:`repro_torch.launch.dryrun`): start from
    ``init_fn.zero_state()``, as x^0 is not drawn there. ``comm``, when
    given, stands in for ``NodeComm(mesh, device)`` with the same
    attributes and collectives (the dry run's counting stand-in for one
    rank of a mesh).
    """
    dev = resolve_or_meta(device)
    comm = NodeComm(mesh, dev) if comm is None else comm
    n = math.lcm(int(cfg.n_nodes), comm.node_ax)
    m = n // comm.node_ax
    lo = comm.node_index * m
    plan = dcfg.resolved_plan(n)
    R = plan.R
    comp = dcfg.resolved_compressor()
    comp_eff = dcfg.effective_compressor()
    opt = dcfg.resolved_optimizer()
    H, mbs = int(dcfg.H), int(dcfg.microbatches)
    xhat_dt = dtype_of(dcfg.xhat_dtype)
    param_dt = dtype_of(cfg.param_dtype)
    k_b = (comp_eff._k_b() if isinstance(comp_eff, BlockTopFrac)
           else max(1, min(BLOCK, int(math.ceil(dcfg.frac * BLOCK)))))
    if dcfg.variant not in ("dense", "ring", "shift"):
        raise ValueError(f"unknown variant {dcfg.variant!r}")
    flt = resolve_faults(dcfg.faults)
    if flt is not None:
        flt.validate_for(n)
    # a static circulant W (ring, complete, ...) with no faults turns
    # W x - x into a few row rolls; anything else mixes with the dense
    # product (a repaired or time-varying W is not circulant)
    shift_row = (circulant_row(plan.ws[0])
                 if dcfg.variant in ("ring", "shift") and R == 1 and n > 2
                 and flt is None else None)
    shift_terms = ([(s, float(shift_row[s])) for s in range(1, n)
                    if shift_row[s] > 0.0]
                   if shift_row is not None else None)
    # one rank holding every row of 2 to 16 nodes mixes them in one pass
    # (kernels/xhat_mix.py); a mesh's ranks mix chunk by chunk, fetching
    # the rows they lack from the ranks that hold them
    fused_mix = comm.node_ax == 1 and 2 <= n <= XHAT_MIX_MAX_NODES
    mix_cols = max(COLUMN_CHUNK, MIX_CHUNK_ELEMS // m)
    roll = ((float(shift_row[0]), shift_terms)
            if shift_terms is not None else None)
    ws = torch.tensor(plan.ws, dtype=torch.float32)          # (R, n, n) host
    ws_dev = ws.to(dev)
    degs_dev = torch.tensor(plan.degrees, dtype=torch.float32, device=dev)
    # the stochastic compressor's stream, tagged apart from the fault streams
    base_key = prng.fold_in(prng.PRNGKey(dcfg.seed), COMPRESS_STREAM)

    pshape = param_shapes(cfg)
    slices, D = _flatten_spec(pshape)
    D_pad = max(1, -(-D // BLOCK)) * BLOCK
    gamma = dcfg.resolved_gamma(plan, D)
    payload = float(comp_eff.bits(D))

    def ravel(tree: Mapping[str, Any]) -> torch.Tensor:
        """Model tree -> (D,) float32 flat vector, in the ravel plan's order."""
        return torch.cat([_get(tree, path).reshape(-1).to(torch.float32)
                          for path, _, _, _ in slices])

    def zero_state() -> State:
        """A t = 0 state with every buffer zero: what a restore fills."""
        flat = torch.zeros((m, D_pad), dtype=torch.float32, device=dev)
        total, comp_ = bits_mod.acc_init(dev)
        return {"params": flat,
                "x_hat": torch.zeros((m, D_pad), dtype=xhat_dt, device=dev),
                "opt": opt.init(flat), "t": 0, "bits": total,
                "bits_c": comp_, "sync_rounds": 0,
                "triggers": torch.zeros((), dtype=torch.int32, device=dev)}

    def init_fn(key: Optional[torch.Tensor] = None,
                params: Optional[Mapping[str, Any]] = None) -> State:
        state = zero_state()
        flat = state["params"]
        if params is None:
            # x^0 drawn leaf by leaf straight into row 0, on this device
            init_params(cfg, prng.PRNGKey(0) if key is None else key,
                        out=unravel(flat[0], slices))
        else:
            for path, off, size, _ in slices:
                flat[0, off:off + size].copy_(_get(params, path).reshape(-1))
        flat[1:].copy_(flat[0].expand(m - 1, D_pad))
        return state

    def node_losses_grads(params: torch.Tensor, batch: Mapping[str, Any],
                          grads: torch.Tensor) -> torch.Tensor:
        """Per-node loss of the rank's rows; their gradients accumulate into
        ``grads``, summed over the fsdp group."""
        losses = torch.zeros((m,), dtype=torch.float32, device=dev)
        per = batch["labels"].shape[1]
        if per % mbs:
            raise ValueError(f"batch_per_node {per} is not a multiple of "
                             f"microbatches {mbs}")
        parts = fsdp_split(per, comm.fsdp)
        whole = per // mbs                   # the reference's microbatch
        if whole % parts:
            raise ValueError(f"a microbatch of {whole} rows (batch_per_node "
                             f"{per} / microbatches {mbs}) does not split "
                             f"over fsdp {parts}")
        # rank f holds the f-th block of each of the reference's
        # microbatches, so the group's union of microbatch j is its
        # microbatch j in its token order; the MoE layers route it as one
        # over the group
        mb = whole // parts
        f_lo = comm.fsdp_index * mb if parts > 1 else 0
        group = comm.fsdp_comm if parts > 1 else None
        for i in range(m):
            tree = grad_views(params[i], grads[i], slices, param_dt)
            for j in range(mbs):
                lo_j = j * whole + f_lo
                sub = {k: v[i, lo_j:lo_j + mb] for k, v in batch.items()}
                with spans.span("model.forward"):
                    loss = lm_loss(cfg, tree, sub, group)[0]
                with spans.span("model.backward"):
                    loss.backward()
                losses[i] += loss.detach()
        if mbs > 1:
            losses.div_(mbs)
            grads.div_(mbs)
        if parts > 1:
            comm.sum_fsdp(losses)
            comm.sum_fsdp(grads)
            losses.div_(parts)
            grads.div_(parts)
        return losses

    def mix_term(xe: torch.Tensor, W_r: torch.Tensor) -> torch.Tensor:
        """Consensus term (W_r x - x) of the rank's rows of an (n, chunk)
        block, from its (m, chunk) rows of the new x_hat."""
        x = xe.to(torch.float32)
        if shift_terms is not None:
            # (W x)_i = sum_s c_s x_{(i+s) mod n}: the rolled rows fetched
            # (rolled, with one rank), added in the one-process order
            with spans.span("comm.fetch"):
                rolled = comm.fetch_shifts(xe, [s for s, _ in shift_terms])
            acc = (float(shift_row[0]) - 1.0) * x
            for (_, c_s), x_s in zip(shift_terms, rolled, strict=True):
                acc = acc + c_s * x_s.to(torch.float32)
            return acc
        if comm.node_ax == 1:
            return gossip_mix(W_r, x)
        # the product over all n rows, of which this rank keeps its own: a
        # GEMM of m rows may sum in another order than the n-row one
        with spans.span("comm.fetch"):
            rows = comm.gather_rows(x)
        return gossip_mix(W_r, rows)[lo:lo + m]

    def node_rows(opt_state: Any) -> List[torch.Tensor]:
        """The optimizer state's node-stacked tensors (a shared step count
        is not one)."""
        if isinstance(opt_state, torch.Tensor):
            return [opt_state] if opt_state.dim() and \
                opt_state.shape[0] == m else []
        if isinstance(opt_state, tuple):
            return [r for v in opt_state for r in node_rows(v)]
        return []

    def local_step(state: State, grads: torch.Tensor, eta: torch.Tensor
                   ) -> None:
        """x^{t+1/2} and the optimizer state, in place; nodes that skip the
        step (stragglers, offline) keep their rows exactly."""
        params = state["params"]
        frozen = []
        if flt is not None:
            act = flt.step_mask(state["t"], n)
            frozen = [i for i in range(m) if not act[lo + i]]
        kept = [[buf[i].clone() for buf in [params] + node_rows(state["opt"])]
                for i in frozen]
        state["opt"] = opt.update(grads, state["opt"], params, float(eta))
        for i, rows in zip(frozen, kept, strict=True):
            for buf, row in zip([params] + node_rows(state["opt"]), rows,
                                strict=True):
                buf[i].copy_(row)

    def compress(diff: torch.Tensor, t: int) -> torch.Tensor:
        """q for every row of ``diff`` (untriggered rows are gated later)."""
        if dcfg.use_kernel:
            # one launch over the rank's whole buffer
            return kernel_ops.sign_topk_ensemble(diff, k_b)   # (m, D_pad)
        # the registry operator over each row's true D columns, one row at
        # a time (its temporaries are row-sized), written over diff, with
        # the row's global key
        keys = prng.split(prng.fold_in(base_key, t), n)
        for i in range(m):
            diff[i, :D] = comp(diff[i, :D], keys[lo + i])
        return diff

    def sync(state: State, diff: torch.Tensor, eta: torch.Tensor) -> None:
        params, x_hat = state["params"], state["x_hat"]
        t, r = state["t"], state["sync_rounds"] % R
        with spans.span("sparq.sync.diff"):
            c_t = dcfg.threshold(t)
            sq = torch.zeros((m,), dtype=torch.float32, device=dev)
            for c in _column_chunks(D_pad):
                d = torch.sub(params[:, c], x_hat[:, c].to(torch.float32),
                              out=diff[:, c])
                sq += (d * d).sum(dim=1)
            trig = trigger_mask(comm.gather_vec(sq), c_t, eta)     # (n,)
            live = None
            if flt is None:
                W_r, deg_r = ws_dev[r], degs_dev[r]
            else:
                # the round's matrix repaired over the surviving links,
                # offline nodes muted, bits charged on live links only
                W_r, deg_r, live = flt.apply(ws[r], t, state["sync_rounds"])
                W_r, deg_r = W_r.to(dev), deg_r.to(dev)
                trig = trig & live.to(dev)
            trigf = trig[lo:lo + m].to(torch.float32)
            if on_sync is not None:
                on_sync(diff, {"t": t, "sync_round": state["sync_rounds"],
                               "W": W_r, "deg": deg_r, "live": live,
                               "trig": trig, "rows": (lo, lo + m)})
        with spans.span("sparq.sync.compress"):
            q = compress(diff, t)
        with spans.span("sparq.sync.mix"):
            comm.seconds = 0.0
            if fused_mix:
                # lines 13 and 15 in one pass over the rows (the kernel on
                # the card, its plain version on the CPU)
                xhat_mix(x_hat, params, q, trigf, gamma,
                         w=None if roll is not None else W_r, roll=roll)
            else:
                for c in _column_chunks(D_pad, mix_cols):
                    xe_new = (x_hat[:, c].to(torch.float32)
                              + q[:, c] * trigf[:, None]).to(xhat_dt)
                    x_hat[:, c] = xe_new                  # lines 11, 13
                    params[:, c] += gamma * mix_term(xe_new, W_r)
            exchange_s.append(comm.seconds)
        del q
        with spans.span("sparq.sync.bits"):
            state["bits"], state["bits_c"] = bits_mod.acc_add(
                state["bits"], state["bits_c"],
                sync_message_bits(trig, deg_r, payload))
            state["sync_rounds"] += 1
            state["triggers"] += trig.sum().to(torch.int32)
        if spans.counting():
            # every row is compressed; only the triggered ones are sent
            spans.count("sparq.rows_compressed", m)
            spans.count("sparq.rows_sent", trig[lo:lo + m].sum())
            if fused_mix:
                spans.count("sparq.rows_mixed_kernel", m)

    def train_step(state: State, batch: Mapping[str, Any]
                   ) -> Tuple[State, Dict[str, Any]]:
        with spans.span("sparq.step"):
            return step(state, batch)

    def step(state: State, batch: Mapping[str, Any]
             ) -> Tuple[State, Dict[str, Any]]:
        lead = {v.shape[0] for v in batch.values()}
        if lead not in ({n}, {m}):
            raise ValueError(f"batch leading dims {sorted(lead)} != "
                             f"ensemble size {n} (or this rank's {m} rows)")
        rows = slice(lo, lo + m) if lead == {n} else slice(None)
        # integer tokens and labels as int64; the audio and VLM configs'
        # frontend embeds keep their float dtype
        batch = {k: torch.as_tensor(v)[rows].to(
            device=dev, dtype=None if k == "embeds" else torch.int64)
            for k, v in batch.items()}
        params = state["params"]
        with spans.span("sparq.fwd_bwd"):
            grads = torch.zeros_like(params)
            losses = node_losses_grads(params, batch, grads)
        eta = dcfg.lr(state["t"])
        with torch.no_grad():
            # params becomes x^{t+1/2}; grads is left free for diff
            with spans.span("sparq.local_step"):
                local_step(state, grads, eta)
            if is_sync(state["t"], H):
                with spans.span("sparq.sync"):
                    sync(state, grads, eta)
        del grads
        state["t"] += 1
        metrics = {"loss": comm.gather_vec(losses).mean(), "eta": eta,
                   "bits": state["bits"],
                   "sync_rounds": state["sync_rounds"],
                   "triggers": state["triggers"]}
        return state, metrics

    exchange_s: List[float] = []
    for fn in (init_fn, train_step):
        fn.use_kernel = bool(dcfg.use_kernel)
        fn.lowering = "cuda" if dev.type == "cuda" else "torch"
        fn.device = dev
        fn.n_nodes = n
        fn.rows = (lo, lo + m)
        fn.comm = comm
        fn.exchange_s = exchange_s
        fn.plan = plan
        fn.compressor = comp_eff
        fn.k_b = k_b
        fn.payload_bits = payload
        fn.d_model_total = int(D)
        fn.d_pad = int(D_pad)
        fn.gamma = float(gamma)
        fn.unravel = functools.partial(unravel, slices=slices)
        fn.ravel = ravel
    init_fn.zero_state = zero_state
    return init_fn, train_step, pshape
