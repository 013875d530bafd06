"""Fine-grained Mixture-of-Experts, DeepSeek-MoE style (counterpart of
``repro/models/moe.py``).

Shared experts (always on) plus routed experts with top-k softmax gating
renormalized over the selected set, capacity-based dispatch by a gather into
``(E, C, D)`` and a combine back to the tokens (no ``(T, E, C)`` one-hot is
materialized), and the switch-style load-balance auxiliary loss. Expert
weights are stacked ``(E, D, F)``; the expert products are batched matrix
products, which the reference too computes outside any Pallas kernel. The
routing's integer tables (queue positions, slots, slot owners, counts) come
from one hand-written pass on the card (``kernels/moe_route.py``), from its
plain version, the reference's eager chain, on the CPU.

Two orders that the reference leaves to XLA are fixed here:

* top-k is a stable descending sort, so ties go to the lower expert index,
  as ``jax.lax.top_k`` breaks them. The queue positions do not depend on the
  order of a token's choices: one token never picks the same expert twice;
* the combine adds each token's (at most k) gate-weighted expert outputs in
  increasing slot order in the compute dtype, one rounding per add: the
  order of XLA's serial scatter-add on the CPU (``moe.py:116``), and the
  same in every run on the card, where an ``index_add_`` would add in the
  order its atomics land.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.core import prng
from repro_torch.kernels.moe_route import (choice_share, moe_route,
                                           moe_route_counts)
from repro_torch.models import parallel as tpm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of

Params = Dict[str, torch.Tensor]

# the reference's init_moe draws leaf i from split(key, 7)[i]
_KEY_INDEX = {"router": 0, "w_gate": 1, "w_in": 2, "w_out": 3,
              "shared_gate": 4, "shared_in": 5, "shared_out": 6}


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """One MoE block's leaves and shapes (the reference's ``init_moe``)."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    out = {"router": (d, e), "w_gate": (e, d, f), "w_in": (e, d, f),
           "w_out": (e, f, d)}
    if cfg.n_shared_experts:
        fs = cfg.moe_d_ff * cfg.n_shared_experts
        out.update(shared_gate=(d, fs), shared_in=(d, fs),
                   shared_out=(fs, d))
    return out


def init_keys(cfg: ModelConfig, key: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """The threefry key of each leaf, ``split(key, 7)`` as in ``init_moe``
    (``moe.py:25``); ``key`` may carry leading batch dims, e.g. one key per
    stacked layer."""
    ks = prng.split(key, 7)
    return {name: ks[..., _KEY_INDEX[name], :] for name in param_shapes(cfg)}


def init_scale(cfg: ModelConfig, name: str) -> float:
    """Each leaf's ``dense_init`` scale: the output projections at
    ``0.02 / sqrt(2 L)``, the router and the other matrices at 0.02."""
    if name in ("w_out", "shared_out"):
        return 0.02 / math.sqrt(2 * cfg.n_layers)
    return 0.02


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots per expert: ``ceil(T k cf / E)`` rounded up to 8, at least 8."""
    cap = int(math.ceil(tokens * cfg.moe_top_k * cfg.capacity_factor
                        / cfg.n_experts))
    return max(8, -(-cap // 8) * 8)


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor,
          group: Optional[tpm.Collectives] = None
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int,
                     torch.Tensor]:
    """x: (T, D) -> ``(token_for_slot, gate_for_slot, aux, cap, slot)``.

    ``token_for_slot``: (E*C,) int32 index into [0, T], T marking an empty
    slot; ``gate_for_slot``: (E*C,) float32; ``aux``: the load-balance loss
    ``E * sum_e f_e P_e``. Slots are filled in (token, choice) order; a
    choice past its expert's capacity is dropped. The first four are the
    reference's; ``slot``: (T, k) int64, the slot of each token's choices
    (``E*C`` for a dropped one), the map that :func:`combine` reads.

    With ``group`` (the fsdp group of a node, each rank holding one
    contiguous block of the node's tokens, in rank order) the tokens are
    routed as the reference routes the whole batch: the capacity comes from
    the group's token count; a choice's queue position is the choices of
    its expert on the lower ranks plus its place among this rank's; ``f_e``
    and ``P_e`` are the group's. This rank's tables hold its own tokens at
    their global slots: the rank's rows of the reference's table. Only a
    ``(ranks, E + 1)`` integer gather and an ``(E,)`` sum cross the ranks.
    ``aux`` is the group's value; its gradient flows through this rank's
    probabilities, ``group.size`` times their share, so that the mean of
    the ranks' gradients (the engine's fsdp mean) is the group's."""
    t_count = x.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    dev = x.device
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                          # (T, E)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top.values[:, :k], top.indices[:, :k]
    # renormalized over the selected set
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    # the slot tables (kernels/moe_route.py: each choice's queue position
    # in (token, choice) order) and the load-balance aux (switch):
    # E * sum_e f_e * P_e
    if group is None:
        cap = capacity(cfg, t_count)
        slot, token_for_slot, counts = moe_route(expert_idx, e, cap)
        aux = e * torch.sum(choice_share(counts, t_count) * probs.mean(0))
    else:
        counts = torch.cat([moe_route_counts(expert_idx, e).to(torch.int64),
                            expert_idx.new_tensor([t_count])])     # (E + 1,)
        every = group.all_gather(counts[None], 0)           # (ranks, E + 1)
        # a meta tensor (the dry run) holds no counts; the engine gives
        # every rank of its fsdp group an equal block of the tokens
        t_all = (t_count * group.size if every.device.type == "meta"
                 else int(every[:, e].sum()))
        cap = capacity(cfg, t_all)
        before = every[:group.rank, :e].sum(0)                     # (E,)
        f_e = every[:, :e].sum(0).to(torch.float32) / t_all
        p_own = probs.sum(0)
        p_all = group.all_reduce(p_own.detach())
        p_e = (p_all + group.size * (p_own - p_own.detach())) / t_all
        aux = e * torch.sum(f_e * p_e)
        slot, token_for_slot, _ = moe_route(expert_idx, e, cap, before)

    # each choice's gate at its slot; the dropped ones land in the overflow
    # bin e * cap, cut off below with the tables' own
    gate_for_slot = torch.zeros((e * cap + 1,), dtype=torch.float32,
                                device=dev).index_put(
                                    (slot.reshape(-1),), gate_vals.reshape(-1))
    return token_for_slot[:-1], gate_for_slot[:-1], aux, cap, slot


def _route_counted(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor,
                   group: Optional[tpm.Collectives] = None):
    """:func:`route` in the ``moe.route`` span; while tracing, its choices,
    the dropped ones and those the kernel placed (every choice on the card,
    none on the CPU) are counted once a forward (not again in a
    checkpointed recompute)."""
    with spans.span("moe.route"):
        out = route(cfg, router_w, x, group=group)
    if spans.counting():
        cap, slot = out[3], out[4]
        spans.count("moe.choices", slot.numel())
        spans.count("moe.dropped", (slot == cfg.n_experts * cap).sum())
        spans.count("moe.routed_kernel", slot.numel() if slot.is_cuda else 0)
    return out


def combine(ye: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """``zeros((T, D)).at[token_for_slot].add(ye)`` in ``ye``'s dtype,
    with each token's slots added in increasing slot order.

    ye: (S, D) per-slot outputs; slot: (T, k) each token's slots in any
    order, S for a dropped choice (a zero row, added last)."""
    ye_pad = torch.cat([ye, ye.new_zeros((1, ye.shape[1]))])
    table = torch.sort(slot, dim=1).values
    y = torch.zeros((slot.shape[0], ye.shape[1]), dtype=ye.dtype,
                    device=ye.device)
    for j in range(slot.shape[1]):
        y = y + ye_pad[table[:, j]]
    return y


def flipped_tokens(a, b, t_count: int) -> List[int]:
    """The tokens whose slot set differs between two ``token_for_slot``
    tables (tensors or arrays): where two routings of the same tokens
    disagree."""
    def slots(tfs):
        out = {}
        for s, t in enumerate(tfs.tolist()):
            if t < t_count:
                out.setdefault(t, []).append(s)
        return out
    sa, sb = slots(a), slots(b)
    return sorted(t for t in set(sa) | set(sb) if sa.get(t) != sb.get(t))


def _routed(cfg: ModelConfig, p: Params, xt: torch.Tensor,
            token_for_slot: torch.Tensor, gate_for_slot: torch.Tensor,
            cap: int, slot: torch.Tensor,
            tp: Optional[tpm.TP] = None) -> torch.Tensor:
    """The routed experts on one routing group: gather (E, C, D) through
    the sentinel row, SwiGLU experts, gate-weighted combine. xt: (T, D).

    With a ``tp`` whose expert leaves hold the rank's experts (expert
    parallelism), the rank runs its experts' slots from the routing every
    rank computed alike, combines its own slots in slot order, and an
    all-reduce sums the ranks' combines."""
    cd = dtype_of(cfg.compute_dtype)
    d = xt.shape[1]
    e, f = cfg.n_experts, cfg.moe_d_ff
    lo, hi = 0, e
    if tp is not None:
        for name, rest in (("w_gate", (d, f)), ("w_in", (d, f)),
                           ("w_out", (f, d))):
            if tuple(p[name].shape[1:]) != rest:
                raise tpm.refuse(f"moe/{name} with model off its expert "
                                 f"dimension (block {tuple(p[name].shape)})")
        if tp.split(p["w_gate"].shape[0], e, "moe experts"):
            lo, hi = tp.block(e)
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])                 # sentinel
    tfs = token_for_slot.to(torch.int64)[lo * cap:hi * cap]
    xe = xt_pad[tfs].reshape(hi - lo, cap, d)
    h = (F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(cd)))
         * torch.einsum("ecd,edf->ecf", xe, p["w_in"].to(cd)))
    ye = torch.einsum("ecf,efd->ecd", h, p["w_out"].to(cd))
    ye = ye.reshape((hi - lo) * cap, d) * \
        gate_for_slot[lo * cap:hi * cap, None].to(cd)
    if (lo, hi) == (0, e):
        return combine(ye, slot)
    # the rank's slots; every other slot reads the zero row, added last
    own = (slot >= lo * cap) & (slot < hi * cap)
    local = torch.where(own, slot - lo * cap, (hi - lo) * cap)
    return tp.reduce(combine(ye, local))


def _shared(cfg: ModelConfig, p: Params, xt: torch.Tensor,
            tp: Optional[tpm.TP] = None) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    fs, d = cfg.moe_d_ff * cfg.n_shared_experts, xt.shape[-1]
    hs = (F.silu(tpm.matmul(xt, p["shared_gate"].to(cd), fs, tp))
          * tpm.matmul(xt, p["shared_in"].to(cd), fs, tp))
    return tpm.matmul(hs, p["shared_out"].to(cd), d, tp)


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                group: Optional[tpm.Collectives] = None,
                tp: Optional[tpm.TP] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux). With ``moe_route_blocks > 1`` the tokens
    are routed in that many independent groups (``_moe_forward_blocked``).
    ``group``: the fsdp group whose ranks hold the rest of the batch, which
    is routed as one (:func:`route`); ``tp``: the serve mesh's ``model``
    axis (expert parallelism, :func:`_routed`)."""
    with spans.span("moe.layer"):
        if cfg.moe_route_blocks > 1:
            return _moe_forward_blocked(cfg, p, x, group, tp)
        b, s, d = x.shape
        xt = x.reshape(b * s, d)
        router = tpm.whole(p["router"], d, tp, dim=0)
        token_for_slot, gate_for_slot, aux, cap, slot = _route_counted(
            cfg, router, xt, group)
        y = _routed(cfg, p, xt, token_for_slot, gate_for_slot, cap, slot, tp)
        if cfg.n_shared_experts:
            y = y + _shared(cfg, p, xt, tp)
        return y.reshape(b, s, d), aux.to(torch.float32)


def _moe_forward_blocked(cfg: ModelConfig, p: Params, x: torch.Tensor,
                         group: Optional[tpm.Collectives] = None,
                         tp: Optional[tpm.TP] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked routing (``moe.py:124``): the tokens split into
    ``moe_route_blocks`` groups, each routed on its own with the capacity of
    its own token count; the aux is the groups' mean. With ``group``, whose
    ranks hold equal contiguous blocks of the batch, each rank routes its
    own route blocks (their count must divide by the group's size); the
    aux's value is the mean over all blocks and its gradient the rank's
    blocks' mean, so that the mean of the ranks' gradients is the
    group's."""
    b, s, d = x.shape
    nb = cfg.moe_route_blocks
    if (b * s) % nb:
        raise ValueError(f"{b * s} tokens do not split into {nb} route "
                         f"blocks")
    if group is not None:
        if nb % group.size:
            raise ValueError(f"{nb} route blocks do not split over the "
                             f"{group.size} ranks of the fsdp group")
        nb //= group.size
    xt = x.reshape(b * s, d)
    router = tpm.whole(p["router"], d, tp, dim=0)
    ys, auxs = [], []
    for xb in xt.reshape(nb, b * s // nb, d):
        token_for_slot, gate_for_slot, aux, cap, slot = _route_counted(
            cfg, router, xb)
        ys.append(_routed(cfg, p, xb, token_for_slot, gate_for_slot, cap,
                          slot, tp))
        auxs.append(aux)
    y = torch.cat(ys)
    if cfg.n_shared_experts:
        y = y + _shared(cfg, p, xt, tp)
    aux = torch.stack(auxs).mean()
    if group is not None:
        aux = aux + (group.all_reduce(aux.detach()) / group.size
                     - aux.detach())
    return y.reshape(b, s, d), aux.to(torch.float32)
