"""Fine-grained Mixture-of-Experts, DeepSeek-MoE style (counterpart of
``repro/models/moe.py``).

Shared experts (always on) plus routed experts with top-k softmax gating
renormalized over the selected set, capacity-based dispatch by a gather into
``(E, C, D)`` and a combine back to the tokens (no ``(T, E, C)`` one-hot is
materialized), and the switch-style load-balance auxiliary loss. Expert
weights are stacked ``(E, D, F)``; the expert products are batched matrix
products, which the reference too computes outside any Pallas kernel, so no
kernel of the port is involved.

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
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
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


def route(cfg: ModelConfig, router_w: torch.Tensor, x: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int,
                     torch.Tensor]:
    """x: (T, D) -> ``(token_for_slot, gate_for_slot, aux, cap, slot)``.

    ``token_for_slot``: (E*C,) int32 index into [0, T], T marking an empty
    slot; ``gate_for_slot``: (E*C,) float32; ``aux``: the load-balance loss
    ``E * sum_e f_e P_e``. Slots are filled in (token, choice) order; a
    choice past its expert's capacity is dropped. The first four are the
    reference's; ``slot``: (T, k) int64, the slot of each token's choices
    (``E*C`` for a dropped one), the map that :func:`combine` reads."""
    t_count = x.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    cap = capacity(cfg, t_count)
    dev = x.device
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)                          # (T, E)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top.values[:, :k], top.indices[:, :k]
    # renormalized over the selected set
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)

    # load-balance aux (switch): E * sum_e f_e * P_e
    onehot = F.one_hot(expert_idx, e).to(torch.float32).sum(1)     # (T, E)
    aux = e * torch.sum(onehot.mean(0) * probs.mean(0))

    # position of each (token, choice) within its expert's queue
    flat_expert = expert_idx.reshape(-1)                           # (T*k,)
    pos = torch.cumsum(F.one_hot(flat_expert, e), dim=0) - 1       # (T*k, E)
    pos_in_e = torch.gather(pos, 1, flat_expert[:, None])[:, 0]
    # a choice past its expert's capacity goes to the overflow bin e * cap
    slot = torch.where(pos_in_e < cap, flat_expert * cap + pos_in_e, e * cap)
    token_ids = torch.arange(t_count, dtype=torch.int32,
                             device=dev).repeat_interleave(k)
    token_for_slot = torch.full((e * cap + 1,), t_count, dtype=torch.int32,
                                device=dev).index_put((slot,), token_ids)
    gate_for_slot = torch.zeros((e * cap + 1,), dtype=torch.float32,
                                device=dev).index_put(
                                    (slot,), gate_vals.reshape(-1))
    return (token_for_slot[:-1], gate_for_slot[:-1], aux, cap,
            slot.view(t_count, k))


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
            cap: int, slot: torch.Tensor) -> torch.Tensor:
    """The routed experts on one routing group: gather (E, C, D) through
    the sentinel row, SwiGLU experts, gate-weighted combine. xt: (T, D)."""
    cd = dtype_of(cfg.compute_dtype)
    d = xt.shape[1]
    e = cfg.n_experts
    xt_pad = torch.cat([xt, xt.new_zeros((1, d))])                 # sentinel
    xe = xt_pad[token_for_slot.to(torch.int64)].reshape(e, cap, d)
    h = (F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(cd)))
         * torch.einsum("ecd,edf->ecf", xe, p["w_in"].to(cd)))
    ye = torch.einsum("ecf,efd->ecd", h, p["w_out"].to(cd))
    ye = ye.reshape(e * cap, d) * gate_for_slot[:, None].to(cd)
    return combine(ye, slot)


def _shared(cfg: ModelConfig, p: Params, xt: torch.Tensor) -> torch.Tensor:
    cd = dtype_of(cfg.compute_dtype)
    hs = (F.silu(xt @ p["shared_gate"].to(cd))
          * (xt @ p["shared_in"].to(cd)))
    return hs @ p["shared_out"].to(cd)


def moe_forward(cfg: ModelConfig, p: Params, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D) -> (y, aux). With ``moe_route_blocks > 1`` the tokens
    are routed in that many independent groups (``_moe_forward_blocked``)."""
    if cfg.moe_route_blocks > 1:
        return _moe_forward_blocked(cfg, p, x)
    b, s, d = x.shape
    xt = x.reshape(b * s, d)
    token_for_slot, gate_for_slot, aux, cap, slot = route(cfg, p["router"],
                                                          xt)
    y = _routed(cfg, p, xt, token_for_slot, gate_for_slot, cap, slot)
    if cfg.n_shared_experts:
        y = y + _shared(cfg, p, xt)
    return y.reshape(b, s, d), aux.to(torch.float32)


def _moe_forward_blocked(cfg: ModelConfig, p: Params, x: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocked routing (``moe.py:124``): the tokens split into
    ``moe_route_blocks`` groups, each routed on its own with the capacity of
    its own token count; the aux is the groups' mean."""
    b, s, d = x.shape
    nb = cfg.moe_route_blocks
    if (b * s) % nb:
        raise ValueError(f"{b * s} tokens do not split into {nb} route "
                         f"blocks")
    xt = x.reshape(b * s, d)
    ys, auxs = [], []
    for xb in xt.reshape(nb, b * s // nb, d):
        token_for_slot, gate_for_slot, aux, cap, slot = route(
            cfg, p["router"], xb)
        ys.append(_routed(cfg, p, xb, token_for_slot, gate_for_slot, cap,
                          slot))
        auxs.append(aux)
    y = torch.cat(ys)
    if cfg.n_shared_experts:
        y = y + _shared(cfg, p, xt)
    return y.reshape(b, s, d), torch.stack(auxs).mean().to(torch.float32)
