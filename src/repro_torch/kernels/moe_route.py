"""MoE routing's queue positions and slot tables in one pass: the
hand-written CUDA kernel (``csrc/moe_route.cu``) and its plain PyTorch
version.

It replaces no reference kernel: it fuses the integer chain that
:func:`repro_torch.models.moe.route` ran eagerly, the counterpart of lines
75-80 of ``repro/models/moe.py``. For each routing group of T tokens with k
expert ids each, in (token, choice) order::

    pos    = before[e] + the choices of expert e ahead of this one
    slot   = e * cap + pos, or E * cap (dropped) when pos >= cap
    tfs[s] = the token holding slot s, T where none does (and at E * cap)
    counts = each expert's choices, before capacity

``before`` (E,) carries the choices of each expert on the fsdp group's lower
ranks. The ids may be read in place: the sort's ``indices[:, :k]`` of a
(T, E) tensor (row stride E) needs no copy.

:func:`moe_route` launches the kernel for CUDA tensors and runs
:func:`moe_route_plain` for CPU tensors; it never picks the plain version for
a CUDA tensor. ``meta`` tensors run nothing and charge :func:`work_bytes` to
the cost walks (``kernels.charge``), as a launch does. :func:`moe_route_counts`
is the kernel's counting pass alone (the fsdp group's pre-scan counts).
``moe_route.launches`` counts kernel launches of either entry and nothing
else: one a routing up to :data:`CHUNK` choices a group, two past it.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import kernels

BLOCK = 1024              # threads a block
CHUNK = 32768             # choices one block ranks; past it a counting launch
MAX_EXPERTS = 256         # deepseek-v3's routed experts
MAX_TOP_K = 8             # its top-8
MAX_GROUPS = 65535        # the grid's second extent

ENTRIES = {"count": "moe_route_count", "rank": "moe_route_rank"}
_ARGTYPES = {
    "count": (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
              ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
              ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p),
    "rank": (ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p)}

Tables = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _check(expert_idx: torch.Tensor, n_experts: int, cap: Optional[int],
           before: Optional[torch.Tensor]) -> None:
    """Raise on what the kernel does not take (``cap`` None: the counting
    pass)."""
    if expert_idx.dtype != torch.int64 or expert_idx.dim() not in (2, 3):
        raise ValueError(f"moe_route takes (T, k) or (groups, T, k) int64 "
                         f"expert ids, got {expert_idx.dtype} "
                         f"{tuple(expert_idx.shape)}")
    t, k = expert_idx.shape[-2:]
    if not 1 <= k <= MAX_TOP_K:
        raise ValueError(f"moe_route takes 1 to {MAX_TOP_K} choices a "
                         f"token, got {k}")
    if not 1 <= n_experts <= MAX_EXPERTS:
        raise ValueError(f"moe_route takes 1 to {MAX_EXPERTS} experts, got "
                         f"{n_experts}")
    if expert_idx.dim() == 3 and not 1 <= expert_idx.shape[0] <= MAX_GROUPS:
        raise ValueError(f"moe_route takes 1 to {MAX_GROUPS} groups")
    if t * k >= 2 ** 31:
        raise ValueError(f"{t} x {k} choices exceed 2^31 a group")
    if expert_idx.stride(-1) != 1:
        raise ValueError("the expert ids' choice stride must be 1")
    if cap is not None and not (
            1 <= cap and n_experts * cap + 1 + BLOCK < 2 ** 31):
        raise ValueError(f"capacity {cap} at {n_experts} experts out of "
                         f"range")
    if before is not None and (
            before.dtype != torch.int64 or not before.is_contiguous()
            or tuple(before.shape) != (*expert_idx.shape[:-2], n_experts)):
        raise ValueError(f"before must be contiguous int64 of shape "
                         f"{(*expert_idx.shape[:-2], n_experts)}")


def blocks(n_choices: int) -> int:
    """Blocks a group takes: one a :data:`CHUNK` of choices, at least 1."""
    return max(1, -(-n_choices // CHUNK))


@functools.cache
def entry(key: str) -> Tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    """The library and the bound C launch entry ``"count"`` (``ids,
    group_stride, ld, groups, t, k, e, blocks, block_counts, stream``) or
    ``"rank"`` (``ids, group_stride, ld, groups, t, k, e, cap, blocks,
    before, block_counts, slot, tfs, counts, stream``)."""
    lib = kernels.library("moe_route")
    return lib, kernels.bind(lib, ENTRIES[key], _ARGTYPES[key])


def launch_config(key: str, n_choices: int) -> Tuple[int, int]:
    """``(blocks a group, block)`` of a launch over ``n_choices`` choices a
    group."""
    return kernels.launch_config("moe_route", ENTRIES[key], n_choices)


def attributes(key: str) -> Dict[str, int]:
    """The compiled kernel's registers, static shared memory, local memory,
    largest block and resident blocks per SM (:func:`kernels.attributes`)."""
    return kernels.attributes("moe_route", ENTRIES[key])


def work_bytes(t: int, k: int, n_experts: int, cap: Optional[int],
               groups: int = 1, before: bool = False) -> int:
    """The bytes one routing must move: the ids read and the slots written
    at 8 B a choice, the slot owners (E cap + 1) and counts at 4 B, ``before``
    read; ``cap`` None: the counting pass, ids in and counts out. At the MoE
    cells' 4,096 x 6 of 64 (cap 480): 516,356 B."""
    if cap is None:
        return groups * (8 * t * k + 4 * n_experts)
    per = 16 * t * k + 4 * (n_experts * cap + 1) + 4 * n_experts
    return groups * (per + (8 * n_experts if before else 0))


def _ids_strides(expert_idx: torch.Tensor) -> Tuple[int, int, int]:
    """``(groups, group stride, token stride)`` of the ids in elements."""
    if expert_idx.dim() == 3:
        return (expert_idx.shape[0], expert_idx.stride(0),
                expert_idx.stride(1))
    return 1, 0, expert_idx.stride(0)


def _launch_count(expert_idx: torch.Tensor, n_experts: int) -> torch.Tensor:
    """The counting launch: (groups, blocks, E) int32."""
    groups, gs, ld = _ids_strides(expert_idx)
    t, k = expert_idx.shape[-2:]
    nb = blocks(t * k)
    out = torch.empty((groups, nb, n_experts), dtype=torch.int32,
                      device=expert_idx.device)
    lib, fn = entry("count")
    with torch.cuda.device(expert_idx.device):
        stream = torch.cuda.current_stream(expert_idx.device).cuda_stream
        code = fn(kernels.ptr(expert_idx), gs, ld, groups, t, k, n_experts,
                  nb, kernels.ptr(out), stream)
    kernels.check(lib, code, "moe_route_count")
    moe_route.launches += 1
    return out


def _launch_rank(expert_idx: torch.Tensor, n_experts: int, cap: int,
                 before: Optional[torch.Tensor]) -> Tables:
    groups, gs, ld = _ids_strides(expert_idx)
    lead, (t, k) = expert_idx.shape[:-2], expert_idx.shape[-2:]
    dev = expert_idx.device
    nb = blocks(t * k)
    block_counts = _launch_count(expert_idx, n_experts) if nb > 1 else None
    slot = torch.empty((*lead, t, k), dtype=torch.int64, device=dev)
    tfs = torch.empty((*lead, n_experts * cap + 1), dtype=torch.int32,
                      device=dev)
    counts = torch.empty((*lead, n_experts), dtype=torch.int32, device=dev)
    lib, fn = entry("rank")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        code = fn(kernels.ptr(expert_idx), gs, ld, groups, t, k, n_experts,
                  cap, nb, kernels.ptr(before), kernels.ptr(block_counts),
                  kernels.ptr(slot), kernels.ptr(tfs), kernels.ptr(counts),
                  stream)
    kernels.check(lib, code, "moe_route_rank")
    moe_route.launches += 1
    return slot, tfs, counts


def moe_route_plain(expert_idx: torch.Tensor, n_experts: int, cap: int,
                    before: Optional[torch.Tensor] = None) -> Tables:
    """The plain PyTorch version, on any device: the eager chain
    :func:`repro_torch.models.moe.route` ran, group by group."""
    if expert_idx.dim() == 3:
        outs = [moe_route_plain(expert_idx[i], n_experts, cap,
                                None if before is None else before[i])
                for i in range(expert_idx.shape[0])]
        return tuple(torch.stack(o) for o in zip(*outs))
    t_count, k = expert_idx.shape
    e, dev = n_experts, expert_idx.device
    flat_expert = expert_idx.reshape(-1)                           # (T*k,)
    choices = F.one_hot(flat_expert, e)                            # (T*k, E)
    # position of each (token, choice) within its expert's queue
    pos = torch.cumsum(choices, dim=0) - 1 + (0 if before is None
                                              else before)         # (T*k, E)
    pos_in_e = torch.gather(pos, 1, flat_expert[:, None])[:, 0]
    # a choice past its expert's capacity goes to the overflow bin e * cap
    slot = torch.where(pos_in_e < cap, flat_expert * cap + pos_in_e, e * cap)
    token_ids = torch.arange(t_count, dtype=torch.int32,
                             device=dev).repeat_interleave(k)
    token_for_slot = torch.full((e * cap + 1,), t_count, dtype=torch.int32,
                                device=dev).index_put((slot,), token_ids)
    token_for_slot[-1] = t_count            # the overflow bin holds no token
    return (slot.view(t_count, k), token_for_slot,
            choices.sum(0).to(torch.int32))


def moe_route(expert_idx: torch.Tensor, n_experts: int, cap: int,
              before: Optional[torch.Tensor] = None) -> Tables:
    """expert_idx: (T, k) or (groups, T, k) int64 ids in [0, E), choice
    stride 1; ``before``: (E,) or (groups, E) int64 or None. Returns
    ``(slot, token_for_slot, counts)``: (..., T, k) int64, (..., E cap + 1)
    int32 and (..., E) int32. CUDA tensors launch the kernel (one launch for
    every group, two past :data:`CHUNK` choices a group); CPU tensors run
    :func:`moe_route_plain`; ``meta`` tensors charge the kernel's bytes and
    run nothing."""
    meta = kernels.on_meta(expert_idx, before)
    if not meta and not kernels.uses_kernel(expert_idx, before):
        return moe_route_plain(expert_idx, n_experts, cap, before)
    _check(expert_idx, n_experts, cap, before)
    lead, (t, k) = expert_idx.shape[:-2], expert_idx.shape[-2:]
    groups = _ids_strides(expert_idx)[0]
    kernels.charge("moe_route", work_bytes(t, k, n_experts, cap, groups,
                                           before is not None))
    if not meta:
        return _launch_rank(expert_idx, n_experts, cap, before)
    m = torch.device("meta")
    return (torch.empty((*lead, t, k), dtype=torch.int64, device=m),
            torch.empty((*lead, n_experts * cap + 1), dtype=torch.int32,
                        device=m),
            torch.empty((*lead, n_experts), dtype=torch.int32, device=m))


def moe_route_counts(expert_idx: torch.Tensor, n_experts: int
                     ) -> torch.Tensor:
    """Each expert's choices (..., E) int32: the kernel's counting pass
    alone for CUDA tensors, ``one_hot(ids).sum`` for CPU tensors; ``meta``
    tensors charge its bytes and run nothing."""
    meta = kernels.on_meta(expert_idx)
    if not meta and not kernels.uses_kernel(expert_idx):
        flat = expert_idx.reshape(*expert_idx.shape[:-2], -1)
        return F.one_hot(flat, n_experts).sum(-2).to(torch.int32)
    _check(expert_idx, n_experts, None, None)
    lead, (t, k) = expert_idx.shape[:-2], expert_idx.shape[-2:]
    groups = _ids_strides(expert_idx)[0]
    kernels.charge("moe_route", work_bytes(t, k, n_experts, None, groups))
    if meta:
        return torch.empty((*lead, n_experts), dtype=torch.int32,
                           device=torch.device("meta"))
    per_block = _launch_count(expert_idx, n_experts)
    out = per_block[:, 0] if per_block.shape[1] == 1 else \
        per_block.sum(1, dtype=torch.int32)
    return out.reshape(*lead, n_experts)


def choice_share(counts: torch.Tensor, t_count: int) -> torch.Tensor:
    """f_e, each expert's choices over the T tokens in float32, rounded as
    ``one_hot(ids).float().sum(1).mean(0)`` rounds it on the counts' device:
    ``count / T`` on the CPU (a sum, then a division); on the card ATen's
    mean multiplies the sum by ``float(E) / float(T E)``."""
    c = counts.to(torch.float32)
    if counts.device.type != "cuda":
        return c / t_count
    e = counts.shape[-1]
    return c * float(np.float32(e) / np.float32(t_count * e))


moe_route.launches = 0
