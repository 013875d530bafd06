"""Fused trigger-gated blockwise SignTopK: the hand-written CUDA kernel
(``csrc/sign_topk.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/sign_topk.py``. The selection contract is the
reference's: per 1024-element tile the support is exactly the index set
``jax.lax.top_k(|diff|, k_b)`` would return (every ``|diff|`` strictly above
the k_b-th largest, then the lowest-index ties until k_b are chosen), except
that zero lanes are never selected, so ``|support| <= k_b`` and zero-padded
tiles stay silent.

:func:`sign_topk_blocks` launches the kernel for CUDA tensors and runs the
plain version (:func:`sign_topk_blocks_plain`) for CPU tensors; it never
picks the plain version for a CUDA tensor. ``sign_topk_blocks.launches`` counts kernel
launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple, Union

import torch

from repro_torch import kernels

BLOCK = 1024

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p)
ENTRIES = {torch.float32: "sign_topk_f32", torch.bfloat16: "sign_topk_bf16"}


def _row_threshold(av: torch.Tensor, k_b: int) -> torch.Tensor:
    """Per-row k_b-th largest of nonnegative f32 rows by exact radix select
    on the bit patterns (``sign_topk.py:44``). ``|diff|`` has bit 31 clear,
    so an int32 view keeps the pattern order and the passes start at bit 30
    (the reference's bit-31 pass can never fire). The result is an achieved
    element, 0 for rows with fewer than k_b nonzeros. av: (rows, B) ->
    (rows, 1)."""
    u = av.contiguous().view(torch.int32)
    prefix = torch.zeros(av.shape[0], dtype=torch.int32, device=av.device)
    for bit in range(30, -1, -1):
        cand = prefix | (1 << bit)
        cnt = (u >= cand[:, None]).sum(dim=1)
        prefix = torch.where(cnt >= k_b, cand, prefix)
    return prefix.view(torch.float32)[:, None]


def _block_compress(diff: torch.Tensor, trig: Union[float, torch.Tensor],
                    k_b: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-k blockwise SignTopK on f32 rows (``sign_topk.py:66``).

    diff: (rows, BLOCK) f32; trig: 0. or 1. Returns (q (rows, BLOCK) f32,
    per-row scale (rows,) f32, already trig-gated)."""
    av = diff.abs()
    pos = av > 0.0
    thr = _row_threshold(av, k_b)
    gt = (av > thr) & pos
    tie = (av >= thr) & ~gt & pos
    # fill the remaining quota with the lowest-index ties (top_k order)
    quota = k_b - gt.sum(dim=1, keepdim=True, dtype=torch.int32)
    rank = torch.cumsum(tie.to(torch.int32), dim=1, dtype=torch.int32)
    mask = gt | (tie & (rank <= quota))
    nsel = mask.sum(dim=1, keepdim=True, dtype=torch.float32)
    scale = (torch.where(mask, av, 0.0).sum(dim=1, keepdim=True)
             / torch.clamp(nsel, min=1.0))
    signs = torch.where(diff >= 0, 1.0, -1.0)
    t = torch.as_tensor(trig, dtype=torch.float32, device=diff.device)
    q = torch.where(mask, t * scale * signs, 0.0)
    return q, (t * scale[:, 0]).to(torch.float32)


def _check_cuda_inputs(x_half: torch.Tensor, x_hat: Optional[torch.Tensor],
                       k_b: int) -> None:
    if x_half.dtype not in ENTRIES:
        raise TypeError(f"sign_topk kernel takes float32 or bfloat16, got "
                        f"{x_half.dtype}")
    if x_half.dim() != 2 or x_half.shape[1] != BLOCK:
        raise ValueError(f"sign_topk kernel takes (n_tiles, {BLOCK}) inputs, "
                         f"got {tuple(x_half.shape)}")
    if not 1 <= k_b <= BLOCK:
        raise ValueError(f"k_b must lie in [1, {BLOCK}], got {k_b}")
    for name, t in (("x_half", x_half), ("x_hat", x_hat)):
        if t is None:
            continue
        if t.dtype != x_half.dtype or t.shape != x_half.shape:
            raise ValueError(f"{name} must match x_half's shape and dtype")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")


def entry(dtype: torch.dtype) -> Tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    """The library and the bound C launch entry for ``dtype``: ``(x_half,
    x_hat, trig, k_b, n_tiles, q, x_hat_new, scale, stream)``."""
    lib = kernels.library("sign_topk")
    return lib, kernels.bind(lib, ENTRIES[dtype], _ARGTYPES)


def launch_config(dtype: torch.dtype, n_tiles: int) -> Tuple[int, int]:
    """``(grid, block)`` of the kernel's launch over ``n_tiles`` tiles."""
    return kernels.launch_config("sign_topk", ENTRIES[dtype], n_tiles)


def attributes(dtype: torch.dtype) -> Dict[str, int]:
    """The compiled kernel's registers, static shared memory, local memory,
    largest block and resident blocks per SM (:func:`kernels.attributes`)."""
    return kernels.attributes("sign_topk", ENTRIES[dtype])


def _launch(x_half: torch.Tensor, x_hat: Optional[torch.Tensor], trig: float,
            k_b: int) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                               torch.Tensor]:
    _check_cuda_inputs(x_half, x_hat, k_b)
    n = x_half.shape[0]
    q = torch.empty_like(x_half)
    x_hat_new = None if x_hat is None else torch.empty_like(x_half)
    scale = torch.empty((n,), dtype=torch.float32, device=x_half.device)
    if n == 0:
        return q, x_hat_new, scale
    lib, fn = entry(x_half.dtype)
    with torch.cuda.device(x_half.device):
        stream = torch.cuda.current_stream(x_half.device).cuda_stream
        code = fn(kernels.ptr(x_half), kernels.ptr(x_hat), float(trig), k_b,
                  n, kernels.ptr(q), kernels.ptr(x_hat_new),
                  kernels.ptr(scale), stream)
    kernels.check(lib, code, "sign_topk")
    sign_topk_blocks.launches += 1
    return q, x_hat_new, scale


def sign_topk_blocks_plain(x_half: torch.Tensor,
                           x_hat: Optional[torch.Tensor],
                           trig: Union[float, torch.Tensor], k_b: int
                           ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                      torch.Tensor]:
    """The plain PyTorch version of the kernel, on any device: the
    reference's XLA leg (``sign_topk.py:109``) written in torch."""
    if x_half.dim() != 2 or x_half.shape[1] != BLOCK:
        raise ValueError(f"inner dim must be {BLOCK}, got "
                         f"{tuple(x_half.shape)}")
    diff = x_half.to(torch.float32)
    if x_hat is not None:
        diff = diff - x_hat.to(torch.float32)
    q32, scale = _block_compress(diff, trig, k_b)
    q = q32.to(x_half.dtype)
    return q, (None if x_hat is None else x_hat + q), scale


def sign_topk_blocks(x_half: torch.Tensor, x_hat: Optional[torch.Tensor],
                     trig: Union[float, torch.Tensor], k_b: int
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                torch.Tensor]:
    """x_half, x_hat: (n_blocks, BLOCK) f32 or bf16; trig: 0. or 1.

    Returns (q, x_hat_new, per-block scale f32), like the reference
    (``sign_topk.py:122``). ``x_hat=None`` is the ensemble mode: diff is
    x_half itself and x_hat_new is None (no zero x_hat is allocated and no
    x_hat_new is written). CUDA tensors launch the kernel; CPU tensors run
    :func:`sign_topk_blocks_plain`."""
    if kernels.uses_kernel(x_half, x_hat):
        return _launch(x_half, x_hat, float(trig), k_b)
    return sign_topk_blocks_plain(x_half, x_hat, trig, k_b)


sign_topk_blocks.launches = 0
