"""Blockwise QSGD stochastic quantizer: the hand-written CUDA kernel
(``csrc/qsgd.cu``) and its plain PyTorch version.

Counterpart of ``repro/kernels/qsgd.py``. Per 1024-element tile: ``norm =
||x||_2``; ``level = |x| / norm * s`` (norm 0 counts as 1); the level is
rounded down, or up where the uniform noise ``u`` lies below its fraction;
``out = norm * sign(x) * level / s`` with ``sign(0) = 0``. The noise is an
input, as in the reference, so one ``u`` gives one answer.

:func:`qsgd_blocks` launches the kernel for CUDA tensors and runs
:func:`qsgd_blocks_plain` for CPU tensors; it never picks the plain version
for a CUDA tensor. ``meta`` tensors get a ``meta`` output and run nothing.
``qsgd_blocks.launches`` counts kernel launches and nothing else. A launch
and a ``meta`` call charge :func:`work_bytes` to the cost walks
(``kernels.charge``).
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch import kernels

BLOCK = 1024

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_longlong, ctypes.c_void_p, ctypes.c_void_p)
ENTRIES = {torch.float32: "qsgd_f32", torch.bfloat16: "qsgd_bf16"}


def qsgd_rows(x: torch.Tensor, u: torch.Tensor, s: int) -> torch.Tensor:
    """The per-row Q_s math on float32 rows (``qsgd.py:24``); reduces over
    the last axis."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    safe = torch.where(norm > 0, norm, 1.0)
    level = x.abs() / safe * s
    low = torch.floor(level)
    q = (low + (u < level - low).to(torch.float32)) / s
    return norm * torch.sign(x) * q


def _check(x: torch.Tensor, u: torch.Tensor, s: int) -> None:
    if x.dim() != 2 or x.shape[1] != BLOCK:
        raise ValueError(f"qsgd takes (n_tiles, {BLOCK}) inputs, got "
                         f"{tuple(x.shape)}")
    if u.shape != x.shape:
        raise ValueError(f"u must have x's shape {tuple(x.shape)}, got "
                         f"{tuple(u.shape)}")
    if int(s) < 1:
        raise ValueError(f"s must be a positive number of levels, got {s}")


def entry(dtype: torch.dtype) -> Tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    """The library and the bound C launch entry for ``dtype``: ``(x, u, s,
    n_tiles, out, stream)``."""
    lib = kernels.library("qsgd")
    return lib, kernels.bind(lib, ENTRIES[dtype], _ARGTYPES)


def launch_config(dtype: torch.dtype, n_tiles: int) -> Tuple[int, int]:
    """``(grid, block)`` of the kernel's launch over ``n_tiles`` tiles."""
    return kernels.launch_config("qsgd", ENTRIES[dtype], n_tiles)


def attributes(dtype: torch.dtype) -> Dict[str, int]:
    """The compiled kernel's registers, static shared memory, local memory,
    largest block and resident blocks per SM (:func:`kernels.attributes`)."""
    return kernels.attributes("qsgd", ENTRIES[dtype])


def work_bytes(n_tiles: int, dtype: torch.dtype) -> int:
    """The bytes one launch over ``n_tiles`` tiles must move: x and the
    float32 noise u read once, the output written once. At float32:
    ``n_tiles * 1024 * 12``."""
    esize = dtype.itemsize
    return n_tiles * BLOCK * (2 * esize + 4)


def _output(x: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """The output of the kernel on checked inputs, allocated and not
    written, and its charge to the cost walks."""
    if x.dtype not in ENTRIES:
        raise TypeError(f"qsgd kernel takes float32 or bfloat16 x, got "
                        f"{x.dtype}")
    if u.dtype != torch.float32:
        raise TypeError(f"qsgd kernel takes float32 noise, got {u.dtype}")
    for name, t in (("x", x), ("u", u)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{name} must be contiguous and 16-byte aligned")
    if x.shape[0]:
        kernels.charge("qsgd", work_bytes(x.shape[0], x.dtype))
    return torch.empty_like(x)


def _launch(x: torch.Tensor, u: torch.Tensor, s: int) -> torch.Tensor:
    out = _output(x, u)
    n = x.shape[0]
    if n == 0:
        return out
    lib, fn = entry(x.dtype)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(kernels.ptr(x), kernels.ptr(u), int(s), n, kernels.ptr(out),
                  stream)
    kernels.check(lib, code, "qsgd")
    qsgd_blocks.launches += 1
    return out


def qsgd_blocks_plain(x: torch.Tensor, u: torch.Tensor, s: int = 16
                      ) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device: the
    reference's XLA leg (``qsgd.py:50``) written in torch."""
    _check(x, u, s)
    return qsgd_rows(x.to(torch.float32), u.to(torch.float32),
                     int(s)).to(x.dtype)


def qsgd_blocks(x: torch.Tensor, u: torch.Tensor, s: int = 16
                ) -> torch.Tensor:
    """x: (n_blocks, BLOCK) float32 or bfloat16; u: (n_blocks, BLOCK)
    uniform [0, 1) noise, float32 on the card. Returns the quantized x in
    x's dtype (``qsgd.py:41``). CUDA tensors launch the kernel; CPU tensors
    run :func:`qsgd_blocks_plain`; ``meta`` tensors get a ``meta``
    output."""
    if kernels.on_meta(x, u):
        _check(x, u, s)
        return _output(x, u)
    if kernels.uses_kernel(x, u):
        _check(x, u, s)
        return _launch(x, u, int(s))
    return qsgd_blocks_plain(x, u, s)


qsgd_blocks.launches = 0
