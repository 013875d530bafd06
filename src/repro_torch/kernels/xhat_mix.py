"""The sync's x_hat update and gossip mixing in one pass: the hand-written
CUDA kernel (``csrc/xhat_mix.cu``) and its plain PyTorch version.

It replaces no reference kernel: it fuses what the flat engine's sync did
in eager column chunks, lines 13 and 15 of Algorithm 1 over the rank's
``(n, D_pad)`` rows when one rank holds every node::

    x_hat' = round_xhat(x_hat + q * trig)     (line 13)
    x     += gamma * (W x_hat' - x_hat')      (line 15)

Two modes, chosen by what the engine knows of its gossip plan:

* ``roll=(c_0, ((s, c_s), ...))``: a static circulant W; the consensus term
  is ``(c_0 - 1) x_hat'`` plus ``c_s`` times the rows rolled by each shift
  ``s``, in that order, every step rounded: bit for bit the eager path;
* ``w``: any ``(n, n)`` float32 W on the device (``gossip_mix``'s dense
  product); the kernel sums over the nodes in its own order, within float32
  rounding of the plain version's ``tensordot``
  (:func:`repro_torch.kernels.parity.xhat_mix_tolerance`).

:func:`xhat_mix` launches the kernel for CUDA tensors and runs
:func:`xhat_mix_plain` for CPU tensors; it never picks the plain version for
a CUDA tensor. ``meta`` tensors run nothing and charge :func:`work_bytes` to
the cost walks (``kernels.charge``), as a launch does. ``xhat_mix.launches``
counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from repro_torch import kernels
from repro_torch.core.sparq import gossip_mix

BLOCK = 1024
MAX_NODES = 16            # the kernel's instantiations: 2 <= n <= 16
COLUMN_CHUNK = 1 << 22    # columns per chunk of the plain version

Roll = Tuple[float, Sequence[Tuple[int, float]]]

_ARGTYPES = (ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float),
             ctypes.c_uint, ctypes.c_float, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_longlong, ctypes.c_void_p)
ENTRIES = {("roll", torch.float32): "xhat_mix_roll_f32",
           ("roll", torch.bfloat16): "xhat_mix_roll_bf16",
           ("dense", torch.float32): "xhat_mix_dense_f32",
           ("dense", torch.bfloat16): "xhat_mix_dense_bf16"}


def _check(x_hat: torch.Tensor, x: torch.Tensor, q: torch.Tensor,
           trig: torch.Tensor, w: Optional[torch.Tensor],
           roll: Optional[Roll]) -> None:
    """Raise on what the kernel does not take."""
    if x_hat.dim() != 2 or x_hat.shape[1] % BLOCK:
        raise ValueError(f"xhat_mix takes (n, tiles * {BLOCK}) rows, got "
                         f"{tuple(x_hat.shape)}")
    n = x_hat.shape[0]
    if not 2 <= n <= MAX_NODES:
        raise ValueError(f"xhat_mix takes 2 to {MAX_NODES} rows, got {n}")
    if x_hat.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x_hat must be float32 or bfloat16, got "
                        f"{x_hat.dtype}")
    for name, t in (("x", x), ("q", q)):
        if t.shape != x_hat.shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 of x_hat's shape "
                             f"{tuple(x_hat.shape)}")
    if trig.shape != (n,) or trig.dtype != torch.float32:
        raise ValueError(f"trig must be float32 of shape ({n},)")
    if (roll is None) == (w is None):
        raise ValueError("give exactly one of roll (a circulant) and w")
    if w is not None and (w.shape != (n, n) or w.dtype != torch.float32):
        raise ValueError(f"w must be float32 of shape ({n}, {n})")
    if roll is not None and any(not 1 <= s < n for s, _ in roll[1]):
        raise ValueError(f"roll shifts must lie in [1, {n})")
    # the rows are read in 16-byte vectors, trig and W one float at a time
    for t, align in ((x_hat, 16), (x, 16), (q, 16), (trig, 4), (w, 4)):
        if t is not None and (not t.is_contiguous() or t.data_ptr() % align):
            raise ValueError(f"xhat_mix inputs must be contiguous and "
                             f"{align}-byte aligned")


def entry(key: Tuple[str, torch.dtype]
          ) -> Tuple[ctypes.CDLL, ctypes._CFuncPtr]:
    """The library and the bound C launch entry for ``(mode, x_hat dtype)``:
    ``(x_hat, x, q, trig, w, coefs, mask, gamma, n, n_tiles, ld,
    stream)``."""
    lib = kernels.library("xhat_mix")
    return lib, kernels.bind(lib, ENTRIES[key], _ARGTYPES)


def launch_config(key: Tuple[str, torch.dtype], n_tiles: int
                  ) -> Tuple[int, int]:
    """``(grid, block)`` of the kernel's launch over ``n_tiles`` tiles of
    every row (the same for every n)."""
    return kernels.launch_config("xhat_mix", ENTRIES[key], n_tiles)


def attributes(key: Tuple[str, torch.dtype]) -> Dict[str, int]:
    """The compiled kernel's registers, static shared memory, local memory,
    largest block and resident blocks per SM (:func:`kernels.attributes`),
    the worst over its instantiations for n = 2..16."""
    return kernels.attributes("xhat_mix", ENTRIES[key])


def work_bytes(n: int, width: int, dtype: torch.dtype, dense: bool) -> int:
    """The bytes one launch over ``(n, width)`` rows must move: q, x_hat and
    x read once, x_hat and x written once, trig (and W) read. At float32:
    20 B a coordinate."""
    per = 4 + 2 * dtype.itemsize + 2 * 4
    return n * width * per + 4 * n + (4 * n * n if dense else 0)


def _roll_args(roll: Roll, n: int) -> Tuple[ctypes.Array, int]:
    """The circulant's coefficients for the C entry: ``c_0 - 1``, then c_s
    at index s, and the mask of the summed shifts."""
    c0, terms = roll
    coefs = [0.0] * n
    coefs[0] = float(c0) - 1.0
    mask = 0
    for s, c_s in terms:
        coefs[s] = float(c_s)
        mask |= 1 << s
    return (ctypes.c_float * n)(*coefs), mask


def _launch(x_hat: torch.Tensor, x: torch.Tensor, q: torch.Tensor,
            trig: torch.Tensor, gamma: float, w: Optional[torch.Tensor],
            roll: Optional[Roll]) -> None:
    n, width = x_hat.shape
    if roll is not None:
        coefs, mask = _roll_args(roll, n)
    else:
        coefs, mask = None, 0
    lib, fn = entry(("roll" if roll is not None else "dense", x_hat.dtype))
    with torch.cuda.device(x_hat.device):
        stream = torch.cuda.current_stream(x_hat.device).cuda_stream
        code = fn(kernels.ptr(x_hat), kernels.ptr(x), kernels.ptr(q),
                  kernels.ptr(trig), kernels.ptr(w), coefs, mask,
                  float(gamma), n, width // BLOCK, width, stream)
    kernels.check(lib, code, "xhat_mix")
    xhat_mix.launches += 1


def xhat_mix_plain(x_hat: torch.Tensor, x: torch.Tensor, q: torch.Tensor,
                   trig: torch.Tensor, gamma: float, *,
                   w: Optional[torch.Tensor] = None,
                   roll: Optional[Roll] = None) -> None:
    """The plain PyTorch version, on any device, in place: the engine's
    eager expressions column chunk by column chunk (the temporaries are a
    chunk's)."""
    trigf = trig.to(torch.float32)[:, None]
    for lo in range(0, x_hat.shape[1], COLUMN_CHUNK):
        c = slice(lo, lo + COLUMN_CHUNK)
        xe_new = (x_hat[:, c].to(torch.float32)
                  + q[:, c] * trigf).to(x_hat.dtype)           # line 13
        x_hat[:, c] = xe_new
        xe = xe_new.to(torch.float32)
        if roll is not None:
            # (W x)_i = sum_s c_s x_{(i+s) mod n}, in the shifts' order
            acc = (float(roll[0]) - 1.0) * xe
            for s, c_s in roll[1]:
                acc = acc + c_s * torch.roll(xe_new, -s, dims=0).to(
                    torch.float32)
        else:
            acc = gossip_mix(w, xe)
        x[:, c] += gamma * acc                                   # line 15


def xhat_mix(x_hat: torch.Tensor, x: torch.Tensor, q: torch.Tensor,
             trig: torch.Tensor, gamma: float, *,
             w: Optional[torch.Tensor] = None,
             roll: Optional[Roll] = None) -> None:
    """x_hat: (n, D) float32 or bfloat16, x and q: (n, D) float32, trig:
    (n,) float32 of 0 and 1, D whole tiles; exactly one of ``w`` ((n, n)
    float32) and ``roll`` (``(c_0, ((s, c_s), ...))`` of a circulant W).
    Updates x_hat and x in place. CUDA tensors launch the kernel; CPU
    tensors run :func:`xhat_mix_plain`; ``meta`` tensors charge the
    kernel's bytes and run nothing."""
    meta = kernels.on_meta(x_hat, x, q, trig, w)
    if not meta and not kernels.uses_kernel(x_hat, x, q, trig, w):
        xhat_mix_plain(x_hat, x, q, trig, gamma, w=w, roll=roll)
        return
    _check(x_hat, x, q, trig, w, roll)
    kernels.charge("xhat_mix", work_bytes(*x_hat.shape, x_hat.dtype,
                                          w is not None))
    if not meta:
        _launch(x_hat, x, q, trig, gamma, w, roll)


xhat_mix.launches = 0
