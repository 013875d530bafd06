"""The slice of ``jax.random`` that the reference draws from, bit for bit.

The reference takes every random draw from JAX's default ``threefry2x32``
generator with 64-bit mode off. Comparisons between the two packages depend
on those draws (engine key splits, minibatch indices, QSGD and RandK noise),
so the port computes the same stream instead of using torch's generator.

Two streams. JAX's ``jax_threefry_partitionable`` flag picks how split and
random bits lay out their counters; it is on by default since JAX 0.5 and
off before. The port's default follows the ``JAX_THREEFRY_PARTITIONABLE``
environment variable as JAX reads it when it is imported (unset: on;
``0``/``false``/``no``/``off``/``n``/``f``: off), and
:func:`threefry_partitionable` sets the choice inside a block, as the flag
sets JAX's. The committed golden traces (``tests/golden/*.json``) and
``BENCH_*.json`` files were drawn with the flag off.

Representation. A key is an ``int64`` tensor whose last axis holds the two
32-bit words ``(k0, k1)``; leading axes are a batch of keys, and every draw
from a batch of keys is batched over them (``split(k, n)`` followed by one
draw per row is one call). torch's ``uint32`` arithmetic is too thin for the
hash, so words live in 64-bit integers and are masked to 32 bits after every
add and shift. Keys may lie on any device and draws land on the key's
device; a key on the CPU is hashed with numpy, whose small-array operations
cost far less than torch's.

Algorithms (``jax/_src/prng.py`` and ``jax/_src/random.py`` of jax 0.9):

* ``threefry2x32``: 20 rounds in five groups of four, key injection after
  each group (``_threefry2x32_lowering``).
* ``fold_in(key, d)`` hashes the counter pair ``(0, d)`` in both streams.
* Partitionable (``_threefry_split_foldlike``,
  ``_threefry_random_bits_partitionable``): ``split(key, num)[i]`` hashes
  ``(0, i)``, so ``split(k)[1] == fold_in(k, 1)``; 32-bit bits at flat index
  ``i`` are ``b0 ^ b1`` of the hash of ``(i >> 32, i & 0xFFFFFFFF)``.
* Original (``_threefry_split_original``, ``_threefry_random_bits_original``,
  ``threefry_2x32``): ``L`` counters ``0..L-1`` are padded to even length,
  halved, the halves hashed pairwise and the two outputs concatenated;
  split takes ``L = 2 num`` words, 32-bit bits ``L = size``.
* ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus
  1, then ``f * (maxval - minval) + minval`` as one fused multiply-add (XLA
  contracts it; done here in float64, where the product is exact) and a
  ``max`` with ``minval`` (``_uniform``).
* ``normal``: ``sqrt(2) erfinv(u)`` for ``u`` uniform on
  ``[nextafter(-1, 0), 1)`` (``_normal_real``); ``truncated_normal``:
  ``u`` uniform on ``[erf(lower/sqrt2), erf(upper/sqrt2))``, then
  ``sqrt(2) erfinv(u)`` clipped to the open interval (``_truncated_normal``).
  ``erfinv`` is XLA's float32 polynomial (:func:`erfinv`), not torch's.
* ``randint``: two 32-bit draws from ``split(key)`` combined modulo the span
  in uint32 arithmetic (``_randint``).
* ``permutation``: rounds of a stable sort keyed on fresh 32-bit draws
  (``_shuffle``); ``choice(replace=False)`` is a permutation's prefix.
"""
from __future__ import annotations

import contextlib
import math
import os
from typing import Iterator, Optional, Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
Word = Union[int, np.ndarray, torch.Tensor]
Shape = Union[int, Sequence[int]]
_TRUE = ("y", "yes", "t", "true", "on", "1")
_FALSE = ("n", "no", "f", "false", "off", "0")


def _env_partitionable() -> bool:
    """``JAX_THREEFRY_PARTITIONABLE`` read as JAX's ``bool_env`` reads it."""
    val = os.environ.get("JAX_THREEFRY_PARTITIONABLE", "true").lower()
    if val in _TRUE:
        return True
    if val in _FALSE:
        return False
    raise ValueError(f"invalid truth value {val!r} for environment "
                     f"'JAX_THREEFRY_PARTITIONABLE'")


_PARTITIONABLE = [_env_partitionable()]


@contextlib.contextmanager
def threefry_partitionable(flag: bool) -> Iterator[None]:
    """Draw from the partitionable stream (``True``) or the original one
    (``False``) inside the ``with`` block."""
    old = _PARTITIONABLE[0]
    _PARTITIONABLE[0] = bool(flag)
    try:
        yield
    finally:
        _PARTITIONABLE[0] = old


def partitionable() -> bool:
    """The layout draws take now (the default or a
    :func:`threefry_partitionable` block's)."""
    return _PARTITIONABLE[0]


def _rotl(v: Word, r: int) -> Word:
    return ((v << r) & MASK) | (v >> (32 - r))


def threefry2x32(k0: Word, k1: Word, x0: Word, x1: Word) -> Tuple[Word, Word]:
    """The threefry2x32 hash of counter words ``(x0, x1)`` under key words
    ``(k0, k1)``: 32-bit values held in Python ints, int64 numpy arrays or
    int64 tensors, which broadcast against each other."""
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & MASK
    return x0, x1


def _shape(shape: Shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(map(int, shape))


def PRNGKey(seed: int, device: Union[str, torch.device] = "cpu"
            ) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 64-bit mode off: ``(0, seed mod
    2**32)``."""
    return torch.tensor([0, int(seed) & MASK], dtype=torch.int64,
                        device=device)


def _check_key(key: torch.Tensor) -> None:
    if key.shape[-1:] != (2,) or key.dtype != torch.int64:
        raise ValueError(f"a key is an int64 tensor of shape (..., 2), got "
                         f"{key.dtype} {tuple(key.shape)}")


def _numpy_leg(where: Union[torch.Tensor, torch.device]) -> bool:
    """Hash with numpy (keys or outputs on the CPU) rather than torch
    (elsewhere)."""
    dev = where.device if isinstance(where, torch.Tensor) else where
    return torch.device(dev).type == "cpu"


def _hash_iota(key: torch.Tensor, n: int) -> torch.Tensor:
    """The stream's ``n`` hashed words under every key of ``key`` (..., 2),
    as an int64 tensor of shape (..., n, 2) for the partitionable layout
    (the word pair of counter i) or (..., n) for the original one (the
    concatenated outputs of ``threefry_2x32(key, iota(n))``)."""
    _check_key(key)
    on_cpu = _numpy_leg(key)
    k = key.numpy() if on_cpu else key
    k0, k1 = k[..., 0:1], k[..., 1:2]
    if _PARTITIONABLE[0]:
        i = np.arange(n, dtype=np.int64) if on_cpu else \
            torch.arange(n, dtype=torch.int64, device=key.device)
        b0, b1 = threefry2x32(k0, k1, i >> 32, i & MASK)
        out = np.stack([b0, b1], -1) if on_cpu else torch.stack([b0, b1], -1)
    else:
        half = (n + 1) // 2
        i = np.arange(half, dtype=np.int64) if on_cpu else \
            torch.arange(half, dtype=torch.int64, device=key.device)
        hi = i + half
        hi = hi * (hi < n)                   # odd n: the pad counter is 0
        b0, b1 = threefry2x32(k0, k1, i, hi)
        cat = np.concatenate if on_cpu else torch.cat
        out = cat([b0, b1], -1)[..., :n]
    return torch.from_numpy(np.ascontiguousarray(out)) if on_cpu else out


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split``: (..., 2) keys -> (..., num, 2)."""
    num = int(num)
    if _PARTITIONABLE[0]:
        return _hash_iota(key, num)
    return _hash_iota(key, 2 * num).reshape(*key.shape[:-1], num, 2)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in`` with a 32-bit ``data``: (..., 2) -> (..., 2)."""
    _check_key(key)
    b0, b1 = threefry2x32(key[..., 0], key[..., 1], 0, int(data) & MASK)
    return torch.stack([b0, b1], dim=-1)


def random_bits(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """32-bit ``jax.random.bits``: uint32 values in an int64 tensor of shape
    (*key.shape[:-1], *shape)."""
    shape = _shape(shape)
    words = _hash_iota(key, math.prod(shape))
    if _PARTITIONABLE[0]:
        words = words[..., 0] ^ words[..., 1]
    return words.reshape(*key.shape[:-1], *shape)


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """32-bit draws -> float32 in [0, 1): the top 23 bits as a mantissa."""
    one = 0x3F800000                      # the bit pattern of 1.0f
    return ((bits >> 9) | one).to(torch.int32).view(torch.float32) - 1.0


def _scale_unit(f: torch.Tensor, minval: float, maxval: float
                ) -> torch.Tensor:
    """``max(minval, f * (maxval - minval) + minval)`` in float32, with the
    multiply-add fused as XLA fuses it: the float64 product of two float32
    values is exact, so one rounding to float32 remains."""
    lo = np.float32(minval)
    span = np.float32(np.float32(maxval) - lo)
    if lo == 0.0 and span == 1.0:
        return f
    u = (f.double() * float(span) + float(lo)).float()
    return torch.clamp_min(u, float(lo))


def uniform(key: torch.Tensor, shape: Shape, minval: float = 0.0,
            maxval: float = 1.0) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32, minval, maxval)``."""
    return _scale_unit(_unit_floats(random_bits(key, shape)), minval, maxval)


def _mulmod32(a: torch.Tensor, b: int) -> torch.Tensor:
    """``(a * b) mod 2**32`` for 32-bit ``a`` and ``b`` without leaving
    int64."""
    lo = a * (b & 0xFFFF)
    hi = ((a * (b >> 16)) & 0xFFFF) << 16
    return (lo + hi) & MASK


def randint(key: torch.Tensor, shape: Shape, minval: int, maxval: int
            ) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval)`` (int32 sampling):
    values in [minval, maxval) as int64, shape (*key.shape[:-1], *shape)."""
    minval, maxval = int(minval), int(maxval)
    lim = 2 ** 31
    if not (-lim <= minval < lim and -lim <= maxval < lim):
        raise ValueError("randint takes int32 bounds only")
    shape = _shape(shape)
    both = random_bits(split(key), shape)      # (..., 2, *shape)
    hi = both.select(key.dim() - 1, 0)
    lo = both.select(key.dim() - 1, 1)
    span = (maxval - minval) & MASK if maxval > minval else 1
    mult = (((1 << 16) % span) ** 2 & MASK) % span
    off = (_mulmod32(hi % span, mult) + lo % span) & MASK
    return minval + off % span


def permutation(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: (..., n) int64."""
    n = int(n)
    batch = key.shape[:-1]
    x = torch.arange(n, dtype=torch.int64,
                     device=key.device).expand(*batch, n)
    uint32max = np.iinfo(np.uint32).max
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(uint32max)))
    for _ in range(rounds):
        pair = split(key)
        key, sub = pair[..., 0, :], pair[..., 1, :]
        order = torch.sort(random_bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x.contiguous()


def choice(key: torch.Tensor, n: int, shape: Shape, replace: bool = False
           ) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=False)``: the first
    prod(shape) entries of ``permutation(key, n)``."""
    if replace:
        raise NotImplementedError("choice(replace=True) is not ported")
    shape = _shape(shape)
    k = math.prod(shape)
    if k > n:
        raise ValueError(f"cannot take {k} of {n} without replacement")
    perm = permutation(key, n)[..., :k]
    return perm.reshape(*key.shape[:-1], *shape)


# ------------------------------------------------------------ normals

# XLA's float32 ErfInv (M. Giles, "Approximating the erfinv function"): the
# polynomial in w = -log1p(-x^2), one set of coefficients below w = 5 and
# one above, evaluated by Horner's rule
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)
_SQRT2 = float(np.float32(np.sqrt(2.0)))
DRAW_CHUNK = 1 << 24    # values per pass of a large single-key draw


def erfinv(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``erf_inv`` as plain float32 operations, so that the
    CPU and the card evaluate one formula. Within 2 ulps of XLA's on the CPU
    (``tests/test_torch_init.py``); ``torch.erfinv`` is further off, most
    near +-1."""
    w = -torch.log1p(x * -x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)
    p = torch.where(lt, _ERFINV_LT5[0], _ERFINV_GE5[0])
    for lo, hi in zip(_ERFINV_LT5[1:], _ERFINV_GE5[1:]):
        p = torch.where(lt, lo, hi) + p * w
    out = p * x
    return torch.where(x.abs() == 1.0, x * math.inf, out)


def bits_range(key: Tuple[int, int], n: int, lo: int, hi: int,
               device: torch.device) -> torch.Tensor:
    """``random_bits(key, (n,))[lo:hi]`` for one key given as two Python
    ints, hashing only those counters: a large draw is made in slices whose
    int64 temporaries stay small. On the CPU the hash runs in numpy, as
    ``_hash_iota``'s does."""
    k0, k1 = key
    on_cpu = _numpy_leg(device)
    j = np.arange(lo, hi, dtype=np.int64) if on_cpu else \
        torch.arange(lo, hi, dtype=torch.int64, device=device)
    if _PARTITIONABLE[0]:
        b0, b1 = threefry2x32(k0, k1, j >> 32, j & MASK)
        out = b0 ^ b1
    else:
        # original layout: output j < half is word 0 of the pair
        # (j, j + half), output j >= half is word 1 of the pair (j - half,
        # j); a pad counter past n is 0
        where = np.where if on_cpu else torch.where
        half = (n + 1) // 2
        first = j < half
        i = where(first, j, j - half)
        top = i + half
        b0, b1 = threefry2x32(k0, k1, i, top * (top < n))
        out = where(first, b0, b1)
    return torch.from_numpy(out) if on_cpu else out


def key_words(key: torch.Tensor) -> Tuple[int, int]:
    """One key (2,) as its two words, Python ints."""
    _check_key(key)
    if key.dim() != 1:
        raise ValueError(f"normal draws take one key of shape (2,), got "
                         f"{tuple(key.shape)}")
    k0, k1 = key.tolist()
    return int(k0), int(k1)


def _draw(key: torch.Tensor, shape: Shape, out: Optional[torch.Tensor],
          fill) -> torch.Tensor:
    """Fill ``out`` (or a new float32 tensor on the key's device) with
    ``fill(bits)`` of consecutive slices of the key's 32-bit draws."""
    words = key_words(key)
    shape = _shape(shape)
    n = math.prod(shape)
    if out is None:
        out = torch.empty(shape, dtype=torch.float32, device=key.device)
    if out.dtype != torch.float32 or out.numel() != n or \
            not out.is_contiguous():
        raise ValueError(f"out must be a contiguous float32 tensor of "
                         f"{n} values")
    flat = out.view(-1)
    for lo in range(0, n, DRAW_CHUNK):
        hi = min(n, lo + DRAW_CHUNK)
        flat[lo:hi] = fill(bits_range(words, n, lo, hi, out.device))
    return out


def normal(key: torch.Tensor, shape: Shape,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``jax.random.normal(key, shape)`` in float32, for one key; written
    into ``out`` when given (it fixes the device), slice by slice."""
    lo = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))

    def fill(bits):
        return _SQRT2 * erfinv(_scale_unit(_unit_floats(bits), lo, 1.0))
    return _draw(key, shape, out, fill)


def _bounds(lower: float, upper: float) -> Tuple[float, float, float, float]:
    """``erf`` of the bounds over sqrt 2 (the uniform's range) and the open
    interval's float32 ends."""
    lo32, hi32 = np.float32(lower), np.float32(upper)
    bounds = torch.tensor([lo32, hi32], dtype=torch.float32)
    a, b = torch.erf(bounds / np.float32(np.sqrt(2.0))).tolist()
    return (a, b, float(np.nextafter(lo32, np.float32(np.inf))),
            float(np.nextafter(hi32, np.float32(-np.inf))))


def truncated_normal_of_bits(bits: torch.Tensor, lower: float, upper: float
                             ) -> torch.Tensor:
    """The truncated normals of 32-bit draws ``bits`` (int64 tensor)."""
    a, b, clip_lo, clip_hi = _bounds(lower, upper)
    u = _scale_unit(_unit_floats(bits), a, b)
    return torch.clamp(_SQRT2 * erfinv(u), clip_lo, clip_hi)


def truncated_normal(key: torch.Tensor, lower: float, upper: float,
                     shape: Shape, out: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """``jax.random.truncated_normal(key, lower, upper, shape)`` in float32,
    for one key; written into ``out`` when given, slice by slice. The bounds'
    ``erf`` is torch's float32 one, equal to XLA's at +-2 (the model's
    bounds) but not everywhere (at 5.5 it rounds to 1.0, XLA's to
    0.9999998)."""
    return _draw(key, shape, out,
                 lambda bits: truncated_normal_of_bits(bits, lower, upper))
