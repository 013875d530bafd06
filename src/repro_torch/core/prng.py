"""The slice of ``jax.random`` that the reference draws from, bit for bit.

The reference takes every random draw from JAX's default ``threefry2x32``
generator with 64-bit mode off. Comparisons between the two packages depend
on those draws (engine key splits, minibatch indices, QSGD and RandK noise),
so the port computes the same stream instead of using torch's generator.

Two streams. JAX's ``jax_threefry_partitionable`` flag picks how split and
random bits lay out their counters; it is on by default since JAX 0.5 and
off before. :func:`threefry_partitionable` sets the port's choice (on by
default), as the flag sets JAX's. The committed golden traces
(``tests/golden/*.json``) were drawn with the flag off.

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
* ``uniform``: the top 23 bits as the mantissa of a float in [1, 2), minus 1.
* ``randint``: two 32-bit draws from ``split(key)`` combined modulo the span
  in uint32 arithmetic (``_randint``).
* ``permutation``: rounds of a stable sort keyed on fresh 32-bit draws
  (``_shuffle``); ``choice(replace=False)`` is a permutation's prefix.
"""
from __future__ import annotations

import contextlib
import math
from typing import Iterator, Sequence, Tuple, Union

import numpy as np
import torch

MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA
Word = Union[int, np.ndarray, torch.Tensor]
Shape = Union[int, Sequence[int]]
_PARTITIONABLE = [True]


@contextlib.contextmanager
def threefry_partitionable(flag: bool) -> Iterator[None]:
    """Draw from the partitionable stream (``True``, the default) or the
    original one (``False``) inside the ``with`` block."""
    old = _PARTITIONABLE[0]
    _PARTITIONABLE[0] = bool(flag)
    try:
        yield
    finally:
        _PARTITIONABLE[0] = old


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


def _numpy_leg(key: torch.Tensor) -> bool:
    """Hash with numpy (keys on the CPU) rather than torch (elsewhere)."""
    return key.device.type == "cpu"


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


def uniform(key: torch.Tensor, shape: Shape) -> torch.Tensor:
    """``jax.random.uniform(key, shape)`` in float32, in [0, 1)."""
    bits = random_bits(key, shape)
    one = 0x3F800000                      # the bit pattern of 1.0f
    f = ((bits >> 9) | one).to(torch.int32).view(torch.float32)
    return f - 1.0


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
