"""Compression operators (Definition 1 of the paper; counterpart of
``repro/core/compression.py``).

A compression operator C satisfies, for some omega in (0, 1]:
``E_C ||x - C(x)||^2 <= (1 - omega) ||x||^2`` and ``C(0) = 0``.

Every operator of the reference's registry is here: Identity, TopK, RandK,
Sign, QSGD (the global-norm quantizer, not the blockwise kernel), SignTopK,
QsTopK, TopFrac and BlockTopFrac, with ``compress_tree``,
``tree_payload_bits``, ``make_compressor`` and the contraction audit
``omega_certificate``.

Batching. An operator acts on the last axis; leading axes are independent
vectors (the reference engine passes its whole ``(n, d)`` ensemble at once,
where the reference vmaps over the nodes). A stochastic operator takes one
``prng`` key per vector, shape ``(*x.shape[:-1], 2)``, and draws exactly
what ``jax.random`` draws from it; the draws are made on the key's device
and moved to x's. Ties in Top-k selection keep the lowest indices, as
``jax.lax.top_k`` does: a stable descending sort gives that order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Union

import torch
import torch.nn.functional as F

from repro_torch.core import bits as bits_mod
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.kernels.sign_topk import BLOCK, sign_topk_blocks


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base class. Subclasses implement __call__(x, key) and omega(d)."""

    name: str = "identity"

    def __call__(self, x: torch.Tensor,
                 key: Optional[torch.Tensor] = None) -> torch.Tensor:
        return x

    def omega(self, d: int) -> float:
        return 1.0

    def bits(self, d: int) -> float:
        """Bits transmitted for one compressed d-dim message."""
        return 32.0 * d

    @property
    def deterministic(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class Identity(Compressor):
    name: str = "identity"


def _topk_mask(x: torch.Tensor, k: int) -> torch.Tensor:
    """0/1 mask (x's dtype) of the k largest |x| along the last axis, ties
    broken by the lowest index (``compression.py:64``): everything above
    the k-th largest value, then the first ties at it in index order. No
    sort: at the flat buffer's full width a row holds 6.2e8 entries, whose
    sort indices alone would take 5 GB."""
    k = min(k, x.shape[-1])
    a = x.abs()
    thr = torch.topk(a, k, dim=-1, sorted=False).values.amin(
        dim=-1, keepdim=True)
    above = a > thr
    ties = a == thr
    need = k - above.sum(dim=-1, keepdim=True)
    rank = torch.cumsum(ties, dim=-1, dtype=torch.int32)
    return (above | (ties & (rank <= need))).to(x.dtype)


def _sign(x: torch.Tensor) -> torch.Tensor:
    """+1 where x >= 0, else -1 (the reference's sign convention)."""
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _need_key(key: Optional[torch.Tensor], x: torch.Tensor,
              name: str) -> torch.Tensor:
    if key is None:
        raise ValueError(f"{name} requires a PRNG key")
    if key.shape != (*x.shape[:-1], 2):
        raise ValueError(f"{name} takes one key per vector: want shape "
                         f"{(*x.shape[:-1], 2)}, got {tuple(key.shape)}")
    return key


def _quantize(x: torch.Tensor, u: torch.Tensor, s: int) -> torch.Tensor:
    """Q_s with the global norm of each vector (``compression.py:153``):
    norm * sign(x) * (floor(level) + [u < frac]) / s, sign(0) = 0."""
    norm = torch.sqrt(torch.sum(x * x, dim=-1, keepdim=True))
    safe = torch.where(norm > 0, norm, 1.0)
    level = x.abs() / safe * s
    low = torch.floor(level)
    q = (low + (u < level - low).to(x.dtype)) / s
    return norm * torch.sign(x) * q


@dataclasses.dataclass(frozen=True)
class TopK(Compressor):
    k: int = 10
    name: str = "topk"

    def __call__(self, x, key=None):
        return x * _topk_mask(x, self.k)

    def omega(self, d: int) -> float:
        return min(self.k, d) / d

    def bits(self, d: int) -> float:
        return bits_mod.topk_bits(d, min(self.k, d))


@dataclasses.dataclass(frozen=True)
class RandK(Compressor):
    k: int = 10
    name: str = "randk"

    def __call__(self, x, key=None):
        key = _need_key(key, x, "RandK")
        d = x.shape[-1]
        idx = prng.choice(key, d, (min(self.k, d),)).to(x.device)
        return x * torch.zeros_like(x).scatter_(-1, idx, 1.0)

    def omega(self, d: int) -> float:
        return min(self.k, d) / d

    def bits(self, d: int) -> float:
        # indices can be a shared seed; count values only + 32b seed
        return 32.0 * min(self.k, d) + 32.0

    @property
    def deterministic(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class Sign(Compressor):
    """Deterministic 1-bit quantizer (||x||_1/d) sign(x) [KRSJ19]."""

    name: str = "sign"

    def __call__(self, x, key=None):
        scale = torch.sum(x.abs(), dim=-1, keepdim=True) / x.shape[-1]
        return scale * _sign(x)

    def omega(self, d: int) -> float:
        return 1.0 / d

    def bits(self, d: int) -> float:
        return bits_mod.sign_bits(d)


def qsgd_beta(d: int, s: int) -> float:
    return min(d / (s * s), math.sqrt(d) / s)


@dataclasses.dataclass(frozen=True)
class QSGD(Compressor):
    """Stochastic quantizer Q_s [AGL+17] over the whole vector: unbiased,
    E||x - Q(x)||^2 <= beta ||x||^2; ``scaled=True`` divides by 1 + beta,
    which makes it a (1 / (1 + beta))-compressor."""

    s: int = 16
    scaled: bool = True
    name: str = "qsgd"

    def __call__(self, x, key=None):
        key = _need_key(key, x, "QSGD")
        d = x.shape[-1]
        u = prng.uniform(key, (d,)).to(device=x.device, dtype=x.dtype)
        y = _quantize(x, u, self.s)
        if self.scaled:
            y = y / (1.0 + qsgd_beta(d, self.s))
        return y.to(x.dtype)

    def omega(self, d: int) -> float:
        b = qsgd_beta(d, self.s)
        if self.scaled:
            return 1.0 / (1.0 + b)
        return max(1.0 - b, 0.0)

    def bits(self, d: int) -> float:
        return bits_mod.qsgd_bits(d, self.s)

    @property
    def deterministic(self) -> bool:
        return False


def _sign_topk(x: torch.Tensor, k: int) -> torch.Tensor:
    """(||TopK(x)||_1 / k) * sign(x) on the Top-k support."""
    mask = _topk_mask(x, k)
    scale = torch.sum((x * mask).abs(), dim=-1, keepdim=True) / k
    return scale * _sign(x) * mask


@dataclasses.dataclass(frozen=True)
class SignTopK(Compressor):
    """(||TopK(x)||_1 / k) * Sign(TopK(x)), the paper's operator (v)."""

    k: int = 10
    name: str = "signtopk"

    def __call__(self, x, key=None):
        return _sign_topk(x, min(self.k, x.shape[-1]))

    def omega(self, d: int) -> float:
        return 1.0 / d

    def bits(self, d: int) -> float:
        return bits_mod.signtopk_bits(d, min(self.k, d))


@dataclasses.dataclass(frozen=True)
class QsTopK(Compressor):
    """(1 / (1 + beta_{k,s})) Q_s(TopK(x)), the paper's operator (iv)."""

    k: int = 10
    s: int = 16
    name: str = "qstopk"

    def __call__(self, x, key=None):
        key = _need_key(key, x, "QsTopK")
        d = x.shape[-1]
        k = min(self.k, d)
        mask = _topk_mask(x, k)
        u = prng.uniform(key, (d,)).to(device=x.device, dtype=x.dtype)
        y = _quantize(x * mask, u, self.s) * mask
        return (y / (1.0 + qsgd_beta(k, self.s))).to(x.dtype)

    def omega(self, d: int) -> float:
        k = min(self.k, d)
        return k / (d * (1.0 + qsgd_beta(k, self.s)))

    def bits(self, d: int) -> float:
        k = min(self.k, d)
        return bits_mod.topk_index_bits(d, k) + bits_mod.qsgd_bits(k, self.s)

    @property
    def deterministic(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class TopFrac(SignTopK):
    """SignTopK with k = ceil(frac * d) over the whole flat vector. The
    inherited fixed ``k`` is refused, as the reference refuses it."""

    k: Optional[int] = None
    frac: float = 0.1
    name: str = "signtop_frac"

    def __post_init__(self):
        if self.k is not None:
            raise ValueError(
                "TopFrac/signtop_frac derives k = ceil(frac * d); passing "
                f"k={self.k!r} would be silently ignored: use frac= instead")
        if not 0.0 < self.frac <= 1.0:
            raise ValueError(f"TopFrac needs 0 < frac <= 1, got {self.frac!r}")

    def _k(self, d: int) -> int:
        return max(1, int(math.ceil(self.frac * d)))

    def omega(self, d: int) -> float:
        # isotropic proxy k/d, capped at the 2/pi retention of full sign
        # quantization (the reference's reasoning, compression.py:271-279)
        return min(self._k(d) / d, 2.0 / math.pi)

    def __call__(self, x, key=None):
        return _sign_topk(x, self._k(x.shape[-1]))

    def bits(self, d: int) -> float:
        return bits_mod.signtopk_bits(d, self._k(d))


@dataclasses.dataclass(frozen=True)
class BlockTopFrac(TopFrac):
    """Blockwise exact-k SignTopK over BLOCK=1024 tiles: the kernel seam.

    Each vector is zero-padded to whole tiles and each tile keeps its own
    k_b = ceil(frac * BLOCK) support with a per-tile scale, through
    :func:`repro_torch.kernels.sign_topk.sign_topk_blocks`: the CUDA kernel
    for a CUDA tensor, its plain version for a CPU one. So one
    ``ops.sign_topk_ensemble`` launch over an (n, D_pad) buffer equals this
    operator applied row by row. Padding emits nothing. Deterministic."""

    name: str = "signtopk_block"

    def _k_b(self) -> int:
        return max(1, min(BLOCK, int(math.ceil(self.frac * BLOCK))))

    def __call__(self, x, key=None):
        d = x.shape[-1]
        nb = max(1, -(-d // BLOCK))
        xp = F.pad(x, (0, nb * BLOCK - d)).reshape(-1, BLOCK)
        q, _, _ = sign_topk_blocks(xp.to(torch.float32), None, 1.0,
                                   self._k_b())
        return q.to(x.dtype).reshape(*x.shape[:-1], nb * BLOCK)[..., :d]

    def omega(self, d: int) -> float:
        return min(self._k_b() / BLOCK, 2.0 / math.pi)

    def bits(self, d: int) -> float:
        # per tile: k_b sign bits and indices, plus the shared scale
        nb = max(1, -(-int(d) // BLOCK))
        return nb * bits_mod.signtopk_bits(BLOCK, self._k_b())


def tree_leaves(tree: Any) -> list:
    """Tensor leaves in ``jax.tree.leaves`` order: dict entries by sorted
    key, list and tuple entries in order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in tree_leaves(v)]
    raise TypeError(f"unsupported tree node {type(tree).__name__}")


def _tree_map(tree: Any, leaves: Any) -> Any:
    if isinstance(tree, torch.Tensor):
        return next(leaves)
    if isinstance(tree, dict):
        out = {k: _tree_map(tree[k], leaves) for k in sorted(tree)}
        return {k: out[k] for k in tree}
    return type(tree)(_tree_map(v, leaves) for v in tree)


def compress_tree(comp: Compressor, tree: Any,
                  key: Optional[torch.Tensor] = None) -> Any:
    """Per-tensor compression of a tree of tensors (paper Section 5.2): each
    leaf is flattened, compressed and reshaped back; a stochastic compressor
    gets ``split(key, n_leaves)[i]`` for leaf i, as the reference."""
    leaves = tree_leaves(tree)
    if not leaves:
        return tree
    keys = [None] * len(leaves) if key is None else \
        list(prng.split(key, len(leaves)))
    out = [comp(leaf.reshape(-1), k).reshape(leaf.shape)
           for leaf, k in zip(leaves, keys, strict=True)]
    return _tree_map(tree, iter(out))


def tree_payload_bits(comp: Compressor, tree: Any) -> float:
    """Total message payload bits for one per-tensor-compressed tree."""
    return float(sum(comp.bits(math.prod(leaf.shape) or 1)
                     for leaf in tree_leaves(tree)))


_REGISTRY = {
    "identity": Identity,
    "topk": TopK,
    "randk": RandK,
    "sign": Sign,
    "qsgd": QSGD,
    "signtopk": SignTopK,
    "qstopk": QsTopK,
    "signtop_frac": TopFrac,
    "signtopk_block": BlockTopFrac,
}


# ------------------------------------------------------------ omega certificate
#
# The contract audit (repro_torch.analysis R7) holds every compressor to a
# contraction certificate: an omega(d) in (0, 1] with
# E_C ||x - C(x)||^2 <= (1 - omega) ||x||^2. Registry operators declare
# analytic omegas; TopFrac's k/d is an isotropic proxy (its adversarial
# worst case is SignTopK's 1/d), so it is checked on isotropic draws only,
# while worst-case certificates also face a one-hot adversarial input. A
# compressor that keeps the base class's ``omega`` gets a sampled lower
# bound from the same draws instead of the identity's claim of 1.

@dataclasses.dataclass(frozen=True)
class OmegaCertificate:
    """Result of certifying one compressor's contraction factor at size d."""

    name: str
    d: int              # dimension the certificate's omega is evaluated at
    omega: float        # certified contraction factor in (0, 1]
    kind: str           # "analytic" (declared omega) | "sampled"
    qualifier: str      # "worst-case" | "isotropic-proxy"
    d_test: int         # dimension the empirical draws ran at
    trials: int         # draws checked (isotropic, plus the one-hot)
    worst_ratio: float  # max observed E_C ||x - C(x)||^2 / ||x||^2
    bound: float        # 1 - omega(d_test) + tol the ratios were held to
    refuted: bool       # an observed ratio exceeded the certified bound

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def _mean_contraction_ratio(comp: Compressor, x: torch.Tensor,
                            key: torch.Tensor, key_draws: int) -> float:
    """E_C ||x - C(x)||^2 / ||x||^2, averaging the operator's randomness
    over ``split(key, key_draws)`` (``compression.py:411``)."""
    sq = float(torch.sum(x * x))
    if sq == 0.0:
        return 0.0
    if comp.deterministic:
        err = x - comp(x, key)
        return float(torch.sum(err * err)) / sq
    total = 0.0
    for k in prng.split(key, key_draws):
        err = x - comp(x, k)
        total += float(torch.sum(err * err))
    return total / (key_draws * sq)


def omega_certificate(comp: Compressor, d: int, *, d_test: int = 4096,
                      trials: int = 6, key_draws: int = 8,
                      tol: float = 0.05, seed: int = 0,
                      device: Union[str, torch.device, None] = "cuda"
                      ) -> OmegaCertificate:
    """Certify ``comp``'s contraction omega at model dimension ``d``
    (``compression.py:428``), with the reference's draws made on
    ``device``: ``normal(fold_in(PRNGKey(seed), i), (d_test,))`` for each
    trial, the one-hot adversarial input for a declared worst-case omega,
    and ``split(fold_in(PRNGKey(seed + 1), i), key_draws)`` for a stochastic
    operator on draw i. The draws run at ``d_test = min(d, d_test)``. On a
    CUDA device BlockTopFrac runs through the SignTopK kernel."""
    dev = resolve_device(device)
    d = int(d)
    d_test = int(min(d, d_test))
    declared = type(comp).omega is not Compressor.omega \
        or isinstance(comp, Identity)
    proxy = isinstance(comp, TopFrac)
    base = prng.PRNGKey(seed, device=dev)
    draws = [prng.normal(prng.fold_in(base, i), (d_test,))
             for i in range(trials)]
    if declared and not proxy:
        # worst-case certificates must survive the adversarial one-hot too
        one_hot = torch.zeros((d_test,), dtype=torch.float32, device=dev)
        one_hot[0] = 1.0
        draws.append(one_hot)
    key = prng.PRNGKey(seed + 1, device=dev)
    worst = max(_mean_contraction_ratio(comp, x, prng.fold_in(key, i),
                                        key_draws)
                for i, x in enumerate(draws))
    if declared:
        omega_d, omega_t = float(comp.omega(d)), float(comp.omega(d_test))
        bound = 1.0 - omega_t + tol
        refuted = (not 0.0 < omega_d <= 1.0) or worst > bound
        kind = "analytic"
    else:
        # half the observed contraction margin, floored: conservative by
        # construction, so never self-refuting
        omega_d = max((1.0 - worst) * 0.5, 1e-4)
        bound = 1.0 - omega_d + tol
        refuted = False
        kind = "sampled"
    return OmegaCertificate(
        name=comp.name, d=d, omega=omega_d, kind=kind,
        qualifier="isotropic-proxy" if proxy else "worst-case",
        d_test=d_test, trials=len(draws), worst_ratio=float(worst),
        bound=float(bound), refuted=bool(refuted))


def make_compressor(name: str, **kw) -> Compressor:
    if name not in _REGISTRY:
        raise ValueError(f"unknown compressor {name!r}; have "
                         f"{sorted(_REGISTRY)}")
    return _REGISTRY[name](**kw)
