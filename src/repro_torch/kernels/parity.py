"""Holding each hand-written kernel against its plain PyTorch version on the
same inputs. Used on the card by ``tests/test_torch_cuda.py`` and by
``chip_smoke.py``; on the CPU both sides are the plain version, and
``tests/test_torch_qsgd.py`` holds the plain QSGD against the reference with
the same comparator.

What must agree, and how closely (SignTopK):

* the selected index set of every tile, and the per-tile threshold (the
  k_b-th largest ``|diff|``): exactly, because the radix select is exact;
* ``trig = 0``: q exactly zero and x_hat_new exactly x_hat;
* q, the scales and x_hat_new: within ``F32_RTOL`` relative for float32,
  because a scale is a float32 sum of up to k_b positive terms that the
  kernel adds in another order than PyTorch (a few ulps); within
  ``BF16_RTOL`` (one bfloat16 ulp) for bfloat16, because a scale a few
  float32 ulps apart can round q to the neighbouring bfloat16 value.

QSGD cannot agree bit for bit: the kernel adds a tile's x^2 in another order
than PyTorch, and an ulp of difference in the norm can flip floor(level), or
flip u < level - floor(level) where u lies within ulps of that fraction. A
flip moves the element by exactly one level, norm / s. So an element passes
(:func:`compare_qsgd`) when

* it agrees within ``F32_RTOL`` (float32) or ``BF16_RTOL`` (bfloat16) of
  its magnitude, or
* it differs by one level, and the other side's fraction
  ``level - floor(level)``, or ``u`` minus that fraction, lies within
  ``QSGD_BOUNDARY_ULPS`` ulps of ``level`` of a boundary.

Any other mismatch fails; the boundary flips are counted.

The x_hat update and mixing (:func:`compare_xhat_mix`): x_hat bit for bit
(one rounding of ``x_hat + q * trig``, the same on both sides); x bit for
bit in roll mode, where the kernel keeps the eager order and rounding of
every product and sum, and within :func:`xhat_mix_tolerance` in dense mode,
where the sum over the nodes runs in another order than ``tensordot``'s.

MoE routing's tables (:func:`check_moe_route`): integers, so the slots, the
slot owners and the counts bit for bit.
"""
from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.kernels import moe_route as mr
from repro_torch.kernels import ops
from repro_torch.kernels.qsgd import qsgd_blocks, qsgd_blocks_plain
from repro_torch.kernels.sign_topk import (BLOCK, _row_threshold,
                                           sign_topk_blocks,
                                           sign_topk_blocks_plain)
from repro_torch.kernels.xhat_mix import xhat_mix, xhat_mix_plain

F32_RTOL = 1e-5
BF16_RTOL = 2.0 ** -7

# (kind, n_tiles, dtype, k_b, trig, fused): the cases of tests/test_kernels.py
#   normal  - x_half ~ N(0, 1), x_hat ~ 0.3 N(0, 1)
#   ties    - values on a 1/4 grid, so many |diff| tie at the threshold
#   const   - every |diff| equal, signs mixed: the whole tile is one tie
#   zeros   - all-zero input: must stay silent
#   ragged  - a flat vector of d = n_tiles elements (the reference tests'
#             ragged lengths), zero-padded to whole tiles as ops.py pads it
# and the edges of the kernel's histogram-and-filter select, in ensemble and
# fused mode (fused: x_half = 2 diff, x_hat = diff, so diff is exact):
#   narrow  - |diff| = 1 + j 2**-23, j < 1024: every element shares the first
#             and the second digit, so all 1024 are candidates
#   octave  - |diff| uniform in [1, 2): one exponent, 8 first digits
#   spread  - |diff| log-uniform from SPREAD_SMALLEST (subnormal) to 1e35,
#             with -0.0 lanes (1e35, not 1e38: the scale is a float32 sum
#             of up to 1024 magnitudes and must stay finite to be compared)
#   sparse  - 50 nonzeros per tile: at k_b > 50 the threshold is 0
#   many    - 8192 tiles cycling through the kinds above, normal, zeros and
#             const in one launch: more tiles than resident warps, so each
#             warp clears its histogram and counter between tiles
RAGGED_D = (1, 1023, 1025, 2500, 3089)
SELECT_EDGE_KINDS = ("narrow", "octave", "spread", "sparse")
MANY_KINDS = ("normal", *SELECT_EDGE_KINDS, "zeros", "const")
SPREAD_SMALLEST = 1e-40
SIGN_TOPK_CASES = tuple(
    [("normal", nb, dt, k_b, trig, True)
     for nb in (1, 2, 8, 16, 32) for dt in ("float32", "bfloat16")
     for k_b in (1, 16, 103, 128, 512) for trig in (0.0, 1.0)]
    + [("ties", 8, dt, k_b, 1.0, fused) for dt in ("float32", "bfloat16")
       for k_b in (1, 16, 103, 512) for fused in (True, False)]
    + [("const", 2, dt, k_b, 1.0, False) for dt in ("float32", "bfloat16")
       for k_b in (1, 103, 1024)]
    + [("zeros", 2, dt, 128, 1.0, True) for dt in ("float32", "bfloat16")]
    + [("ragged", d, dt, k_b, 1.0, False) for d in RAGGED_D
       for dt in ("float32", "bfloat16") for k_b in (1, 103)]
    + [(kind, nb, dt, k_b, 1.0, fused)
       for kind, nb in [(k, 8) for k in SELECT_EDGE_KINDS] + [("many", 8192)]
       for dt in ("float32", "bfloat16") for k_b in (1, 103, 1024)
       for fused in (False, True)])


def _signed_diff(kind: str, rng: np.random.Generator, nb: int,
                 smallest: float) -> np.ndarray:
    """The (nb, BLOCK) diff of one select-edge kind (float64)."""
    shape = (nb, BLOCK)
    signs = np.where(rng.random(shape) < 0.5, -1.0, 1.0)
    if kind == "narrow":
        return signs * (1.0 + rng.integers(0, BLOCK, shape) * 2.0 ** -23)
    if kind == "octave":
        return signs * rng.uniform(1.0, 2.0, shape)
    if kind == "spread":
        mag = 10.0 ** rng.uniform(np.log10(smallest), 35.0, shape)
        return np.where(rng.random(shape) < 0.05, -0.0, signs * mag)
    if kind == "sparse":
        out = np.zeros(shape)
        for r in range(nb):
            out[r, rng.choice(BLOCK, 50, replace=False)] = \
                rng.standard_normal(50)
        return out
    if kind == "normal":
        return rng.standard_normal(shape)
    if kind == "zeros":
        return np.zeros(shape)
    if kind == "const":
        return 7.0 * np.where(np.arange(BLOCK) % 3 == 0, 1.0,
                              -1.0) * np.ones(shape)
    if kind == "many":
        rows = [_signed_diff(MANY_KINDS[r % len(MANY_KINDS)], rng, 1,
                             smallest) for r in range(nb)]
        return np.concatenate(rows)
    raise ValueError(kind)


def make_sign_topk_case(spec: Tuple, device: torch.device, seed: int = 0,
                        smallest: float = SPREAD_SMALLEST
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor],
                                   float, int]:
    """Inputs (x_half, x_hat or None, trig, k_b) of one case, from a numpy
    seed. ``smallest`` is the least magnitude of the ``spread`` kind (a
    subnormal by default)."""
    kind, nb, dt, k_b, trig, fused = spec
    rng = np.random.default_rng([seed, nb, k_b, int(trig), int(fused)])
    if kind == "ragged":
        nb = -(-nb // BLOCK)
    shape = (nb, BLOCK)
    if kind in SELECT_EDGE_KINDS or kind == "many":
        diff = _signed_diff(kind, rng, nb, smallest)
        xh, xe = 2.0 * diff, diff
    elif kind == "normal":
        xh = rng.standard_normal(shape)
        xe = 0.3 * rng.standard_normal(shape)
    elif kind == "ties":
        xh = np.round(rng.standard_normal(shape) * 4.0) / 4.0
        xe = np.round(rng.standard_normal(shape) * 2.0) / 4.0
    elif kind == "const":
        xh = 7.0 * np.where(np.arange(nb * BLOCK) % 3 == 0, 1.0,
                            -1.0).reshape(shape)
        xe = np.zeros(shape)
    elif kind == "zeros":
        xh = xe = np.zeros(shape)
    elif kind == "ragged":
        d = spec[1]
        flat = np.zeros(nb * BLOCK)
        flat[:d] = rng.standard_normal(d)
        xh, xe = flat.reshape(shape), np.zeros(shape)
    else:
        raise ValueError(kind)
    dtype = getattr(torch, dt)

    def tensor(a):
        return torch.tensor(a, dtype=torch.float32).to(dtype).to(device)
    if not fused and (kind in SELECT_EDGE_KINDS or kind == "many"):
        xh = xe
    return tensor(xh), (tensor(xe) if fused else None), trig, k_b


def _fail(what: str, spec) -> None:
    raise AssertionError(f"sign_topk kernel != plain version: {what} "
                         f"(case {spec})")


def check_sign_topk(x_half: torch.Tensor, x_hat: Optional[torch.Tensor],
                    trig: float, k_b: int, spec=None) -> float:
    """Run ``sign_topk_blocks`` (the kernel, for CUDA tensors) and the
    plain version on the same inputs, raise AssertionError where they
    disagree beyond the module's tolerances, and return the largest
    absolute difference over q, x_hat_new and the scales."""
    return compare_sign_topk(x_half, x_hat, trig, k_b,
                             sign_topk_blocks(x_half, x_hat, trig, k_b), spec)


def check_sign_topk_chunked(x: torch.Tensor, k_b: int, chunk_rows: int,
                            spec=None) -> float:
    """One ensemble-mode launch (x_hat = None, trig = 1) over the whole
    ``(n_tiles, BLOCK)`` input, held against the plain version
    ``chunk_rows`` tiles at a time: the plain version's temporaries at the
    main path's full shape would not fit on the card. Returns the largest
    absolute difference."""
    q, _, scale = sign_topk_blocks(x, None, 1.0, k_b)
    err = 0.0
    for lo in range(0, x.shape[0], chunk_rows):
        hi = min(x.shape[0], lo + chunk_rows)
        err = max(err, compare_sign_topk(
            x[lo:hi], None, 1.0, k_b, (q[lo:hi], None, scale[lo:hi]),
            spec=(spec, f"tiles {lo}:{hi}")))
    return err


def compare_sign_topk(x_half: torch.Tensor, x_hat: Optional[torch.Tensor],
                      trig: float, k_b: int,
                      kernel_out: Tuple[torch.Tensor, Optional[torch.Tensor],
                                        torch.Tensor],
                      spec=None) -> float:
    """Hold ``kernel_out`` = (q, x_hat_new, scale) of ``sign_topk_blocks``
    against the plain version on the same inputs (see
    :func:`check_sign_topk`)."""
    q_k, xn_k, sc_k = kernel_out
    q_p, xn_p, sc_p = sign_topk_blocks_plain(x_half, x_hat, trig, k_b)
    f32 = torch.float32
    rtol = F32_RTOL if x_half.dtype == f32 else BF16_RTOL
    if trig == 0.0:
        if torch.any(q_k != 0) or torch.any(sc_k != 0):
            _fail("trig = 0 emitted a nonzero message", spec)
        if xn_k is not None and not torch.equal(xn_k, x_hat):
            _fail("trig = 0 changed x_hat", spec)
        return 0.0
    diff = x_half.to(f32) - (0.0 if x_hat is None else x_hat.to(f32))
    av = diff.abs()
    sel_k, sel_p = q_k != 0, q_p != 0
    if not torch.equal(sel_k, sel_p):
        bad = int((sel_k != sel_p).any(dim=1).sum())
        _fail(f"selected index sets differ in {bad} tiles", spec)
    thr_p = _row_threshold(av, k_b)[:, 0]
    # the kernel's threshold: the least selected |diff| of a full support,
    # 0 where the tile has fewer than k_b nonzeros
    full = sel_k.sum(dim=1) == k_b
    least = torch.where(sel_k, av, torch.inf).amin(dim=1)
    thr_k = torch.where(full, least, torch.zeros_like(least))
    if not torch.equal(thr_k, thr_p):
        _fail("thresholds differ", spec)
    errs = []
    for name, a, b, scale in (
            ("q", q_k, q_p, q_p),
            ("scale", sc_k, sc_p, sc_p),
            ("x_hat_new", xn_k, xn_p, q_p)):
        if a is None:
            continue
        err = (a.to(f32) - b.to(f32)).abs()
        tol = rtol * scale.to(f32).abs()
        if name == "x_hat_new":   # plus the rounding of x_hat + q itself
            tol = tol + rtol * b.to(f32).abs()
        if bool(torch.any(err > tol)):
            _fail(f"{name} beyond rtol {rtol}: max err "
                  f"{float(err.max()):.3e}", spec)
        errs.append(float(err.max()) if err.numel() else 0.0)
    return max(errs)


def check_all_sign_topk(device: torch.device) -> Iterator[Tuple[Tuple, float]]:
    """Every case of :data:`SIGN_TOPK_CASES`: yields (case, max_abs_err)."""
    for spec in SIGN_TOPK_CASES:
        yield spec, check_sign_topk(*make_sign_topk_case(spec, device),
                                    spec=spec)


def check_ensemble_matches_rows(device: torch.device, n: int = 4,
                                d: int = 2 * BLOCK + 300, k_b: int = 13
                                ) -> None:
    """``ops.sign_topk_ensemble`` (one launch over every node's tiles) must
    equal ``ops.trigger_compress_update`` row by row, bit for bit: both run
    the same tile math on the same values."""
    rng = np.random.default_rng(9)
    diff = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32,
                        device=device)
    q_ens = ops.sign_topk_ensemble(diff, k_b)
    for r in range(n):
        q_row, _, _ = ops.trigger_compress_update(
            diff[r], torch.zeros(d, device=device), 0.0, k_b)
        if not torch.equal(q_ens[r], q_row):
            raise AssertionError(f"ensemble row {r} != per-row update")


def check_payload_reconstructs(device: torch.device) -> None:
    """``ops.sign_topk``'s (vals, idx) payload rebuilds q exactly at ragged
    lengths and under an all-ties input."""
    rng = np.random.default_rng(0)
    cases = [(rng.standard_normal(d), k) for d, k in
             ((1, 1), (1023, 100), (1025, 64), (2500, 250), (3089, 123))]
    cases.append((7.0 * np.where(np.arange(2048) % 3 == 0, 1.0, -1.0), 256))
    for flat, k in cases:
        x = torch.tensor(flat, dtype=torch.float32, device=device)
        q, vals, idx = ops.sign_topk(x, k)
        nb = max(1, -(-x.shape[0] // BLOCK))
        rebuilt = torch.zeros(nb * BLOCK, device=device)
        rebuilt[idx.long()] = vals
        if not torch.equal(rebuilt[:x.shape[0]], q):
            raise AssertionError(f"payload does not rebuild q at d="
                                 f"{x.shape[0]}, k={k}")


# --------------------------------------------------------------------- QSGD

QSGD_BOUNDARY_ULPS = 4
# (kind, n_tiles, dtype, s): the cases of tests/test_kernels.py
#   normal - x ~ N(0, 1), u ~ U[0, 1)
#   zeros  - an all-zero tile: zeros out, never NaN
QSGD_CASES = tuple(
    [("normal", nb, dt, s) for nb in (1, 4, 16) for s in (4, 16, 64)
     for dt in ("float32", "bfloat16")]
    + [("zeros", 2, dt, 16) for dt in ("float32", "bfloat16")])
QSGD_RAGGED_D = (1, 1023, 1025, 2500)


def make_qsgd_case(spec: Tuple, device: torch.device, seed: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor, int]:
    """Inputs (x, u, s) of one case, from a numpy seed."""
    kind, nb, dt, s = spec
    rng = np.random.default_rng([seed, nb, s])
    if kind == "normal":
        x = rng.standard_normal((nb, BLOCK))
    elif kind == "zeros":
        x = np.zeros((nb, BLOCK))
    else:
        raise ValueError(kind)
    u = rng.random((nb, BLOCK), dtype=np.float32)
    xt = torch.tensor(x, dtype=torch.float32).to(getattr(torch, dt))
    return xt.to(device), torch.tensor(u, device=device), s


def compare_qsgd(x: torch.Tensor, u: torch.Tensor, s: int,
                 out: torch.Tensor, want: torch.Tensor = None, spec=None
                 ) -> Tuple[float, int]:
    """Hold ``out`` (the kernel's, for CUDA tensors) against ``want`` (by
    default the plain version on the same inputs) with the module's QSGD
    comparator. Raises AssertionError on any mismatch that is not a
    one-level flip at a boundary; returns (largest absolute difference over
    the elements that agree within the tolerance, number of boundary
    flips)."""
    if want is None:
        want = qsgd_blocks_plain(x, u, s)
    f32 = torch.float32
    xf = x.to(f32).reshape(-1, BLOCK)
    uf = u.to(f32).reshape(-1, BLOCK)
    a = out.to(f32).reshape(-1, BLOCK)
    b = want.to(f32).reshape(-1, BLOCK)
    if out.shape != want.shape or out.dtype != want.dtype:
        raise AssertionError(f"qsgd: output {out.dtype} {tuple(out.shape)} "
                             f"!= {want.dtype} {tuple(want.shape)} ({spec})")
    if not bool(torch.isfinite(a).all()):
        raise AssertionError(f"qsgd: non-finite output ({spec})")
    rtol = F32_RTOL if x.dtype == f32 else BF16_RTOL
    err = (a - b).abs()
    close = err <= rtol * torch.maximum(a.abs(), b.abs())
    n_flip = 0
    if not bool(close.all()):
        norm = torch.sqrt(torch.sum(xf * xf, dim=1, keepdim=True))
        safe = torch.where(norm > 0, norm, 1.0)
        level = xf.abs() / safe * s
        frac = level - torch.floor(level)
        win = QSGD_BOUNDARY_ULPS * (torch.nextafter(level, level + 1.0)
                                    - level)
        edge = ((frac <= win) | (1.0 - frac <= win)
                | ((uf - frac).abs() <= win))
        step = (norm / s).expand_as(a)
        one_level = (err - step).abs() <= rtol * (step + a.abs() + b.abs())
        bad = ~close & ~(edge & one_level)
        if bool(bad.any()):
            i = torch.nonzero(bad)[0].tolist()
            raise AssertionError(
                f"qsgd: {int(bad.sum())} elements differ beyond rtol {rtol} "
                f"and are no one-level flip at a boundary; first at tile "
                f"{i[0]} lane {i[1]}: {float(a[i[0], i[1]])} vs "
                f"{float(b[i[0], i[1]])} ({spec})")
        n_flip = int((~close).sum())
    agree = torch.where(close, err, 0.0)
    return (float(agree.max()) if err.numel() else 0.0), n_flip


def check_qsgd(x: torch.Tensor, u: torch.Tensor, s: int, spec=None
               ) -> Tuple[float, int]:
    """``qsgd_blocks`` (the kernel, for CUDA tensors) against the plain
    version on the same inputs (see :func:`compare_qsgd`)."""
    return compare_qsgd(x, u, s, qsgd_blocks(x, u, s), spec=spec)


def check_qsgd_chunked(x: torch.Tensor, u: torch.Tensor, s: int,
                       chunk_rows: int, spec=None) -> Tuple[float, int]:
    """One launch over the whole ``(n_tiles, BLOCK)`` input, held against
    the plain version ``chunk_rows`` tiles at a time (its temporaries at
    the training buffer's shape would not fit on the card). Returns the
    largest absolute difference and the boundary flips over every tile."""
    out = qsgd_blocks(x, u, s)
    err, flips = 0.0, 0
    for lo in range(0, x.shape[0], chunk_rows):
        hi = min(x.shape[0], lo + chunk_rows)
        e, f = compare_qsgd(x[lo:hi], u[lo:hi], s, out[lo:hi],
                            spec=(spec, f"tiles {lo}:{hi}"))
        err, flips = max(err, e), flips + f
    return err, flips


def check_all_qsgd(device: torch.device
                   ) -> Iterator[Tuple[Tuple, float, int]]:
    """Every case of :data:`QSGD_CASES`: yields (case, max_abs_err,
    boundary flips)."""
    for spec in QSGD_CASES:
        yield (spec, *check_qsgd(*make_qsgd_case(spec, device), spec=spec))


def check_ops_qsgd_ragged(device: torch.device, s: int = 16
                          ) -> Tuple[float, int]:
    """``ops.qsgd`` on ragged lengths with threefry noise against the plain
    version on the zero-padded tiles fed the same draw: the output has
    length d and equals the padded result's head. Returns (max_abs_err,
    boundary flips)."""
    rng = np.random.default_rng(5)
    err, flips = 0.0, 0
    for d in QSGD_RAGGED_D:
        x = torch.tensor(rng.standard_normal(d), dtype=torch.float32,
                         device=device)
        key = prng.PRNGKey(d)
        got = ops.qsgd(x, key, s)
        if got.shape != (d,):
            raise AssertionError(f"ops.qsgd at d={d} gave {tuple(got.shape)}")
        nb = -(-d // BLOCK)
        xp = torch.zeros(nb * BLOCK, device=device)
        xp[:d] = x
        xp = xp.view(nb, BLOCK)
        u = prng.uniform(key, (nb, BLOCK)).to(device)
        got_p = torch.zeros(nb * BLOCK, device=device)
        got_p[:d] = got
        e, f = compare_qsgd(xp, u, s, got_p.view(nb, BLOCK),
                            spec=f"ops.qsgd d={d}")
        err, flips = max(err, e), flips + f
    return err, flips


def check_qsgd_unbiased(device: torch.device, draws: int = 256, s: int = 64
                        ) -> float:
    """``test_qsgd_kernel_unbiased``: the mean of ``draws`` quantizations
    of one tile under keys 0..draws-1 lies within 0.15 of x everywhere
    (s = 64 keeps the variance factor at 0.25). Returns max |mean - x|."""
    x = torch.tensor(np.random.default_rng(0).standard_normal(BLOCK),
                     dtype=torch.float32, device=device)
    total = torch.zeros_like(x)
    for i in range(draws):
        total += ops.qsgd(x, prng.PRNGKey(i), s)
    gap = float((total / draws - x).abs().max())
    if gap >= 0.15:
        raise AssertionError(f"qsgd mean over {draws} keys is {gap} from x")
    return gap


# ----------------------------------------------------------------- x_hat mix

# the kernel's nodes exercised by the card tests and the K1 probes: the two
# smallest, the MoE cells' 4 and the largest instantiation
XHAT_MIX_NODES = (2, 3, 4, 16)
XHAT_MIX_GAMMA = 0.3
U32 = 2.0 ** -24         # float32's unit roundoff


def xhat_mix_plan(mode: str, n: int, device: torch.device,
                  gen: Optional[torch.Generator] = None
                  ) -> Tuple[Optional[torch.Tensor], Optional[Tuple]]:
    """``(w, roll)`` of a probe: in roll mode a circulant with shifts 1 and
    n - 1 (and 2 with a small weight from n = 4), ``w`` None; in dense mode
    a row-stochastic ``(n, n)`` W drawn from ``gen``, ``roll`` None."""
    if mode == "roll":
        terms = {1: 0.25}
        terms[n - 1] = terms.get(n - 1, 0.0) + 0.35
        if n >= 4:
            terms[2] = 0.0625
        return None, (1.0 - sum(terms.values()), tuple(sorted(terms.items())))
    w = torch.rand((n, n), generator=gen, device=device)
    return w / w.sum(dim=1, keepdim=True), None


def xhat_mix_trig(n: int, device: torch.device) -> torch.Tensor:
    """Every third node untriggered (node 1 first), the rest triggered."""
    return torch.tensor([0.0 if i % 3 == 1 else 1.0 for i in range(n)],
                        device=device)


def make_xhat_mix_case(mode: str, n: int, width: int, dtype: torch.dtype,
                       device: torch.device, seed: int = 0) -> Tuple:
    """``(x_hat, x, q, trig, w, roll)`` of one case: x_hat ~ 0.5 N(0, 1) in
    ``dtype``, x ~ N(0, 1), q ~ 0.1 N(0, 1), all ``(n, width)``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    x_hat = (0.5 * torch.randn((n, width), generator=gen, device=device)
             ).to(dtype)
    x = torch.randn((n, width), generator=gen, device=device)
    q = 0.1 * torch.randn((n, width), generator=gen, device=device)
    w, roll = xhat_mix_plan(mode, n, device, gen)
    return x_hat, x, q, xhat_mix_trig(n, device), w, roll


def xhat_mix_tolerance(want_x: torch.Tensor, xe: torch.Tensor,
                       w: torch.Tensor, gamma: float) -> torch.Tensor:
    """How far dense mode's x may lie from the plain version's, per
    coordinate. Each side sums the n products ``W_ij xe_j`` in its own
    order (the kernel a fused multiply-add chain, ``tensordot`` its GEMM's)
    and subtracts ``xe_i``: each lies within ``(n + 1) u`` of the exact
    term relative to ``sum_j |W_ij| |xe_j| + |xe_i|`` (u = 2^-24), so the
    two within twice that, and gamma's product adds a rounding of each;
    adding the update to x rounds once more, one spacing of x on each
    side."""
    n = xe.shape[0]
    mag = torch.tensordot(w.abs(), xe.abs(), dims=1) + xe.abs()
    a = want_x.abs()
    spacing = torch.nextafter(a, torch.full_like(a, float("inf"))) - a
    return 2.0 * spacing + gamma * 2.0 * (n + 2) * U32 * mag


def compare_xhat_mix(before: Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                   torch.Tensor],
                     got: Tuple[torch.Tensor, torch.Tensor],
                     w: Optional[torch.Tensor], roll: Optional[Tuple],
                     gamma: float, spec=None) -> float:
    """Hold the kernel's ``(x_hat, x)`` against the plain version run on
    ``before`` = (x_hat, x, q, trig), the inputs as they were: x_hat bit for
    bit in both modes; x bit for bit in roll mode and within
    :func:`xhat_mix_tolerance` in dense mode. Returns the largest absolute
    difference of x."""
    xh, x, q, trig = (t.clone() for t in before)
    xhat_mix_plain(xh, x, q, trig, gamma, w=w, roll=roll)
    got_xh, got_x = got
    what = f"xhat_mix kernel != plain version ({spec})"
    if not torch.equal(got_xh, xh):
        bad = int((got_xh != xh).any(dim=0).sum())
        raise AssertionError(f"{what}: x_hat differs in {bad} columns")
    err = (got_x - x).abs()
    if roll is not None:
        if not torch.equal(got_x, x):
            raise AssertionError(f"{what}: x differs by up to "
                                 f"{float(err.max()):.3e} in roll mode")
    else:
        tol = xhat_mix_tolerance(x, xh.to(torch.float32), w, gamma)
        if bool(torch.any(~(err <= tol))):
            raise AssertionError(f"{what}: x beyond the dense tolerance, "
                                 f"max err {float(err.max()):.3e}")
    return float(err.max()) if err.numel() else 0.0


def check_xhat_mix(mode: str, n: int, width: int, dtype: torch.dtype,
                   device: torch.device, seed: int = 0) -> float:
    """One case through :func:`repro_torch.kernels.xhat_mix.xhat_mix` (the
    kernel, for CUDA tensors) against the plain version; returns the
    largest absolute difference of x."""
    x_hat, x, q, trig, w, roll = make_xhat_mix_case(mode, n, width, dtype,
                                                    device, seed)
    before = tuple(t.clone() for t in (x_hat, x, q, trig))
    xhat_mix(x_hat, x, q, trig, XHAT_MIX_GAMMA, w=w, roll=roll)
    return compare_xhat_mix(before, (x_hat, x), w, roll, XHAT_MIX_GAMMA,
                            spec=(mode, n, width, dtype))


# ------------------------------------------------- MoE routing's tables

# (name, groups, tokens, k, experts, capacity, before): the MoE cells'
# routings (capacity factor 1.25), deepseek-v3's 256 experts top-8, one
# token, T k = 7,007 (not a multiple of 32 or of a warp's run), every token
# on the same k experts at capacity 8, the fsdp group's offsets, three
# groups in one launch, and a group one block's chunk past one block (two
# launches). before: None, "low" (up to a quarter of the capacity) or
# "past" (some experts' offsets at or past the capacity)
MOE_ROUTE_CASES = (
    ("cells_train", 1, 4096, 6, 64, 480, None),
    ("cells_sync", 1, 2048, 6, 64, 240, None),
    ("deepseek_v3", 1, 1024, 8, 256, 40, None),
    ("one_token", 1, 1, 6, 64, 8, None),
    ("ragged", 1, 1001, 7, 64, 112, None),
    ("same_experts", 1, 4096, 6, 64, 8, None),
    ("before", 1, 4096, 6, 64, 480, "low"),
    ("before_past", 1, 2048, 6, 64, 240, "past"),
    ("groups", 3, 2048, 6, 64, 240, "low"),
    ("two_blocks", 1, mr.CHUNK // 6 + 1, 6, 64, 8 * (mr.CHUNK // 512 + 2),
     None),
)


def make_moe_route_case(spec: Tuple, device: torch.device, seed: int = 0
                        ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """``(expert_idx, before)`` of one case: the top-k of a skewed score
    over the experts (expert e's score lifted by 0.5 e / E, so the later
    experts overflow first), kept as the sort leaves it: a ``[..., :k]``
    view of the ``(..., T, E)`` ids, as ``route`` reads them; (T, k) for one
    group, (groups, T, k) past it. Drawn with numpy, so every device gets
    the same ids."""
    name, groups, t, k, e, cap, before = spec
    rng = np.random.default_rng(seed)
    if name == "same_experts":
        order = np.broadcast_to(np.arange(e), (groups, t, e)).copy()
    else:
        score = rng.random((groups, t, e)) + 0.5 * np.arange(e) / e
        order = np.argsort(-score, axis=-1, kind="stable")
    ids = torch.from_numpy(order).to(device)[..., :k]
    off = None
    if before is not None:
        hi = cap // 4 if before == "low" else 2 * cap
        off = torch.from_numpy(rng.integers(0, hi + 1, (groups, e))
                               ).to(device)
    if groups == 1:
        ids = ids[0]
        off = None if off is None else off[0].contiguous()
    return ids, off


def compare_moe_route(ids: torch.Tensor, before: Optional[torch.Tensor],
                      n_experts: int, cap: int, got: Tuple, spec=None) -> int:
    """Hold ``(slot, token_for_slot, counts)`` against the plain version on
    the same ids, bit for bit. Returns the dropped choices."""
    want = mr.moe_route_plain(ids, n_experts, cap, before)
    for name, g, w in zip(("slot", "token_for_slot", "counts"), got, want):
        if g.dtype != w.dtype or g.shape != w.shape or not torch.equal(g, w):
            bad = int((g != w).sum()) if g.shape == w.shape else "shape"
            raise AssertionError(f"moe_route kernel != plain version "
                                 f"({spec}): {name} differs ({bad})")
    return int((want[0] == n_experts * cap).sum())


def check_moe_route(spec: Tuple, device: torch.device, seed: int = 0
                    ) -> int:
    """One case through :func:`repro_torch.kernels.moe_route.moe_route`
    (the kernel, for CUDA tensors) and its counting pass against the plain
    version; returns the dropped choices."""
    ids, before = make_moe_route_case(spec, device, seed)
    e, cap = spec[4], spec[5]
    got = mr.moe_route(ids, e, cap, before)
    counts = mr.moe_route_counts(ids, e)
    if not torch.equal(counts, got[2]):
        raise AssertionError(f"moe_route_counts != the ranking's counts "
                             f"({spec})")
    return compare_moe_route(ids, before, e, cap, got, spec)
