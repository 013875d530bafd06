"""Mamba2's SSD block (counterpart of ``repro/models/ssm.py``,
arXiv:2405.21060).

The chunked SSD algorithm: quadratic within a chunk, a linear recurrence
across chunks. Grouped B and C (``ssm_groups``), multi-head x with head dim
P, a depthwise causal conv over the (x, B, C) channels, a learned negative A
per head, the D skip and the gated RMS norm before the output projection.
The numerics follow the reference step by step: the projections, the conv
and the gated norm in the compute dtype, the scan in float32, ``softplus``
as ``logaddexp(x, 0)``. The einsums and projections are ``torch.einsum`` and
matrix products; the reference too computes them outside any Pallas kernel,
so no kernel of the port is involved.

Decode is the one-token recurrence (``init_ssm_cache``, ``ssm_decode``):
the state (B, H, P, N) in float32 and the conv's last K-1 inputs in the
compute dtype; the cache does not grow with the context.

With a ``tp`` (:mod:`repro_torch.models.parallel`) the leaves are the rank's
blocks over a serve mesh's ``model`` axis. ``w_in`` is one fused leaf whose
column blocks cut across the z, x, B, C and dt segments, so its product is
gathered before :func:`_split_proj`. Where the per-head leaves (``a_log``,
``dt_bias``, ``d_skip``) and the state split by heads, each rank runs the
scan or the recurrence of its heads and the head outputs are gathered
before the gated norm; the conv runs on the rank's channel block where its
window is split so, and is gathered after.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.device import resolve_or_meta
from repro_torch.models import parallel as tpm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import dtype_of, rms_norm_vec

Params = Dict[str, torch.Tensor]

# the reference's init_ssm draws leaf i from split(key, 5)[i]
_KEY_INDEX = {"w_in": 0, "conv_w": 1, "w_out": 2}


def _dims(cfg: ModelConfig) -> Tuple[int, int, int, int, int]:
    """(d_inner, heads, head dim P, groups G, state N)."""
    return (cfg.d_inner, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_groups,
            cfg.ssm_state)


def conv_channels(cfg: ModelConfig) -> int:
    d_in, _, _, g, n = _dims(cfg)
    return d_in + 2 * g * n


def param_shapes(cfg: ModelConfig) -> Dict[str, Tuple[int, ...]]:
    """One SSM block's leaves and shapes (the reference's ``init_ssm``)."""
    d = cfg.d_model
    d_in, h, _, g, n = _dims(cfg)
    c = conv_channels(cfg)
    return {"w_in": (d, 2 * d_in + 2 * g * n + h),   # z, x, B, C, dt
            "conv_w": (cfg.ssm_conv, c), "conv_b": (c,), "a_log": (h,),
            "d_skip": (h,), "dt_bias": (h,), "norm_scale": (d_in,),
            "w_out": (d_in, d)}


def init_keys(cfg: ModelConfig, key: torch.Tensor
              ) -> Dict[str, torch.Tensor]:
    """The threefry key of each drawn leaf, ``split(key, 5)`` as in
    ``init_ssm``; ``key`` may carry leading batch dims (one key per stacked
    layer)."""
    ks = prng.split(key, 5)
    return {name: ks[..., i, :] for name, i in _KEY_INDEX.items()}


def init_scale(cfg: ModelConfig, name: str) -> float:
    """Each drawn leaf's ``dense_init`` scale: ``w_out`` at
    ``0.02 / sqrt(2 L)``, ``conv_w`` at 0.5, ``w_in`` at 0.02."""
    if name == "w_out":
        return 0.02 / math.sqrt(2 * cfg.n_layers)
    return 0.5 if name == "conv_w" else 0.02


def _linspace_1_16(h: int) -> np.ndarray:
    """``jnp.linspace(1., 16., h)`` in float32 as XLA computes it on the
    CPU: with ``c = f32(1 / (h - 1))``, entry i is ``fma(i, 16 c, 1 - i c)``
    and the last entry 16. The product of two float32 values is exact in
    float64, so the float64 sum rounds as the fused multiply-add does."""
    f32 = np.float32
    if h == 1:
        return np.ones((1,), f32)
    c = f32(1) / f32(h - 1)
    i = np.arange(h - 1, dtype=f32)
    head = (f32(1) - i * c).astype(f32)
    out = (i.astype(np.float64) * np.float64(f32(16) * c)
           + head.astype(np.float64)).astype(f32)
    return np.concatenate([out, np.array([16.0], f32)])


def constant_leaves(cfg: ModelConfig) -> Dict[str, np.ndarray]:
    """The leaves ``init_ssm`` sets without a key, as float32 arrays:
    ``a_log = log(linspace(1, 16, h))`` and ``dt_bias =
    log(expm1(0.01))``, each ``log`` and ``expm1`` rounded once from
    float64 (XLA's float32 ``log`` is within an ulp of that), ``d_skip``
    and ``norm_scale`` 1, ``conv_b`` 0."""
    d_in, h, _, _, _ = _dims(cfg)
    f32 = np.float32
    a_log = np.log(_linspace_1_16(h).astype(np.float64)).astype(f32)
    e = f32(np.expm1(np.float64(f32(0.01))))
    dt_bias = np.full((h,), np.log(np.float64(e)), f32)
    return {"a_log": a_log, "dt_bias": dt_bias,
            "d_skip": np.ones((h,), f32), "norm_scale": np.ones((d_in,), f32),
            "conv_b": np.zeros((conv_channels(cfg),), f32)}


def _split_proj(cfg: ModelConfig, zxbcdt: torch.Tensor):
    d_in, h, _, g, n = _dims(cfg)
    return torch.split(zxbcdt, [d_in, d_in + 2 * g * n, h], dim=-1)


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv then SiLU. xbc: (B, L, C); w: (K, C). The K
    shifted products are summed in order in xbc's dtype, as the reference's
    ``sum``."""
    k, length = w.shape[0], xbc.shape[1]
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    out = pad[:, 0:length, :] * w[0][None, None, :]
    for i in range(1, k):
        out = out + pad[:, i:i + length, :] * w[i][None, None, :]
    return F.silu(out + b[None, None, :])


def segsum(x: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums: ``out[..., i, j] = sum_{j<k<=i}
    x[..., k]``, ``-inf`` above the diagonal. A masked cumulative sum, as
    the reference (not ``cs[i] - cs[j]``, which rounds otherwise)."""
    seg = x.shape[-1]
    xr = x[..., None].expand(*x.shape, seg)
    below = torch.tril(torch.ones((seg, seg), dtype=torch.bool,
                                  device=x.device), -1)
    xr = torch.where(below, xr, torch.zeros((), dtype=x.dtype,
                                            device=x.device))
    x_seg = torch.cumsum(xr, dim=-2)
    keep = torch.tril(torch.ones((seg, seg), dtype=torch.bool,
                                 device=x.device), 0)
    return torch.where(keep, x_seg, torch.full((), -math.inf,
                                               dtype=x.dtype,
                                               device=x.device))


def ssd_chunked(x: torch.Tensor, a: torch.Tensor, b: torch.Tensor,
                c: torch.Tensor, chunk: int,
                initial_state: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """SSD scan, all float32. x: (B, L, H, P); a: (B, L, H) (``dt * A``,
    negative); b, c: (B, L, G, N), heads per group H // G, group-major.
    Returns y (B, L, H, P) and the final state (B, H, P, N). The intra-chunk
    term is factored into pairwise einsums, so no (b, c, l, h, n, p)
    intermediate is formed."""
    bb, L, h, p = x.shape
    g = b.shape[2]
    f32 = torch.float32
    x, a, b, c = (t.to(f32) for t in (x, a, b, c))
    # "b l g n -> b l (g r) n": each group's row repeated for its r heads
    b = b.repeat_interleave(h // g, dim=2)
    c = c.repeat_interleave(h // g, dim=2)
    nc = L // chunk
    if nc * chunk != L:
        raise ValueError(f"L={L} not divisible by chunk={chunk}")
    x = x.reshape(bb, nc, chunk, h, p)
    b = b.reshape(bb, nc, chunk, h, -1)
    c = c.reshape(bb, nc, chunk, h, -1)
    a = a.reshape(bb, nc, chunk, h).permute(0, 3, 1, 2)          # b h c l
    a_cs = torch.cumsum(a, dim=-1)

    # 1. intra-chunk (quadratic) term
    l_mat = torch.exp(segsum(a))                                 # b h c l l
    cb = torch.einsum("bclhn,bcshn->bhcls", c, b)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", cb * l_mat, x)

    # 2. chunk-final states
    decay_states = torch.exp(a_cs[..., -1:] - a_cs)              # b h c l
    xd = x * decay_states.permute(0, 2, 3, 1)[..., None]
    states = torch.einsum("bclhn,bclhp->bchpn", b, xd)

    # 3. inter-chunk recurrence on the states
    if initial_state is None:
        initial_state = torch.zeros((bb, h, p, b.shape[-1]), dtype=f32,
                                    device=x.device)
    states = torch.cat([initial_state[:, None].to(f32), states], dim=1)
    a_chunk = F.pad(a_cs[..., -1], (1, 0))                       # b h (c+1)
    decay_chunk = torch.exp(segsum(a_chunk))
    new_states = torch.einsum("bhzc,bchpn->bzhpn", decay_chunk, states)
    states, final_state = new_states[:, :-1], new_states[:, -1]

    # 4. state -> output term
    state_decay = torch.exp(a_cs)                                # b h c l
    y_off = torch.einsum("bclhn,bchpn->bclhp", c, states)
    y_off = y_off * state_decay.permute(0, 2, 3, 1)[..., None]
    return (y_diag + y_off).reshape(bb, L, h, p), final_state


def _heads_split(cfg: ModelConfig, p: Params, tp: Optional[tpm.TP]
                 ) -> bool:
    """Whether the per-head leaves hold the rank's heads."""
    h = cfg.ssm_heads
    return tp is not None and all(tp.split(p[k].shape[-1], h, f"ssm/{k}")
                                  for k in ("a_log", "dt_bias", "d_skip"))


def ssm_forward(cfg: ModelConfig, p: Params, x: torch.Tensor,
                positions: Optional[torch.Tensor] = None,
                tp: Optional[tpm.TP] = None) -> torch.Tensor:
    """Train/prefill. x: (B, L, D) in the compute dtype -> (B, L, D).
    ``positions`` is unused, as in the reference."""
    cd = dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    bsz, L, d = x.shape
    d_in, h, p_dim, g, n = _dims(cfg)
    n_proj = 2 * d_in + 2 * g * n + h
    z, xbc, dt_raw = _split_proj(cfg, tpm.matmul(x, p["w_in"].to(cd),
                                                 n_proj, tp))
    c_all = conv_channels(cfg)
    xbc = _causal_conv(xbc, tpm.whole(p["conv_w"], c_all, tp).to(cd),
                       tpm.whole(p["conv_b"], c_all, tp).to(cd))
    xs, b, c = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    xs = xs.reshape(bsz, L, h, p_dim)
    b = b.reshape(bsz, L, g, n)
    c = c.reshape(bsz, L, g, n)
    local = _heads_split(cfg, p, tp)
    if local:
        # the rank's heads: their x and dt, and their groups' B and C rows
        # (each group's row repeated for its heads, group-major)
        lo, hi = tp.block(h)
        xs, dt_raw = xs[:, :, lo:hi], dt_raw[..., lo:hi]
        b, c = (t.repeat_interleave(h // g, dim=2)[:, :, lo:hi]
                for t in (b, c))
    # jax.nn.softplus is logaddexp(x, 0)
    u = dt_raw.to(f32) + p["dt_bias"].to(f32)
    dt = torch.logaddexp(u, torch.zeros((), dtype=f32, device=u.device))
    a_neg = -torch.exp(p["a_log"].to(f32))                       # (H,)
    chunk = min(cfg.ssm_chunk, L)
    while L % chunk:
        chunk -= 1
    y, _ = ssd_chunked(xs * dt[..., None], dt * a_neg[None, None, :], b, c,
                       chunk)
    y = y + xs.to(f32) * p["d_skip"].to(f32)[None, None, :, None]
    y = y.reshape(bsz, L, -1).to(cd)
    if local:
        y = tp.gather(y, -1)
    y = rms_norm_vec(y * F.silu(z)) * tpm.whole(p["norm_scale"], d_in,
                                                tp).to(cd)
    return tpm.matmul(y, p["w_out"].to(cd), d, tp)


# ------------------------------------------------------------------ decode

def init_ssm_cache(cfg: ModelConfig, batch: int,
                   n_layers: Optional[int] = None,
                   device: torch.device | str | None = "cuda") -> Params:
    """``state``: (L, B, H, P, N) float32; ``conv``: (L, B, K-1, C) in the
    compute dtype; both zero; on the card unless ``device`` names
    another."""
    device = resolve_or_meta(device)
    _, h, p_dim, _, n = _dims(cfg)
    L = cfg.n_layers if n_layers is None else n_layers
    cd = dtype_of(cfg.compute_dtype)
    return {
        "state": torch.zeros((L, batch, h, p_dim, n), dtype=torch.float32,
                             device=device),
        "conv": torch.zeros((L, batch, cfg.ssm_conv - 1, conv_channels(cfg)),
                            dtype=cd, device=device),
    }


def ssm_decode(cfg: ModelConfig, p: Params, x: torch.Tensor,
               state: torch.Tensor, conv_buf: torch.Tensor,
               tp: Optional[tpm.TP] = None
               ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """One-token recurrent update. x: (B, 1, D); state: (B, H, P, N);
    conv_buf: (B, K-1, C). Returns the output (B, 1, D) and the new state
    and conv window (new tensors; the caller stores them). The conv's
    product over the K-window, which the reference takes in the compute
    dtype, is taken in float32 and rounded once. With a ``tp``, ``state``
    is the rank's block of its heads or of its head dim P (the recurrence
    runs per head and per P row alike) and ``conv_buf`` the rank's block of
    its channels or the whole window."""
    cd = dtype_of(cfg.compute_dtype)
    f32 = torch.float32
    d_in, h, p_dim, g, n = _dims(cfg)
    bsz, d = x.shape[0], x.shape[-1]
    c_all = conv_channels(cfg)
    split, conv_split = None, False
    if tp is not None:
        for dim, (got, w) in enumerate(zip(state.shape[1:], (h, p_dim, n),
                                           strict=True)):
            if tp.split(got, w, "ssm state"):
                split = dim
        if split == 2:
            raise tpm.refuse(f"ssm state with model on its state dim "
                             f"(whole {n})")
        if tp.split(conv_buf.shape[1], cfg.ssm_conv - 1, "ssm conv window"):
            raise tpm.refuse(f"ssm conv window with model on its "
                             f"{cfg.ssm_conv - 1} steps")
        conv_split = tp.split(conv_buf.shape[-1], c_all, "ssm conv window")
    n_proj = 2 * d_in + 2 * g * n + h
    z, xbc, dt_raw = _split_proj(cfg, tpm.matmul(x[:, 0], p["w_in"].to(cd),
                                                 n_proj, tp))
    if conv_split:
        # the rank's channels of the window, convolved, then gathered
        window = torch.cat([conv_buf, xbc[:, None, slice(*tp.block(c_all))]],
                           dim=1)
        conv_w, conv_b = p["conv_w"], p["conv_b"]
    else:
        window = torch.cat([conv_buf, xbc[:, None, :]], dim=1)   # (B,K,C)
        conv_w = tpm.whole(p["conv_w"], c_all, tp)
        conv_b = tpm.whole(p["conv_b"], c_all, tp)
    conv_out = torch.einsum("bkc,kc->bc", window.to(f32),
                            conv_w.to(cd).to(f32)).to(cd)
    xbc = F.silu(conv_out + conv_b.to(cd))
    if conv_split:
        xbc = tp.gather(xbc, -1)
    new_conv = window[:, 1:]
    xs, b, c = torch.split(xbc, [d_in, g * n, g * n], dim=-1)
    # the state's heads and P rows this rank runs
    if split == 0 and not _heads_split(cfg, p, tp):
        raise tpm.refuse("an ssm state split by heads with a_log, dt_bias "
                         "and d_skip whole")
    hs = slice(*tp.block(h)) if split == 0 else slice(None)
    ps = slice(*tp.block(p_dim)) if split == 1 else slice(None)

    def per_head(name):
        leaf = p[name].to(f32)
        return leaf if split == 0 else tpm.whole(leaf, h, tp)
    xs = xs.reshape(bsz, h, p_dim)[:, hs, ps].to(f32)
    # "b (g n) -> b (g r) n": each group's row repeated for its r heads
    b = b.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)[:, hs] \
        .to(f32)
    c = c.reshape(bsz, g, n).repeat_interleave(h // g, dim=1)[:, hs] \
        .to(f32)
    u = dt_raw[:, hs].to(f32) + per_head("dt_bias")
    dt = torch.logaddexp(u, torch.zeros((), dtype=f32, device=u.device))
    a_neg = -torch.exp(per_head("a_log"))
    decay = torch.exp(dt * a_neg[None, :])                       # (B,H)
    new_state = (state * decay[..., None, None]
                 + torch.einsum("bh,bhp,bhn->bhpn", dt, xs, b))
    y = torch.einsum("bhpn,bhn->bhp", new_state, c)
    y = y + xs * per_head("d_skip")[None, :, None]
    if split is not None:
        y = tp.gather(y, 1 + split)
    y = y.reshape(bsz, d_in).to(cd)
    y = rms_norm_vec(y * F.silu(z)) * tpm.whole(p["norm_scale"], d_in,
                                                tp).to(cd)
    out = tpm.matmul(y, p["w_out"].to(cd), d, tp)[:, None, :]
    return out, (new_state, new_conv)
