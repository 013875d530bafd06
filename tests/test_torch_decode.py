"""Port parity, decoding: ``init_cache`` and ``decode_step`` of
``repro_torch.models.transformer``, ``decode_attention`` with its sliding-
window ring buffer, the absorbed ``mla_decode`` and ``ssm_decode``.

The reference's own decode tests (``tests/test_decode_consistency.py``,
the decode case of ``tests/test_ssm_moe_units.py``) run on the port; then
the port's decode is held against the reference's token by token, on the
same numpy-seeded inputs and the reference's weights.

Tolerances:
* the port's decode against its own teacher-forced forward, bfloat16
  compute: the reference test's ``TOL = 0.05`` on logits of about unit
  scale (the forward scores in bfloat16, the decode in float32); MoE
  configs at ``capacity_factor = 8.0``, as there, so that routing B
  tokens per step and B*S tokens at once drops no choice in either;
* one SSM block's decode against its forward: that test's ``0.02``;
* the port against the reference, float32 compute: logits and every float
  cache leaf within ``1e-5`` of the array's largest magnitude (float32
  sums in other orders: about 1.3e-6 measured), every ``pos`` leaf equal
  exactly;
* ``mla_decode`` in bfloat16 compute: the output and the cache's new
  entries within ``2e-2`` of the largest (the reference's bfloat16
  absorption products against the port's float32 ones rounded once, and
  RoPE's sines a bfloat16 ulp apart), ``pos`` equal exactly.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import ARCH_IDS as J_ARCH_IDS  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

S = 16
TOL = 0.05      # the reference's bf16 accumulation-order tolerance
F32_TOL = 1e-5  # float32 compute, of each array's largest magnitude
MLA_BF16_TOL = 2e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers at once, and their small multi-threaded torch operations slow
    each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=F32_TOL, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, (what, err, scale)


# ------------------------------------- the reference's decode tests, ported

def _run(cfg, seed=1):
    """Max |decode logits - teacher-forced forward logits| over S steps, on
    the port alone (``test_decode_consistency._run``)."""
    params = ttf.init_params(cfg, prng.PRNGKey(seed))
    rng = np.random.default_rng(seed)
    toks = torch.tensor(rng.integers(0, cfg.vocab_size, (2, S)))
    emb = None
    if cfg.family in ("audio", "vlm"):
        emb = torch.tensor(rng.standard_normal((2, S, cfg.d_model)),
                           dtype=torch.float32)
    with torch.no_grad():
        full, _ = ttf.forward(cfg, params, toks, embeds=emb)
        cache = ttf.init_cache(cfg, 2, S if cfg.sliding_window is None
                               else min(cfg.sliding_window, S),
                               device="cpu")
        errs = []
        for t in range(S):
            e_t = emb[:, t:t + 1] if emb is not None else None
            lg, cache = ttf.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                        t, embeds=e_t)
            errs.append(float((lg[:, 0].float()
                               - full[:, t].float()).abs().max()))
    return max(errs)


def test_arch_ids_equal_reference():
    assert ARCH_IDS == J_ARCH_IDS


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_decode_matches_forward(arch_id):
    cfg = get_config(arch_id).reduced()
    # generous capacity so MoE routing matches between the two paths
    if cfg.n_experts:
        cfg = dataclasses.replace(cfg, capacity_factor=8.0)
    assert _run(cfg) < TOL


def test_decode_matches_forward_swa():
    cfg = get_config("qwen1.5-0.5b").reduced()
    cfg = dataclasses.replace(cfg, sliding_window=S + 4)  # window covers all
    assert _run(cfg) < TOL


def test_swa_ring_buffer_reuses_slots():
    """With window < S the cache physically holds only ``window`` slots."""
    cfg = get_config("stablelm-1.6b").reduced()
    cfg = dataclasses.replace(cfg, sliding_window=8)
    cache = ttf.init_cache(cfg, 2, 8, device="cpu")
    assert cache["kv"]["k"].shape[2] == 8
    params = ttf.init_params(cfg, prng.PRNGKey(0))
    toks = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 12)))
    with torch.no_grad():
        for t in range(12):
            lg, cache = ttf.decode_step(cfg, params, cache, toks[:, t:t + 1],
                                        t)
    # all slots written with positions from the last window
    pos = cache["kv"]["pos"][0]
    assert int(pos.min()) >= 12 - 8
    assert pos.tolist() == [8, 9, 10, 11, 4, 5, 6, 7]
    assert not bool(torch.isnan(lg).any())


def test_ssm_decode_matches_forward_per_block():
    """``tests/test_ssm_moe_units.py``'s decode case on the port: one SSM
    block's token-by-token decode against its forward, bfloat16 compute."""
    cfg = get_config("mamba2-370m").reduced()
    p = {k: v[0] for k, v in ttf.init_params(
        cfg, prng.PRNGKey(3))["seg0"]["ssm"].items()}
    x = torch.tensor(np.random.default_rng(3).standard_normal(
        (2, 8, cfg.d_model)) * 0.5, dtype=torch.float32)
    with torch.no_grad():
        y_full = tssm.ssm_forward(cfg, p, x.to(torch.bfloat16))
        cache = tssm.init_ssm_cache(cfg, 2, n_layers=1, device="cpu")
        state, conv = cache["state"][0], cache["conv"][0]
        outs = []
        for t in range(8):
            o, (state, conv) = tssm.ssm_decode(cfg, p, x[:, t:t + 1].to(
                torch.bfloat16), state, conv)
            outs.append(o)
    y_dec = torch.cat(outs, dim=1)
    np.testing.assert_allclose(y_dec.float().numpy(), y_full.float().numpy(),
                               atol=0.02)


# ------------------------------------------------ against the reference

def _cfgs(arch, **kw):
    kw = {"compute_dtype": "float32", **kw}
    return (dataclasses.replace(jget(arch).reduced(), **kw),
            dataclasses.replace(get_config(arch).reduced(), **kw))


def _check_cache(tcache, jcache):
    want = dict(_walk(jax.tree.map(np.asarray, jcache)))
    got = dict(_walk(tcache))
    assert got.keys() == want.keys()
    for path, w in want.items():
        g = got[path]
        if path[-1] == "pos":
            assert g.dtype == torch.int32
            np.testing.assert_array_equal(g.numpy(), w, err_msg=str(path))
        else:
            _close(g, w, what=path)


@pytest.mark.parametrize("arch,window", [(a, None) for a in ARCH_IDS]
                         + [("qwen1.5-0.5b", 8), ("zamba2-7b", 8)])
def test_decode_step_equals_reference(arch, window):
    """Token by token in float32 compute: the logits and every cache leaf
    after every step; with a window of 8 over 12 steps the ring buffer
    wraps (the hybrid's shared-block caches too)."""
    steps = 12
    jc, tc = _cfgs(arch, sliding_window=window)
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(1)))
    tp = ttf.params_from_jax(tc, pn)
    jp = jax.tree.map(jnp.asarray, pn)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jc.vocab_size, (2, steps)).astype(np.int32)
    emb = (rng.standard_normal((2, steps, jc.d_model)).astype(np.float32)
           if jc.family in ("audio", "vlm") else None)
    clen = window or steps
    jcache = jtf.init_cache(jc, 2, clen)
    tcache = ttf.init_cache(tc, 2, clen, device="cpu")
    step = jax.jit(lambda p, c, t, pos, e: jtf.decode_step(jc, p, c, t, pos,
                                                           embeds=e))
    for t in range(steps):
        e = None if emb is None else emb[:, t:t + 1]
        jl, jcache = step(jp, jcache, jnp.asarray(toks[:, t:t + 1]),
                          jnp.int32(t), None if e is None else jnp.asarray(e))
        with torch.no_grad():
            tl, tcache = ttf.decode_step(
                tc, tp, tcache, torch.tensor(toks[:, t:t + 1]), t,
                embeds=None if e is None else torch.tensor(e))
        _close(tl, jl, what=("logits", t))
        _check_cache(tcache, jcache)
    if window:
        key = "attn" if tc.family == "hybrid" else "kv"
        assert int(tcache[key]["pos"].min()) == steps - window


@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
def test_mla_decode_equals_reference(compute):
    """One absorbed MLA decode against a cache half filled with random
    entries, at a position past the filled ones."""
    jc, tc = _cfgs("deepseek-v3-671b", compute_dtype=compute)
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(2)))
    p = {k: v[0] for k, v in pn["seg0"]["attn"].items()}
    rng = np.random.default_rng(5)
    b, c, pos = 2, 12, 6
    x = rng.standard_normal((b, 1, jc.d_model)).astype(np.float32)
    ckv = rng.standard_normal((b, c, jc.kv_lora_rank)).astype(np.float32)
    kr = rng.standard_normal((b, c, jc.qk_rope_dim)).astype(np.float32)
    cpos = np.where(np.arange(c) < pos, np.arange(c), -1).astype(np.int32)
    jdt = jnp.dtype(compute)
    want = jattn.mla_decode(jc, jax.tree.map(jnp.asarray, p),
                            jnp.asarray(x, jdt), jnp.asarray(ckv, jdt),
                            jnp.asarray(kr, jdt), jnp.asarray(cpos),
                            jnp.int32(pos))
    tdt = getattr(torch, compute)
    tp = {k: torch.tensor(v) for k, v in p.items()}
    caches = (torch.tensor(ckv).to(tdt), torch.tensor(kr).to(tdt),
              torch.tensor(cpos))
    got = tattn.mla_decode(tc, tp, torch.tensor(x).to(tdt), *caches, pos)
    tol = F32_TOL if compute == "float32" else MLA_BF16_TOL
    _close(got[0], want[0], tol, "out")
    _close(got[1][0], want[1][0], tol, "ckv")
    _close(got[1][1], want[1][1], tol, "kr")
    np.testing.assert_array_equal(got[1][2].numpy(), np.asarray(want[1][2]))
    # the cache tensors were written in place
    assert all(g is c_ for g, c_ in zip(got[1], caches, strict=True))


def test_ssm_decode_equals_reference():
    """One SSM block's decode against the reference's, float32 compute,
    from a nonzero state and conv window."""
    jc, tc = _cfgs("mamba2-370m")
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(4)))
    p = {k: v[0] for k, v in pn["seg0"]["ssm"].items()}
    rng = np.random.default_rng(6)
    x = rng.standard_normal((2, 1, jc.d_model)).astype(np.float32)
    st = rng.standard_normal((2, jc.ssm_heads, jc.ssm_head_dim,
                              jc.ssm_state)).astype(np.float32)
    cv = rng.standard_normal((2, jc.ssm_conv - 1, jssm.conv_channels(
        jc))).astype(np.float32)
    jo, (jst, jcv) = jssm.ssm_decode(jc, jax.tree.map(jnp.asarray, p),
                                     jnp.asarray(x), jnp.asarray(st),
                                     jnp.asarray(cv))
    to, (tst, tcv) = tssm.ssm_decode(tc, {k: torch.tensor(v) for k, v in
                                          p.items()}, torch.tensor(x),
                                     torch.tensor(st), torch.tensor(cv))
    _close(to, jo, what="out")
    _close(tst, jst, what="state")
    _close(tcv, jcv, what="conv")


def test_init_cache_equals_reference_shapes():
    """Every family's cache tree: keys, shapes and dtypes, bfloat16
    compute; the hybrid holds one KV cache per shared-block use (13 for
    zamba2-7b's 81 layers)."""
    for arch in ARCH_IDS:
        jc, tc = jget(arch), get_config(arch)
        want = jax.eval_shape(lambda c=jc: jtf.init_cache(c, 4, 64))
        got = ttf.init_cache(tc, 4, 64, device="meta")
        w = dict(_walk(want))
        g = dict(_walk(got))
        assert g.keys() == w.keys(), arch
        for path, sds in w.items():
            assert tuple(g[path].shape) == tuple(sds.shape), (arch, path)
            assert str(g[path].dtype).split(".")[-1] == str(sds.dtype), \
                (arch, path)
    z = ttf.init_cache(get_config("zamba2-7b"), 1, 8, device="meta")
    assert z["attn"]["k"].shape[0] == 13


def test_init_cache_defaults_to_cuda():
    """The decode cache lands on the card unless the caller names another
    device: without a card every cache constructor raises for its default,
    and ``device="meta"`` still gives the shapes."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    for arch in ("qwen1.5-0.5b", "deepseek-v3-671b", "mamba2-370m",
                 "zamba2-7b"):
        cfg = get_config(arch).reduced()
        with pytest.raises(RuntimeError, match="is_available"):
            ttf.init_cache(cfg, 2, 8)
        meta = ttf.init_cache(cfg, 2, 8, device="meta")
        assert all(v.device.type == "meta" for sub in meta.values()
                   for v in sub.values())
    cfg = get_config("deepseek-v3-671b").reduced()
    for make in (tattn.init_kv_cache, tattn.init_mla_cache):
        with pytest.raises(RuntimeError, match="is_available"):
            make(cfg, 2, 8)
    with pytest.raises(RuntimeError, match="is_available"):
        tssm.init_ssm_cache(get_config("mamba2-370m").reduced(), 2)
