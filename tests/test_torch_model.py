"""Port parity, model: weights handed over from the reference, the token
pipeline, the flat ravel order, and the dense model's loss and gradients on
a cut-down qwen1.5-0.5b, against ``repro`` on the same inputs.

Tolerances:
* weights, batches and the ravel: equal bit for bit;
* loss and gradients with float32 attention scores in both packages:
  ``rtol = 1e-5`` of each leaf's largest gradient (float32 sums in other
  orders);
* the reference's default path keeps attention scores in bfloat16, and XLA
  fuses chains of bfloat16 operations in float32 where PyTorch rounds after
  each one, so scores may differ by a bfloat16 ulp: the loss within
  ``1e-5`` relative (float32 compute) and ``1e-4`` (bfloat16 compute), the
  gradients within ``2e-2`` and ``5e-2`` of each leaf's largest gradient.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.data.synthetic import TokenPipeline as JPipe  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.dist.sparq_dist import DistSparqConfig as JDcfg  # noqa: E402
from repro.dist.sparq_dist import build_sparq as jbuild  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.data.synthetic import TokenPipeline  # noqa: E402
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import layers as tlayers  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import reference_fields  # noqa: E402

SMALL = dict(n_layers=1, d_model=128, vocab=256)


def _cfgs(**kw):
    j = dataclasses.replace(jget("qwen1.5-0.5b").reduced(**SMALL), **kw)
    t = dataclasses.replace(tget("qwen1.5-0.5b").reduced(**SMALL), **kw)
    return j, t


def _jax_params(cfg, seed=0):
    return jax.tree.map(np.asarray, jtf.init_params(cfg, jax.random.PRNGKey(seed)))


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def test_config_equals_reference_field_for_field():
    j, t = jget("qwen1.5-0.5b"), tget("qwen1.5-0.5b")
    assert dataclasses.asdict(j) == reference_fields(t)
    assert dataclasses.asdict(j.reduced(**SMALL)) == \
        reference_fields(t.reduced(**SMALL))
    # every reference config is served, field for field; an unknown arch
    # is still refused
    assert reference_fields(tget("deepseek-v3-671b")) == \
        dataclasses.asdict(jget("deepseek-v3-671b"))
    with pytest.raises(ValueError, match="unknown arch"):
        tget("gpt-2")


def test_params_from_jax_bit_for_bit():
    jc, tc = _cfgs()
    pn = _jax_params(jc)
    tp = ttf.params_from_jax(tc, pn)
    got = dict(_walk(tp))
    want = dict(_walk(pn))
    assert got.keys() == want.keys()
    for path, arr in want.items():
        assert got[path].dtype == torch.float32
        np.testing.assert_array_equal(got[path].numpy(), arr)
    shapes = jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
        lambda k: jtf.init_params(jc, k), jax.random.PRNGKey(0)))
    assert ttf.param_shapes(tc) == shapes
    bad = dict(pn, final_norm={"scale": np.zeros(3, np.float32)})
    with pytest.raises(ValueError):
        ttf.params_from_jax(tc, bad)


def test_token_pipeline_bit_for_bit():
    kw = dict(vocab_size=151936, seq_len=33, batch_per_node=3, n_nodes=5,
              seed=4)
    t, j = TokenPipeline(**kw), JPipe(**kw)
    for step in (0, 1, 17):
        bt, bj = t.global_batch(step), j.global_batch(step)
        for k in ("tokens", "labels"):
            assert bt[k].dtype == bj[k].dtype
            np.testing.assert_array_equal(bt[k], bj[k])


def test_ravel_equals_reference_exactly():
    """Leaf order decides the 1024-element tiles: the port's ravel of the
    handed-over weights must be the reference's flat vector exactly."""
    jc, tc = _cfgs(n_nodes=4)
    pn = _jax_params(jc, seed=3)
    mesh = jsh.train_mesh(jax.make_mesh((1, 1), ("data", "model")), jc)
    _, jstep, _, _ = jbuild(jc, mesh, JDcfg(use_kernel=True, frac=0.1))
    init_fn, tstep, _ = build_sparq(tc, DistSparqConfig(use_kernel=True,
                                                        frac=0.1),
                                    device="cpu")
    want = np.asarray(jstep.ravel(jax.tree.map(jnp.asarray, pn)))
    flat = tstep.ravel(ttf.params_from_jax(tc, pn))
    np.testing.assert_array_equal(flat.numpy(), want)
    assert (tstep.d_model_total, tstep.d_pad) == (jstep.d_model_total,
                                                   jstep.d_pad)
    state = init_fn(params=ttf.params_from_jax(tc, pn))
    assert not state["params"][:, tstep.d_model_total:].any()
    for row in state["params"]:
        np.testing.assert_array_equal(row[:tstep.d_model_total].numpy(),
                                      want)
    back = dict(_walk(tstep.unravel(state["params"][2])))
    for path, arr in _walk(pn):
        np.testing.assert_array_equal(back[path].numpy(), arr)


def _loss_and_grads(jc, tc, seq=16, seed=0):
    pn = _jax_params(jc)
    rng = np.random.default_rng(seed)
    batch = {k: rng.integers(0, jc.vocab_size, (2, seq)).astype(np.int32)
             for k in ("tokens", "labels")}
    (l_j, _), g_j = jax.value_and_grad(
        lambda p: jtf.lm_loss(jc, p, {k: jnp.asarray(v)
                                      for k, v in batch.items()}),
        has_aux=True)(jax.tree.map(jnp.asarray, pn))
    tp = ttf.params_from_jax(tc, pn)
    for _, leaf in _walk(tp):
        leaf.requires_grad_(True)
    l_t = ttf.lm_loss(tc, tp, {k: torch.tensor(v, dtype=torch.long)
                               for k, v in batch.items()})[0]
    l_t.backward()
    grads = [(path, leaf.grad.numpy(), np.asarray(dict(_walk(g_j))[path]))
             for path, leaf in _walk(tp)]
    return float(l_t.detach()), float(l_j), grads


def _assert_grads(grads, rtol):
    for path, got, want in grads:
        err = float(np.max(np.abs(got - want)))
        assert err <= rtol * float(np.max(np.abs(want))), (path, err)


@pytest.mark.parametrize("seq", [16, 40])
def test_loss_and_grads_tight_with_float32_scores(monkeypatch, seq):
    """The model's own arithmetic: with attention scores in float32 in both
    packages, loss and every gradient agree to float32 rounding."""
    monkeypatch.setattr(jattn, "chunked_attention", functools.partial(
        jattn.chunked_attention, score_dtype=jnp.float32))
    monkeypatch.setattr(tattn, "chunked_attention", functools.partial(
        tattn.chunked_attention, score_dtype=torch.float32))
    jc, tc = _cfgs(compute_dtype="float32")
    l_t, l_j, grads = _loss_and_grads(jc, tc, seq=seq)
    assert l_t == pytest.approx(l_j, rel=1e-6)
    _assert_grads(grads, 1e-5)


@pytest.mark.parametrize("compute_dtype,loss_rtol,grad_rtol",
                         [("float32", 1e-5, 2e-2), ("bfloat16", 1e-4, 5e-2)])
def test_loss_and_grads_default_path(compute_dtype, loss_rtol, grad_rtol):
    jc, tc = _cfgs(compute_dtype=compute_dtype)
    l_t, l_j, grads = _loss_and_grads(jc, tc)
    assert l_t == pytest.approx(l_j, rel=loss_rtol)
    _assert_grads(grads, grad_rtol)


def test_chunked_ce_and_attention_match_reference():
    jc, tc = _cfgs(compute_dtype="float32")
    rng = np.random.default_rng(8)
    pn = _jax_params(jc)
    h = rng.standard_normal((2, 24, 128)).astype(np.float32)
    labels = rng.integers(0, 256, (2, 24)).astype(np.int32)
    want = jtf.chunked_ce(jc, jax.tree.map(jnp.asarray, pn["embed"]),
                          jnp.asarray(h), jnp.asarray(labels), chunk=8)
    got = ttf.chunked_ce(tc, ttf.params_from_jax(tc, pn)["embed"],
                         torch.tensor(h), torch.tensor(labels).long(),
                         chunk=8)
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    q, k, v = rng.standard_normal((3, 2, 32, 4, 16)).astype(np.float32)
    pos = np.arange(32, dtype=np.int32)
    for window, chunks in ((None, (8, 16)), (5, (32, 8))):
        want = jattn.chunked_attention(
            *map(jnp.asarray, (q, k, v, pos, pos)), window=window,
            q_chunk=chunks[0], k_chunk=chunks[1], score_dtype=jnp.float32)
        got = tattn.chunked_attention(
            *map(torch.tensor, (q, k, v, pos, pos)), window=window,
            q_chunk=chunks[0], k_chunk=chunks[1], score_dtype=torch.float32)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


def test_remat_changes_nothing():
    _, tc = _cfgs(compute_dtype="float32")
    pn = _jax_params(dataclasses.replace(_cfgs()[0],
                                         compute_dtype="float32"))
    toks = torch.tensor(np.random.default_rng(1).integers(0, 256, (2, 16)))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tc, remat=remat, n_layers=1)
        tp = ttf.params_from_jax(c, pn)
        for _, leaf in _walk(tp):
            leaf.requires_grad_(True)
        loss = ttf.lm_loss(c, tp, {"tokens": toks, "labels": toks})[0]
        loss.backward()
        out.append([leaf.grad.clone() for _, leaf in _walk(tp)])
    for a, b in zip(out[0], out[1], strict=True):
        assert torch.equal(a, b)


def test_unported_families_raise():
    """Every family is ported and every model entry takes it: MLA and MTP
    (alone or together) return the reference's shapes, and their keys
    cover every drawn leaf; the MoE, SSM and hybrid families likewise."""
    jc, tc = _cfgs()

    def entries(c):
        return (ttf.param_shapes(c),
                ttf.init_keys(c, torch.zeros(2, dtype=torch.int64)))
    for kw in (dict(use_mla=True), dict(use_mtp=True),
               dict(use_mla=True, use_mtp=True, q_lora_rank=32)):
        c = dataclasses.replace(tc, **kw)
        shapes, keys = entries(c)
        want = jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
            lambda k, c=dataclasses.replace(jc, **kw): jtf.init_params(c, k),
            jax.random.PRNGKey(0)))
        assert shapes == want
        drawn = {p for p, _ in _walk(shapes) if p[-1] not in (
            "scale", "bias", "bq", "bk", "bv")}
        assert set(keys) == drawn
        if c.use_mla:
            assert ("seg0", "attn", "w_uk") in keys
            assert ("seg0", "attn", "wq") not in keys
        if c.use_mtp:
            assert ("mtp", "proj") in keys and set(shapes["mtp"]) == {
                "proj", "block", "norm"}
    shapes, keys = entries(dataclasses.replace(tc, family="ssm",
                                               ssm_state=16))
    assert set(shapes) == {"embed", "final_norm", "seg0"}
    assert set(shapes["seg0"]) == {"norm", "ssm"}
    assert ("seg0", "ssm", "w_in") in keys
    shapes, keys = entries(dataclasses.replace(tc, family="hybrid",
                                               ssm_state=16, attn_every=2))
    assert set(shapes["shared_attn"]) == {"attn", "mlp", "norm1", "norm2"}
    assert ("shared_attn", "attn", "wq") in keys
    entries(dataclasses.replace(tc, family="moe", n_experts=4, moe_top_k=2,
                                moe_d_ff=64))


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_norm_eps_is_the_configs(norm):
    """The norms take the configuration's ``norm_eps``; at its default,
    1e-5, they are the reference's, and a config at another value keeps the
    field, so it never compares equal to a reference config."""
    _, tc = _cfgs(norm=norm)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(3, 5, tc.d_model, generator=g) * 0.02
    p = {"scale": torch.rand(tc.d_model, generator=g) + 0.5,
         "bias": torch.randn(tc.d_model, generator=g)}

    def plain(eps):
        if norm == "layernorm":
            y = (x - x.mean(-1, keepdim=True)) * torch.rsqrt(
                x.var(-1, keepdim=True, unbiased=False) + eps)
            return y * p["scale"] + p["bias"]
        ms = (x * x).mean(-1, keepdim=True)
        return x * torch.rsqrt(ms + eps) * p["scale"]
    assert tc.norm_eps == 1e-5 and "norm_eps" not in reference_fields(tc)
    assert torch.equal(tlayers.apply_norm(tc, p, x), plain(1e-5))
    c6 = dataclasses.replace(tc, norm_eps=1e-6)
    y6 = tlayers.apply_norm(c6, p, x)
    assert torch.equal(y6, plain(1e-6))
    assert not torch.allclose(y6, plain(1e-5), rtol=1e-3)
    assert reference_fields(c6)["norm_eps"] == 1e-6
