"""Port parity, serving: ``repro_torch.dist.serve`` (``serve_shapes``,
``build_prefill``, ``build_decode``) against ``repro.dist.serve`` on a
one-device ``("data", "model")`` mesh on the CPU, their ``shardings_fn``
against the reference's at its abstract ``(data 16, model 16)`` mesh, a
``(data 2, model 1)`` serve and a ``(data 1, model 2)`` prefill over two
gloo ranks against one process (the model axis's full cases are
``tests/test_torch_tp_serve.py``'s), the serve-shape helpers of the
registry, and the port's ``serve_demo`` on the CPU.

Tolerances:
* shapes, dtypes, the registry's serve adjustments, the demo's prompt and
  every leaf's placement: equal exactly;
* the data-2 serve and the model-2 prefill, float32, against one process
  on the whole batch:
  logits and the cache's float leaves within ``1e-5`` of the largest,
  ``pos`` exactly;
* prefill logits and decode logits in float32 compute (float32 scores):
  within ``1e-5`` of the largest logit; decode's ``pos`` leaves exactly;
* the demo's first logits, bfloat16 compute: the reference's ``TOL =
  0.05`` (``tests/test_decode_consistency.py``).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.dist import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.dist import comm  # noqa: E402
from repro_torch.dist import serve as tserve  # noqa: E402
from repro_torch.dist import sharding as tsh  # noqa: E402
from repro_torch.examples import serve_demo  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import reference_fields  # noqa: E402

TOL = 0.05
F32_TOL = 1e-5
# the families: dense with QKV bias, audio (embeds), MoE, MLA, SSM, hybrid
SERVE_ARCHS = ("qwen1.5-0.5b", "musicgen-large", "deepseek-moe-16b",
               "deepseek-v3-671b", "mamba2-370m", "zamba2-7b")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers at once, and their small multi-threaded torch operations slow
    each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def same_stream():
    """The port draws from the threefry stream JAX is set to."""
    with prng.threefry_partitionable(jax.config.jax_threefry_partitionable):
        yield


@pytest.fixture
def float32_scores(monkeypatch):
    monkeypatch.setattr(jattn, "chunked_attention", functools.partial(
        jattn.chunked_attention, score_dtype=jnp.float32))
    monkeypatch.setattr(tattn, "chunked_attention", functools.partial(
        tattn.chunked_attention, score_dtype=torch.float32))


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _same_spec(got, want, what):
    assert (got is None) == (want is None), what
    if got is None:
        return
    assert got.device.type == "meta", what
    assert tuple(got.shape) == tuple(want.shape), what
    assert str(got.dtype).split(".")[-1] == str(want.dtype), what


@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k",
                                        "prefill_32k"])
def test_serve_shapes_and_registry_equal_reference(shape_name):
    """Every config at full size: ``for_shape``, ``cache_len`` and the
    meta trees of ``serve_shapes`` (params, cache, tokens or embeds, pos)
    against the reference's ShapeDtypeStructs."""
    shape = treg.shape_by_name(shape_name)
    jshape = jreg.shape_by_name(shape_name)
    assert dataclasses.asdict(shape) == dataclasses.asdict(jshape)
    assert shape.is_decode == jshape.is_decode
    assert treg.LONG_CONTEXT_WINDOW == jreg.LONG_CONTEXT_WINDOW
    for arch in treg.ARCH_IDS:
        tc = treg.for_shape(treg.get_config(arch), shape)
        jc = jreg.for_shape(jreg.get_config(arch), jshape)
        assert reference_fields(tc) == dataclasses.asdict(jc), arch
        assert treg.uses_attention(tc) == jreg.uses_attention(jc)
        clen = treg.cache_len(tc, shape)
        assert clen == jreg.cache_len(jc, jshape)
        if shape_name == "prefill_32k" and arch not in SERVE_ARCHS:
            continue      # the eval_shape of the largest trees is slow
        got = tserve.serve_shapes(tc, shape, clen)
        want = jserve.serve_shapes(jc, jshape, clen)
        for g, w, what in zip(got[2:], want[2:], ("tokens", "embeds", "pos"),
                              strict=True):
            _same_spec(g, w, (arch, what))
        for gt, wt in zip(got[:2], want[:2], strict=True):
            g, w = dict(_walk(gt)), dict(_walk(wt))
            assert g.keys() == w.keys(), arch
            for path in w:
                _same_spec(g[path], w[path], (arch, path))
    tc = treg.for_shape(treg.get_config("qwen1.5-0.5b"),
                        treg.shape_by_name("long_500k"))
    assert tc.sliding_window == 4096
    assert treg.cache_len(tc, treg.shape_by_name("long_500k")) == 4096
    assert treg.for_shape(treg.get_config("mamba2-370m"),
                          treg.shape_by_name("long_500k")).sliding_window \
        is None


def _setup(arch):
    kw = dict(compute_dtype="float32")
    jc = dataclasses.replace(jreg.get_config(arch).reduced(), **kw)
    tc = dataclasses.replace(treg.get_config(arch).reduced(), **kw)
    pn = jax.tree.map(lambda a: np.asarray(a, np.float32),
                      jtf.init_params(jc, jax.random.PRNGKey(1)))
    rng = np.random.default_rng(2)
    s = 16
    if jc.family in ("audio", "vlm"):
        tok = None
        emb = rng.standard_normal((2, s, jc.d_model)).astype(np.float32)
    else:
        tok = rng.integers(0, jc.vocab_size, (2, s)).astype(np.int32)
        emb = None
    return jc, tc, pn, tok, emb


def _close(got, want, what):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= F32_TOL * float(np.abs(want).max()), (what, err)


def _mesh():
    """The reference's serve view of one device (``sharding.serve_mesh``)."""
    return jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_build_prefill_equals_reference(float32_scores, arch):
    jc, tc, pn, tok, emb = _setup(arch)
    mesh = _mesh()
    jpre, _ = jserve.build_prefill(jc, mesh)
    with mesh:      # its batch-axis constraint names the mesh's axes
        want = jax.jit(jpre)(jax.tree.map(jnp.asarray, pn),
                             None if tok is None else jnp.asarray(tok),
                             None if emb is None else jnp.asarray(emb))
    tpre, _ = tserve.build_prefill(tc, "cpu")
    got = tpre(ttf.params_from_jax(tc, pn), tok, emb)
    assert not got.requires_grad
    _close(got, want, arch)


@pytest.mark.parametrize("arch", SERVE_ARCHS)
def test_build_decode_equals_reference(arch):
    """8 steps through both builders from empty caches: logits, and the
    caches' ``pos`` leaves exactly."""
    jc, tc, pn, tok, emb = _setup(arch)
    mesh = _mesh()
    jdec, _ = jserve.build_decode(jc, mesh)
    jdec = jax.jit(jdec)
    tdec, _ = tserve.build_decode(tc, "cpu")
    jp = jax.tree.map(jnp.asarray, pn)
    tp = ttf.params_from_jax(tc, pn)
    jcache = jtf.init_cache(jc, 2, 8)
    tcache = ttf.init_cache(tc, 2, 8, device="cpu")
    for t in range(8):
        jt = None if tok is None else tok[:, t:t + 1]
        je = None if emb is None else emb[:, t:t + 1]
        with mesh:
            jl, jcache = jdec(jp, jcache,
                              None if jt is None else jnp.asarray(jt),
                              None if je is None else jnp.asarray(je),
                              jnp.int32(t))
        tl, tcache = tdec(tp, tcache, jt, je, t)
        _close(tl, jl, (arch, t))
    want = dict(_walk(jax.tree.map(np.asarray, jcache)))
    for path, g in _walk(tcache):
        if path[-1] == "pos":
            np.testing.assert_array_equal(g.numpy(), want[path])


def test_bfloat16_params_serve_in_bfloat16():
    """``params_from_jax(..., dtype=bfloat16)`` keeps deepseek-v3's weights
    in their own dtype (exactly the reference's values), and prefill and
    decode read them without a float32 copy of the tree."""
    jc = jreg.get_config("deepseek-v3-671b").reduced()
    tc = treg.get_config("deepseek-v3-671b").reduced()
    pn = jax.tree.map(np.asarray, jtf.init_params(jc, jax.random.PRNGKey(0)))
    tp = ttf.params_from_jax(tc, pn, dtype=torch.bfloat16)
    for path, leaf in _walk(tp):
        assert leaf.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(leaf.float().numpy(),
                                      np.asarray(dict(_walk(pn))[path],
                                                 np.float32))
    toks = np.random.default_rng(0).integers(0, tc.vocab_size, (1, 8))
    logits = tserve.build_prefill(tc, "cpu")[0](tp, toks)
    assert logits.shape == (1, 8, tc.vocab_size)
    cache = ttf.init_cache(tc, 1, 8, device="cpu")
    lg, cache = tserve.build_decode(tc, "cpu")[0](tp, cache, toks[:, :1],
                                                  None, 0)
    assert float((lg[:, 0].float() - logits[:, 0].float()).abs().max()) < TOL


def test_serve_entry_points_default_to_cuda():
    """Without a card, the builders and the demo raise for their default
    device rather than run on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cfg = treg.get_config("qwen1.5-0.5b").reduced()
    for build in (tserve.build_prefill, tserve.build_decode):
        with pytest.raises(RuntimeError, match="is_available"):
            build(cfg)
    with pytest.raises(RuntimeError, match="is_available"):
        serve_demo.run(["--gen", "1"])


@pytest.mark.parametrize("arch,window", [("qwen1.5-0.5b", 0),
                                         ("qwen1.5-0.5b", 8),
                                         ("deepseek-v3-671b", 0),
                                         ("zamba2-7b", 0)])
def test_serve_demo_on_cpu(arch, window, capsys):
    """The port's demo with ``--device cpu``: the reference demo's prompt
    (``jax.random.randint`` of ``PRNGKey(0)``), greedy tokens that are the
    argmax of the port's own logits, and its first decode step's logits
    against the reference's ``decode_step`` on the same weights."""
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--gen", "6"]
    if window:
        argv += ["--window", str(window)]
    out = serve_demo.run(argv)
    assert "[serve] OK" in capsys.readouterr().out
    cfg = out["cfg"]
    key = jax.random.PRNGKey(0)
    want_prompt = np.asarray(jax.random.randint(key, (2, 6), 0,
                                                cfg.vocab_size))
    np.testing.assert_array_equal(out["prompt"].numpy(), want_prompt)
    assert tuple(out["tokens"].shape) == (2, 6)
    assert int(out["tokens"][:, -1:].ne(
        out["logits"].argmax(-1)).sum()) == 0
    if window:
        pos = out["cache"]["kv"]["pos"][0]
        assert pos.shape == (window,) and int(pos.min()) == 12 - window
    jc = jreg.get_config(arch).reduced()
    if window:
        jc = dataclasses.replace(jc, sliding_window=window)
    jp = jtf.init_params(jc, key)
    jl, _ = jtf.decode_step(jc, jp, jtf.init_cache(jc, 2, 12),
                            jnp.asarray(want_prompt[:, :1]), jnp.int32(0))
    tc = out["cfg"]
    tp = ttf.init_params(tc, prng.PRNGKey(0))
    tl, _ = tserve.build_decode(tc, "cpu")[0](
        tp, ttf.init_cache(tc, 2, 12, device="cpu"), out["prompt"][:, :1],
        None, 0)
    assert float(np.abs(tl.float().numpy() - np.asarray(
        jl, np.float32)).max()) < TOL


SERVE_SIZES = {"data": 16, "model": 16}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.int32: jnp.int32}


def _sds(tree):
    """A meta tree of the port as the reference's ShapeDtypeStructs."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    return jax.ShapeDtypeStruct(tuple(tree.shape), JDTYPE[tree.dtype])


def _same_placement(got, want, leaf, what):
    """One leaf's port NamedSharding against the reference's: the same
    axis or None per dimension."""
    if want is None:
        assert got is None, what
        return
    ndim = len(leaf.shape)
    spec = tuple(want.spec) + (None,) * (ndim - len(tuple(want.spec)))
    assert tuple(got.spec) == spec, what


def _same_tree(got, want, leaves, what):
    g, w, lv = dict(_walk(got)), dict(_walk(want)), dict(_walk(leaves))
    assert g.keys() == w.keys(), what
    for path in w:
        _same_placement(g[path], w[path], lv[path], (what, path))


@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_shardings_equal_reference(arch):
    """``shardings_fn`` of both builders, every ``embed_mode`` and
    ``cache_mode``, at the reference's abstract (data 16, model 16) mesh:
    each parameter, cache, batch and position leaf placed as the
    reference's ``NamedSharding`` places it."""
    amesh = jax.sharding.AbstractMesh((16, 16), ("data", "model"))
    shape = treg.shape_by_name("decode_32k")
    tc, jc = treg.get_config(arch), jreg.get_config(arch)
    clen = treg.cache_len(tc, shape)
    params, cache, tok, emb, pos = tserve.serve_shapes(tc, shape, clen)
    jp, jcache, jtok, jemb = _sds(params), _sds(cache), _sds(tok), \
        _sds(emb)
    for mode in ("vocab", "dmodel"):
        _, jsh_ = jserve.build_prefill(jc, amesh, embed_mode=mode)
        _, tsh_ = tserve.build_prefill(tc, SERVE_SIZES, embed_mode=mode)
        want, got = jsh_(jp, jtok, jemb), tsh_(params, tok, emb)
        _same_tree(got[0], want[0], params, (mode, "params"))
        for g, w, leaf in zip(got[1:], want[1:], (tok, emb), strict=True):
            _same_placement(g, w, leaf, (mode, "batch"))
    for mode in ("auto", "inner", "seq"):
        _, jsh_ = jserve.build_decode(jc, amesh, cache_mode=mode)
        _, tsh_ = tserve.build_decode(tc, SERVE_SIZES, cache_mode=mode)
        want = jsh_(jp, jcache, jtok, jemb)
        got = tsh_(params, cache, tok, emb)
        _same_tree(got[0], want[0], params, (mode, "params"))
        _same_tree(got[1], want[1], cache, (mode, "cache"))
        for g, w, leaf in zip(got[2:], want[2:], (tok, emb, pos),
                              strict=True):
            _same_placement(g, w, leaf, (mode, "batch"))
    step, _ = tserve.build_prefill(tc, SERVE_SIZES)
    with pytest.raises(ValueError, match="abstract mesh"):
        step({}, np.zeros((2, 2), np.int32))


def test_data_two_serve_equals_one_process():
    """(data 2, model 1) over two gloo ranks, each on its half of the
    batch, against one process on the whole batch (float32); and the same
    ranks' prefill over (data 1, model 2), each on its parameter blocks,
    against one process."""
    from torch.distributed.tensor import Replicate, Shard
    tc = dataclasses.replace(treg.get_config("qwen1.5-0.5b").reduced(
        n_layers=1, d_model=64, vocab=128), compute_dtype="float32")
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, 128, (4, 8)))
    steps = 4
    # the ranks' function lives in a test module that does not import JAX,
    # which each rank would otherwise import to find it
    from test_torch_multirank import serve_ranks
    ranks = comm.spawn(serve_ranks, 2, (tc, toks, steps), timeout_s=240,
                       deadline_s=240)
    params = ttf.init_params(tc, prng.PRNGKey(0))
    prefill, _ = tserve.build_prefill(tc, "cpu")
    decode, _ = tserve.build_decode(tc, "cpu")
    want = [prefill(params, toks)]
    cache = ttf.init_cache(tc, toks.shape[0], steps, device="cpu")
    for t in range(steps):
        lg, cache = decode(params, cache, toks[:, t:t + 1], None, t)
        want.append(lg)
    sizes = {"data": 2, "model": 1}
    specs = tsh.cache_specs(cache, sizes)
    assert [r["coords"]["data"] for r in ranks] == [0, 1]
    for r in ranks:
        _close(r["tp_logits"], want[0].numpy(), "model-2 prefill")
        assert r["tok_spec"] == ("data", None) and r["pos_spec"] == ()
        assert r["placements"] == [Shard(0), Replicate()]
        rows = slice(2 * r["coords"]["data"], 2 * r["coords"]["data"] + 2)
        for g, w in zip(r["logits"], want, strict=True):
            assert g.shape == w[rows].shape
            _close(g, w[rows].numpy(), "logits")
        for path, w in _walk(cache):
            spec = dict(_walk(specs))[path]
            w = w[tsh.local_index(spec, tuple(w.shape), sizes, r["coords"])]
            g = dict(_walk(r["cache"]))[path]
            if path[-1] == "pos":
                assert torch.equal(g, w)
            else:
                _close(g, w.numpy(), path)
