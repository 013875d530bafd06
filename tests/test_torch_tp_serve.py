"""Port parity, tensor-parallel serve (ROADMAP A.13): the serve builders
over a ``(data, model)`` mesh whose ``model`` axis has two ranks, gloo on
the CPU, against the port's one-process serve of the same configs, which
is in turn held against the reference's ``build_prefill`` and
``build_decode`` on a one-device mesh with the same parameters and inputs.

Two ranks at ``(data 1, model 2)`` serve every one of the ten ``reduced()``
configs with ``cache_mode="auto"``, and the SSM, hybrid and MLA configs
with their caches on the slots (``"seq"``) too, and the dense config with
one kv head (``KV1``), whose cache ``"auto"`` splits over head_dim; four ranks at ``(data 2,
model 2)`` serve the dense config in both ``embed_mode``s and all three
``cache_mode``s. A case's fourth field picks the decode's ring (``RINGS``):
the plain run fills ``STEPS`` slots in ``STEPS`` steps; ``wrap`` decodes 7
steps into 4 slots, so positions 4-6 overwrite slots 0-2, which lie on
both ranks' blocks when the slots are split; ``window`` adds a sliding
window of 3 to that, so the mask drops a slot the ring still holds (with a
window of 4, the cache's length, every slot the ring holds is inside it
and the mask would drop nothing that ``wrap`` does not). The ring cases
run the dense and the MLA configs with their caches split by slots and
by heads or latent.

The ranks are spawned once per module fixture and loop over the cases
inside; each builds the whole parameter tree and the whole cache, cuts its
blocks with ``serve.local_shard`` and drops the whole trees, runs a
prefill and teacher-forced decode steps, and returns its logits, its cache
shard and its parameter blocks. The one-process runs here use float32
compute and scores, as the ranks do; the reference's runs use float32
scores too (JAX is imported only where the reference runs, so the ranks,
which import this module, do not load it).

Tolerances:
* logits: within ``F32_TOL`` (``1e-5``) of the largest logit, the ranks
  against one process and one process against the reference;
* every cache shard against the one-process cache's ``local_index``
  block: within the same tolerance of the block's largest entry, ``pos``
  exactly; the one-process cache against the reference's the same way;
* every parameter leaf a rank holds: exactly its ``local_index`` block of
  the whole leaf, in a storage of its own (no whole copy behind it).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.dist import comm, serve, sharding  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

F32_TOL = 1e-5
S, STEPS = 8, 4
# ring -> (decode steps, cache slots, sliding window)
RINGS = {"": (STEPS, STEPS, None), "wrap": (7, 4, None),
         "window": (7, 4, 3)}
TIMEOUT_S = 300.0
F32_SCORES = functools.partial(tattn.chunked_attention,
                               score_dtype=torch.float32)
DENSE = "qwen1.5-0.5b"
MLA = "deepseek-v3-671b"
# one kv head: model 2 does not divide the kv heads, so cache_specs puts
# the cache's model axis on head_dim (the dry run meets this placement at
# the reference's 16-wide model axis in chameleon-34b, minitron-4b and
# qwen1.5-32b, whose 8 kv heads it does not divide)
KV1 = f"{DENSE}:kv1"
VARIANTS = {"kv1": {"n_kv_heads": 1}}
# (arch, embed_mode, cache_mode, ring) of each mesh's ranks
TWO = [(a, "vocab", "auto", "") for a in treg.ARCH_IDS] + \
    [(a, "vocab", "seq", "") for a in ("mamba2-370m", "zamba2-7b", MLA,
                                       "deepseek-moe-16b")] + \
    [(a, "vocab", c, r) for a in (DENSE, MLA) for c in ("auto", "seq")
     for r in ("wrap", "window")] + \
    [(KV1, "vocab", "auto", r) for r in ("", "window")]
FOUR = [(DENSE, e, c, "") for e in ("vocab", "dmodel")
        for c in ("auto", "inner", "seq")] + \
    [(DENSE, "vocab", "seq", "wrap"), (DENSE, "dmodel", "seq", "window")]


def _ids(case):
    return "-".join(f for f in case if f)


def _variant(arch):
    """``(registry arch, field overrides)`` of a case's arch name."""
    name, _, variant = arch.partition(":")
    return name, VARIANTS.get(variant, {})


def _cfg(arch, ring=""):
    name, over = _variant(arch)
    return dataclasses.replace(treg.get_config(name).reduced(),
                               compute_dtype="float32",
                               sliding_window=RINGS[ring][2], **over)


def _inputs(cfg, batch):
    """Tokens or frontend embeddings for the prefill's ``S`` positions and
    every decode step's (teacher-forced from the same rows)."""
    rng = np.random.default_rng(7)
    if cfg.family in ("audio", "vlm"):
        emb = rng.standard_normal((batch, S, cfg.d_model)).astype(np.float32)
        return None, torch.as_tensor(emb)
    tok = rng.integers(0, cfg.vocab_size, (batch, S)).astype(np.int64)
    return torch.as_tensor(tok), None


def _cut(x, t):
    return None if x is None else x[:, t:t + 1]


def _serve(cfg, mesh, tok, emb, embed_mode, cache_mode, ring):
    """Prefill and teacher-forced decode steps into a ring of slots, as
    ``RINGS[ring]`` says, on ``mesh`` (a device, or a rank's serve mesh,
    whose blocks are cut here)."""
    steps, slots, _ = RINGS[ring]
    prefill, pre_sh = serve.build_prefill(cfg, mesh, embed_mode=embed_mode)
    decode, dec_sh = serve.build_decode(cfg, mesh, cache_mode=cache_mode)
    params = ttf.init_params(cfg, prng.PRNGKey(0))
    cache = ttf.init_cache(cfg, (tok if emb is None else emb).shape[0],
                           slots, device="cpu")
    pre, dec = params, params
    if not isinstance(mesh, str):
        ps, _, _ = pre_sh(params, tok, emb)
        pre = serve.local_shard(params, ps, mesh)
        ps, cs, _, _, _ = dec_sh(params, cache, _cut(tok, 0), _cut(emb, 0))
        dec = serve.local_shard(params, ps, mesh)
        cache = serve.local_shard(cache, cs, mesh)
        del params
    logits = [prefill(pre, tok, emb)]
    for t in range(steps):
        lg, cache = decode(dec, cache, _cut(tok, t), _cut(emb, t), t)
        logits.append(lg)
    return {"logits": logits, "cache": cache, "params": pre,
            "dec_params": dec}


def tp_ranks(rank, cases, batch):
    """One rank of a serve mesh: every case of ``cases``, or the error it
    raised."""
    tattn.chunked_attention = F32_SCORES
    smesh = sharding.serve_mesh(make_production_mesh(
        model=2, device_type="cpu"))
    out = {"coords": sharding.coordinates(smesh),
           "sizes": sharding.axis_sizes(smesh)}
    for case in cases:
        arch, embed_mode, cache_mode, ring = case
        cfg = _cfg(arch, ring)
        tok, emb = _inputs(cfg, batch)
        try:
            out[case] = _serve(cfg, smesh, tok, emb, embed_mode, cache_mode,
                               ring)
        except NotImplementedError as e:
            out[case] = {"refused": str(e)}
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two():
    return comm.spawn(tp_ranks, 2, (TWO, 2), timeout_s=TIMEOUT_S,
                      deadline_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def four():
    return comm.spawn(tp_ranks, 4, (FOUR, 4), timeout_s=TIMEOUT_S,
                      deadline_s=TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _one(arch, batch, embed_mode, cache_mode, ring):
    """The one-process serve of a case (memoized for the module)."""
    saved, tattn.chunked_attention = tattn.chunked_attention, F32_SCORES
    try:
        cfg = _cfg(arch, ring)
        tok, emb = _inputs(cfg, batch)
        out = _serve(cfg, "cpu", tok, emb, embed_mode, cache_mode, ring)
    finally:
        tattn.chunked_attention = saved
    return out


@functools.lru_cache(maxsize=None)
def _reference(arch, batch, ring):
    """The reference's serve of a case on a one-device ``(data, model)``
    mesh with float32 scores: the one-process run's parameters (the port's
    ``init_params``, handed over as numpy), inputs and ring -> its prefill
    and decode logits and its final cache, as numpy (memoized)."""
    import jax
    import jax.numpy as jnp
    from repro.configs import registry as jreg
    from repro.dist import serve as jserve
    from repro.models import attention as jattn
    from repro.models import transformer as jtf
    steps, slots, window = RINGS[ring]
    name, over = _variant(arch)
    jc = dataclasses.replace(jreg.get_config(name).reduced(),
                             compute_dtype="float32", sliding_window=window,
                             **over)
    tok, emb = _inputs(_cfg(arch, ring), batch)
    tok = None if tok is None else jnp.asarray(tok.numpy(), jnp.int32)
    emb = None if emb is None else jnp.asarray(emb.numpy())
    params = {}
    for path, t in _walk(ttf.init_params(_cfg(arch, ring),
                                         prng.PRNGKey(0))):
        sub = params
        for k in path[:-1]:
            sub = sub.setdefault(k, {})
        sub[path[-1]] = jnp.asarray(t.float().numpy())
    mesh = jax.sharding.Mesh(np.array(jax.devices()[:1]).reshape(1, 1),
                             ("data", "model"))
    saved = jattn.chunked_attention
    jattn.chunked_attention = functools.partial(saved,
                                                score_dtype=jnp.float32)
    try:
        jpre, _ = jserve.build_prefill(jc, mesh)
        jdec, _ = jserve.build_decode(jc, mesh)
        jdec = jax.jit(jdec)
        cache = jtf.init_cache(jc, batch, slots)
        with mesh:  # the builders' batch-axis constraints name its axes
            logits = [jax.jit(jpre)(params, tok, emb)]
            for t in range(steps):
                lg, cache = jdec(params, cache, _cut(tok, t), _cut(emb, t),
                                 jnp.int32(t))
                logits.append(lg)
    finally:
        jattn.chunked_attention = saved
    return ([np.array(lg, np.float32) for lg in logits],
            dict(_walk(jax.tree.map(np.array, cache))))


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _close(got, want, what):
    assert got.shape == want.shape, what
    err = float((got.float() - want.float()).abs().max())
    assert err <= F32_TOL * float(want.float().abs().max()), (what, err)


def _check_reference(one, arch, batch, ring):
    """The one-process run's logits and final cache against the
    reference's on the same parameters and inputs."""
    logits, cache = _reference(arch, batch, ring)
    for i, (g, w) in enumerate(zip(one["logits"], logits, strict=True)):
        _close(g, torch.as_tensor(w), (arch, ring, "reference logits", i))
    got = dict(_walk(one["cache"]))
    assert set(got) == set(cache), (arch, ring)
    for path, w in cache.items():
        if path[-1] == "pos":
            np.testing.assert_array_equal(got[path].numpy(), w)
        else:
            _close(got[path], torch.as_tensor(w.astype(np.float32)),
                   (arch, ring, "reference cache", path))


def _check(ranks, case, batch):
    """The one-process run against the reference, then each rank's logits
    (its data rows), cache shard and parameter blocks against the
    one-process run."""
    arch, embed_mode, cache_mode, ring = case
    want = _one(arch, batch, embed_mode, cache_mode, ring)
    _check_reference(want, arch, batch, ring)
    cfg = _cfg(arch, ring)
    sizes = ranks[0]["sizes"]
    tok, emb = _inputs(cfg, batch)
    _, pre_sh = serve.build_prefill(cfg, sizes, embed_mode=embed_mode)
    _, dec_sh = serve.build_decode(cfg, sizes, cache_mode=cache_mode)
    pspec, _, _ = pre_sh(want["params"], tok, emb)
    dspec, cspec, _, _, _ = dec_sh(want["params"], want["cache"],
                                   _cut(tok, 0), _cut(emb, 0))
    per = batch // sizes["data"]
    for r in ranks:
        got, c = r[case], r["coords"]
        assert "refused" not in got, got.get("refused")
        rows = slice(c["data"] * per, (c["data"] + 1) * per)
        for i, (g, w) in enumerate(zip(got["logits"], want["logits"],
                                       strict=True)):
            _close(g, w[rows], (case, c, "logits", i))
        for key, specs in (("params", pspec), ("dec_params", dspec)):
            specs = dict(_walk(specs))
            for path, w in _walk(want[key]):
                g = dict(_walk(got[key]))[path]
                w = w[sharding.local_index(specs[path].spec, tuple(w.shape),
                                           sizes, c)]
                assert torch.equal(g, w), (case, key, path)
                assert g.untyped_storage().nbytes() == \
                    g.numel() * g.element_size(), (case, key, path)
        specs = dict(_walk(cspec))
        for path, w in _walk(want["cache"]):
            g = dict(_walk(got["cache"]))[path]
            w = w[sharding.local_index(specs[path].spec, tuple(w.shape),
                                       sizes, c)]
            if path[-1] == "pos":
                assert torch.equal(g, w), (case, path)
            else:
                _close(g, w, (case, c, path))


@pytest.mark.parametrize("case", TWO, ids=_ids)
def test_model_two_serve_equals_one_process(two, case):
    """(data 1, model 2): prefill and decode logits, the cache shards and
    the parameter blocks of both ranks."""
    assert [r["coords"]["model"] for r in two] == [0, 1]
    _check(two, case, 2)


@pytest.mark.parametrize("case", FOUR, ids=_ids)
def test_data_two_model_two_serve_equals_one_process(four, case):
    """(data 2, model 2), dense: each embed_mode and cache_mode; each
    rank's data rows."""
    assert [(r["coords"]["data"], r["coords"]["model"]) for r in four] == \
        [(0, 0), (0, 1), (1, 0), (1, 1)]
    _check(four, case, 4)


def test_model_axis_shards_every_leaf_it_places(two):
    """The qwen config's every parameter leaf that its spec puts on
    ``model`` is half the whole on each rank, the cache's kv heads too:
    nothing is quietly replicated."""
    cfg = _cfg(DENSE)
    whole = ttf.param_shapes(cfg)
    r = two[0][(DENSE, "vocab", "auto", "")]
    specs = dict(_walk(serve._serve_param_specs(whole, {"data": 1,
                                                        "model": 2},
                                                "vocab")))
    for path, shape in _walk(whole):
        got = tuple(dict(_walk(r["params"]))[path].shape)
        want = tuple(n // 2 if ax == "model" else n
                     for n, ax in zip(shape, specs[path]))
        assert got == want, path
        assert "model" in specs[path], path
    k = r["cache"]["kv"]["k"]
    assert k.shape[3] == cfg.n_kv_heads // 2
    # one kv head: the cache splits over head_dim
    k = two[0][(KV1, "vocab", "auto", "")]["cache"]["kv"]["k"]
    assert k.shape[3:] == (1, cfg.resolved_head_dim // 2)


def test_whole_params_are_refused():
    """A step handed the whole tree over a model-2 mesh says to cut it."""
    cfg = _cfg(DENSE)
    m = serve._Mesh({"data": 1, "model": 2})
    params = ttf.init_params(cfg, prng.PRNGKey(0))
    with pytest.raises(ValueError, match="local_shard"):
        m.check_blocks(cfg, params, "vocab")


@pytest.mark.parametrize("arch", [DENSE, "zamba2-7b"])
def test_serve_demo_model_two_on_cpu(arch, capfd):
    """``serve_demo --model 2``: two gloo ranks greedy-decode the same
    tokens as one process, and rank 0's last logits agree within the
    bfloat16 demo's ``TOL`` (``tests/test_torch_serve.py``)."""
    from repro_torch.examples import serve_demo
    argv = ["--arch", arch, "--device", "cpu", "--batch", "2",
            "--prompt-len", "6", "--gen", "6"]
    one = serve_demo.run(argv)
    two = serve_demo.run(argv + ["--model", "2"])
    assert "(model 2)" in capfd.readouterr().out
    assert torch.equal(two["tokens"], one["tokens"])
    assert float((two["logits"].float() - one["logits"].float()).abs()
                 .max()) < 0.05
