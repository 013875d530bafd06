"""Port parity, the model zoo: every config the port serves against the
reference's (fields, parameter shapes, ravel order, x^0 on the threefry key
tree, loss and gradients at reduced width), the flat-buffer engine over
syncs on the MoE, SSM and hybrid configs and on chameleon's bfloat16
weights, the train CLI on the MoE, SSM and hybrid configs, and
recomputation of a MoE block. The hybrid zamba2-7b runs 4 layers with its
shared attention block after layers 1 and 3, so that block's gradient is
the sum of two uses.

Tolerances:
* configs, shapes, the ravel and the MoE slot tables: equal exactly;
* x^0: within 4 float32 ulps (``tests/test_torch_init.py``), and within one
  bfloat16 ulp for bfloat16 weights (float32 draws within 4 ulps can round
  to neighbouring bfloat16 values);
* loss and gradients with float32 compute and float32 attention scores in
  both packages: the loss within ``1e-6`` relative, every gradient within
  ``1e-5`` of its leaf's largest (``tests/test_torch_model.py``);
* the engines: ``tests/test_torch_dist.py``'s (params and x_hat within
  ``atol = 5e-4``, triggers and sync rounds exact, bits within ``1e-6``);
* the CLI's first loss in the default bfloat16 numerics: ``1e-4`` relative
  (the SSM block's bfloat16 projections, conv and gated norm round after
  each op here and in fused float32 chains in XLA: measured 2.1e-5 on
  mamba2-370m and 7.1e-6 on zamba2-7b).
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro.data.synthetic import TokenPipeline as JPipe  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.dist.sparq_dist import DistSparqConfig as JDcfg  # noqa: E402
from repro.dist.sparq_dist import build_sparq as jbuild  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs import registry  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import triggers as ttrig  # noqa: E402
from repro_torch.dist.sparq_dist import (DistSparqConfig, _flatten_spec,  # noqa: E402
                                         build_sparq)
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402
from repro_torch.models.config import reference_fields  # noqa: E402

ARCHS = ("qwen1.5-0.5b", "minitron-4b", "stablelm-1.6b", "qwen1.5-32b",
         "musicgen-large", "chameleon-34b", "deepseek-moe-16b",
         "mamba2-370m", "zamba2-7b", "deepseek-v3-671b")
# three layers: deepseek-moe-16b's seg1 then stacks two MoE blocks
SMALL = dict(n_layers=3, d_model=128, vocab=256)
# four for the hybrid: reduced() sets attn_every = 2, so the shared block
# runs after layers 1 and 3
LAYERS = {"zamba2-7b": 4}
ULPS = 4


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


def _cfgs(arch, **kw):
    small = dict(SMALL, n_layers=LAYERS.get(arch, SMALL["n_layers"]))
    return (dataclasses.replace(jget(arch).reduced(**small), **kw),
            dataclasses.replace(registry.get_config(arch).reduced(**small),
                                **kw))


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _f32(tree):
    """A reference tree as float32 numpy arrays (bfloat16 values kept)."""
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def test_registry_serves_seven_archs_and_refuses_the_rest():
    """Since MLA and MTP are ported the registry serves all ten of the
    reference's archs, in its order; an unknown arch is refused."""
    assert set(registry.ARCH_IDS) == set(ARCHS) and len(ARCHS) == 10
    assert registry.ARCH_IDS == jreg.ARCH_IDS
    with pytest.raises(ValueError, match="unknown arch"):
        registry.get_config("gpt-2")


@pytest.mark.parametrize("arch", ARCHS)
def test_config_and_shapes_equal_reference(arch):
    j, t = jget(arch), registry.get_config(arch)
    assert dataclasses.asdict(j) == reference_fields(t)
    for jc, tc in ((j, t), _cfgs(arch)):
        assert dataclasses.asdict(jc.reduced()) == \
            reference_fields(tc.reduced())
        shapes = jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
            lambda k, c=jc: jtf.init_params(c, k), jax.random.PRNGKey(0)))
        assert ttf.param_shapes(tc) == shapes
    assert ttf.segments(t) == jtf.segments(j)


@pytest.mark.parametrize("arch", ["deepseek-moe-16b", "minitron-4b",
                                  "mamba2-370m", "zamba2-7b"])
def test_ravel_order_equals_ravel_pytree(arch):
    jc, tc = _cfgs(arch, n_nodes=4)
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(3)))
    want = np.asarray(ravel_pytree(jax.tree.map(jnp.asarray, pn))[0])
    _, step, _ = build_sparq(tc, DistSparqConfig(use_kernel=True, frac=0.1),
                             device="cpu")
    got = step.ravel(ttf.params_from_jax(tc, pn)).numpy()
    np.testing.assert_array_equal(got, want)
    if arch == "deepseek-moe-16b":
        paths = [p for p, _ in _walk(ttf.param_shapes(tc))]
        assert paths[:3] == [("embed", "embedding"), ("embed", "lm_head"),
                             ("final_norm", "scale")]
        moe_paths = [p[-1] for p in paths if p[:2] == ("seg1", "moe")]
        assert moe_paths == ["router", "shared_gate", "shared_in",
                             "shared_out", "w_gate", "w_in", "w_out"]
    if arch == "zamba2-7b":
        # the engine's own slices: the shared block's leaves come last
        slices = _flatten_spec(ttf.param_shapes(tc))[0]
        tops = [path[0] for path, _, _, _ in slices]
        assert list(dict.fromkeys(tops)) == ["embed", "final_norm", "seg0",
                                             "shared_attn"]
        assert [path[-1] for path, _, _, _ in slices
                if path[:2] == ("seg0", "ssm")] == [
            "a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "norm_scale",
            "w_in", "w_out"]


def _ulps(got, want, dtype):
    """The largest distance in steps of ``dtype`` (float32 or bfloat16)."""
    if dtype == torch.bfloat16:
        bits = got.view(torch.int16).numpy().astype(np.int64), \
            np.asarray(want).view(np.int16).astype(np.int64)
        sign = 0x7FFF
    else:
        bits = got.numpy().view(np.int32).astype(np.int64), \
            np.asarray(want, np.float32).view(np.int32).astype(np.int64)
        sign = 0x7FFFFFFF
    a, b = (np.where(i < 0, -(i & sign), i) for i in bits)
    return int(np.max(np.abs(a - b), initial=0))


def _assert_init_equal(arch):
    jc, tc = _cfgs(arch)
    want = dict(_walk(jax.tree.map(np.asarray, jtf.init_params(
        jc, jax.random.PRNGKey(0)))))
    got = dict(_walk(ttf.init_params(tc, prng.PRNGKey(0))))
    assert set(got) == set(want)
    dt = getattr(torch, tc.param_dtype)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape and g.dtype == dt, path
        assert _ulps(g, w, dt) <= (1 if dt == torch.bfloat16 else ULPS), path


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_equals_reference_leaf_by_leaf(arch):
    """In the layout the session runs in (``tests/test_torch_layout.py``:
    the original one)."""
    _assert_init_equal(arch)


@pytest.fixture
def partitionable_stream():
    """JAX's default threefry layout in both packages, restored after."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", True)
    try:
        with prng.threefry_partitionable(True):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_equal_reference_in_the_partitionable_layout(
        partitionable_stream, arch):
    """The same, in the layout JAX draws from by default: every family's
    x^0, whatever layout the session runs in."""
    assert jax.config.jax_threefry_partitionable and prng.partitionable()
    _assert_init_equal(arch)


def _batch(cfg, seed=0, embeds=False):
    rng = np.random.default_rng(seed)
    batch = {"labels": rng.integers(0, cfg.vocab_size, (2, 16)).astype(
        np.int32)}
    if embeds:
        batch["embeds"] = rng.standard_normal((2, 16, cfg.d_model)).astype(
            np.float32)
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab_size, (2, 16)).astype(
            np.int32)
    return batch


def _torch_batch(batch):
    return {k: torch.tensor(v, dtype=torch.long if v.dtype == np.int32
                            else torch.float32) for k, v in batch.items()}


def _jax_route_tables(jc, params, batch):
    """The reference's slot table of every MoE layer in one forward, read
    out of its scans with a debug callback."""
    seen = []
    real = jmoe.route

    def route(cfg, w, x):
        out = real(cfg, w, x)
        jax.debug.callback(lambda t: seen.append(np.asarray(t)), out[0])
        return out
    jmoe.route = route
    try:
        jax.block_until_ready(jtf.forward_hidden(
            jc, params, batch.get("tokens"), embeds=batch.get("embeds")))
        jax.effects_barrier()
    finally:
        jmoe.route = real
    return seen


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_tight_with_float32_scores(float32_scores, arch,
                                                  monkeypatch):
    """Each config's loss, aux and gradients at reduced width in float32;
    musicgen-large through ``embeds``, chameleon-34b with its qk-norm, the
    MoE configs with the routing of every layer equal exactly (deepseek-
    v3-671b with MLA and its MTP term)."""
    jc, tc = _cfgs(arch, compute_dtype="float32")
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(1)))
    batch = _batch(jc, embeds=arch == "musicgen-large")
    jp = jax.tree.map(jnp.asarray, pn)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (l_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(jc, p, jb), has_aux=True))(jp)
    tp = ttf.params_from_jax(tc, pn)
    for _, leaf in _walk(tp):
        leaf.requires_grad_(True)
    tables = []
    real = tmoe.route

    def route(cfg, w, x, group=None):
        out = real(cfg, w, x, group)
        tables.append(out[0].clone())
        return out
    monkeypatch.setattr(tmoe, "route", route)
    l_t, m_t = ttf.lm_loss(tc, tp, _torch_batch(batch))
    l_t.backward()
    assert float(l_t.detach()) == pytest.approx(float(l_j), rel=1e-6)
    assert float(m_t["aux"].detach()) == pytest.approx(float(m_j["aux"]),
                                                       rel=1e-5,
                                                       abs=1e-12)
    want = dict(_walk(jax.tree.map(np.asarray, g_j)))
    for path, leaf in _walk(tp):
        # through embeds the embedding table is unused: no gradient, and the
        # reference's is zero
        got = (np.zeros_like(want[path]) if leaf.grad is None
               else leaf.grad.numpy())
        err = float(np.max(np.abs(got - want[path])))
        assert err <= 1e-5 * float(np.max(np.abs(want[path]))), (path, err)
    if tc.n_experts:
        jt = _jax_route_tables(jc, jp, jb)
        assert len(tables) == len(jt) == 2
        for a, b in zip(tables, jt, strict=True):
            np.testing.assert_array_equal(a.numpy(), b)
        assert float(m_t["aux"].detach()) > 0
    else:
        assert not tables and float(m_t["aux"].detach()) == 0.0


def test_forward_logits_through_embeds(float32_scores):
    jc, tc = _cfgs("musicgen-large", compute_dtype="float32")
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(2)))
    emb = _batch(jc, embeds=True)["embeds"]
    want, _ = jtf.forward(jc, jax.tree.map(jnp.asarray, pn),
                          embeds=jnp.asarray(emb))
    got, aux = ttf.forward(tc, ttf.params_from_jax(tc, pn),
                           embeds=torch.tensor(emb))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5 * float(np.abs(want).max()))
    assert float(aux) == 0.0


def test_remat_changes_nothing_for_a_moe_block(monkeypatch):
    """Under recomputation the MoE block routes again in the backward: the
    recomputed table equals the forward's, so the gradients are equal."""
    _, tc = _cfgs("deepseek-moe-16b", compute_dtype="float32", n_layers=2)
    pn = _f32(jtf.init_params(_cfgs("deepseek-moe-16b", n_layers=2)[0],
                              jax.random.PRNGKey(4)))
    toks = torch.tensor(np.random.default_rng(1).integers(0, 256, (2, 16)))
    tables = []
    real = tmoe.route

    def route(cfg, w, x, group=None):
        out = real(cfg, w, x, group)
        tables.append(out[0].clone())
        return out
    monkeypatch.setattr(tmoe, "route", route)
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tc, remat=remat)
        tp = ttf.params_from_jax(c, pn)
        for _, leaf in _walk(tp):
            leaf.requires_grad_(True)
        loss = ttf.lm_loss(c, tp, {"tokens": toks, "labels": toks})[0]
        loss.backward()
        out.append([loss.detach()] + [leaf.grad.clone()
                                      for _, leaf in _walk(tp)])
    for a, b in zip(out[0], out[1], strict=True):
        assert torch.equal(a, b)
    # one route without recomputation; forward and re-route with it
    assert len(tables) == 3
    assert torch.equal(tables[0], tables[1]) and \
        torch.equal(tables[1], tables[2])


@pytest.mark.parametrize("arch,beta,steps", [
    ("deepseek-moe-16b", 0.9, 4), ("chameleon-34b", 0.0, 3),
    ("mamba2-370m", 0.0, 4), ("zamba2-7b", 0.9, 4)])
def test_flat_engine_matches_reference_over_syncs(float32_scores, arch, beta,
                                                  steps):
    """The flat-buffer engine against the reference's on a ring, kernel
    path, H = 2: the MoE config with momentum over 4 steps (two syncs), the
    SSM config (2 layers) and the hybrid (4 layers, the shared block used
    twice, with momentum) over two syncs, and
    chameleon-34b, whose bfloat16 weights the loss reads rounded from the
    float32 row in both packages, over one sync and the local step after
    it. Its gradients come back through the cast rounded to bfloat16, so at
    its second sync many |diff| entries of a tile tie exactly, and a
    rounding difference between the packages moves the selection among
    them (measured: 20 of 1,970,176 x_hat entries, each by a whole scale)."""
    n = 4
    jc, tc = _cfgs(arch, n_nodes=n, compute_dtype="float32",
                   n_layers=LAYERS.get(arch, 2))
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jc.vocab_size, (n, 2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    common = dict(H=2, variant="ring", frac=0.25, use_kernel=True,
                  gamma=0.3, momentum=beta)
    mesh = jsh.train_mesh(jax.make_mesh((1, 1), ("data", "model")), jc)
    jinit, jstep, _, _ = jbuild(jc, mesh, JDcfg(
        threshold=jtrig.zero(), lr=jsched.fixed(0.05), **common))
    tinit, tstep, _ = build_sparq(tc, DistSparqConfig(
        threshold=ttrig.zero(), lr=tsched.fixed(0.05), **common),
        device="cpu")
    jstep = jax.jit(jstep)
    js = jinit(jax.random.PRNGKey(0))
    p0 = _f32(jtf.init_params(jc, jax.random.PRNGKey(0)))
    ts = tinit(params=ttf.params_from_jax(tc, p0))
    np.testing.assert_array_equal(ts["params"].numpy(),
                                  np.asarray(js["params"]))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    # bfloat16 weights: a float32 difference of an ulp in the row can round
    # a weight to the neighbouring bfloat16 value, so the loss has the
    # bfloat16 tolerance of test_torch_model.py's default path
    loss_rtol = 1e-4 if tc.param_dtype == "bfloat16" else 1e-5
    for _ in range(steps):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=loss_rtol)
    assert int(ts["triggers"]) == int(js["triggers"]) > 0
    assert ts["sync_rounds"] == int(js["sync_rounds"]) == steps // 2
    np.testing.assert_allclose(float(ts["bits"]), float(js["bits"]),
                               rtol=1e-6)
    np.testing.assert_allclose(ts["params"].numpy(), np.asarray(js["params"]),
                               atol=5e-4, rtol=0)
    np.testing.assert_allclose(ts["x_hat"].numpy(), np.asarray(js["x_hat"]),
                               atol=5e-4, rtol=0)
    if tc.param_dtype == "bfloat16":
        # after the steps the rows hold values that bfloat16 cannot: the
        # loss reads them rounded, which is what makes the losses agree
        row = ts["params"][0, :tstep.d_model_total]
        assert not torch.equal(row, row.to(torch.bfloat16).float())


def test_cli_moe_first_loss_equals_reference():
    """``--arch deepseek-moe-16b --reduced --device cpu`` through the CLI
    from PRNGKey(0): its first loss, the mean of the nodes' losses, against
    the reference's loss of its own PRNGKey(0) init on each node's batch,
    in the default bfloat16 numerics."""
    out = train.run(["--arch", "deepseek-moe-16b", "--reduced", "--nodes",
                     "4", "--use-kernel", "--H", "3", "--seq-len", "32",
                     "--batch-per-node", "1", "--steps", "1", "--device",
                     "cpu"])
    assert out["cfg"].arch_id == "deepseek-moe-16b"
    jc = dataclasses.replace(jget("deepseek-moe-16b").reduced(), n_nodes=4)
    p0 = jtf.init_params(jc, jax.random.PRNGKey(0))
    loss = jax.jit(lambda p, b: jtf.lm_loss(jc, p, b)[0])
    pipe = JPipe(vocab_size=jc.vocab_size, seq_len=32, batch_per_node=1,
                 n_nodes=4, seed=0)
    want = np.mean([float(loss(p0, pipe.batch(i, 0))) for i in range(4)])
    assert out["losses"][0] == pytest.approx(want, rel=1e-4)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_cli_ssm_and_hybrid_first_loss_equal_reference(arch):
    """``--arch mamba2-370m`` and ``--arch zamba2-7b`` (``--reduced``: 2
    layers, the hybrid's shared block after layer 1) through the CLI on
    the CPU, in the default bfloat16 numerics: the first loss against the
    reference's, as for the MoE config."""
    out = train.run(["--arch", arch, "--reduced", "--nodes", "4",
                     "--use-kernel", "--H", "3", "--seq-len", "32",
                     "--batch-per-node", "1", "--steps", "1", "--device",
                     "cpu"])
    assert out["cfg"].arch_id == arch
    jc = dataclasses.replace(jget(arch).reduced(), n_nodes=4)
    p0 = jtf.init_params(jc, jax.random.PRNGKey(0))
    loss = jax.jit(lambda p, b: jtf.lm_loss(jc, p, b)[0])
    pipe = JPipe(vocab_size=jc.vocab_size, seq_len=32, batch_per_node=1,
                 n_nodes=4, seed=0)
    want = np.mean([float(loss(p0, pipe.batch(i, 0))) for i in range(4)])
    assert out["losses"][0] == pytest.approx(want, rel=1e-4)


def test_grad_views_add_both_uses_of_the_shared_block(float32_scores):
    """The flat engine's per-node tree (``grad_views``) holds
    ``shared_attn`` as one top-level leaf per weight: backward adds the
    gradients of its two uses (after layers 1 and 3) into one view of the
    grads row. The whole row against the reference's raveled gradient."""
    from repro_torch.dist.sparq_dist import grad_views
    jc, tc = _cfgs("zamba2-7b", compute_dtype="float32")
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(5)))
    batch = _batch(jc, seed=3)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    g_j = jax.grad(lambda p: jtf.lm_loss(jc, p, jb)[0])(
        jax.tree.map(jnp.asarray, pn))
    slices, d = _flatten_spec(ttf.param_shapes(tc))
    row = torch.tensor(np.asarray(ravel_pytree(
        jax.tree.map(jnp.asarray, pn))[0]))
    grad_row = torch.zeros(d)
    ttf.lm_loss(tc, grad_views(row, grad_row, slices),
                _torch_batch(batch))[0].backward()
    want = np.asarray(ravel_pytree(g_j)[0])
    for path, off, size, _ in slices:
        got, w = grad_row[off:off + size].numpy(), want[off:off + size]
        err = float(np.max(np.abs(got - w)))
        assert err <= 1e-5 * float(np.max(np.abs(w))), (path, err)
        if path[0] == "shared_attn":
            assert float(np.max(np.abs(w))) > 0, path
