"""Port parity, MLA and MTP (deepseek-v3-671b): the MLA block's init keys
and x^0, ``mla_forward``, the MTP head, ``lm_loss`` with its MTP term and
its gradients, the flat-buffer engine and the train CLI, against
``repro`` on the same numpy-seeded inputs and the reference's weights.

Tolerances:
* x^0: within 4 float32 ulps of the reference's draw with float32 weights
  (``tests/test_torch_init.py``), within one bfloat16 ulp with the config's
  bfloat16 weights;
* ``mla_forward``, ``mtp_hidden`` in float32 compute and float32 scores:
  within ``1e-5`` of the largest output; the loss within ``1e-6``
  relative and every gradient within ``1e-5`` of its leaf's largest
  (``tests/test_torch_archs.py``);
* the engines over 6 steps on float32 weights: ``tests/test_torch_dist.py``'s
  (losses within ``1e-5`` relative, params and x_hat within ``atol =
  5e-4``, triggers and sync rounds exact, bits within ``1e-6``); the CLI,
  on the config's bfloat16 weights: its first loss in the default bfloat16
  numerics within ``1e-4`` relative, its bits equal to the reckoning from
  its triggers within ``1e-6``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.flatten_util import ravel_pytree  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.dist.sparq_dist import DistSparqConfig as JDcfg  # noqa: E402
from repro.dist.sparq_dist import build_sparq as jbuild  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import triggers as ttrig  # noqa: E402
from repro_torch.data.synthetic import TokenPipeline  # noqa: E402
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ARCH = "deepseek-v3-671b"
TOL = 1e-5
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


def _cfgs(**kw):
    return (dataclasses.replace(jget(ARCH).reduced(), **kw),
            dataclasses.replace(tget(ARCH).reduced(), **kw))


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _close(got, want, tol=TOL, what=""):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), (what, err)


def _ulps(got, want, dtype):
    if dtype == torch.bfloat16:
        bits = (got.view(torch.int16).numpy().astype(np.int64),
                np.asarray(want).view(np.int16).astype(np.int64))
        sign = 0x7FFF
    else:
        bits = (got.numpy().view(np.int32).astype(np.int64),
                np.asarray(want, np.float32).view(np.int32).astype(np.int64))
        sign = 0x7FFFFFFF
    a, b = (np.where(i < 0, -(i & sign), i) for i in bits)
    return int(np.max(np.abs(a - b), initial=0))


@pytest.mark.parametrize("q_lora", [True, False])
def test_param_shapes_and_keys_equal_reference(q_lora):
    """The tree's keys and shapes, the MLA leaves (``w_dq``/``w_uq`` with a
    ``q_lora_rank``, else ``w_q``) and the ``mtp`` head, at full width and
    reduced; the full config with 4 layers is 15.797 B parameters."""
    kw = {} if q_lora else {"q_lora_rank": 0}
    for jc, tc in ((dataclasses.replace(jget(ARCH), **kw),
                    dataclasses.replace(tget(ARCH), **kw)), _cfgs(**kw)):
        shapes = jax.tree.map(lambda s: tuple(s.shape), jax.eval_shape(
            lambda k, c=jc: jtf.init_params(c, k), jax.random.PRNGKey(0)))
        assert ttf.param_shapes(tc) == shapes
    got = ttf.param_shapes(tc)
    want_q = {"w_dq", "w_uq"} if q_lora else {"w_q"}
    assert set(got["seg1"]["attn"]) == {"w_dkv", "w_kr", "w_uk", "w_uv",
                                        "wo"} | want_q
    assert set(got["mtp"]) == {"proj", "block", "norm"}
    assert got["mtp"]["proj"] == (2 * tc.d_model, tc.d_model)
    assert set(got["mtp"]["block"]) == {"attn", "mlp", "norm1", "norm2"}
    full = dataclasses.replace(tget(ARCH), n_layers=4)
    total = sum(int(np.prod(s)) for _, s in _walk(ttf.param_shapes(full)))
    assert total == 15_797_342_208


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_init_params_equals_reference(param_dtype):
    jc, tc = _cfgs(param_dtype=param_dtype)
    want = dict(_walk(jax.tree.map(np.asarray, jtf.init_params(
        jc, jax.random.PRNGKey(0)))))
    got = dict(_walk(ttf.init_params(tc, prng.PRNGKey(0))))
    assert set(got) == set(want)
    assert ("mtp", "block", "attn", "w_uq") in got
    dt = getattr(torch, param_dtype)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape and g.dtype == dt, path
        assert _ulps(g, w, dt) <= (1 if dt == torch.bfloat16 else ULPS), path


@pytest.mark.parametrize("q_lora", [True, False])
def test_mla_forward_equals_reference(float32_scores, q_lora):
    jc, tc = _cfgs(compute_dtype="float32",
                   **({} if q_lora else {"q_lora_rank": 0}))
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(1)))
    p = {k: v[0] for k, v in pn["seg0"]["attn"].items()}
    x = np.random.default_rng(0).standard_normal(
        (2, 16, jc.d_model)).astype(np.float32)
    pos = np.arange(16, dtype=np.int32)
    want = jattn.mla_forward(jc, jax.tree.map(jnp.asarray, p),
                             jnp.asarray(x), jnp.asarray(pos))
    got = tattn.mla_forward(tc, {k: torch.tensor(v) for k, v in p.items()},
                            torch.tensor(x), torch.tensor(pos))
    _close(got, want, what="mla_forward")


def _batch(cfg, seed=0, s=16):
    rng = np.random.default_rng(seed)
    return {k: rng.integers(0, cfg.vocab_size, (2, s)).astype(np.int32)
            for k in ("tokens", "labels")}


def test_mtp_hidden_equals_reference(float32_scores):
    jc, tc = _cfgs(compute_dtype="float32")
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(2)))
    toks = _batch(jc)["tokens"]
    jp = jax.tree.map(jnp.asarray, pn)
    h, _ = jtf.forward_hidden(jc, jp, jnp.asarray(toks))
    want = jtf.mtp_hidden(jc, jp, jnp.asarray(toks), h)
    tp = ttf.params_from_jax(tc, pn)
    th, _ = ttf.forward_hidden(tc, tp, torch.tensor(toks).long())
    _close(th, h, what="hidden")
    got = ttf.mtp_hidden(tc, tp, torch.tensor(toks).long(), th)
    assert tuple(got.shape) == (2, 15, tc.d_model)
    _close(got, want, what="mtp_hidden")


def test_lm_loss_with_mtp_and_grads_equal_reference(float32_scores):
    """The loss with its MTP term (and the MoE aux) and the gradient of
    every leaf; the embedding's gradient sums its three uses (the input,
    the MTP head's next-token embedding, and no tied head) and the raveled
    gradient is the reference's."""
    jc, tc = _cfgs(compute_dtype="float32")
    pn = _f32(jtf.init_params(jc, jax.random.PRNGKey(1)))
    batch = _batch(jc)
    jp = jax.tree.map(jnp.asarray, pn)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (l_j, m_j), g_j = jax.jit(jax.value_and_grad(
        lambda p: jtf.lm_loss(jc, p, jb), has_aux=True))(jp)
    tp = ttf.params_from_jax(tc, pn)
    for _, leaf in _walk(tp):
        leaf.requires_grad_(True)
    l_t, m_t = ttf.lm_loss(tc, tp, {k: torch.tensor(v).long()
                                    for k, v in batch.items()})
    l_t.backward()
    got = {k: float(v.detach()) for k, v in m_t.items()}
    assert got["mtp"] == pytest.approx(float(m_j["mtp"]), rel=1e-6)
    assert got["ce"] == pytest.approx(float(m_j["ce"]), rel=1e-6)
    assert got["loss"] == pytest.approx(float(l_j), rel=1e-6)
    assert got["loss"] == pytest.approx(
        got["ce"] + tc.router_aux_coef * got["aux"]
        + tc.mtp_coef * got["mtp"], rel=1e-6)
    want = dict(_walk(jax.tree.map(np.asarray, g_j)))
    for path, leaf in _walk(tp):
        err = float(np.max(np.abs(leaf.grad.numpy() - want[path])))
        assert err <= 1e-5 * float(np.max(np.abs(want[path]))), (path, err)
    flat_j = np.asarray(ravel_pytree(g_j)[0])
    flat_t = torch.cat([leaf.grad.reshape(-1) for _, leaf in _walk(tp)])
    _close(flat_t, flat_j, what="raveled gradient")


def test_flat_engine_matches_reference_over_six_steps(float32_scores):
    """``deepseek-v3-671b.reduced()`` (one dense MLA layer, one MoE MLA
    layer, the MTP head) through the flat-buffer engine against the
    reference's: ring of 4, kernel path, H = 3, 6 steps (two syncs); losses
    with the MTP term, triggers, sync rounds, bits, params and x_hat. The
    weights are float32 here: with the config's bfloat16 ones the gradients
    come back through the cast rounded to bfloat16, many |diff| entries of
    a tile tie, and a rounding difference moves the selection among them
    (``tests/test_torch_archs.py``'s chameleon-34b case; measured here: a
    whole SignTopK step, 0.2, in the params from the first sync on)."""
    n = 4
    jc, tc = _cfgs(n_nodes=n, compute_dtype="float32",
                   param_dtype="float32")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jc.vocab_size, (n, 2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    common = dict(H=3, variant="ring", frac=0.25, use_kernel=True,
                  gamma=0.3)
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
    for _ in range(6):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
    assert int(ts["triggers"]) == int(js["triggers"]) > 0
    assert ts["sync_rounds"] == int(js["sync_rounds"]) == 2
    np.testing.assert_allclose(float(ts["bits"]), float(js["bits"]),
                               rtol=1e-6)
    for key in ("params", "x_hat"):
        np.testing.assert_allclose(ts[key].numpy(), np.asarray(js[key]),
                                   atol=5e-4, rtol=0, err_msg=key)


def test_cli_first_loss_equals_reference():
    """``--arch deepseek-v3-671b --reduced --use-kernel --device cpu``
    through the CLI from PRNGKey(0), 3 steps with H = 3: finite losses, one
    sync, bits equal to the reckoning from the triggers; its first loss,
    the mean of the nodes' losses with the MTP term, against the
    reference's ``lm_loss`` of its own PRNGKey(0) init on each node's
    batch, in the default bfloat16 numerics."""
    out = train.run(["--arch", ARCH, "--reduced", "--nodes", "4",
                     "--use-kernel", "--H", "3", "--seq-len", "32",
                     "--batch-per-node", "1", "--steps", "3", "--device",
                     "cpu"])
    assert out["cfg"].arch_id == ARCH and out["cfg"].use_mtp
    state, step = out["state"], out["train_step"]
    assert len(out["losses"]) == 3 and state["sync_rounds"] == 1
    trig = int(state["triggers"])
    assert trig > 0
    want_bits = 2.0 * (4 + trig * step.payload_bits)
    assert float(state["bits"]) == pytest.approx(want_bits, rel=1e-6)
    jc = dataclasses.replace(jget(ARCH).reduced(), n_nodes=4)
    p0 = jtf.init_params(jc, jax.random.PRNGKey(0))
    batch = TokenPipeline(vocab_size=jc.vocab_size, seq_len=32,
                          batch_per_node=1, n_nodes=4,
                          seed=0).global_batch(0)
    loss = jax.jit(lambda p, b: jtf.lm_loss(jc, p, b)[0])
    losses = [float(loss(p0, {k: jnp.asarray(np.asarray(v[i]))
                              for k, v in batch.items()}))
              for i in range(4)]
    assert out["losses"][0] == pytest.approx(float(np.mean(losses)),
                                             rel=1e-4)
