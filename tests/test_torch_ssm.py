"""Port parity, SSM: ``repro_torch.models.ssm`` (``segsum``, ``ssd_chunked``,
the causal conv, ``ssm_forward``, the init constants) against
``repro.models.ssm`` on the same numpy-seeded inputs, the reference's own
SSD unit tests (``tests/test_ssm_moe_units.py``) on the port, and
recomputation of an SSM and a hybrid model.

Tolerances:
* ``segsum``: the ``-inf`` entries equal exactly, the finite ones within
  ``1e-6`` of the largest (XLA's cumsum adds in another order: one ulp
  measured);
* ``ssd_chunked`` (y, the final state and the gradients) and the causal
  conv in float32: within ``1e-5`` of each array's largest magnitude
  (float32 sums in other orders);
* ``ssm_forward`` in float32 compute: within ``1e-5`` of the largest
  output;
* against the naive recurrence in float64: the reference test's ``2e-4``;
* ``a_log``: within one float32 ulp (XLA's float32 ``log`` is not
  correctly rounded; the port rounds a float64 ``log`` once), ``dt_bias``
  and the linspace under it equal exactly;
* recomputation: bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

TOL = 1e-5
# XLA's CPU cumsum is a reduce-window that XLA rewrites into a blocked scan,
# so its partial sums round at other points than torch's running sum: the
# finite entries of segsum differ by an ulp (measured) of values near 1
SEGSUM_TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers at once, and their small multi-threaded torch operations slow
    each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    err = float(np.max(np.abs(got - want)))
    assert err <= tol * float(np.max(np.abs(want))), err


def _ssd_inputs(seed, bb=2, L=32, h=4, p=8, g=2, n=6, a_scale=0.5):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    return (rng.standard_normal((bb, L, h, p)).astype(f32),
            (-np.abs(rng.standard_normal((bb, L, h))) * a_scale).astype(f32),
            rng.standard_normal((bb, L, g, n)).astype(f32),
            rng.standard_normal((bb, L, g, n)).astype(f32))


def _cfgs(arch="mamba2-370m", **kw):
    """Both packages' reduced config (d_model 128: d_inner 256, 8 heads of
    32, state 16, chunk 16) in float32 compute, with ``kw`` replaced."""
    size = dict(n_layers=2, d_model=128, vocab=256)
    return tuple(dataclasses.replace(get(arch).reduced(**size),
                                     compute_dtype="float32", **kw)
                 for get in (jget, tget))


@pytest.mark.parametrize("length", [1, 5, 16])
def test_segsum_equals_reference(length):
    x = np.random.default_rng(length).standard_normal(
        (2, 3, length)).astype(np.float32)
    want = np.asarray(jssm.segsum(jnp.asarray(x)))
    got = tssm.segsum(torch.tensor(x)).numpy()
    inf = np.isneginf(want)
    assert inf.sum() == length * (length - 1) // 2 * 6
    np.testing.assert_array_equal(np.isneginf(got), inf)
    np.testing.assert_array_equal(np.isfinite(got), ~inf)
    _close(got[~inf], want[~inf], SEGSUM_TOL)


@pytest.mark.parametrize("chunk,groups", [(8, 1), (16, 1), (32, 1),
                                          (8, 2), (16, 2), (32, 2)])
def test_ssd_chunked_equals_reference(chunk, groups):
    """y and the final state; with two groups the group-to-head map must
    be group-major (``repeat_interleave``), as einops' ``(g r)``."""
    x, a, b, c = _ssd_inputs(chunk + groups, g=groups)
    y_j, s_j = jax.jit(jssm.ssd_chunked, static_argnums=4)(
        *map(jnp.asarray, (x, a, b, c)), chunk)
    y_t, s_t = tssm.ssd_chunked(*map(torch.tensor, (x, a, b, c)), chunk)
    _close(y_t, y_j)
    _close(s_t, s_j)


def _naive_ssd(x, a, b, c):
    """The reference test's sequential recurrence in float64."""
    bb, L, h, p = x.shape
    rep = h // b.shape[2]
    b = np.repeat(np.array(b, np.float64), rep, axis=2)
    c = np.repeat(np.array(c, np.float64), rep, axis=2)
    x, a = np.array(x, np.float64), np.array(a, np.float64)
    state = np.zeros((bb, h, p, b.shape[-1]))
    y = np.zeros_like(x)
    for t in range(L):
        decay = np.exp(a[:, t])[:, :, None, None]
        state = state * decay + np.einsum("bhp,bhn->bhpn", x[:, t], b[:, t])
        y[:, t] = np.einsum("bhpn,bhn->bhp", state, c[:, t])
    return y, state


@pytest.mark.parametrize("seed,chunk", [(0, 4), (1, 8), (2, 16), (7, 4),
                                        (11, 8)])
def test_ssd_chunked_matches_recurrence(seed, chunk):
    x, a, b, c = _ssd_inputs(seed)
    y, final = tssm.ssd_chunked(*map(torch.tensor, (x, a, b, c)), chunk)
    y_ref, s_ref = _naive_ssd(x, a, b, c)
    np.testing.assert_allclose(y.numpy(), y_ref, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), s_ref, rtol=2e-4, atol=2e-4)


def test_ssd_chunk_invariance():
    x, a, b, c = map(torch.tensor, _ssd_inputs(3, bb=1, L=64, h=2, p=4,
                                               g=1, n=8, a_scale=1.0))
    y16, _ = tssm.ssd_chunked(x, a, b, c, 16)
    y64, _ = tssm.ssd_chunked(x, a, b, c, 64)
    np.testing.assert_allclose(y16.numpy(), y64.numpy(), rtol=1e-4,
                               atol=1e-4)


def test_ssd_chunked_gradients_finite_and_equal_reference():
    """The backward through ``exp(segsum(.))``: its ``-inf`` entries give
    ``exp = 0`` and a zero gradient, never NaN; every input's gradient
    within 1e-5 of JAX's."""
    x, a, b, c = _ssd_inputs(5, g=2)
    w = np.random.default_rng(6).standard_normal((2, 32, 4, 8)).astype(
        np.float32)
    ws = np.random.default_rng(7).standard_normal((2, 4, 8, 6)).astype(
        np.float32)

    def j_loss(*args):
        y, s = jssm.ssd_chunked(*args, 8)
        return jnp.sum(y * w) + jnp.sum(s * ws)
    g_j = jax.jit(jax.grad(j_loss, argnums=(0, 1, 2, 3)))(
        *map(jnp.asarray, (x, a, b, c)))
    ins = [torch.tensor(v, requires_grad=True) for v in (x, a, b, c)]
    y, s = tssm.ssd_chunked(*ins, 8)
    (torch.sum(y * torch.tensor(w)) + torch.sum(s * torch.tensor(ws))
     ).backward()
    for t, j in zip(ins, g_j, strict=True):
        assert torch.isfinite(t.grad).all()
        _close(t.grad, j)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_causal_conv_equals_reference(dtype):
    """The four shifted products summed in order, then SiLU: equal within
    1e-5 in float32; in bfloat16 both packages round each product and sum
    (XLA may keep a fused chain in float32), so within one bfloat16 ulp
    of the largest output, 2^-7."""
    rng = np.random.default_rng(2)
    xbc = rng.standard_normal((2, 12, 10)).astype(np.float32)
    w = (0.5 * rng.standard_normal((4, 10))).astype(np.float32)
    bias = rng.standard_normal((10,)).astype(np.float32)
    jd, td = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(jssm._causal_conv(
        *(jnp.asarray(v).astype(jd) for v in (xbc, w, bias))), np.float32)
    got = tssm._causal_conv(*(torch.tensor(v).to(td)
                              for v in (xbc, w, bias))).float()
    _close(got, want, TOL if dtype == "float32" else 2.0 ** -7)


def _ssm_weights(cfg, seed):
    """One SSM block's weights from the reference's ``init_ssm``, with the
    constant leaves perturbed so that the D skip, dt bias, A and norm
    scale all matter."""
    p = jax.tree.map(np.asarray, jssm.init_ssm(cfg, jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    for k in ("a_log", "d_skip", "dt_bias", "norm_scale", "conv_b"):
        p[k] = (p[k] + 0.1 * rng.standard_normal(p[k].shape)).astype(
            np.float32)
    p["w_in"] = (p["w_in"] * 20).astype(np.float32)
    return p


@pytest.mark.parametrize("length", [40, 8, 32])
def test_ssm_forward_equals_reference(length):
    """Float32 compute at L = 40 (the chunk drops from 16 to 10), L = 8 <
    chunk, and L = 32 (two chunks)."""
    jc, tc = _cfgs()
    p = _ssm_weights(jc, length)
    x = np.random.default_rng(length).standard_normal(
        (2, length, jc.d_model)).astype(np.float32)
    want = jax.jit(lambda p, x: jssm.ssm_forward(jc, p, x, jnp.arange(
        length)))(jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    got = tssm.ssm_forward(tc, {k: torch.tensor(v) for k, v in p.items()},
                           torch.tensor(x))
    _close(got, want)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-7b"])
def test_init_constants_equal_reference(arch):
    """``a_log``, ``dt_bias`` and the other constant leaves of
    ``init_ssm`` at the full config's head count (32 and 112) and the
    reduced one's."""
    for jc, tc in ((jget(arch), tget(arch)), _cfgs(arch)):
        want = jax.eval_shape(lambda k, c=jc: jssm.init_ssm(c, k),
                              jax.random.PRNGKey(0))
        h = jc.ssm_heads
        consts = tssm.constant_leaves(tc)
        np.testing.assert_array_equal(
            tssm._linspace_1_16(h), np.asarray(jnp.linspace(1.0, 16.0, h)))
        a_log = np.asarray(jnp.log(jnp.linspace(1.0, 16.0, h)))
        ulps = np.abs(consts["a_log"].view(np.int32).astype(np.int64)
                      - a_log.view(np.int32).astype(np.int64))
        assert int(ulps.max()) <= 1
        np.testing.assert_array_equal(consts["dt_bias"], np.asarray(
            jnp.log(jnp.expm1(jnp.full((h,), 0.01)))))
        for k, v in consts.items():
            assert v.shape == tuple(want[k].shape) and \
                v.dtype == want[k].dtype == np.float32, k
        assert (consts["d_skip"] == 1).all() and \
            (consts["norm_scale"] == 1).all() and (consts["conv_b"] == 0).all()


@pytest.mark.parametrize("arch,n_layers", [("mamba2-370m", 2),
                                           ("zamba2-7b", 4)])
def test_remat_changes_nothing(arch, n_layers):
    """An SSM model, and a hybrid whose shared block runs twice: under
    recomputation the loss and every gradient are equal bit for bit."""
    jc, tc = _cfgs(arch, n_layers=n_layers)
    pn = jax.tree.map(np.asarray, jtf.init_params(jc, jax.random.PRNGKey(4)))
    toks = torch.tensor(np.random.default_rng(1).integers(0, 256, (2, 16)))
    out = []
    for remat in (False, True):
        c = dataclasses.replace(tc, remat=remat)
        tp = ttf.params_from_jax(c, pn)
        leaves = [leaf for _, leaf in ttf._tree_items(tp)]
        for leaf in leaves:
            leaf.requires_grad_(True)
        loss = ttf.lm_loss(c, tp, {"tokens": toks, "labels": toks})[0]
        loss.backward()
        out.append([loss.detach()] + [leaf.grad.clone() for leaf in leaves])
    for a, b in zip(out[0], out[1], strict=True):
        assert torch.equal(a, b)
