"""Port parity for x^0: ``repro_torch.core.prng``'s ``uniform`` with bounds,
``normal`` and ``truncated_normal`` against ``jax.random``, the model's
``init_params`` on the reference's threefry key tree, and the flat-buffer
engine's ``init_fn(key=...)`` against the reference's, in both of JAX's
threefry layouts.

Tolerances. The uniform draws must be equal bit for bit (the same 32-bit
hash and the same fused multiply-add). The normals pass through ``erfinv``:
the port evaluates XLA's float32 polynomial one rounded operation at a time,
and XLA's CPU code fuses some of them, so the values may differ by a few
ulps. Measured on the CPU: ``erfinv`` within 2 ulps, the normals and the
weights within 3 ulps (``torch.erfinv`` itself is further off, most near
+-1). The tests allow ``ULPS = 4``.
"""
import dataclasses
import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax import lax  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.dist.sparq_dist import DistSparqConfig as JDcfg  # noqa: E402
from repro.dist.sparq_dist import build_sparq as jbuild  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq  # noqa: E402
from repro_torch.models import transformer as ttf  # noqa: E402

ULPS = 4
SEEDS = (0, 1, 42, 2 ** 31 - 1)
SHAPES = ((1,), (3,), (1001,), (7, 13), (4, 5, 9), (1 << 16,))
SMALL = dict(n_layers=2, d_model=128, vocab=256)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers at once, and their small multi-threaded torch operations slow
    each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True, params=[True, False],
                ids=["partitionable", "original"])
def stream(request):
    """Both packages draw from the same threefry layout for the test."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    try:
        with prng.threefry_partitionable(request.param):
            yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _ulps(got, want) -> int:
    """The largest distance in float32 steps (0 between +0 and -0)."""
    def ordered(x):
        i = np.asarray(x, np.float32).view(np.int32).astype(np.int64)
        return np.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int(np.max(np.abs(ordered(got) - ordered(want)), initial=0))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_with_bounds_bit_for_bit(seed, shape):
    for lo, hi in ((0.0, 1.0), (-0.3, 2.7), (-0.9544997, 0.9544997),
                   (0.1, 0.2), (-5.0, -4.5)):
        got = prng.uniform(prng.PRNGKey(seed), shape, lo, hi)
        want = jax.random.uniform(jax.random.PRNGKey(seed), shape,
                                  jnp.float32, lo, hi)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=f"bounds {lo, hi}")


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", SEEDS)
def test_normal_and_truncated_normal_within_ulps(seed, shape):
    jk, tk = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    assert _ulps(prng.normal(tk, shape), jax.random.normal(jk, shape)) \
        <= ULPS
    for lo, hi in ((-2.0, 2.0), (-1.0, 0.5), (0.0, 3.0)):
        got = prng.truncated_normal(tk, lo, hi, shape)
        want = jax.random.truncated_normal(jk, lo, hi, shape)
        assert _ulps(got, want) <= ULPS, (lo, hi)
        assert float(got.min()) > lo and float(got.max()) < hi


def test_draw_in_slices_equals_one_draw(monkeypatch):
    """A large draw is made slice by slice (``DRAW_CHUNK``) from the bits of
    the whole shape: odd slice lengths, both layouts, both hashing legs, and
    into ``out``."""
    key, shape = prng.PRNGKey(7), (37, 29)
    whole = prng.truncated_normal(key, -2.0, 2.0, shape)
    bits = prng.random_bits(key, shape).reshape(-1)
    monkeypatch.setattr(prng, "DRAW_CHUNK", 100)
    out = torch.full(shape, float("nan"))
    prng.truncated_normal(key, -2.0, 2.0, shape, out=out)
    assert torch.equal(out, whole)
    n = bits.numel()
    for numpy_leg in (True, False):
        # the numpy leg hashes on the CPU, the torch leg on the card
        monkeypatch.setattr(prng, "_numpy_leg", lambda where: numpy_leg)
        for lo, hi in ((0, n), (0, 1), (5, 538), (n // 2, n), (n - 3, n)):
            got = prng.bits_range(prng.key_words(key), n, lo, hi,
                                  torch.device("cpu"))
            assert torch.equal(got, bits[lo:hi]), (numpy_leg, lo, hi)


def test_erfinv_is_xlas_polynomial():
    x = np.concatenate([
        np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (1 << 20,),
                                      jnp.float32, -1.0, 1.0)),
        np.float32([0.0, -0.0, 0.5, -0.9999999, 0.9999999, 1.0, -1.0])])
    got = prng.erfinv(torch.tensor(x)).numpy()
    want = np.asarray(lax.erf_inv(jnp.asarray(x)))
    finite = np.isfinite(want)
    np.testing.assert_array_equal(got[~finite], want[~finite])
    assert _ulps(got[finite], want[finite]) <= 2


def _tree_leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _tree_leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def test_init_params_equals_reference_leaf_by_leaf():
    jc, tc = jget("qwen1.5-0.5b").reduced(**SMALL), \
        tget("qwen1.5-0.5b").reduced(**SMALL)
    want = dict(_tree_leaves(jax.tree.map(
        np.asarray, jtf.init_params(jc, jax.random.PRNGKey(0)))))
    got = dict(_tree_leaves(ttf.init_params(tc, prng.PRNGKey(0))))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert _ulps(g, w) <= ULPS, path
    # the key tree: every drawn leaf's uniform bits are the reference's
    keys = ttf.init_keys(tc, prng.PRNGKey(0))
    jkeys = jax.random.split(jax.random.PRNGKey(0), 8)
    k_emb = jax.random.split(jkeys[0])[0]
    np.testing.assert_array_equal(keys[("embed", "embedding")].numpy(),
                                  np.asarray(k_emb))
    blocks = jax.random.split(jax.random.fold_in(jkeys[2], 0), 2)
    k_wo = jax.random.split(jax.random.split(blocks[1], 6)[2], 4)[3]
    np.testing.assert_array_equal(keys[("seg0", "attn", "wo")][1].numpy(),
                                  np.asarray(k_wo))


def test_init_params_into_views_and_other_dtypes():
    """Drawn into a tree of views (the flat engine's row 0) the values are
    those of the tree it allocates; a bfloat16 config rounds the float32
    draw, as ``astype`` does."""
    tc = tget("qwen1.5-0.5b").reduced(**SMALL)
    own = dict(_tree_leaves(ttf.init_params(tc, prng.PRNGKey(3))))

    def nans(tree):
        return {k: nans(v) if isinstance(v, dict) else
                torch.full(v, float("nan")) for k, v in tree.items()}
    views = nans(ttf.param_shapes(tc))
    ttf.init_params(tc, prng.PRNGKey(3), out=views)
    for p, v in _tree_leaves(views):
        assert torch.equal(v, own[p]), p
    bf = dataclasses.replace(tc, param_dtype="bfloat16")
    half = dict(_tree_leaves(ttf.init_params(bf, prng.PRNGKey(3))))
    for p, v in own.items():
        assert half[p].dtype == torch.bfloat16
        assert torch.equal(half[p], v.to(torch.bfloat16)), p


def test_init_fn_equals_reference_init_fn():
    """Identical rows, each the reference's x^0 within the ulps, and a zero
    tail past D."""
    kw = dict(n_nodes=4)
    jc = dataclasses.replace(jget("qwen1.5-0.5b").reduced(**SMALL), **kw)
    tc = dataclasses.replace(tget("qwen1.5-0.5b").reduced(**SMALL), **kw)
    mesh = jsh.train_mesh(jax.make_mesh((1, 1), ("data", "model")), jc)
    jinit = jbuild(jc, mesh, JDcfg(H=2, use_kernel=True, frac=0.25,
                                   lr=jsched.fixed(0.05)))[0]
    tinit = build_sparq(tc, DistSparqConfig(H=2, use_kernel=True, frac=0.25,
                                            lr=tsched.fixed(0.05)),
                        device="cpu")[0]
    for seed in (0, 5):
        want = np.asarray(jinit(jax.random.PRNGKey(seed))["params"])
        state = tinit(key=prng.PRNGKey(seed))
        got = state["params"].numpy()
        assert got.shape == want.shape
        assert all(np.array_equal(got[i], got[0]) for i in range(4))
        assert not got[:, tinit.d_model_total:].any()
        assert _ulps(got, want) <= ULPS
        assert not state["x_hat"].any() and state["t"] == 0
    # the default key is PRNGKey(0)
    assert torch.equal(tinit()["params"], tinit(key=prng.PRNGKey(0))
                       ["params"])


@pytest.mark.parametrize("value,want", [
    (None, True), ("1", True), ("true", True), ("ON", True), ("0", False),
    ("false", False), ("No", False), ("off", False)])
def test_default_layout_follows_the_environment(monkeypatch, stream, value,
                                                want):
    """``JAX_THREEFRY_PARTITIONABLE`` read as JAX reads it, at import; a
    ``threefry_partitionable`` block still overrides it. The module is
    reloaded under the patched environment and again after it."""
    try:
        if value is None:
            monkeypatch.delenv("JAX_THREEFRY_PARTITIONABLE", raising=False)
        else:
            monkeypatch.setenv("JAX_THREEFRY_PARTITIONABLE", value)
        importlib.reload(prng)
        assert prng.partitionable() is want
        with prng.threefry_partitionable(not want):
            assert prng.partitionable() is (not want)
        assert prng.partitionable() is want
        monkeypatch.setenv("JAX_THREEFRY_PARTITIONABLE", "maybe")
        with pytest.raises(ValueError, match="invalid truth value"):
            importlib.reload(prng)
    finally:
        monkeypatch.undo()
        importlib.reload(prng)
