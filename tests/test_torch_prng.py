"""Port parity: ``repro_torch.core.prng`` against ``jax.random`` (the
``threefry2x32`` default, 64-bit mode off), bit for bit, over several seeds
and in both of JAX's threefry streams (``jax_threefry_partitionable`` on,
JAX's default since 0.5, and off, the stream of the committed golden
traces). Every comparison is exact: the port computes the same integer hash
and the same float32 bit patterns."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

SEEDS = (0, 1, 42, 2 ** 31 - 1, 123456789)


@pytest.fixture(autouse=True, params=[True, False],
                ids=["partitionable", "original"])
def stream(request):
    """Both packages draw from the same threefry stream for the test."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", request.param)
    try:
        with prng.threefry_partitionable(request.param):
            yield request.param
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _eq(got: torch.Tensor, want) -> None:
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_settings_are_the_ones_the_port_reproduces(stream):
    assert jax.config.jax_default_prng_impl == "threefry2x32"
    assert not jax.config.jax_enable_x64
    k = _jkey(0)
    same = np.array_equal(np.asarray(jax.random.split(k)[1]),
                          np.asarray(jax.random.fold_in(k, 1)))
    assert same == stream
    assert torch.equal(prng.split(prng.PRNGKey(0))[1],
                       prng.fold_in(prng.PRNGKey(0), 1)) == stream


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key(seed):
    _eq(prng.PRNGKey(seed), _jkey(seed))


@pytest.mark.parametrize("num", [2, 6, 60])
@pytest.mark.parametrize("seed", SEEDS)
def test_split(seed, num):
    _eq(prng.split(prng.PRNGKey(seed), num), jax.random.split(_jkey(seed),
                                                             num))


@pytest.mark.parametrize("seed", SEEDS)
def test_split_of_a_batch_of_keys_is_batched(seed):
    keys_t = prng.split(prng.PRNGKey(seed), 6)
    keys_j = jax.random.split(_jkey(seed), 6)
    want = np.stack([np.asarray(jax.random.split(k, 3)) for k in keys_j])
    _eq(prng.split(keys_t, 3), want)


@pytest.mark.parametrize("data", [0, 1, 7, 2 ** 32 - 1])
@pytest.mark.parametrize("seed", SEEDS)
def test_fold_in(seed, data):
    _eq(prng.fold_in(prng.PRNGKey(seed), data),
        jax.random.fold_in(_jkey(seed), data))


@pytest.mark.parametrize("shape", [(3,), (64, 1024), (70000,)])
@pytest.mark.parametrize("seed", SEEDS)
def test_uniform(seed, shape):
    got = prng.uniform(prng.PRNGKey(seed), shape)
    want = np.asarray(jax.random.uniform(_jkey(seed), shape))
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                  want.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
def test_random_bits(seed):
    got = prng.random_bits(prng.PRNGKey(seed), (5, 7))
    want = np.asarray(jax.random.bits(_jkey(seed), (5, 7), jnp.uint32))
    _eq(got, want.astype(np.int64))


@pytest.mark.parametrize("span", [40, 200, 2 ** 20])
@pytest.mark.parametrize("seed", SEEDS)
def test_randint(seed, span):
    got = prng.randint(prng.PRNGKey(seed), (5, 9), 0, span)
    want = jax.random.randint(_jkey(seed), (5, 9), 0, span)
    _eq(got, want)
    lo = prng.randint(prng.PRNGKey(seed), (17,), -3, span - 3)
    _eq(lo, jax.random.randint(_jkey(seed), (17,), -3, span - 3))


@pytest.mark.parametrize("seed", SEEDS)
def test_randint_batched_over_split_keys(seed):
    """The convex gradient's draw: split(key, n) then one randint per row,
    in one batched call."""
    keys_t = prng.split(prng.PRNGKey(seed), 60)
    keys_j = jax.random.split(_jkey(seed), 60)
    want = jax.vmap(lambda k: jax.random.randint(k, (5,), 0, 200))(keys_j)
    _eq(prng.randint(keys_t, (5,), 0, 200), want)


@pytest.mark.parametrize("n", [1, 10, 64, 7840])
@pytest.mark.parametrize("seed", SEEDS)
def test_permutation_and_choice(seed, n):
    _eq(prng.permutation(prng.PRNGKey(seed), n),
        jax.random.permutation(_jkey(seed), n))
    k = min(10, n)
    _eq(prng.choice(prng.PRNGKey(seed), n, (k,)),
        jax.random.choice(_jkey(seed), n, shape=(k,), replace=False))


def test_choice_batched_over_keys():
    keys_t = prng.split(prng.PRNGKey(3), 6)
    keys_j = jax.random.split(_jkey(3), 6)
    want = jax.vmap(lambda k: jax.random.choice(k, 64, (10,),
                                                replace=False))(keys_j)
    _eq(prng.choice(keys_t, 64, (10,)), want)


def test_torch_leg_equals_numpy_leg(monkeypatch):
    """Keys off the CPU are hashed with torch operations, keys on it with
    numpy: both legs give the same words (checked on the CPU by forcing the
    torch leg)."""
    keys = prng.split(prng.PRNGKey(5), 6)

    def draws():
        return (prng.split(keys, 3), prng.uniform(keys, (33,)),
                prng.randint(keys, (7,), 0, 200), prng.permutation(keys, 50))
    want = draws()
    monkeypatch.setattr(prng, "_numpy_leg", lambda key: False)
    for a, b in zip(draws(), want, strict=True):
        assert torch.equal(a, b)


def test_refusals():
    with pytest.raises(ValueError):
        prng.split(torch.zeros(3, dtype=torch.int64))
    with pytest.raises(ValueError):
        prng.randint(prng.PRNGKey(0), (2,), 0, 2 ** 32)
    with pytest.raises(ValueError):
        prng.choice(prng.PRNGKey(0), 4, (5,))
    with pytest.raises(NotImplementedError):
        prng.choice(prng.PRNGKey(0), 4, (2,), replace=True)
