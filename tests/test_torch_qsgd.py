"""Port parity, QSGD: the port's plain blockwise QSGD (``qsgd_blocks_plain``,
``ref.qsgd_ref``, ``ops.qsgd``) against the reference's on the same
numpy-made inputs and the same ``jax.random`` keys.

Tolerance: the comparator of ``repro_torch.kernels.parity.compare_qsgd``.
An element passes when it agrees within 1e-5 relative (float32) or one
bfloat16 ulp, or when it differs by exactly one level (norm / s) where the
fraction ``level - floor(level)``, or ``u`` minus it, lies within 4 ulps of
a rounding boundary: XLA and PyTorch add a tile's squares in different
orders, so the norms may differ by an ulp. Any other difference fails.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.qsgd import qsgd_blocks as jqsgd_blocks  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.kernels import ops, parity, ref  # noqa: E402
from repro_torch.kernels.qsgd import (qsgd_blocks,  # noqa: E402
                                      qsgd_blocks_plain)

BLOCK = 1024


@pytest.fixture(autouse=True)
def same_stream():
    """The port draws from the threefry stream JAX is set to."""
    with prng.threefry_partitionable(jax.config.jax_threefry_partitionable):
        yield


def _case(nb, s, dtype, seed=0):
    rng = np.random.default_rng([seed, nb, s])
    x = rng.standard_normal((nb, BLOCK)).astype(np.float32)
    u = rng.random((nb, BLOCK), dtype=np.float32)
    return x, u, getattr(torch, dtype)


@pytest.mark.parametrize("lowering", ["xla", "interpret"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("s", [4, 16, 64])
@pytest.mark.parametrize("nb", [1, 4, 16])
def test_plain_equals_reference_kernel(nb, s, dtype, lowering):
    x, u, tdt = _case(nb, s, dtype)
    xt = torch.tensor(x).to(tdt)
    want = jqsgd_blocks(jnp.asarray(x).astype(dtype), jnp.asarray(u), s=s,
                        lowering=lowering)
    want_t = torch.tensor(np.asarray(want.astype(jnp.float32))).to(tdt)
    got = qsgd_blocks_plain(xt, torch.tensor(u), s)
    assert got.dtype == tdt and got.shape == (nb, BLOCK)
    parity.compare_qsgd(xt, torch.tensor(u), s, got, want_t,
                        spec=(nb, s, dtype, lowering))


@pytest.mark.parametrize("s", [4, 16, 64])
def test_ref_oracle_equals_reference_oracle(s):
    x, u, _ = _case(4, s, "float32", seed=1)
    got = ref.qsgd_ref(torch.tensor(x.reshape(-1)),
                       torch.tensor(u.reshape(-1)), s)
    want = np.asarray(jref.qsgd_ref(jnp.asarray(x.reshape(-1)),
                                    jnp.asarray(u.reshape(-1)), s))
    parity.compare_qsgd(torch.tensor(x), torch.tensor(u), s,
                        got.view(4, BLOCK), torch.tensor(want).view(4, BLOCK))
    # the oracle and the kernel's plain version are one function
    assert torch.equal(got.view(4, BLOCK),
                       qsgd_blocks_plain(torch.tensor(x), torch.tensor(u), s))


@pytest.mark.parametrize("d", [1, 1023, 1025, 2500, 4096])
@pytest.mark.parametrize("s", [4, 16])
def test_ops_qsgd_equals_reference_with_the_same_key(d, s):
    """Same key: the port draws the reference's uniform noise bit for bit,
    pads and un-pads as the reference does."""
    x = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    for seed in (0, 3):
        got = ops.qsgd(torch.tensor(x), prng.PRNGKey(seed), s)
        want = np.asarray(jops.qsgd(jnp.asarray(x), jax.random.PRNGKey(seed),
                                    s=s))
        assert got.shape == (d,)
        nb = -(-d // BLOCK)
        pad = nb * BLOCK - d
        xp = torch.nn.functional.pad(torch.tensor(x), (0, pad)).view(nb, BLOCK)
        u = prng.uniform(prng.PRNGKey(seed), (nb, BLOCK))
        np.testing.assert_array_equal(
            u.numpy(), np.asarray(jax.random.uniform(jax.random.PRNGKey(seed),
                                                     (nb, BLOCK))))
        parity.compare_qsgd(
            xp, u, s,
            torch.nn.functional.pad(got, (0, pad)).view(nb, BLOCK),
            torch.nn.functional.pad(torch.tensor(want), (0, pad)).view(
                nb, BLOCK), spec=(d, s, seed))


@pytest.mark.parametrize("s", [1, 4, 16, 64])
def test_levels_lie_on_the_s_grid(s):
    """|out| = norm * level / s with an integer level in [0, s], the sign of
    x, and zeros where x is zero."""
    x, u, _ = _case(8, s, "float32", seed=2)
    x[:, ::7] = 0.0
    xt = torch.tensor(x)
    out = qsgd_blocks_plain(xt, torch.tensor(u), s)
    norm = torch.sqrt(torch.sum(xt * xt, dim=1, keepdim=True))
    lev = out.abs() / norm * s
    assert torch.all((lev - lev.round()).abs() < 1e-3)
    assert torch.all(lev.round() <= s)
    assert torch.equal(torch.sign(out), torch.sign(xt) * (out != 0))
    assert torch.all(out[:, ::7] == 0)


def test_zero_tile_gives_zeros():
    x = torch.zeros((3, BLOCK))
    x[1] = torch.linspace(-1, 1, BLOCK)
    out = qsgd_blocks_plain(x, torch.rand((3, BLOCK)), 16)
    assert torch.isfinite(out).all()
    assert torch.equal(out[0], torch.zeros(BLOCK))
    assert torch.equal(out[2], torch.zeros(BLOCK))


def test_unbiased_over_keys():
    """``test_qsgd_kernel_unbiased``: the mean over 256 keys lies within
    0.15 of x (s = 64)."""
    assert parity.check_qsgd_unbiased(torch.device("cpu")) < 0.15


def test_parity_cases_run_on_the_cpu():
    """The card's cases, plain against plain here: every case passes with
    no flips, and the wrapper launched nothing."""
    before = qsgd_blocks.launches
    cases = list(parity.check_all_qsgd(torch.device("cpu")))
    assert len(cases) == len(parity.QSGD_CASES)
    assert all(err == 0.0 and flips == 0 for _, err, flips in cases)
    assert parity.check_ops_qsgd_ragged(torch.device("cpu")) == (0.0, 0)
    x = torch.randn((5, BLOCK), generator=torch.Generator().manual_seed(0))
    assert parity.check_qsgd_chunked(x, torch.rand((5, BLOCK)), 16, 2) == \
        (0.0, 0)
    assert qsgd_blocks.launches == before


def test_comparator_counts_boundary_flips_and_catches_the_rest():
    x, u, _ = _case(2, 16, "float32", seed=4)
    xt, ut = torch.tensor(x), torch.tensor(u)
    want = qsgd_blocks_plain(xt, ut, 16)
    norm = torch.sqrt(torch.sum(xt * xt, dim=1))
    level = xt.abs() / norm[:, None] * 16
    frac = level - torch.floor(level)
    # a one-level flip where u lies on the fraction: a boundary flip
    edge = ut.clone()
    edge[0, 5] = frac[0, 5]
    want_e = qsgd_blocks_plain(xt, edge, 16)
    moved = want_e.clone()
    moved[0, 5] += float(norm[0]) / 16 * float(torch.sign(xt[0, 5]))
    _, flips = parity.compare_qsgd(xt, edge, 16, moved, want_e)
    assert flips == 1
    # the same one-level move away from any boundary is refused
    bad = want.clone()
    far = ((frac[1] - 0.5).abs() < 0.2) & ((ut[1] - frac[1]).abs() > 0.2)
    lane = int(torch.argmax(far.to(torch.int64)))
    bad[1, lane] += float(norm[1]) / 16
    with pytest.raises(AssertionError, match="no one-level flip"):
        parity.compare_qsgd(xt, ut, 16, bad, want)
    with pytest.raises(AssertionError, match="non-finite"):
        parity.compare_qsgd(xt, ut, 16, want * float("nan"), want)


def test_wrapper_refuses_what_the_plain_version_does_not_take():
    with pytest.raises(ValueError):
        qsgd_blocks(torch.zeros((2, 512)), torch.zeros((2, 512)), 16)
    with pytest.raises(ValueError):
        qsgd_blocks(torch.zeros((2, BLOCK)), torch.zeros((1, BLOCK)), 16)
    with pytest.raises(ValueError):
        qsgd_blocks(torch.zeros((2, BLOCK)), torch.zeros((2, BLOCK)), 0)
    with pytest.raises(ValueError):
        qsgd_blocks(torch.zeros((2, BLOCK), device="meta"),
                    torch.zeros((2, BLOCK)), 16)
