"""Port parity, kernel math and wrappers: the port's plain SignTopK
(``repro_torch.kernels``) against the reference's compiled XLA leg and
``kernels/ref.py``, on the same numpy-seeded inputs.

Tolerances: thresholds, selected index sets, payload indices and trigger
decisions must be equal exactly (the radix select is exact and both sides
break ties by index). q, scales and x_hat_new come out of float32 sums that
XLA and PyTorch add in different orders, so they may differ by a few ulps:
``RTOL = 1e-6`` for float32; bfloat16 outputs may round to the neighbouring
bfloat16 value, ``RTOL_BF16 = 2**-7`` (one bfloat16 ulp).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels import sign_topk as jst  # noqa: E402
from repro_torch.kernels import ops, parity, ref  # noqa: E402
from repro_torch.kernels import sign_topk as st  # noqa: E402

BLOCK = 1024
RTOL = 1e-6
RTOL_BF16 = 2.0 ** -7


def _inputs(kind, nb, seed):
    rng = np.random.default_rng(seed)
    if kind == "normal":
        xh = rng.standard_normal((nb, BLOCK))
        xe = 0.3 * rng.standard_normal((nb, BLOCK))
    elif kind == "ties":     # a 1/4 grid: many |diff| tie at the threshold
        xh = np.round(rng.standard_normal((nb, BLOCK)) * 4.0) / 4.0
        xe = np.round(rng.standard_normal((nb, BLOCK)) * 2.0) / 4.0
    elif kind == "sparse":   # fewer nonzeros than k_b in some tiles
        xh = rng.standard_normal((nb, BLOCK)) * (rng.random((nb, BLOCK)) < 0.01)
        xe = np.zeros((nb, BLOCK))
    else:
        raise ValueError(kind)
    return xh.astype(np.float32), xe.astype(np.float32)


def _close(got, want, rtol, scale=None):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    ref_scale = np.abs(want) if scale is None else np.abs(scale)
    assert np.all(np.abs(got - want) <= rtol * ref_scale + 1e-30), \
        float(np.max(np.abs(got - want)))


@pytest.mark.parametrize("kind", ["normal", "ties", "sparse"])
@pytest.mark.parametrize("k_b", [1, 16, 103, 128, 512])
def test_row_threshold_equals_reference(kind, k_b):
    xh, xe = _inputs(kind, 8, k_b)
    av = np.abs(xh - xe)
    want = np.asarray(jst._row_threshold(jnp.asarray(av), k_b))
    got = st._row_threshold(torch.tensor(av), k_b).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("nb", [1, 2, 8, 32])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("k_b", [1, 16, 103, 128, 512])
def test_sign_topk_blocks_matches_reference(nb, dtype, k_b):
    xh, xe = _inputs("normal", nb, nb * 1000 + k_b)
    jx = [jnp.asarray(a).astype(dtype) for a in (xh, xe)]
    tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in (xh, xe)]
    rtol = RTOL if dtype == "float32" else RTOL_BF16
    for trig in (0.0, 1.0):
        q_j, xn_j, sc_j = jst.sign_topk_blocks(*jx, jnp.float32(trig), k_b,
                                               lowering="xla")
        q_t, xn_t, sc_t = st.sign_topk_blocks(*tx, trig, k_b)
        q_j = np.asarray(q_j.astype(jnp.float32))
        q_t = q_t.float().numpy()
        np.testing.assert_array_equal(q_t != 0, q_j != 0)   # support
        _close(q_t, q_j, rtol)
        _close(sc_t.numpy(), np.asarray(sc_j), RTOL)
        _close(xn_t.float().numpy(), np.asarray(xn_j.astype(jnp.float32)),
               rtol, scale=np.abs(np.asarray(xn_j.astype(jnp.float32)))
               + np.abs(q_j))
        if trig == 0.0:
            assert not np.any(q_t)
            assert torch.equal(xn_t, tx[1])


@pytest.mark.parametrize("kind", ["ties", "sparse"])
@pytest.mark.parametrize("k_b", [1, 16, 103, 512])
def test_block_compress_masks_equal_under_ties(kind, k_b):
    xh, xe = _inputs(kind, 8, 7 * k_b)
    diff = xh - xe
    q_j, sc_j = jst._block_compress(jnp.asarray(diff), jnp.float32(1.0), k_b)
    q_t, sc_t = st._block_compress(torch.tensor(diff), 1.0, k_b)
    np.testing.assert_array_equal(q_t.numpy() != 0, np.asarray(q_j) != 0)
    assert int((q_t != 0).sum(dim=1).max()) <= k_b
    _close(q_t.numpy(), np.asarray(q_j), RTOL)
    _close(sc_t.numpy(), np.asarray(sc_j), RTOL)


def test_sign_topk_ref_matches_reference():
    xh, xe = _inputs("ties", 4, 3)
    for k_b in (5, 102):
        q_j, xn_j, vals_j, idx_j = jref.sign_topk_ref(
            jnp.asarray(xh.reshape(-1)), jnp.asarray(xe.reshape(-1)),
            jnp.float32(1.0), k_b)
        q_t, xn_t, vals_t, idx_t = ref.sign_topk_ref(
            torch.tensor(xh.reshape(-1)), torch.tensor(xe.reshape(-1)),
            1.0, k_b)
        np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
        _close(vals_t.numpy(), np.asarray(vals_j), RTOL)
        _close(q_t.numpy(), np.asarray(q_j), RTOL)
        _close(xn_t.numpy(), np.asarray(xn_j), RTOL,
               scale=np.abs(np.asarray(xn_j)) + np.abs(np.asarray(q_j)))


def test_sqdiff_partials_and_padding_match_reference():
    rng = np.random.default_rng(4)
    x, y = rng.standard_normal((2, 3 * BLOCK)).astype(np.float32)
    _close(ref.sqdiff_partials_ref(torch.tensor(x), torch.tensor(y)).numpy(),
           np.asarray(jref.sqdiff_partials_ref(jnp.asarray(x),
                                               jnp.asarray(y))), RTOL)
    padded, n = ref.pad_to_blocks(torch.tensor(x[:2500]))
    want, n_j = jref.pad_to_blocks(jnp.asarray(x[:2500]))
    assert n == n_j == 3
    np.testing.assert_array_equal(padded.numpy(), np.asarray(want))


@pytest.mark.parametrize("d,k", [(1, 1), (1023, 100), (1025, 64),
                                 (2500, 250), (3089, 123)])
def test_ops_sign_topk_matches_reference(d, k):
    flat = np.random.default_rng(d).standard_normal(d).astype(np.float32)
    q_j, vals_j, idx_j = jops.sign_topk(jnp.asarray(flat), k,
                                        lowering="xla")
    q_t, vals_t, idx_t = ops.sign_topk(torch.tensor(flat), k)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    assert idx_t.dtype == torch.int32
    _close(vals_t.numpy(), np.asarray(vals_j), RTOL)
    _close(q_t.numpy(), np.asarray(q_j), RTOL)


def test_ops_sign_topk_all_ties_payload():
    """Every |entry| equal: the whole tile is one tie, broken by index, and
    the payload (gathered in top_k order) must be the reference's exactly."""
    flat = 7.0 * np.where(np.arange(2048) % 3 == 0, 1.0, -1.0)
    flat = flat.astype(np.float32)
    q_j, vals_j, idx_j = jops.sign_topk(jnp.asarray(flat), 256,
                                        lowering="xla")
    q_t, vals_t, idx_t = ops.sign_topk(torch.tensor(flat), 256)
    np.testing.assert_array_equal(idx_t.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    np.testing.assert_array_equal(q_t.numpy(), np.asarray(q_j))
    assert int((q_t != 0).sum()) == 256
    rebuilt = torch.zeros(2048).index_put_((idx_t.long(),), vals_t)
    assert torch.equal(rebuilt, q_t)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_trigger_compress_update_matches_reference(dtype):
    x = np.random.default_rng(1).standard_normal(3 * BLOCK + 17)
    x = x.astype(np.float32)
    xe = 0.5 * x
    sq = float(np.sum((x - xe) ** 2))
    rtol = RTOL if dtype == "float32" else RTOL_BF16
    for threshold in (sq * 2, sq / 2):
        jx = [jnp.asarray(a).astype(dtype) for a in (x, xe)]
        tx = [torch.tensor(a).to(getattr(torch, dtype)) for a in (x, xe)]
        q_j, xn_j, trig_j = jops.trigger_compress_update(
            *jx, jnp.float32(threshold), 32, lowering="xla")
        q_t, xn_t, trig_t = ops.trigger_compress_update(*tx, threshold, 32)
        assert float(trig_t) == float(trig_j)
        q_j = np.asarray(q_j.astype(jnp.float32))
        np.testing.assert_array_equal(q_t.float().numpy() != 0, q_j != 0)
        _close(q_t.float().numpy(), q_j, rtol)
        xn_j = np.asarray(xn_j.astype(jnp.float32))
        _close(xn_t.float().numpy(), xn_j, rtol, scale=np.abs(xn_j)
               + np.abs(q_j))
        if float(trig_t) == 0.0:
            assert torch.equal(xn_t, tx[1])


def test_sign_topk_ensemble_matches_reference():
    n, d = 4, 2 * BLOCK + 300
    diff = np.random.default_rng(9).standard_normal((n, d))
    diff = diff.astype(np.float32)
    q_j = np.asarray(jops.sign_topk_ensemble(jnp.asarray(diff), 13,
                                             lowering="xla"))
    q_t = ops.sign_topk_ensemble(torch.tensor(diff), 13)
    assert q_t.shape == (n, d)
    np.testing.assert_array_equal(q_t.numpy() != 0, q_j != 0)
    _close(q_t.numpy(), q_j, RTOL)


def test_ensemble_equals_rows_and_zeros_stay_silent():
    parity.check_ensemble_matches_rows(torch.device("cpu"))
    parity.check_payload_reconstructs(torch.device("cpu"))
    xb = torch.zeros((2, BLOCK))
    q, xn, sc = st.sign_topk_blocks(xb, xb, 1.0, 128)
    assert not q.any() and not sc.any() and torch.equal(xn, xb)


@pytest.mark.parametrize("spec", parity.SIGN_TOPK_CASES[::9])
def test_parity_harness_on_cpu(spec):
    """The card's comparison harness, run where both sides are the plain
    version: every case must pass it, and no kernel is launched."""
    before = st.sign_topk_blocks.launches
    parity.check_sign_topk(*parity.make_sign_topk_case(
        spec, torch.device("cpu")), spec=spec)
    assert st.sign_topk_blocks.launches == before


def test_chunked_harness_holds_every_tile():
    """The full-shape check walks every chunk, the ragged last one too,
    over a whole-tile tie (a norm weight's tile) and a silent zero tile;
    and the comparison fails on an output wrong in a single tile."""
    x = torch.tensor(np.random.default_rng(3).standard_normal((37, BLOCK)),
                     dtype=torch.float32)
    x[5], x[6] = 1.0, 0.0
    before = st.sign_topk_blocks.launches
    parity.check_sign_topk_chunked(x, 103, chunk_rows=8)
    assert st.sign_topk_blocks.launches == before
    q, _, sc = st.sign_topk_blocks_plain(x, None, 1.0, 103)
    q[36, q[36].nonzero()[0]] = 0.0
    with pytest.raises(AssertionError, match="index sets"):
        parity.compare_sign_topk(x[32:], None, 1.0, 103,
                                 (q[32:], None, sc[32:]))


# The select edges of the CUDA kernel (kernels/parity.py), at a few tiles:
# the port's plain version against the reference's XLA leg. XLA on the CPU
# flushes subnormals to zero (jnp.abs(1e-40) is 0.0 there) while PyTorch and
# the kernel keep them, so ``spread`` starts at the least normal float32
# here; its subnormals are held kernel against plain version on the card.
EDGE_CASES = [(kind, 14 if kind == "many" else 2, dt, k_b, 1.0, fused)
              for kind in (*parity.SELECT_EDGE_KINDS, "many")
              for dt in ("float32", "bfloat16") for k_b in (1, 103, 1024)
              for fused in (False, True)]


@pytest.mark.parametrize("spec", EDGE_CASES,
                         ids=["-".join(map(str, s)) for s in EDGE_CASES])
def test_select_edges_match_reference(spec):
    dtype = spec[2]
    xh_t, xe_t, trig, k_b = parity.make_sign_topk_case(
        spec, torch.device("cpu"), smallest=1.2e-38)
    xh = xh_t.float().numpy()
    xe = np.zeros_like(xh) if xe_t is None else xe_t.float().numpy()
    q_j, xn_j, sc_j = jst.sign_topk_blocks(
        jnp.asarray(xh).astype(dtype), jnp.asarray(xe).astype(dtype),
        jnp.float32(trig), k_b, lowering="xla")
    q_t, xn_t, sc_t = st.sign_topk_blocks(xh_t, xe_t, trig, k_b)
    q_j = np.asarray(q_j.astype(jnp.float32))
    q_t = q_t.float().numpy()
    av = np.abs(xh - xe)
    np.testing.assert_array_equal(
        st._row_threshold(torch.tensor(av), k_b).numpy(),
        np.asarray(jst._row_threshold(jnp.asarray(av), k_b)))
    np.testing.assert_array_equal(q_t != 0, q_j != 0)      # support
    assert int((q_t != 0).sum(axis=1).max()) <= k_b
    rtol = RTOL if dtype == "float32" else RTOL_BF16
    _close(q_t, q_j, rtol)
    _close(sc_t.numpy(), np.asarray(sc_j), RTOL)
    if xe_t is not None:
        xn_j = np.asarray(xn_j.astype(jnp.float32))
        _close(xn_t.float().numpy(), xn_j, rtol,
               scale=np.abs(xn_j) + np.abs(q_j))
