"""Port parity, MoE: ``repro_torch.models.moe`` (capacity, routing, the
dispatch and combine, the blocked path) against ``repro.models.moe`` on the
same numpy-seeded inputs and weights, and the reference's own MoE unit
tests (``tests/test_ssm_moe_units.py``) on the port.

Tolerances:
* capacity, the slot table ``token_for_slot`` and the token drops: equal
  exactly. Routing is a discrete decision; with a stable top-k (ties to the
  lower expert index, as ``jax.lax.top_k``) the tables of the two packages
  are the same on these inputs, and a test says which token differs if not;
* float32 compute: gates, aux, outputs and every gradient within ``1e-5``
  (relative to each array's largest magnitude): float32 sums in other
  orders;
* bfloat16 compute: the tolerance of ``test_torch_model.py``'s default
  path, ``1e-4`` relative on scalar losses and ``5e-2`` of each gradient's
  largest magnitude. The combine adds in the reference's order, but the
  bfloat16 expert products and the gather's backward round at other points.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

F32_TOL = 1e-5
BF16_LOSS_RTOL, BF16_GRAD_RTOL = 1e-4, 5e-2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers at once, and their small multi-threaded torch operations slow
    each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(**kw):
    """The reduced deepseek-moe-16b of both packages (4 experts, top-2, one
    shared expert, expert width 128, d_model 256), with ``kw`` replaced."""
    return (dataclasses.replace(jget("deepseek-moe-16b").reduced(), **kw),
            dataclasses.replace(tget("deepseek-moe-16b").reduced(), **kw))


def _weights(cfg, seed=0):
    """Numpy-seeded MoE weights of ``cfg``'s shapes at init-like scale."""
    rng = np.random.default_rng(seed)
    return {k: (0.02 if k != "router" else 0.5)
            * rng.standard_normal(s).astype(np.float32)
            for k, s in tmoe.param_shapes(cfg).items()}


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(got, want, rtol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.max(np.abs(got - want), initial=0.0))
    assert err <= rtol * max(float(np.max(np.abs(want), initial=0.0)),
                             1e-30), (what, err)


@pytest.mark.parametrize("tokens", [1, 7, 64, 256, 1000])
@pytest.mark.parametrize("cf", [0.25, 1.0, 1.25, 8.0])
def test_capacity_matches_reference(tokens, cf):
    full = (jget("deepseek-moe-16b"), tget("deepseek-moe-16b"))
    for j, t in (full, _cfgs()):
        j = dataclasses.replace(j, capacity_factor=cf)
        t = dataclasses.replace(t, capacity_factor=cf)
        assert tmoe.capacity(t, tokens) == jmoe.capacity(j, tokens)
    # the card's shape: 2 x 128 tokens per node, top-6 of 64 at 1.25
    assert tmoe.capacity(tget("deepseek-moe-16b"), 256) == 32


@pytest.mark.parametrize("cf,t_count,seed", [
    (1.25, 64, 0), (0.25, 64, 1), (1.0, 200, 2), (8.0, 16, 3)])
def test_route_matches_reference(cf, t_count, seed):
    jc, tc = _cfgs(capacity_factor=cf)
    w = _weights(tc, seed)["router"]
    x = _x((t_count, tc.d_model), seed + 10)
    tfs_j, gfs_j, aux_j, cap_j = jmoe.route(jc, jnp.asarray(w),
                                            jnp.asarray(x))
    tfs_t, gfs_t, aux_t, cap_t, _ = tmoe.route(tc, torch.tensor(w),
                                               torch.tensor(x))
    assert cap_t == cap_j and tfs_t.dtype == torch.int32
    flips = tmoe.flipped_tokens(tfs_t, np.asarray(tfs_j), t_count)
    assert not flips, f"tokens routed differently: {flips}"
    np.testing.assert_array_equal(tfs_t.numpy(), np.asarray(tfs_j))
    _close(gfs_t.numpy(), gfs_j, F32_TOL, "gate_for_slot")
    assert float(aux_t) == pytest.approx(float(aux_j), rel=F32_TOL)
    kept = int((tfs_t < t_count).sum())
    if cf < 1.0:
        assert kept < t_count * tc.moe_top_k     # the drops are exercised


def test_tied_probabilities_route_as_the_reference():
    """Two experts with the same router column tie exactly for every token:
    both packages pick the lower index first, so the tables are equal."""
    jc, tc = _cfgs()
    w = _weights(tc, 4)["router"]
    w[:, 2] = w[:, 1]
    x = _x((48, tc.d_model), 5)
    tfs_j = np.asarray(jmoe.route(jc, jnp.asarray(w), jnp.asarray(x))[0])
    tfs_t = tmoe.route(tc, torch.tensor(w), torch.tensor(x))[0].numpy()
    np.testing.assert_array_equal(tfs_t, tfs_j)


def test_choice_order_inside_a_token_leaves_the_slot_table_unchanged(
        monkeypatch):
    """Queue positions come from a cumsum in (token, choice) order, but a
    token never picks one expert twice, so no count it sees depends on the
    order of its own choices: reversing every token's choices (as a top-k
    that orders ties otherwise would) gives the same slot and gate tables."""
    _, tc = _cfgs(capacity_factor=0.5)
    w = torch.tensor(_weights(tc, 6)["router"])
    x = torch.tensor(_x((96, tc.d_model), 7))
    want = tmoe.route(tc, w, x)
    real_sort = torch.sort

    def sort_then_reverse_top_k(t, *a, **kw):
        out = real_sort(t, *a, **kw)
        if t.dim() != 2 or not t.is_floating_point():
            return out
        k = tc.moe_top_k
        idx = torch.cat([out.indices[:, :k].flip(1), out.indices[:, k:]], 1)
        return torch.return_types.sort((torch.gather(t, 1, idx), idx))
    monkeypatch.setattr(tmoe.torch, "sort", sort_then_reverse_top_k)
    got = tmoe.route(tc, w, x)
    assert torch.equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    assert got[3] == want[3]
    # the per-token slot map holds the same slots in the reversed order,
    # and combine sorts each token's slots before it adds
    assert torch.equal(got[4], want[4].flip(1))


def test_combine_adds_in_slot_order_one_rounding_per_add():
    """``combine`` equals the reference's scatter-add written as a serial
    loop over the slots in bfloat16, bit for bit, with empty slots, dropped
    choices and each token's slots handed over out of order."""
    rng = np.random.default_rng(8)
    t_count, k, n_slots, d = 10, 3, 40, 16
    slot = rng.permutation(n_slots)[:t_count * k].reshape(t_count, k)
    slot = np.where(rng.random((t_count, k)) < 0.3, n_slots, slot)
    tfs = np.full(n_slots, t_count, np.int64)
    for t in range(t_count):
        for s in slot[t]:
            if s < n_slots:
                tfs[s] = t
    ye = torch.tensor(rng.standard_normal((n_slots, d)),
                      dtype=torch.bfloat16)
    got = tmoe.combine(ye, torch.tensor(slot))
    want = torch.zeros((t_count + 1, d), dtype=torch.bfloat16)
    for s in range(n_slots):
        want[tfs[s]] = want[tfs[s]] + ye[s]
    assert torch.equal(got, want[:t_count])


def _moe_both(jc, tc, w, x):
    """(y, aux) and the gradients of a scalar loss, the weighted mean square
    of y plus aux (no cancelling terms, so it has a relative tolerance),
    with respect to x and every weight, in both packages."""
    r = _x(x.shape, 99)

    def jfun(p, xx):
        y, aux = jmoe.moe_forward(jc, p, xx)
        return jnp.mean((y.astype(jnp.float32) * r) ** 2) + aux, (y, aux)
    (lj, (yj, auxj)), gj = jax.jit(jax.value_and_grad(
        jfun, argnums=(0, 1), has_aux=True))(
            {k: jnp.asarray(v) for k, v in w.items()},
            jnp.asarray(x).astype(jc.compute_dtype))
    tw = {k: torch.tensor(v, requires_grad=True) for k, v in w.items()}
    cd = getattr(torch, tc.compute_dtype)
    tx = torch.tensor(x).to(cd).requires_grad_(True)
    yt, auxt = tmoe.moe_forward(tc, tw, tx)
    lt = torch.mean((yt.float() * torch.tensor(r)) ** 2) + auxt
    lt.backward()
    grads = [("x", tx.grad.float().numpy(),
              np.asarray(gj[1], np.float32))] + [
        (k, tw[k].grad.numpy(), np.asarray(gj[0][k], np.float32))
        for k in sorted(w)]
    return (float(lt.detach()), float(lj), yt.detach().float().numpy(),
            np.asarray(yj, np.float32), float(auxt.detach()), float(auxj),
            grads)


@pytest.mark.parametrize("cf,blocks,shared", [
    (1.25, 1, 1), (0.25, 1, 1), (8.0, 1, 0), (1.25, 4, 1), (0.5, 2, 0)],
    ids=["default", "drops", "ample-no-shared", "blocked", "blocked-drops"])
def test_moe_forward_and_grads_float32(cf, blocks, shared):
    jc, tc = _cfgs(capacity_factor=cf, moe_route_blocks=blocks,
                   n_shared_experts=shared, compute_dtype="float32")
    w = _weights(tc, 11)
    x = _x((2, 32, tc.d_model), 12)
    lt, lj, yt, yj, auxt, auxj, grads = _moe_both(jc, tc, w, x)
    assert lt == pytest.approx(lj, rel=F32_TOL)
    assert auxt == pytest.approx(auxj, rel=F32_TOL)
    _close(yt, yj, F32_TOL, "y")
    for name, got, want in grads:
        _close(got, want, F32_TOL, name)


@pytest.mark.parametrize("cf,blocks", [(1.25, 1), (0.25, 1), (1.25, 4)],
                         ids=["default", "drops", "blocked"])
def test_moe_forward_and_grads_bfloat16(cf, blocks):
    jc, tc = _cfgs(capacity_factor=cf, moe_route_blocks=blocks)
    assert tc.compute_dtype == "bfloat16"
    w = _weights(tc, 13)
    x = _x((2, 32, tc.d_model), 14)
    lt, lj, yt, yj, auxt, auxj, grads = _moe_both(jc, tc, w, x)
    assert lt == pytest.approx(lj, rel=BF16_LOSS_RTOL)
    assert auxt == pytest.approx(auxj, rel=F32_TOL)    # the router is f32
    _close(yt, yj, BF16_GRAD_RTOL, "y")
    for name, got, want in grads:
        _close(got, want, BF16_GRAD_RTOL, name)


# ------------------------------------ the reference's unit tests, on the port

def _port_cfg(**kw):
    return dataclasses.replace(tget("deepseek-moe-16b").reduced(), **kw)


def _port_weights(cfg, seed):
    g = torch.Generator().manual_seed(seed)
    return {k: torch.randn(s, generator=g) * (0.02 if k != "router" else 0.1)
            for k, s in tmoe.param_shapes(cfg).items()}


def test_router_gates_normalized_and_capacity():
    cfg = _port_cfg(capacity_factor=1.0)
    g = torch.Generator().manual_seed(0)
    x = torch.randn((64, cfg.d_model), generator=g)
    w = torch.randn((cfg.d_model, cfg.n_experts), generator=g) * 0.1
    token_for_slot, gate_for_slot, aux, cap, _ = tmoe.route(cfg, w, x)
    assert token_for_slot.shape == (cfg.n_experts * cap,)
    # every real token index is < T; the sentinel T marks empty slots
    assert int(token_for_slot.max()) <= 64
    assert float(gate_for_slot.min()) >= 0.0
    assert float(gate_for_slot.max()) <= 1.0
    assert float(aux) > 0.0
    # each token's kept gates sum to at most 1, exactly 1 when nothing drops
    per_token = torch.zeros(65).index_add_(0, token_for_slot.long(),
                                           gate_for_slot)[:64]
    assert float(per_token.max()) <= 1.0 + 1e-6
    for e in range(cfg.n_experts):
        assert int((token_for_slot[e * cap:(e + 1) * cap] < 64).sum()) <= cap


def test_moe_equals_dense_reference_at_full_capacity():
    """With capacity big enough for zero drops, the dispatch and combine
    must equal the naive per-token dense mixture."""
    cfg = _port_cfg(capacity_factor=8.0, n_shared_experts=0)
    p = _port_weights(cfg, 1)
    x = torch.randn((1, 16, cfg.d_model),
                    generator=torch.Generator().manual_seed(1))
    y, aux = tmoe.moe_forward(cfg, p, x.to(torch.bfloat16))

    xt = x[0].double()
    probs = torch.softmax(xt @ p["router"].double(), -1)
    gv, gi = torch.topk(probs, cfg.moe_top_k)
    gv = gv / gv.sum(-1, keepdim=True)
    wg, wi, wo = (p[k].double() for k in ("w_gate", "w_in", "w_out"))
    y_ref = torch.zeros_like(xt)
    for t in range(xt.shape[0]):
        for c in range(cfg.moe_top_k):
            e = int(gi[t, c])
            h = torch.nn.functional.silu(xt[t] @ wg[e]) * (xt[t] @ wi[e])
            y_ref[t] += gv[t, c] * (h @ wo[e])
    np.testing.assert_allclose(y[0].float().numpy(), y_ref.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_moe_capacity_drops_tokens_gracefully():
    cfg = _port_cfg(capacity_factor=0.25)
    p = _port_weights(cfg, 2)
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    y, aux = tmoe.moe_forward(cfg, p, x.to(torch.bfloat16))
    assert y.shape == x.shape
    assert not bool(torch.isnan(y).any())
    tfs = tmoe.route(cfg, p["router"], x.reshape(64, -1))[0]
    assert int((tfs < 64).sum()) < 64 * cfg.moe_top_k


def test_blocked_routing_equals_global_at_ample_capacity():
    """moe_route_blocks > 1 must equal global routing when nothing drops."""
    cfg = _port_cfg(capacity_factor=8.0, n_shared_experts=1)
    p = _port_weights(cfg, 7)
    x = torch.randn((2, 32, cfg.d_model),
                    generator=torch.Generator().manual_seed(7))
    x = x.to(torch.bfloat16)
    y_global, _ = tmoe.moe_forward(cfg, p, x)
    y_block, _ = tmoe.moe_forward(
        dataclasses.replace(cfg, moe_route_blocks=4), p, x)
    np.testing.assert_allclose(y_block.float().numpy(),
                               y_global.float().numpy(), rtol=2e-2,
                               atol=2e-2)
