"""Port parity, small modules: bits and the float32 Kahan accumulator,
trigger and LR schedules, the blockwise compressor's payload, the
optimizers, the topologies and the shared SPARQ primitives, each against its
``repro`` counterpart on the same numpy-seeded inputs.

Tolerances: formulas on Python floats, mixing matrices, degrees, trigger
decisions and float32 schedules that are single correctly rounded operations
must be equal exactly. ``poly``'s power and the optimizers' fused
multiply-adds may differ by an ulp or two: ``rtol = 1e-6``.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import bits as jbits  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import sparq as jsparq  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro.optim import sgd as jsgd  # noqa: E402
from repro_torch.core import bits, compression, schedule, sparq  # noqa: E402
from repro_torch.core import topology, triggers  # noqa: E402
from repro_torch.optim import sgd  # noqa: E402


def test_bit_formulas_equal_reference():
    for d in (1, 2, 1000, 1024, 619_570_176):
        for k in (1, 10, 103):
            assert bits.topk_bits(d, k) == jbits.topk_bits(d, k)
            assert bits.signtopk_bits(d, k) == jbits.signtopk_bits(d, k)
            assert bits.topk_index_bits(d, k) == jbits.topk_index_bits(d, k)
        for s in (1, 4, 16):
            assert bits.qsgd_bits(d, s) == jbits.qsgd_bits(d, s)
        assert bits.sign_bits(d) == jbits.sign_bits(d)
        assert bits.dense_bits(d) == jbits.dense_bits(d)
        for trig in (False, True):
            assert bits.message_bits(7.0, trig) == jbits.message_bits(7.0,
                                                                       trig)


def test_kahan_accumulator_equals_reference_in_float32():
    """The reference runs with x64 off, so its totals are float32 with a
    Kahan term; past 2^24 a plain float32 sum drops small increments and the
    compensated one must not — bit for bit the same in both packages."""
    assert not jax.config.jax_enable_x64
    incs = [7.05e8, 3.0, 1.0, 7.05e8, 12.0, 5.5, 7.05e8] * 4
    t_j, c_j = jbits.acc_init()
    t_t, c_t = bits.acc_init()
    for inc in incs:
        t_j, c_j = jbits.acc_add(t_j, c_j, jnp.float32(inc))
        t_t, c_t = bits.acc_add(t_t, c_t, torch.tensor(inc))
        assert t_t.dtype == torch.float32
        assert float(t_t) == float(t_j) and float(c_t) == float(c_j)


@pytest.mark.parametrize("name,kw", [
    ("zero", {}), ("constant", {"c0": 2.0}), ("poly", {"c0": 3.0}),
    ("poly", {"c0": 0.5, "eps": 0.25}),
    ("piecewise", {"c0": 1.0, "step": 0.5, "every": 7, "until": 30})])
def test_threshold_schedules_equal_reference(name, kw):
    s_t = triggers.make_schedule(name, **kw)
    s_j = jtrig.make_schedule(name, **kw)
    assert s_t.name == s_j.name
    got = np.array([float(s_t(t)) for t in range(60)], np.float32)
    want = np.array([float(s_j(t)) for t in range(60)], np.float32)
    np.testing.assert_allclose(got, want, rtol=1e-6 if name == "poly" else 0)


def test_threshold_schedule_errors_match_reference():
    for mod in (triggers, jtrig):
        with pytest.raises(ValueError):
            mod.poly(1.0, eps=1.0)
        with pytest.raises(ValueError):
            mod.piecewise(1.0, 1.0, every=0, until=3)
        with pytest.raises(ValueError):
            mod.make_schedule("nope")


def test_should_trigger_equals_reference():
    rng = np.random.default_rng(2)
    x, xe = rng.standard_normal((2, 500)).astype(np.float32)
    sq = float(np.sum((x - xe) ** 2))
    for c in (sq * 0.5 / 0.01, sq * 2 / 0.01):
        got = triggers.should_trigger(torch.tensor(x), torch.tensor(xe),
                                      c, 0.1)
        want = jtrig.should_trigger(jnp.asarray(x), jnp.asarray(xe), c, 0.1)
        assert bool(got) == bool(want)


@pytest.mark.parametrize("make", [
    lambda m: m.decaying(0.5, 10.0), lambda m: m.decaying(0.5, 100.0),
    lambda m: m.fixed(0.05), lambda m: m.theorem1_lr(0.1, 1.0, 5, 0.02),
    lambda m: m.theorem2_lr(16, 1000),
    lambda m: m.warmup_piecewise(0.1, 5, (20, 40))],
    ids=["decay10", "decay100", "fixed", "thm1", "thm2", "warmup"])
def test_lr_schedules_equal_reference_in_float32(make):
    s_t, s_j = make(schedule), make(jsched)
    assert s_t.name == s_j.name
    for t in range(0, 60, 3):
        got, want = s_t(t), s_j(t)
        assert got.dtype == torch.float32
        assert float(got) == float(want), (t, float(got), float(want))


def test_sync_index_equals_reference():
    assert [schedule.is_sync(t, 4) for t in range(9)] == \
        [bool(jsched.is_sync(t, 4)) for t in range(9)]


@pytest.mark.parametrize("frac", [0.01, 0.1, 0.25, 1.0])
def test_block_top_frac_payload_equals_reference(frac):
    c_t, c_j = compression.BlockTopFrac(frac=frac), \
        jcomp.BlockTopFrac(frac=frac)
    t_t, t_j = compression.TopFrac(frac=frac), jcomp.TopFrac(frac=frac)
    assert c_t._k_b() == c_j._k_b()
    for d in (1, 1000, 1024, 3089, 619_570_176):
        assert c_t.bits(d) == c_j.bits(d)
        assert c_t.omega(d) == c_j.omega(d)
        assert t_t._k(d) == t_j._k(d)
        assert t_t.bits(d) == t_j.bits(d)
        assert t_t.omega(d) == t_j.omega(d)
    x = np.random.default_rng(3).standard_normal(2500).astype(np.float32)
    got = c_t(torch.tensor(x)).numpy()
    want = np.asarray(c_j(jnp.asarray(x)))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6)


def test_compressor_refusals():
    with pytest.raises(ValueError):
        compression.TopFrac(frac=0.0)
    with pytest.raises(ValueError):
        compression.TopFrac(k=5)
    with pytest.raises(ValueError, match="PRNG key"):
        compression.RandK(k=2)(torch.zeros(8))
    assert compression.Compressor().bits(10) == jcomp.Compressor().bits(10)


@pytest.mark.parametrize("name,kw", [
    ("sgd", {}), ("sgd", {"weight_decay": 0.01}),
    ("momentum", {"beta": 0.9}), ("momentum", {"beta": 0.9,
                                              "nesterov": True}),
    ("momentum", {"beta": 0.5, "weight_decay": 0.01}),
    ("adamw", {})])
def test_optimizers_equal_reference(name, kw):
    """Three in-place updates of a (4, 2048) flat buffer against the
    reference's pure updates on the same gradients."""
    rng = np.random.default_rng(5)
    p0 = rng.standard_normal((4, 2048)).astype(np.float32)
    gs = rng.standard_normal((3, 4, 2048)).astype(np.float32)
    o_t, o_j = sgd.make_optimizer(name, **kw), jsgd.make_optimizer(name, **kw)
    p_t = torch.tensor(p0)
    s_t = o_t.init(p_t)
    p_j = jnp.asarray(p0)
    s_j = o_j.init(p_j)
    for i, lr in enumerate((0.1, 0.05, 0.025)):
        s_t = o_t.update(torch.tensor(gs[i]), s_t, p_t, lr)
        p_j, s_j = o_j.update(jnp.asarray(gs[i]), s_j, p_j, jnp.float32(lr))
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-6,
                               atol=1e-6)


def test_resolve_optimizer_rules_equal_reference():
    for mod in (sgd, jsgd):
        assert mod.resolve_optimizer(None).name == "sgd"
        assert mod.resolve_optimizer(None, 0.9).name == "momentum(0.9)"
        for bad in ((mod.sgd(), 0.9, False), (mod.sgd(), 0.0, True),
                    (None, 0.0, True)):
            with pytest.raises(ValueError):
                mod.resolve_optimizer(bad[0], bad[1], nesterov=bad[2])


# the kinds, sizes and seeds tests/test_topology.py builds: its property
# tests draw ring/complete sizes from 3..40 and edge-sampled expander bases
# (n = 12) from seeds 0..1000; its fixed cases are listed as they are
TOPOLOGIES = (
    [("ring", n, 4, 0) for n in range(1, 41)]
    + [("complete", n, 4, 0) for n in range(3, 41)]
    + [("torus2d", n, 4, 0) for n in (4, 9, 16)]
    + [("expander", 16, 4, s) for s in range(40)]
    + [("expander", 12, 4, s) for s in (0, 1, 2, 500, 1000)]
    + [("expander", n, deg, s) for n, deg, s in
       ((16, 3, 0), (16, 3, 1), (10, 5, 2), (8, 7, 0), (16, 5, 3),
        (8, 3, 1), (8, 2, 1), (4, 2, 1))])


@pytest.mark.parametrize("kind,n,deg,seed", TOPOLOGIES)
@pytest.mark.parametrize("mixing", ["uniform", "metropolis"])
def test_topology_equals_reference(kind, n, deg, seed, mixing):
    t_t = topology.make_topology(kind, n, deg=deg, seed=seed, mixing=mixing)
    t_j = jtopo.make_topology(kind, n, deg=deg, seed=seed, mixing=mixing)
    np.testing.assert_array_equal(t_t.w, t_j.w)
    np.testing.assert_array_equal(t_t.degrees, t_j.degrees)
    assert t_t.delta == t_j.delta and t_t.beta == t_j.beta
    for omega in (0.1, 103 / 1024, 2 / math.pi):
        assert t_t.gamma_star(omega) == t_j.gamma_star(omega)
    row_t, row_j = topology.circulant_row(t_t.w), jtopo.circulant_row(t_j.w)
    assert (row_t is None) == (row_j is None)
    if row_t is not None:
        np.testing.assert_array_equal(row_t, row_j)
    p_t = topology.make_plan(kind, n, deg=deg, seed=seed, mixing=mixing)
    p_j = jtopo.make_plan(kind, n, deg=deg, seed=seed, mixing=mixing)
    np.testing.assert_array_equal(p_t.degrees, p_j.degrees)
    assert p_t.delta_eff == p_j.delta_eff
    assert p_t.gamma_star(0.1) == p_j.gamma_star(0.1)


def test_topology_refusals_match_reference():
    for mod in (topology, jtopo):
        with pytest.raises(ValueError):
            mod.make_topology("torus2d", 5)
        with pytest.raises(ValueError):
            mod.random_regular_adjacency(7, 3)
        with pytest.raises(ValueError):
            mod.Topology(w=np.array([[0.5, 0.6], [0.5, 0.4]])).validate()
        with pytest.raises(ValueError, match="dynamic"):
            mod.make_plan("ring", 8, dynamic="nope")
        with pytest.raises(ValueError, match="even"):
            mod.GossipPlan.matchings(7)
        with pytest.raises(ValueError, match="keep-probability"):
            mod.GossipPlan.edge_sampled(mod.make_topology("ring", 8), p=0.0)
        with pytest.raises(ValueError, match="node count"):
            mod.GossipPlan.cycle([mod.make_topology("ring", 8),
                                  mod.make_topology("ring", 6)])


def test_sparq_primitives_equal_reference():
    rng = np.random.default_rng(6)
    sq = rng.random(6).astype(np.float32) * 4.0
    for c_t, eta in ((1.0, 1.0), (100.0, 0.2), (0.0, 0.5)):
        got = sparq.trigger_mask(torch.tensor(sq), torch.tensor(c_t),
                                 torch.tensor(eta))
        want = jsparq.trigger_mask(jnp.asarray(sq), jnp.float32(c_t),
                                   jnp.float32(eta))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    w = topology.make_topology("expander", 6, deg=3, seed=1).w
    x = rng.standard_normal((6, 33)).astype(np.float32)
    np.testing.assert_allclose(
        sparq.gossip_mix(torch.tensor(w, dtype=torch.float32),
                         torch.tensor(x)).numpy(),
        np.asarray(jsparq.gossip_mix(jnp.asarray(w, jnp.float32),
                                     jnp.asarray(x))), rtol=0, atol=1e-6)
    trig = np.array([1, 0, 1, 1, 0, 1], bool)
    deg = np.array([2, 3, 2, 2, 3, 2], np.float32)
    payload = 705_107_040.0
    got = sparq.sync_message_bits(torch.tensor(trig), torch.tensor(deg),
                                  payload)
    want = jsparq.sync_message_bits(jnp.asarray(trig), jnp.asarray(deg),
                                    payload)
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(float(want), rel=1e-6)
