"""Port parity, the core API's leftovers: ``Topology.p`` and ``neighbors``,
``GossipPlan.is_static``, ``beta_max`` and ``p``
(``repro_torch.core.topology``), ``schedule.periodic_sync_mask`` and
``TokenPipeline.node_batches``, against the reference's, on the reference's
own cases (``tests/test_topology.py``, ``tests/test_substrate.py``,
``tests/test_system.py``).

Tolerances: exact everywhere. The spectral quantities are the same float64
numpy on the same matrices, the sync mask is integer arithmetic, and the
batches are the same numpy draws.
"""
import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import schedule as jsched  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.data.synthetic import TokenPipeline as JPipe  # noqa: E402
from repro_torch.core import schedule, topology  # noqa: E402
from repro_torch.data.synthetic import TokenPipeline  # noqa: E402

OMEGAS = (0.01, 0.1, 0.5, 1.0)


@pytest.mark.parametrize("n", [3, 4, 7, 16, 30])
def test_topology_p_equals_reference(n):
    """``tests/test_topology.py:40-47`` on both packages: p is gamma* delta
    / 8, the paper's lower bound holds, and the value is the
    reference's."""
    t, jt = topology.make_topology("ring", n), jtopo.make_topology("ring", n)
    for omega in OMEGAS:
        p = t.p(omega)
        assert p == jt.p(omega)
        assert p == t.gamma_star(omega) * t.delta / 8.0
        assert p >= t.delta ** 2 * omega / 644 - 1e-12


@pytest.mark.parametrize("kind,n", [("ring", 6), ("ring", 2),
                                    ("torus2d", 16), ("complete", 5),
                                    ("expander", 12)])
def test_neighbors_equal_reference(kind, n):
    """``tests/test_topology.py:59-61`` (ring 6: node 0's neighbours are 1
    and 5) and every node of other graphs against the reference."""
    t, jt = topology.make_topology(kind, n), jtopo.make_topology(kind, n)
    if (kind, n) == ("ring", 6):
        assert set(t.neighbors(0)) == {1, 5}
    for i in range(n):
        got, want = t.neighbors(i), jt.neighbors(i)
        np.testing.assert_array_equal(got, want)
        assert got.dtype == want.dtype
        assert len(got) == t.degrees[i]


def test_static_plan_is_static_and_beta_max():
    """``tests/test_topology.py:140-146``: a static plan's ``is_static``,
    ``beta_max`` (the topology's beta, the same float) and ``p``."""
    t = topology.make_topology("expander", 16, deg=4, seed=1)
    p = topology.GossipPlan.from_topology(t)
    jp = jtopo.GossipPlan.from_topology(
        jtopo.make_topology("expander", 16, deg=4, seed=1))
    assert p.is_static and p.R == 1 and p.n == 16
    assert p.beta_max == t.beta == jp.beta_max
    for omega in OMEGAS:
        assert p.p(omega) == jp.p(omega)
        assert p.p(omega) == t.p(omega)


def test_plan_beta_max_worst_case_over_support():
    """``tests/test_topology.py:300-310``: a cycle's ``beta_max`` is at
    least the lone ring's, and both equal the reference's."""
    def plans(mod):
        ring = mod.make_topology("ring", 8)
        return (mod.GossipPlan.cycle([ring, mod.make_topology("complete",
                                                              8)]),
                mod.GossipPlan.from_topology(ring))
    (both, only), (jboth, jonly) = plans(topology), plans(jtopo)
    assert both.beta_max >= only.beta_max
    assert (both.beta_max, only.beta_max) == (jboth.beta_max,
                                              jonly.beta_max)
    assert not both.is_static and only.is_static
    assert both.p(0.5) == jboth.p(0.5)


@pytest.mark.parametrize("dynamic,n,rounds,seed", [
    ("matchings", 8, 3, 2), ("edges", 16, 5, 7), ("cycle", 12, 4, 0),
    ("none", 8, 1, 0)])
def test_time_varying_plans_equal_reference(dynamic, n, rounds, seed):
    """``is_static``, ``beta_max`` and ``p`` of every kind of plan."""
    kw = dict(n=n, dynamic=dynamic, rounds=rounds, seed=seed)
    kind = "ring" if dynamic == "edges" else "expander"
    got = topology.make_plan(kind, deg=4, **kw)
    want = jtopo.make_plan(kind, deg=4, **kw)
    assert got.is_static == want.is_static == (dynamic == "none")
    assert got.beta_max == want.beta_max
    for omega in OMEGAS:
        assert got.p(omega) == want.p(omega)


def test_theorem1_lr_from_p_equals_reference():
    """``tests/test_system.py:75-79``: the Lemma-6 rate's ``p`` feeds
    Theorem 1's schedule; its values equal the reference's in float32."""
    t, jt = topology.make_topology("ring", 8), jtopo.make_topology("ring", 8)
    omega = 10.0 / (20 * 10)
    p = t.p(omega)
    assert p == jt.p(omega)
    lr = schedule.theorem1_lr(mu=0.1, L=2.0, H=5, p=p)
    jlr = jsched.theorem1_lr(mu=0.1, L=2.0, H=5, p=p)
    for step in (0, 1, 17, 399):
        assert float(lr(step)) == float(jlr(step))


@pytest.mark.parametrize("T,H", [(10, 3), (1, 1), (7, 7), (12, 5)])
def test_periodic_sync_mask_equals_reference(T, H):
    """``tests/test_substrate.py:85-88`` and more sizes: a bool tensor,
    equal to the reference's mask."""
    m = schedule.periodic_sync_mask(T, H)
    assert m.dtype == torch.bool and tuple(m.shape) == (T,)
    np.testing.assert_array_equal(m.numpy(),
                                  np.asarray(jsched.periodic_sync_mask(T, H)))
    if (T, H) == (10, 3):
        assert m.tolist() == [False, False, True] * 3 + [False]
    assert m.tolist() == [schedule.is_sync(t, H) for t in range(T)]


@pytest.mark.parametrize("node", [0, 3])
def test_node_batches_equal_reference(node):
    """``TokenPipeline.node_batches``: step after step the reference's
    batches, each ``batch(node, step)``."""
    kw = dict(vocab_size=97, seq_len=12, batch_per_node=2, n_nodes=4,
              seed=5)
    got = TokenPipeline(**kw).node_batches(node)
    want = JPipe(**kw).node_batches(node)
    for step, (g, w) in enumerate(itertools.islice(zip(got, want), 3)):
        assert g.keys() == w.keys()
        for k in g:
            np.testing.assert_array_equal(g[k], w[k])
            np.testing.assert_array_equal(
                g[k], TokenPipeline(**kw).batch(node, step)[k])
