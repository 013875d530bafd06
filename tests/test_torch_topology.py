"""Port parity: the time-varying gossip plans of ``repro_torch.core.topology``
(random matchings, edge-sampled subgraphs, a cycle over a graph list, and
``make_plan(dynamic=...)``) against ``repro.core.topology``, and the
topology experiment (``launch/topology_bits.py``) against the JAX package's
own run of it.

Tolerances: the plans are numpy in both packages, so the matrices, the
per-round degrees, R and the names are equal exactly, and so are the
spectral quantities (the same float64 numpy on the same matrices); a
support that is disconnected in expectation is refused by both. The
experiment's quick rows equal ``BENCH_topology.json``'s (the reference's
quick run, drawn from JAX's original threefry stream): bits, triggers and
sync rounds exactly, the rounded columns to their last digit.
"""
import json
import os

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

pytest.importorskip("torch")

from repro.core import topology as jtopo  # noqa: E402
from repro_torch.core import prng, topology  # noqa: E402
from repro_torch.launch import topology_bits  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _assert_same_plan(got, want):
    np.testing.assert_array_equal(got.ws, want.ws)
    assert (got.R, got.n, got.name) == (want.R, want.n, want.name)
    np.testing.assert_array_equal(got.degrees, want.degrees)
    np.testing.assert_array_equal(got.w_bar, want.w_bar)
    assert got.delta_eff == want.delta_eff
    for omega in (1e-3, 0.1, 0.5):
        assert got.gamma_star(omega) == want.gamma_star(omega)
    for r in range(2 * got.R):
        np.testing.assert_array_equal(got.round_topology(r).w,
                                      want.round_topology(r).w)


def _both(build):
    """``build(module)`` in both packages: the same plan, or the same
    refusal (a support disconnected in expectation)."""
    try:
        want = build(jtopo)
    except ValueError as e:
        with pytest.raises(ValueError, match="expectation"):
            build(topology)
        assert "expectation" in str(e)
        return None
    got = build(topology)
    _assert_same_plan(got, want)
    return got


@pytest.mark.parametrize("n,rounds,seed", [(8, 3, 2), (4, 1, 0), (16, 5, 7),
                                           (4, 3, 2), (12, 4, 0)])
def test_matchings_equal_reference(n, rounds, seed):
    _both(lambda m: m.GossipPlan.matchings(n, rounds=rounds, seed=seed))


@pytest.mark.parametrize("kind", ["ring", "complete", "expander"])
@pytest.mark.parametrize("p,seed", [(0.5, 0), (0.3, 11), (1.0, 3)])
def test_edge_sampled_equal_reference(kind, p, seed):
    for mixing in ("uniform", "metropolis"):
        _both(lambda m: m.GossipPlan.edge_sampled(
            m.make_topology(kind, 12, deg=4, seed=seed), rounds=6, p=p,
            seed=seed, mixing=mixing))


def test_cycle_equal_reference():
    plan = _both(lambda m: m.GossipPlan.cycle(
        [m.make_topology("ring", 16), m.make_topology("torus2d", 16)]))
    assert plan.R == 2
    np.testing.assert_array_equal(plan.round_topology(3).w,
                                  topology.make_topology("torus2d", 16).w)


@pytest.mark.parametrize("dynamic", ["none", "matchings", "edges", "cycle"])
@pytest.mark.parametrize("kind,n,deg", [("expander", 16, 4), ("ring", 8, 2),
                                        ("torus2d", 16, 4)])
def test_make_plan_equals_reference(dynamic, kind, n, deg):
    for mixing in ("uniform", "metropolis"):
        _both(lambda m: m.make_plan(kind, n, deg=deg, seed=1,
                                    mixing=mixing, dynamic=dynamic,
                                    rounds=4, edge_frac=0.6))


@settings(max_examples=15, deadline=None)
@given(n=st.sampled_from([4, 8, 12, 16]), rounds=st.integers(1, 6),
       seed=st.integers(0, 1000))
def test_matchings_sweep_equal_reference(n, rounds, seed):
    _both(lambda m: m.GossipPlan.matchings(n, rounds=rounds, seed=seed))


@settings(max_examples=15, deadline=None)
@given(kind=st.sampled_from(["ring", "complete", "expander"]),
       p=st.floats(0.3, 1.0), seed=st.integers(0, 1000))
def test_edge_sampled_sweep_equal_reference(kind, p, seed):
    _both(lambda m: m.GossipPlan.edge_sampled(
        m.make_topology(kind, 12, deg=4, seed=seed), rounds=6, p=p,
        seed=seed))


def test_round_validation_allows_a_disconnected_round():
    half = np.eye(4)
    half[0, 0] = half[1, 1] = half[0, 1] = half[1, 0] = 0.5
    for m in (topology, jtopo):
        m.Topology(w=half).validate(require_connected=False)
        with pytest.raises(ValueError, match="disconnected"):
            m.Topology(w=half).validate()
        with pytest.raises(ValueError, match="expectation"):
            m.GossipPlan(ws=half[None], name="one-edge").validate()
        with pytest.raises(ValueError, match="rounds"):
            m.GossipPlan.matchings(8, rounds=0)


def test_topology_experiment_equals_reference_run():
    """The quick experiment on the CPU against the reference's quick run,
    committed as BENCH_topology.json."""
    with open(os.path.join(ROOT, "BENCH_topology.json")) as f:
        want = {r["name"]: r for r in json.load(f)["rows"]}
    with prng.threefry_partitionable(False):
        rows = topology_bits.run_bench(quick=True, device="cpu")
    assert [r["name"] for r in rows] == list(want)
    for r in rows:
        w = want[r["name"]]
        assert (r["bits"], r["trigger_events"], r["rounds"],
                r["plan_rounds"]) == (w["bits"], w["trigger_events"],
                                      w["rounds"], w["plan_rounds"])
        assert round(r["delta"], 4) == w["delta"]
        assert round(r["gamma_star"], 5) == w["gamma_star"]
        assert r["final_loss"] == pytest.approx(w["final_loss"], abs=1e-4)
        assert r["consensus_err"] == pytest.approx(w["consensus_err"],
                                                   abs=1e-4)
