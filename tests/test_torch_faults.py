"""Port parity: fault injection (``repro_torch.core.faults``) against
``repro.core.faults``, both engines under faults against the reference's,
and the fault experiment (``launch/faults_bits.py``) against the JAX
package's own run of it.

Tolerances:
* masks, ``live``, ``deg_eff`` and the repaired ``W_eff``: bit-equal, in
  both of JAX's threefry layouts (``W_eff`` is float32 in both packages and
  its diagonal ``1 - sum(off)`` is added up in the same order);
* the reference engine under faults against the JAX engine: integer
  channels and bits exact, losses and iterates rtol 1e-4 (as
  ``test_torch_engine.py``);
* the experiment's quick rows against ``BENCH_faults.json`` (the
  reference's quick run, drawn from JAX's original threefry stream): bits,
  triggers and sync rounds exactly, the losses to the artifact's 4 digits.
"""
import contextlib
import json
import os

import numpy as np
import pytest
from hypothesis_compat import given, settings, st

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import faults as jf  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import sparq as jsparq  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro.optim.sgd import momentum as jmomentum  # noqa: E402
from repro_torch.core import baselines, compression, prng  # noqa: E402
from repro_torch.core import faults as tf  # noqa: E402
from repro_torch.core import schedule, sparq, topology, triggers  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.launch import faults_bits  # noqa: E402
from repro_torch.optim.sgd import momentum as tmomentum  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N, F, C = 6, 16, 4
D = F * C


@contextlib.contextmanager
def layout(partitionable):
    """Both packages on one threefry layout inside the block."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", partitionable)
    try:
        with prng.threefry_partitionable(partitionable):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


@pytest.fixture(autouse=True)
def same_stream():
    with prng.threefry_partitionable(jax.config.jax_threefry_partitionable):
        yield


def _plans(**kw):
    return jf.FaultPlan(**kw), tf.FaultPlan(**kw)


def _assert_same_masks(W, kw, t, r):
    """Every mask of one plan at (t, r), and its repair of W, bit-equal."""
    jp, tp = _plans(**kw)
    n = W.shape[0]
    W32 = np.asarray(W, np.float32)
    We_j, deg_j, live_j = jp.apply(jnp.asarray(W32), jnp.int32(t),
                                   jnp.int32(r))
    We_t, deg_t, live_t = tp.apply(torch.tensor(W32), t, r)
    assert We_t.dtype == deg_t.dtype == torch.float32
    np.testing.assert_array_equal(We_t.numpy(), np.asarray(We_j))
    np.testing.assert_array_equal(deg_t.numpy(), np.asarray(deg_j))
    np.testing.assert_array_equal(live_t.numpy(), np.asarray(live_j))
    np.testing.assert_array_equal(tp.link_mask(r, n).numpy(),
                                  np.asarray(jp.link_mask(jnp.int32(r), n)))
    np.testing.assert_array_equal(tp.step_mask(t, n).numpy(),
                                  np.asarray(jp.step_mask(jnp.int32(t), n)))
    return We_t, deg_t, live_t


def _assert_repaired_ok(W, W_eff, deg_eff, atol=1e-6):
    """The reference's acceptance property (tests/test_faults.py)."""
    W_eff = W_eff.double().numpy()
    np.testing.assert_allclose(W_eff, W_eff.T, atol=atol)
    np.testing.assert_allclose(W_eff.sum(0), 1.0, atol=atol)
    assert (W_eff >= -atol).all()
    off = W_eff - np.diag(np.diag(W_eff))
    base_off = np.asarray(W) - np.diag(np.diag(np.asarray(W)))
    assert ((off > 0) <= (base_off > 0)).all()
    np.testing.assert_array_equal((off > 0).sum(1), deg_eff.numpy())


MATRICES = [("ring5", lambda: topology.make_topology("ring", 5).w),
            ("complete8", lambda: topology.make_topology("complete", 8).w),
            ("expander12", lambda: topology.make_topology(
                "expander", 12, deg=4, seed=1, mixing="metropolis").w),
            ("matchings8", lambda: topology.make_plan(
                "ring", 8, dynamic="matchings", rounds=3, seed=0).ws[1])]


@pytest.mark.parametrize("partitionable", [True, False])
@pytest.mark.parametrize("name,mat", MATRICES, ids=[m[0] for m in MATRICES])
def test_masks_and_repair_equal_reference(name, mat, partitionable):
    """Fixed seeds over rings, complete graphs, a Metropolis expander and a
    matchings round; three drop rates, several rounds, stragglers and an
    offline node; both threefry layouts."""
    W = mat()
    n = W.shape[0]
    with layout(partitionable):
        for drop in (0.1, 0.5, 0.9):
            for windows in ((), ((0, 0, 100),)):
                kw = dict(link_drop=drop, dropout=windows, seed=3,
                          stragglers=(1, n - 1), straggler_frac=0.5)
                for r in range(3):
                    We, deg, live = _assert_same_masks(W, kw, 5 * r, r)
                    _assert_repaired_ok(W, We, deg)
                    if windows:
                        assert not live[0] and deg[0] == 0.0


@settings(max_examples=12, deadline=None)
@given(n=st.integers(3, 16), drop=st.floats(0.0, 0.9),
       seed=st.integers(0, 1000), r=st.integers(0, 50),
       t=st.integers(0, 200), kind=st.sampled_from(["ring", "complete"]),
       mixing=st.sampled_from(["uniform", "metropolis"]),
       frac=st.floats(0.0, 1.0), offline=st.booleans())
def test_masks_sweep_equal_reference(n, drop, seed, r, t, kind, mixing, frac,
                                     offline):
    W = topology.make_topology(kind, n, mixing=mixing).w
    kw = dict(link_drop=drop, seed=seed, stragglers=(0, n // 2),
              straggler_frac=frac,
              dropout=((n - 1, t // 2, t + 1),) if offline else ())
    We, deg, _ = _assert_same_masks(W, kw, t, r)
    _assert_repaired_ok(W, We, deg)


def test_plan_rules_equal_reference():
    """Validation, the null plan and its resolution, as the reference."""
    for mod in (jf, tf):
        with pytest.raises(ValueError, match="link_drop"):
            mod.FaultPlan(link_drop=1.0)
        with pytest.raises(ValueError, match="straggler_frac"):
            mod.FaultPlan(stragglers=(0,), straggler_frac=1.5)
        with pytest.raises(ValueError, match="stragglers"):
            mod.FaultPlan(straggler_frac=0.5)
        with pytest.raises(ValueError, match="start < end"):
            mod.FaultPlan(dropout=(mod.DropoutWindow(0, 8, 8),))
        with pytest.raises(ValueError, match="out of range"):
            mod.FaultPlan(stragglers=(7,), straggler_frac=0.1).validate_for(4)
        assert mod.resolve_faults(None) is None
        assert mod.resolve_faults(mod.FaultPlan()) is None
        assert mod.resolve_faults(mod.FaultPlan(stragglers=(1, 2))) is None
        assert mod.resolve_faults(mod.FaultPlan(link_drop=0.1)) is not None
    assert tf.COMPRESS_STREAM == jf.COMPRESS_STREAM
    # window tuples are accepted as the reference accepts them
    assert tf.FaultPlan(dropout=((1, 2, 3),)).dropout == \
        (tf.DropoutWindow(1, 2, 3),)
    assert tf.FaultPlan(link_drop=0.2, seed=1) == \
        tf.FaultPlan(link_drop=0.2, seed=1)


def test_gate_update_freezes_node_rows_only():
    act = torch.tensor([True, False, True])
    new = (torch.ones(3, 2), torch.full((3,), 5.0), 7)
    old = (torch.zeros(3, 2), torch.zeros(3), 1)
    got = tf.FaultPlan(link_drop=0.1).gate_update(act, new, old)
    assert torch.equal(got[0], torch.tensor([[1., 1.], [0., 0.], [1., 1.]]))
    assert torch.equal(got[1], torch.tensor([5., 0., 5.])) and got[2] == 7


# ------------------------------------------------- engines under faults


def _problem():
    X, Y = jsyn.convex_dataset(N, 40, n_features=F, n_classes=C, seed=0)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    _, jmake, jfull = jsyn.logistic_loss_and_grad(C)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    _, tmake, tfull = synthetic.logistic_loss_and_grad(C)
    return (jmake(Xj, Yj, 4), lambda xb: jfull(xb, Xj, Yj),
            tmake(Xt, Yt, 4), lambda xb: tfull(xb, Xt, Yt))


def _fault_kw():
    return dict(link_drop=0.3, stragglers=(1,), straggler_frac=0.5,
                dropout=((2, 10, 25),), seed=4)


def _assert_same_run(st_t, tr_t, st_j, tr_j):
    assert len(tr_t) == len(tr_j) > 0
    for a, b in zip(tr_t, tr_j, strict=True):
        assert a[0] == b[0] and a[1] == b[1]
        if len(b) > 3:
            assert (a[3], a[4]) == (b[3], b[4])
        np.testing.assert_allclose(a[2], b[2], rtol=1e-4)
    assert st_t.t == int(st_j.t) and float(st_t.bits) == float(st_j.bits)
    np.testing.assert_allclose(st_t.x.numpy(), np.asarray(st_j.x), rtol=1e-4,
                               atol=1e-6)


@pytest.mark.parametrize("case", ["sgd-ring", "momentum-matchings",
                                  "qsgd-edges", "block-cycle"])
def test_reference_engine_under_faults_equals_reference(case):
    """SPARQ under the golden fault plan, with a zero threshold so every
    live node sends at every sync, on a static ring and on each
    time-varying family; momentum freezes the skipped nodes' buffers;
    QSGD draws its noise through the same keys; BlockTopFrac reaches the
    kernel seam (its plain version on the CPU)."""
    jgrad, jeval, tgrad, teval = _problem()
    comp, plan, beta = {
        "sgd-ring": ("signtopk", dict(kind="ring"), 0.0),
        "momentum-matchings": ("signtopk", dict(dynamic="matchings"), 0.9),
        "qsgd-edges": ("qsgd", dict(kind="complete", dynamic="edges",
                                    edge_frac=0.5), 0.0),
        "block-cycle": ("block", dict(kind="expander", deg=3,
                                      dynamic="cycle"), 0.0)}[case]
    comps = {"signtopk": (compression.SignTopK(k=6), jcomp.SignTopK(k=6)),
             "qsgd": (compression.QSGD(s=8), jcomp.QSGD(s=8)),
             "block": (compression.BlockTopFrac(frac=0.1),
                       jcomp.BlockTopFrac(frac=0.1))}[comp]
    kind = plan.pop("kind", "ring")
    cfgs = []
    for mod, sp, sch, trg, fl, c in (
            (topology, sparq, schedule, triggers, tf, comps[0]),
            (jtopo, jsparq, jsched, jtrig, jf, comps[1])):
        p = mod.make_plan(kind, N, rounds=3, seed=1, **plan)
        opt = dict(momentum=beta) if beta else {}
        cfgs.append(sp.SparqConfig(
            plan=p, compressor=c, threshold=trg.zero(),
            lr=sch.decaying(1.0, 50.0), H=3, gamma=0.3,
            faults=fl.FaultPlan(**_fault_kw()), **opt))
    st_t, tr_t = sparq.run(cfgs[0], tgrad, torch.zeros(D), 45,
                           prng.PRNGKey(1), record_every=9, eval_fn=teval)
    st_j, tr_j = jsparq.run(cfgs[1], jgrad, jnp.zeros(D), 45,
                            jax.random.PRNGKey(1), record_every=9,
                            eval_fn=jeval)
    _assert_same_run(st_t, tr_t, st_j, tr_j)
    assert int(st_t.triggers) == int(st_j.triggers) > 0
    assert st_t.sync_rounds == int(st_j.sync_rounds) == 15


@pytest.mark.parametrize("which", ["choco", "vanilla"])
def test_baselines_under_faults_equal_reference(which):
    jgrad, jeval, tgrad, teval = _problem()
    ring_t, ring_j = (topology.make_topology("ring", N),
                      jtopo.make_topology("ring", N))
    lr_t, lr_j = schedule.decaying(1.0, 50.0), jsched.decaying(1.0, 50.0)
    fp_t, fp_j = tf.FaultPlan(**_fault_kw()), jf.FaultPlan(**_fault_kw())
    kt, kj = prng.PRNGKey(2), jax.random.PRNGKey(2)
    if which == "choco":
        cfg_t = baselines.choco_config(ring_t, compression.SignTopK(k=6),
                                       lr_t, gamma=0.3, faults=fp_t)
        cfg_j = jbase.choco_config(ring_j, jcomp.SignTopK(k=6), lr_j,
                                   gamma=0.3, faults=fp_j)
        st_t, tr_t = sparq.run(cfg_t, tgrad, torch.zeros(D), 40, kt,
                               record_every=10, eval_fn=teval)
        st_j, tr_j = jsparq.run(cfg_j, jgrad, jnp.zeros(D), 40, kj,
                                record_every=10, eval_fn=jeval)
    else:
        st_t, tr_t = baselines.run_generic(
            baselines.make_vanilla_step(ring_t, lr_t, tgrad, momentum=0.9,
                                        faults=fp_t),
            baselines.init_vanilla(torch.zeros(D), N,
                                   tmomentum(0.9)),
            40, kt, record_every=10, eval_fn=teval)
        st_j, tr_j = jbase.run_generic(
            jbase.make_vanilla_step(ring_j, lr_j, jgrad, momentum=0.9,
                                    faults=fp_j),
            jbase.init_vanilla(jnp.zeros(D), N, jmomentum(0.9)),
            40, kj, record_every=10, eval_fn=jeval)
    _assert_same_run(st_t, tr_t, st_j, tr_j)


def test_dropout_window_freezes_node_then_rejoins():
    """An offline node's iterate is frozen for its whole window and moves
    again after it rejoins (``tests/test_faults.py``'s pin, on the port)."""
    b = torch.tensor(np.random.default_rng(2).standard_normal((4, 8)),
                     dtype=torch.float32)
    cfg = sparq.SparqConfig(
        topology=topology.make_topology("ring", 4),
        compressor=compression.SignTopK(k=4), threshold=triggers.zero(),
        lr=schedule.decaying(1.0, 50.0), H=2, gamma=0.3,
        faults=tf.FaultPlan(dropout=(tf.DropoutWindow(1, 4, 12),)))
    step = sparq.make_step(cfg, lambda x, t, k: x - b)
    state, key, snap = cfg.init_state(torch.zeros(8)), prng.PRNGKey(0), {}
    for t in range(16):
        key, sub = prng.split(key)
        state = step(state, sub)
        snap[t + 1] = state.x[1].clone()
    for t in range(5, 13):
        assert torch.equal(snap[t], snap[4])
    assert not torch.equal(snap[13], snap[12])


def test_fault_experiment_equals_reference_run():
    """The quick experiment on the CPU against the reference's quick run,
    committed as BENCH_faults.json; the added BlockTopFrac row is the port's
    own, held to its trigger and bit channels' sanity."""
    with open(os.path.join(ROOT, "BENCH_faults.json")) as f:
        want = {r["name"]: r for r in json.load(f)["rows"]}
    with prng.threefry_partitionable(False):
        rows = faults_bits.run_bench(quick=True, device="cpu")
    got = {r["name"]: r for r in rows}
    assert set(got) == set(want) | {"sparq_mixed_block"}
    for name, w in want.items():
        r = got[name]
        assert (r["bits"], r["trigger_events"], r["sync_rounds"]) == \
            (w["bits"], w["trigger_events"], w["sync_rounds"]), name
        assert (r["link_drop"], r["stragglers"], r["dropout_windows"]) == \
            (w["link_drop"], w["stragglers"], w["dropout_windows"])
        assert r["final_loss"] == pytest.approx(w["final_loss"], abs=1e-4)
        assert r["loss_vs_clean"] == pytest.approx(w["loss_vs_clean"],
                                                   abs=2e-4)
    block = got["sparq_mixed_block"]
    assert block["sync_rounds"] == 80 and 0 < block["trigger_events"] <= 960
    assert 0 < block["bits"] < got["choco_clean"]["bits"]
    assert np.isfinite(block["final_loss"])
