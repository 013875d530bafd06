"""Port parity: the reference engine (``core/engine.py``, ``core/sparq.py``,
``core/baselines.py``), the compressor registry and the convex data, each
against its ``repro`` counterpart on the CPU, with the same numpy-made data
and the same ``jax.random`` keys (the port's ``prng`` draws the same
minibatches and noise).

Tolerances:
* the committed golden traces (``tests/golden/{sparq,squarm,choco,
  sparq_faults}.json``, drawn
  from JAX's original threefry stream, so the port draws from it too): the
  golden test's own, integer channels exact, bits rtol 1e-9, losses and the
  final fingerprint rtol 2e-4;
* port against the JAX engine on the same problem: integer channels and bits
  exact, losses and iterates rtol 1e-4 (the closed-form gradient and the
  matrix products round differently from ``jax.grad`` and XLA's dots, a few
  float32 ulps per step);
* engine against loop within the port, and SQuARM(beta=0) against SPARQ:
  exact, since both sides run the same float32 operations;
* deterministic compressors: selections exact, values rtol 1e-6; stochastic
  ones draw the same noise, so RandK is exact and the quantizers agree to
  rtol 1e-6 (a norm an ulp apart moves no element across a level here).
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import baselines as jbase  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import sparq as jsparq  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro.data import synthetic as jsyn  # noqa: E402
from repro_torch.core import baselines, compression, engine, prng  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import schedule, sparq, topology, triggers  # noqa: E402
from repro_torch.data import synthetic  # noqa: E402
from repro_torch.kernels.sign_topk import sign_topk_blocks  # noqa: E402

GOLDEN_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "golden")
N, F, C = 6, 16, 4
D = F * C
T, REC = 83, 20      # T % REC != 0: the remainder steps run, unrecorded


@pytest.fixture(autouse=True)
def same_stream():
    """The port draws from the threefry stream JAX is set to."""
    with prng.threefry_partitionable(jax.config.jax_threefry_partitionable):
        yield


def _problem(n=N, m=40, f=F, c=C, mb=4):
    """The same convex problem for both packages: (jax grad_fn, jax eval_fn,
    torch grad_fn, torch eval_fn)."""
    X, Y = jsyn.convex_dataset(n, m, n_features=f, n_classes=c, seed=0)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    _, jmake, jfull = jsyn.logistic_loss_and_grad(c)
    Xt, Yt = torch.tensor(X), torch.tensor(Y)
    _, tmake, tfull = synthetic.logistic_loss_and_grad(c)
    return (jmake(Xj, Yj, mb), lambda xb: jfull(xb, Xj, Yj),
            tmake(Xt, Yt, mb), lambda xb: tfull(xb, Xt, Yt))


@pytest.fixture(scope="module")
def problem():
    return _problem()


def _key(seed):
    return prng.PRNGKey(seed), jax.random.PRNGKey(seed)


def _ring_configs(comp_t, comp_j, threshold=("constant", {"c0": 50.0}),
                  H=5, n=N):
    kind, kw = threshold
    cfg_t = sparq.SparqConfig(
        topology=topology.make_topology("ring", n), compressor=comp_t,
        threshold=triggers.make_schedule(kind, **kw),
        lr=schedule.decaying(1.0, 50.0), H=H, gamma=0.3)
    cfg_j = jsparq.SparqConfig(
        topology=jtopo.make_topology("ring", n), compressor=comp_j,
        threshold=jtrig.make_schedule(kind, **kw),
        lr=jsched.decaying(1.0, 50.0), H=H, gamma=0.3)
    return cfg_t, cfg_j


def _assert_same_run(st_t, tr_t, st_j, tr_j, rtol=1e-4):
    assert len(tr_t) == len(tr_j) > 0
    for a, b in zip(tr_t, tr_j, strict=True):
        assert (a[0], a[3], a[4]) == (b[0], b[3], b[4])     # t, rounds, trig
        assert a[1] == b[1]                                 # bits, exact
        np.testing.assert_allclose(a[2], b[2], rtol=rtol)   # loss
    assert st_t.t == int(st_j.t)
    assert int(st_t.triggers) == int(st_j.triggers)
    assert float(st_t.bits) == float(st_j.bits)
    np.testing.assert_allclose(st_t.x.numpy(), np.asarray(st_j.x), rtol=rtol,
                               atol=1e-6)


# ------------------------------------------------------------- data


def test_convex_dataset_equals_reference():
    Xt, Yt = synthetic.convex_dataset(5, 30, n_features=12, n_classes=4,
                                      seed=3)
    Xj, Yj = jsyn.convex_dataset(5, 30, n_features=12, n_classes=4, seed=3)
    np.testing.assert_array_equal(Xt, Xj)
    np.testing.assert_array_equal(Yt, Yj)
    assert Xt.dtype == np.float32 and Yt.dtype == np.int32


def test_logistic_gradient_and_loss_equal_reference(problem):
    """Same key, same minibatch indices: the closed-form gradient equals
    ``jax.grad`` within rtol 1e-5 (different rounding of the same sums)."""
    jgrad, jeval, tgrad, teval = problem
    x = np.random.default_rng(1).standard_normal((N, D)).astype(np.float32)
    for seed in (0, 1, 7):
        kt, kj = _key(seed)
        got = tgrad(torch.tensor(x), 0, kt).numpy()
        want = np.asarray(jgrad(jnp.asarray(x), jnp.int32(0), kj))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(float(teval(torch.tensor(x[0]))),
                               float(jeval(jnp.asarray(x[0]))), rtol=1e-6)


# ----------------------------------------------------- golden traces


def _golden_config(name):
    topo = topology.make_topology("ring", N)
    lr = schedule.decaying(1.0, 50.0)
    comp = compression.SignTopK(k=6)
    thr = triggers.piecewise(30.0 * D, 30.0 * D, every=10, until=60)
    if name == "sparq":
        return sparq.SparqConfig(topology=topo, compressor=comp,
                                 threshold=thr, lr=lr, H=5, gamma=0.3)
    if name == "choco":
        return baselines.choco_config(topo, comp, lr, gamma=0.3)
    if name == "sparq_faults":
        return sparq.SparqConfig(
            topology=topo, compressor=comp, threshold=thr, lr=lr, H=5,
            gamma=0.3, faults=tfaults.FaultPlan(
                link_drop=0.3, stragglers=(1,), straggler_frac=0.5,
                dropout=(tfaults.DropoutWindow(2, 10, 25),), seed=4))
    return sparq.squarm_config(topo, comp, lr, H=5, threshold=thr, beta=0.9,
                               nesterov=True, gamma=0.3)


@pytest.mark.parametrize("case", ["sparq", "squarm", "choco",
                                  "sparq_faults"])
def test_port_reproduces_golden_trace(case):
    """The golden harness of tests/test_golden_traces.py (n=6, d=64, T=60,
    record every 10) run by the port, at the golden tolerances; the fault
    case draws its link, straggler and dropout masks from the port's own
    FaultPlan."""
    with open(os.path.join(GOLDEN_DIR, f"{case}.json")) as f:
        want = json.load(f)
    _, _, tgrad, teval = _problem()
    with prng.threefry_partitionable(False):
        state, trace = sparq.run(_golden_config(case), tgrad, torch.zeros(D),
                                 want["T"], prng.PRNGKey(0),
                                 record_every=want["record_every"],
                                 eval_fn=teval)
    got = trace.to_dict()
    for col in ("t", "sync_rounds", "triggers"):
        assert got[col] == want["trace"][col]
    np.testing.assert_allclose(got["bits"], want["trace"]["bits"], rtol=1e-9)
    np.testing.assert_allclose(got["loss"], want["trace"]["loss"], rtol=2e-4,
                               atol=1e-6)
    xbar = torch.mean(state.x, dim=0).double().numpy()
    fin = want["final"]
    assert state.sync_rounds == fin["sync_rounds"]
    assert int(state.triggers) == fin["triggers"]
    np.testing.assert_allclose(float(state.bits), fin["bits"], rtol=1e-9)
    np.testing.assert_allclose(np.linalg.norm(xbar), fin["x_bar_norm"],
                               rtol=2e-4)
    np.testing.assert_allclose(xbar[:4], fin["x_bar_head"], rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(xbar[-4:], fin["x_bar_tail"], rtol=2e-4,
                               atol=1e-6)


# ------------------------------------- the port against the JAX engine


@pytest.mark.parametrize("name", ["signtopk", "block", "qsgd", "randk",
                                  "qstopk"])
def test_engine_equals_reference_engine(name):
    """SPARQ with a zero threshold (every node triggers at every sync, so
    the compressor runs on every message) on a problem of d = 1280: two
    1024-tiles for BlockTopFrac, whose second tile is ragged."""
    f, c = 64, 20
    jgrad, jeval, tgrad, teval = _problem(f=f, c=c)
    comps = {"signtopk": (compression.SignTopK(k=40), jcomp.SignTopK(k=40)),
             "block": (compression.BlockTopFrac(frac=0.1),
                       jcomp.BlockTopFrac(frac=0.1)),
             "qsgd": (compression.QSGD(s=16), jcomp.QSGD(s=16)),
             "randk": (compression.RandK(k=64), jcomp.RandK(k=64)),
             "qstopk": (compression.QsTopK(k=64, s=8),
                        jcomp.QsTopK(k=64, s=8))}
    cfg_t, cfg_j = _ring_configs(*comps[name], threshold=("zero", {}))
    kt, kj = _key(4)
    before = sign_topk_blocks.launches
    st_t, tr_t = sparq.run(cfg_t, tgrad, torch.zeros(f * c), 40, kt,
                           record_every=10, eval_fn=teval)
    st_j, tr_j = jsparq.run(cfg_j, jgrad, jnp.zeros(f * c), 40, kj,
                            record_every=10, eval_fn=jeval)
    _assert_same_run(st_t, tr_t, st_j, tr_j)
    assert int(st_t.triggers) == N * 8
    assert sign_topk_blocks.launches == before   # CPU: no kernel launches


@pytest.mark.parametrize("which", ["choco", "vanilla", "central"])
def test_baselines_equal_reference(problem, which):
    jgrad, jeval, tgrad, teval = problem
    kt, kj = _key(2)
    if which == "choco":
        lr_t, lr_j = schedule.decaying(1.0, 50.0), jsched.decaying(1.0, 50.0)
        cfg_t = baselines.choco_config(topology.make_topology("ring", N),
                                       compression.SignTopK(k=6), lr_t,
                                       gamma=0.3)
        cfg_j = jbase.choco_config(jtopo.make_topology("ring", N),
                                   jcomp.SignTopK(k=6), lr_j, gamma=0.3)
        st_t, tr_t = sparq.run(cfg_t, tgrad, torch.zeros(D), T, kt,
                               record_every=REC, eval_fn=teval)
        st_j, tr_j = jsparq.run(cfg_j, jgrad, jnp.zeros(D), T, kj,
                                record_every=REC, eval_fn=jeval)
        _assert_same_run(st_t, tr_t, st_j, tr_j)
        return
    lr_t, lr_j = schedule.decaying(1.0, 50.0), jsched.decaying(1.0, 50.0)
    if which == "vanilla":
        step_t = baselines.make_vanilla_step(
            topology.make_topology("ring", N), lr_t, tgrad)
        step_j = jbase.make_vanilla_step(jtopo.make_topology("ring", N),
                                         lr_j, jgrad)
        s0_t = baselines.init_vanilla(torch.zeros(D), N)
        s0_j = jbase.init_vanilla(jnp.zeros(D), N)
    else:
        step_t = baselines.make_central_step(N, lr_t, tgrad)
        step_j = jbase.make_central_step(N, lr_j, jgrad)
        s0_t = baselines.init_central(torch.zeros(D))
        s0_j = jbase.init_central(jnp.zeros(D))
    st_t, tr_t = baselines.run_generic(step_t, s0_t, T, kt, record_every=REC,
                                       eval_fn=teval)
    st_j, tr_j = jbase.run_generic(step_j, s0_j, T, kj, record_every=REC,
                                   eval_fn=jeval)
    assert [r[0] for r in tr_t] == [r[0] for r in tr_j]
    assert [r[1] for r in tr_t] == [r[1] for r in tr_j]
    np.testing.assert_allclose([r[2] for r in tr_t], [r[2] for r in tr_j],
                               rtol=1e-4)
    np.testing.assert_allclose(st_t.x.numpy(), np.asarray(st_j.x), rtol=1e-4,
                               atol=1e-6)


# ------------------------------------ the equalities of tests/test_engine.py


def _assert_traces_equal(tr_engine, tr_loop):
    assert len(tr_engine) == len(tr_loop) > 0
    for e, lp in zip(tr_engine, tr_loop, strict=True):
        assert tuple(e[:len(lp)]) == tuple(lp)


@pytest.mark.parametrize("beta", [None, 0.9])
def test_run_equals_loop_sparq_and_squarm(problem, beta):
    _, _, tgrad, teval = problem
    topo = topology.make_topology("ring", N)
    lr = schedule.decaying(1.0, 50.0)
    if beta is None:
        cfg = sparq.SparqConfig(topology=topo,
                                compressor=compression.SignTopK(k=6),
                                threshold=triggers.constant(50.0), lr=lr, H=5,
                                gamma=0.3)
    else:
        cfg = sparq.squarm_config(topo, compression.SignTopK(k=6), lr, H=5,
                                  threshold=triggers.constant(50.0),
                                  beta=beta, nesterov=True, gamma=0.3)
    key = prng.PRNGKey(3)
    st_e, tr_e = sparq.run(cfg, tgrad, torch.zeros(D), T, key,
                           record_every=REC, eval_fn=teval)
    st_l, tr_l = sparq.run_loop(cfg, tgrad, torch.zeros(D), T, key,
                                record_every=REC, eval_fn=teval)
    _assert_traces_equal(tr_e, tr_l)
    assert len(tr_e) == T // REC
    assert torch.equal(st_e.x, st_l.x) and st_e.t == st_l.t == T
    assert st_e.sync_rounds == st_l.sync_rounds
    assert int(st_e.triggers) == int(st_l.triggers) > 0
    assert torch.equal(sparq.run_scan(cfg, tgrad, torch.zeros(D), T, key).x,
                       st_e.x)


@pytest.mark.parametrize("which", ["vanilla", "central"])
def test_run_equals_loop_baselines(problem, which):
    _, _, tgrad, teval = problem
    lr = schedule.decaying(1.0, 50.0)
    if which == "vanilla":
        step = baselines.make_vanilla_step(topology.make_topology("ring", N),
                                           lr, tgrad)

        def init():
            return baselines.init_vanilla(torch.zeros(D), N)
    else:
        step = baselines.make_central_step(N, lr, tgrad)

        def init():
            return baselines.init_central(torch.zeros(D))
    key = prng.PRNGKey(1)
    st_e, tr_e = baselines.run_generic(step, init(), T, key,
                                       record_every=REC, eval_fn=teval)
    st_l, tr_l = baselines.run_generic_loop(step, init(), T, key,
                                            record_every=REC, eval_fn=teval)
    _assert_traces_equal(tr_e, tr_l)
    assert torch.equal(st_e.x, st_l.x)


def test_squarm_momentum_zero_is_sparq(problem):
    _, _, tgrad, teval = problem
    topo = topology.make_topology("ring", N)
    lr = schedule.decaying(1.0, 50.0)
    cfg_p = sparq.SparqConfig(topology=topo,
                              compressor=compression.SignTopK(k=6),
                              threshold=triggers.constant(50.0), lr=lr, H=5,
                              gamma=0.3)
    cfg_q = sparq.squarm_config(topo, compression.SignTopK(k=6), lr, H=5,
                                threshold=triggers.constant(50.0), beta=0.0,
                                gamma=0.3)
    key = prng.PRNGKey(0)
    st_p, tr_p = sparq.run(cfg_p, tgrad, torch.zeros(D), T, key,
                           record_every=REC, eval_fn=teval)
    st_q, tr_q = sparq.run(cfg_q, tgrad, torch.zeros(D), T, key,
                           record_every=REC, eval_fn=teval)
    _assert_traces_equal(tr_q, tr_p)
    assert torch.equal(st_q.x, st_p.x) and torch.equal(st_q.x_hat,
                                                       st_p.x_hat)
    assert float(st_q.bits) == float(st_p.bits)
    assert st_q.opt.shape == st_q.x.shape and st_p.opt == ()


def test_trace_object_tuple_compat():
    tr = engine.Trace([10, 20], [1.0, 2.0], [0.5, 0.25], [2, 4], [3, 6])
    assert len(tr) == 2
    assert tr[-1] == (20, 2.0, 0.25, 4, 6)
    assert [r[0] for r in tr] == [10, 20] and tr[:1] == [tr[0]]
    d = tr.to_dict()
    assert d["t"] == [10, 20] and d["loss"] == [0.5, 0.25]
    assert len(engine.Trace.empty()) == 0


def test_no_trace_without_eval_fn_and_timed_run(problem):
    _, _, tgrad, teval = problem
    cfg = sparq.SparqConfig(topology=topology.make_topology("ring", N),
                            compressor=compression.SignTopK(k=6),
                            lr=schedule.decaying(1.0, 50.0), H=5, gamma=0.3)
    st, tr = sparq.run(cfg, tgrad, torch.zeros(D), 10, prng.PRNGKey(0),
                       record_every=5)
    assert len(tr) == 0 and st.t == 10
    runner = engine.make_runner(sparq.make_step(cfg, tgrad), T,
                                record_every=REC, eval_fn=teval)
    st, tr, us, mem = engine.timed_run(
        runner, lambda: cfg.init_state(torch.zeros(D)), prng.PRNGKey(0), T)
    assert st.t == T and len(tr) == T // REC and us > 0
    assert mem is None        # peak device memory is read on the card only


def test_step_leaves_its_input_state_alone(problem):
    _, _, tgrad, _ = problem
    cfg = sparq.squarm_config(topology.make_topology("ring", N),
                              compression.SignTopK(k=6),
                              schedule.decaying(1.0, 50.0), H=1, beta=0.9,
                              gamma=0.3)
    s0 = cfg.init_state(torch.ones(D))
    copies = [s0.x.clone(), s0.x_hat.clone(), s0.opt.clone()]
    step = sparq.make_step(cfg, tgrad)
    s1 = step(s0, prng.PRNGKey(0))
    for a, b in zip((s0.x, s0.x_hat, s0.opt), copies, strict=True):
        assert torch.equal(a, b)
    assert s1.sync_rounds == 1 and not torch.equal(s1.x, s0.x)


def test_unported_options_raise():
    """What the reference engine refuses: a config with both ``topology=``
    and ``plan=``, gamma* without the dimension, and a fault plan naming a
    node outside the ensemble raise as the reference's do."""
    for sp, tp, fl in ((sparq, topology, tfaults), (jsparq, jtopo, jfaults)):
        ring = tp.make_topology("ring", 4)
        with pytest.raises(ValueError, match="not both"):
            sp.SparqConfig(topology=ring,
                           plan=tp.GossipPlan.from_topology(ring)).n
        with pytest.raises(ValueError, match="dimension"):
            sp.SparqConfig(topology=ring).resolved_gamma()
        bad = fl.FaultPlan(stragglers=(7,), straggler_frac=0.5)
        with pytest.raises(ValueError, match="out of range"):
            sp.make_step(sp.SparqConfig(topology=ring, faults=bad),
                         lambda x, t, k: x)


# ------------------------------------------------- the compressor registry


REGISTRY = [("identity", {}), ("topk", {"k": 10}), ("randk", {"k": 10}),
            ("sign", {}), ("qsgd", {"s": 16}), ("qsgd", {"s": 4,
                                                         "scaled": False}),
            ("signtopk", {"k": 10}), ("qstopk", {"k": 10, "s": 8}),
            ("signtop_frac", {"frac": 0.1}),
            ("signtopk_block", {"frac": 0.1})]


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("name,kw", REGISTRY,
                         ids=[f"{n}-{kw}" for n, kw in REGISTRY])
def test_registry_operator_equals_reference(name, kw, ties):
    """Every operator on a (6, 300) batch, one key per row from split(key,
    6) (the reference vmaps over the rows). ``ties`` puts the values on a
    coarse grid, so Top-k selections must break ties by the lowest index as
    ``lax.top_k`` does."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((6, 300)).astype(np.float32)
    if ties:
        x = np.round(x * 2.0) / 2.0
    c_t = compression.make_compressor(name, **kw)
    c_j = jcomp.make_compressor(name, **kw)
    kt, kj = _key(9)
    got = c_t(torch.tensor(x), prng.split(kt, 6)).numpy()
    want = np.asarray(jax.vmap(c_j)(jnp.asarray(x), jax.random.split(kj, 6)))
    np.testing.assert_array_equal(got != 0, want != 0)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert c_t.deterministic == c_j.deterministic
    for d in (1, 300, 7840):
        assert c_t.bits(d) == c_j.bits(d)
        assert c_t.omega(d) == c_j.omega(d)


def test_compress_tree_and_payload_bits_equal_reference():
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((8, 40)).astype(np.float32),
            "b": rng.standard_normal(40).astype(np.float32),
            "h": [rng.standard_normal((3, 7)).astype(np.float32)]}
    tree_t = {"w": torch.tensor(tree["w"]), "b": torch.tensor(tree["b"]),
              "h": [torch.tensor(tree["h"][0])]}
    tree_j = jax.tree.map(jnp.asarray, tree)
    kt, kj = _key(5)
    for name, kw in (("qsgd", {"s": 16}), ("topk", {"k": 5})):
        c_t = compression.make_compressor(name, **kw)
        c_j = jcomp.make_compressor(name, **kw)
        got = compression.compress_tree(c_t, tree_t, kt)
        want = jcomp.compress_tree(c_j, tree_j, kj)
        for a, b in zip(compression.tree_leaves(got), jax.tree.leaves(want),
                        strict=True):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)
        assert compression.tree_payload_bits(c_t, tree_t) == \
            jcomp.tree_payload_bits(c_j, tree_j)
    assert compression.compress_tree(compression.TopK(k=3), {}) == {}


def test_registry_refusals():
    with pytest.raises(ValueError):
        compression.make_compressor("nope")
    with pytest.raises(ValueError):
        compression.make_compressor("signtop_frac", k=32)
    with pytest.raises(ValueError, match="key"):
        compression.QSGD()(torch.zeros(3, 8))
    with pytest.raises(ValueError, match="one key per vector"):
        compression.RandK(k=2)(torch.zeros(3, 8), prng.PRNGKey(0))
