"""The port's experiment entry points against the reference: the nonconvex
and momentum experiments (``launch/{nonconvex,momentum}_bits.py`` over
``launch/lm_workload.py``) and the ablation (``launch/ablation_bits.py``)
row by row against the live reference suites' configurations, the convex
experiment's quick rows pinned to ``BENCH_convex.json``, and the port's
examples.

Streams. The committed ``BENCH_*.json`` files were drawn with JAX's
``jax_threefry_partitionable`` off; every comparison here runs both packages
in that layout. The committed nonconvex and momentum losses match neither
layout under jax 0.9.0 (another jax or XLA build drew them), so only their
integer channels (bits, triggers, sync rounds) are pinned to the files; the
losses are held against the live reference.

Tolerances. Bits, triggers and sync rounds exact. The LM rows run with
float32 compute and float32 attention scores in both packages: the
reference's bfloat16 scores round at other points in XLA and PyTorch, and
with momentum 0.9 and lr 0.3 that difference grows over the trajectory. The
recorded losses agree within ``LM_RTOL = 1e-3`` (measured at these sizes:
at most 1.8e-5, and 4.3e-5 for ``sparq``). The momentum-free ``sparq`` row
amplifies rounding differences fastest (past 1e-3 by t = 30), so it is
compared over its first 15 steps. The momentum suite's squarm, choco_mom and
vanilla_mom rows repeat nonconvex rows' configurations, and the
trigger-free SPARQ row triggers wherever the triggered one does, so they
are held equal to those on the port. One row runs the default bfloat16
numerics over 10 steps, losses within ``BF16_RTOL = 1e-2`` (measured
2.5e-3). The ablation's convex losses within ``CONVEX_RTOL = 1e-4``.
"""
import dataclasses
import functools
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import benchmarks.lm_workload as jlw  # noqa: E402
from repro.configs.registry import get_config as jget  # noqa: E402
from repro.core import baselines as jbase  # noqa: E402
from repro.core import engine as jeng  # noqa: E402
from repro.core import sparq as jsparq  # noqa: E402
from repro.core.compression import Sign as JSign  # noqa: E402
from repro.core.compression import SignTopK as JSignTopK  # noqa: E402
from repro.core.compression import TopFrac as JTopFrac  # noqa: E402
from repro.core.schedule import decaying as jdecaying  # noqa: E402
from repro.core.topology import make_topology as jmake_topology  # noqa: E402
from repro.core.triggers import constant as jconstant  # noqa: E402
from repro.core.triggers import piecewise as jpiecewise  # noqa: E402
from repro.core.triggers import zero as jzero  # noqa: E402
from repro.data.synthetic import convex_dataset as jconvex  # noqa: E402
from repro.data.synthetic import logistic_loss_and_grad as jlogistic  # noqa: E402,E501
from repro.models import attention as jattn  # noqa: E402
from repro.optim.sgd import momentum as jmomentum  # noqa: E402
import repro_torch.launch.lm_workload as tlw  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import baselines as tbase  # noqa: E402
from repro_torch.core import engine as teng  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.sparq import make_step as tmake_step  # noqa: E402
from repro_torch.launch import (ablation_bits, convex_bits,  # noqa: E402
                                momentum_bits, nonconvex_bits, suite_io)
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.optim.sgd import momentum as tmomentum  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_RTOL, BF16_RTOL, CONVEX_RTOL = 1e-3, 1e-2, 1e-4
T_LM = 20


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers at once, and their small multi-threaded torch operations slow
    each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def original_stream():
    """Both packages in the committed files' layout."""
    old = jax.config.jax_threefry_partitionable
    jax.config.update("jax_threefry_partitionable", False)
    try:
        with prng.threefry_partitionable(False):
            yield
    finally:
        jax.config.update("jax_threefry_partitionable", old)


def _bench(name):
    with open(os.path.join(ROOT, f"BENCH_{name}.json")) as f:
        return {r["name"]: r for r in json.load(f)["rows"]}


class _Float32:
    """A registry config whose ``reduced()`` computes in float32."""

    def __init__(self, cfg):
        self.cfg = cfg

    def reduced(self, **kw):
        return dataclasses.replace(self.cfg.reduced(**kw),
                                   compute_dtype="float32")


@pytest.fixture(scope="module")
def workloads():
    """(reference, port) quick LM workloads in float32 compute and float32
    scores, cut to T_LM steps recorded every 10, and in the default
    numerics."""
    mp = pytest.MonkeyPatch()
    out = {}
    with prng.threefry_partitionable(False):
        jax.config.update("jax_threefry_partitionable", False)
        out["bfloat16"] = (jlw.make_lm_workload(True),
                           tlw.make_lm_workload(True, "cpu"))
        mp.setattr(jlw, "get_config", lambda n: _Float32(jget(n)))
        mp.setattr(tlw, "get_config", lambda n: _Float32(tget(n)))
        out["float32"] = tuple(
            wl._replace(T=T_LM, rec=10) for wl in
            (jlw.make_lm_workload(True), tlw.make_lm_workload(True, "cpu")))
    mp.undo()
    yield out


@pytest.fixture
def float32_scores(monkeypatch):
    monkeypatch.setattr(jattn, "chunked_attention", functools.partial(
        jattn.chunked_attention, score_dtype=jnp.float32))
    monkeypatch.setattr(tattn, "chunked_attention", functools.partial(
        tattn.chunked_attention, score_dtype=torch.float32))


def _jax_lm_configs(J):
    """The reference suites' own rows (bench_nonconvex.py and
    bench_momentum.py), on the reference workload ``J`` and its T."""
    thr = jpiecewise(2.0, 1.0, every=max(J.T // 6, 1), until=J.T)
    comp = JTopFrac(frac=0.1)
    S = jsparq.SparqConfig
    return {
        "sparq_signtop10_mom": S(topology=J.topo, compressor=comp,
                                 threshold=thr, lr=J.lr, H=5, momentum=0.9),
        "sparq_no_trigger": S(topology=J.topo, compressor=comp,
                              threshold=jzero(), lr=J.lr, H=5, momentum=0.9),
        "choco_sign": S(topology=J.topo, compressor=JSign(),
                        threshold=jzero(), lr=J.lr, H=1, momentum=0.9),
        "choco_top10": S(topology=J.topo, compressor=comp, threshold=jzero(),
                         lr=J.lr, H=1, momentum=0.9),
        "sparq": S(topology=J.topo, compressor=comp, threshold=thr, lr=J.lr,
                   H=5),
        "squarm": jsparq.squarm_config(J.topo, comp, J.lr, H=5,
                                       threshold=thr, beta=0.9),
        "squarm_nesterov": jsparq.squarm_config(
            J.topo, comp, J.lr, H=5, threshold=thr, beta=0.9,
            nesterov=True),
        "choco_mom": jbase.choco_config(J.topo, comp, J.lr,
                                        optimizer=jmomentum(0.9))}


def _port_runner(W, name):
    """(runner, initial state) of one LM row on the port's workload W."""
    if name in ("vanilla_decentralized", "vanilla_mom"):
        opt = tmomentum(0.9)
        return (teng.make_runner(tbase.make_vanilla_step(
            W.topo, W.lr, W.grad_fn, optimizer=opt), W.T, record_every=W.rec,
            eval_fn=W.eval_fn), tbase.init_vanilla(W.flat0, W.n, opt))
    tc = {**nonconvex_bits.configs(W), **momentum_bits.configs(W)}[name]
    return (teng.make_runner(tmake_step(tc, W.grad_fn), W.T,
                             record_every=W.rec, eval_fn=W.eval_fn),
            tc.init_state(W.flat0))


def _run_both(J, W, name):
    """(reference, port) final state and trace of one LM row over J.T."""
    if name in ("vanilla_decentralized", "vanilla_mom"):
        jo = jmomentum(0.9)
        jr = jeng.make_runner(jbase.make_vanilla_step(
            J.topo, J.lr, J.grad_fn, optimizer=jo), J.T, record_every=J.rec,
            eval_fn=J.eval_fn)
        jstate = jbase.init_vanilla(J.flat0, J.n, jo)
    else:
        jc = _jax_lm_configs(J)[name]
        jr = jeng.make_runner(jsparq.make_step(jc, J.grad_fn), J.T,
                              record_every=J.rec, eval_fn=J.eval_fn)
        jstate = jc.init_state(J.flat0)
    tr, tstate = _port_runner(W, name)
    return jr(jstate, jax.random.PRNGKey(1)), tr(tstate, prng.PRNGKey(1))


def _same_channels(jt, tt):
    got, want = tt.to_dict(), jt.to_dict()
    for col in ("t", "sync_rounds", "triggers"):
        assert got[col] == [int(v) for v in want[col]], col
    assert got["bits"] == [float(v) for v in want["bits"]]


LM_ROWS = [("nonconvex", r) for r in (
    "sparq_signtop10_mom", "choco_sign", "choco_top10",
    "vanilla_decentralized")] + [("momentum", r) for r in (
        "sparq", "squarm_nesterov")]
# rows whose trajectory is another row's: the same configuration, or (the
# trigger-free row) a threshold that every node passes at every sync
SAME_ROWS = [("nonconvex", "sparq_no_trigger", "sparq_signtop10_mom"),
             ("momentum", "squarm", "sparq_signtop10_mom"),
             ("momentum", "choco_mom", "choco_top10"),
             ("momentum", "vanilla_mom", "vanilla_decentralized")]


@pytest.mark.parametrize("suite,name", LM_ROWS, ids=lambda v: v)
def test_lm_rows_equal_reference(workloads, float32_scores, suite, name):
    """Each row over T_LM steps: integer channels equal to the reference's
    and to the committed file's trace at the same steps; recorded losses
    within LM_RTOL."""
    J, W = workloads["float32"]
    if name == "sparq":
        J, W = (wl._replace(T=15, rec=5) for wl in (J, W))
    (_, jt), (_, tt) = _run_both(J, W, name)
    _same_channels(jt, tt)
    np.testing.assert_allclose(tt.loss, jt.loss, rtol=LM_RTOL)
    _same_as_committed(tt, suite, name)


def _same_as_committed(tt, suite, name):
    """The trace's integer channels at the committed file's steps."""
    committed = _bench(suite)[name]["trace"]
    cols = ("bits",) if name.startswith("vanilla") else \
        ("bits", "triggers", "sync_rounds")
    got = tt.to_dict()
    at = {t: i for i, t in enumerate(got["t"])}
    shared = [(at[t], j) for j, t in enumerate(committed["t"]) if t in at]
    assert shared
    for col in cols:
        assert [got[col][i] for i, _ in shared] == \
            [committed[col][j] for _, j in shared], col


@pytest.mark.parametrize("suite,name,twin", SAME_ROWS, ids=lambda v: v)
def test_rows_that_repeat_another_row(workloads, float32_scores, suite,
                                      name, twin):
    """SQuARM is SPARQ with momentum 0.9, CHOCO with momentum is
    choco_top10, the vanilla rows are one, and the trigger-free SPARQ row
    sends whenever the triggered one does: on the port each pair's traces
    are equal (the twin is held against the reference above), and the row's
    channels match its committed file."""
    _, W = workloads["float32"]
    tr, st = _port_runner(W, name)
    tt = tr(st, prng.PRNGKey(1))[1]
    tr2, st2 = _port_runner(W, twin)
    assert tt.to_dict() == tr2(st2, prng.PRNGKey(1))[1].to_dict()
    _same_as_committed(tt, suite, name)


def test_lm_row_in_default_numerics(workloads):
    """bfloat16 compute and scores, as the suites run: 10 steps of the
    headline row, channels exact, losses within BF16_RTOL."""
    J, W = (wl._replace(T=10, rec=2) for wl in workloads["bfloat16"])
    (_, jt), (_, tt) = _run_both(J, W, "sparq_signtop10_mom")
    _same_channels(jt, tt)
    np.testing.assert_allclose(tt.loss, jt.loss, rtol=BF16_RTOL)


def test_lm_workload_equals_reference(workloads):
    """x^0 within 4 ulps (the draw's erfinv) and the same ring and LR."""
    for J, W in workloads.values():
        assert W.flat0.shape == J.flat0.shape and W.n == J.n
        np.testing.assert_allclose(W.flat0.numpy(), np.asarray(J.flat0),
                                   rtol=5e-7, atol=1e-9)
        np.testing.assert_array_equal(W.topo.w, J.topo.w)
        for t in (0, 4, 5, 29, 30, 45, 59):
            assert float(W.lr(torch.tensor(t))) == pytest.approx(
                float(J.lr(jnp.asarray(t))), rel=1e-7)


def _jax_ablation(quick=True):
    n, m, f, c = (8, 80, 32, 10) if quick else (20, 200, 128, 10)
    X, Y = jconvex(n, m, n_features=f, n_classes=c, seed=3)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    _, make_grad_fn, full_loss = jlogistic(c)
    return (make_grad_fn(Xj, Yj, 8), lambda xb: full_loss(xb, Xj, Yj),
            jnp.zeros(f * c), jmake_topology("ring", n))


@pytest.mark.parametrize("row", ablation_bits.ROWS, ids=lambda r: r[0])
def test_ablation_rows_equal_reference(row):
    """The full quick row (T = 300): channels equal to the reference's and
    to BENCH_ablation.json, the final loss within CONVEX_RTOL."""
    name, H, k, c0 = row
    n, T, rec, grad_fn, eval_fn, x0 = ablation_bits.problem(True, "cpu")
    cfg = ablation_bits.config(n, H, k, c0)
    st, tt = teng.make_runner(tmake_step(cfg, grad_fn), T, record_every=rec,
                              eval_fn=eval_fn)(cfg.init_state(x0),
                                               prng.PRNGKey(0))
    jgrad, jeval, jx0, jtopo = _jax_ablation()
    jcfg = jsparq.SparqConfig(topology=jtopo, compressor=JSignTopK(k=k),
                              threshold=jconstant(c0) if c0 else jzero(),
                              lr=jdecaying(1.0, 100.0), H=H)
    jst, jt = jeng.make_runner(jsparq.make_step(jcfg, jgrad), T,
                               record_every=rec, eval_fn=jeval)(
        jcfg.init_state(jx0), jax.random.PRNGKey(0))
    _same_channels(jt, tt)
    np.testing.assert_allclose(tt.loss, jt.loss, rtol=CONVEX_RTOL)
    want = _bench("ablation")[f"ablate_{name}"]
    assert (float(st.bits), int(st.triggers), st.sync_rounds) == \
        (want["bits"], want["trigger_events"], want["rounds"])
    final = float(eval_fn(torch.mean(st.x, 0)))
    assert final == pytest.approx(float(jeval(jnp.mean(jst.x, 0))),
                                  rel=CONVEX_RTOL)


def test_convex_quick_rows_equal_committed_file():
    """``launch/convex_bits.py`` quick, in the committed layout: every row's
    bits, triggers and rounds equal BENCH_convex.json's (sparq_signtopk
    8,168 bits and 22 triggers), final losses within the file's rounding."""
    want = _bench("convex")
    rows = convex_bits.run_bench(quick=True, device="cpu")
    assert [r["name"] for r in rows] == list(want)
    for r in rows:
        w = want[r["name"]]
        assert (r["bits"], r["trigger_events"], r["rounds"]) == \
            (w["bits"], w["trigger_events"], w["rounds"]), r["name"]
        assert r["final_loss"] == pytest.approx(w["final_loss"], abs=5e-5)
    assert (rows[0]["bits"], rows[0]["trigger_events"]) == (8168.0, 22)


def test_suite_cli_writes_rows_with_their_layout(tmp_path, monkeypatch):
    out = tmp_path / "runs" / "ablation.json"
    monkeypatch.setattr(ablation_bits, "ROWS", ablation_bits.ROWS[3:4])
    assert ablation_bits.main(["--device", "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["suite"] == "ablation" and doc["quick"]
    assert doc["threefry_partitionable"] is False
    (row,) = doc["rows"]
    assert row["threefry_partitionable"] is False
    assert (row["bits"], row["trigger_events"]) == (126888.0, 477)
    for bad in ("BENCH_ablation.json", str(tmp_path / "BENCH_x.json")):
        with pytest.raises(SystemExit, match="BENCH_"):
            suite_io.parse("x", ["--out", bad])


def _example(module, *args, env_extra=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1", **(env_extra or {}))
    return subprocess.run([sys.executable, "-m", module, *args], env=env,
                          capture_output=True, text=True, timeout=600)


@pytest.mark.parametrize("name", ["quickstart", "squarm_quickstart"])
def test_quickstart_examples_run(name):
    r = _example(f"repro_torch.examples.{name}", "--device", "cpu",
                 env_extra={"REPRO_SMOKE": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    assert "loss" in r.stdout and "bits" in r.stdout


def test_decentralized_lm_example_checkpoints(tmp_path):
    ck = tmp_path / "ck"
    args = ["--device", "cpu", "--steps", "4", "--seq-len", "32",
            "--batch-per-node", "1", "--log-every", "2", "--ckpt-every", "2",
            "--ckpt-dir", str(ck)]
    r = _example("repro_torch.examples.decentralized_lm", *args)
    assert r.returncode == 0, r.stderr[-3000:]
    assert sorted(os.listdir(ck)) == ["step_2", "step_4"]
    r = _example("repro_torch.examples.decentralized_lm", *args, "--resume")
    assert r.returncode == 0, r.stderr[-3000:]
    assert "resumed full train state from step 4" in r.stdout
    assert "DONE no steps run" in r.stdout
