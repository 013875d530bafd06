"""The cell whose nodes each have a card of their own (runner
``node_per_card``), on the CPU over four gloo ranks at a test run's size:
the plain reference of one node a rank against the one-process reference,
the runner's sound run correct and each planted fault caught, its readers
of the traced exchange on a recorded fixture, and its refusal, before it
spawns anything, of a program that lacks what it reads."""
import json
import time

import pytest
from conftest import ROOT, SMALL, tiny_cell

from harness import cell as program
from harness import rows, spec, traffic

CELL = "dsmoe16b-d7n4.train4"
SEED = 3_000_000_011
FIXTURE = ROOT / "bench" / "tests" / "data" / \
    "dsmoe16b-d7n4.train4.record.json"


def _node_rank(rank, c, seed, precision):
    """This rank's node of the plain reference over the default group."""
    import torch.distributed as dist
    pipe = traffic.pipeline(c.workload, int(c.config["vocab_size"]),
                            c.n_nodes, seed)
    batches = [pipe.batch(rank, t)
               for t in range(program.compared_steps(c.H) + c.H)]
    engine = spec.module("engines", c.config["engine"]["reference"])
    return engine.run_node(c.config, c.workload, seed, batches, "cpu",
                           precision, dist.group.WORLD)


def _close(got, want, rel):
    """Nested lists of floats and tensors, each within ``rel`` of the
    largest magnitude beside it."""
    import torch
    if isinstance(want, list):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _close(g, w, rel)
    elif isinstance(want, torch.Tensor):
        assert float((got - want).abs().max()) <= \
            rel * float(want.abs().max()) + 1e-30
    else:
        assert abs(got - want) <= rel * abs(want) + 1e-30


@pytest.mark.parametrize("precision", ["float32", "fp8"])
def test_node_a_rank_equals_one_process(precision):
    """Two syncs: bits and triggers as one process gives them; the losses,
    gradients, x, x_hat and the mixing's readings within float32 rounding
    (each backward takes the blocks again one at a time, and a rank mixes
    with its row of the mixing product: other summation orders)."""
    from repro_torch.dist import comm
    c = tiny_cell(CELL, sizes=SMALL, seq_len=16)
    parts = comm.spawn(_node_rank, 4, (c, SEED, precision),
                       timeout_s=240.0, deadline_s=240.0)
    got = rows.merge(parts, own=True)
    pipe = traffic.pipeline(c.workload, int(c.config["vocab_size"]),
                            c.n_nodes, SEED)
    steps = program.compared_steps(c.H) + c.H
    base = spec.module("engines", "sparq_ring_sgd")
    want = base.run(c.config, c.workload, SEED,
                    [pipe.global_batch(t) for t in range(steps)], "cpu",
                    precision)
    assert want["triggers"] == 8
    for key in ("bits", "triggers", "leaves"):
        assert got[key] == want[key], key
    for key in ("losses", "grad0", "grad0_s", "change", "change_s", "xhat",
                "xhat_s", "mix_norm"):
        _close(got[key], want[key], 1e-5)
    _close(got["mix"], want["mix"], 1e-3)


def _run(**faults):
    c = tiny_cell(CELL, compute_dtype="float32")
    runner = spec.module("runners", c.workload["runner"])
    return runner.run(c, SEED, 0.05, False, "cpu", time.perf_counter(),
                      program.Faults(**faults))


def test_sound_run_is_correct(float32_scores):
    out = _run()
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 3
    assert out["phases"]["ranks_agree"]
    # every rank's sync sends its row to both neighbours and takes theirs
    assert out["phases"]["fetched_bytes_per_sync"] == \
        [4 * out["phases"]["row_bytes"]] * 4
    assert set(out["metrics"]) == {"tokens_per_s", "sync_step_ms",
                                   "peak_mem_gb", "setup_s"}


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_mixing"])
def test_fault_is_caught(fault, float32_scores):
    out = _run(**{fault: True})
    assert not out["correct"], out["checks"]
    if fault == "no_mixing":
        assert 0.99 < out["checks"]["mix_gap"]["value"] <= 1.0


def test_readers_on_a_recorded_trace():
    """The three readers on the ranks' records of a traced run on the
    cards (``--trace 1``), against their formulas worked out here."""
    record = json.loads(FIXTURE.read_text())
    ranks = record["ranks"]
    fetch = spec.reader("comm.fetch_ms")(record)
    assert fetch == max(1e3 * r["span_device_s"]["inclusive"]["comm.fetch"]
                        / r["named_syncs"] for r in ranks)
    link = spec.reader("comm.link_pct")(record)
    assert link == min(
        100.0 * r["counters"]["comm.fetch_bytes"] / r["named_syncs"]
        / (r["span_device_s"]["inclusive"]["comm.fetch.wait"]
           / r["named_syncs"]) / 900e9 for r in ranks)
    assert 0.0 < link <= 100.0
    mfu = spec.reader("mesh.mfu_pct")(record)
    assert mfu == pytest.approx(
        100.0 * record["flops_per_token"] * record["tokens_per_step"]
        * ranks[0]["profiled_steps"] / max(r["window_s"] for r in ranks)
        / (len(ranks) * 989e12))
    assert mfu > 0.0
    # a record without the program's spans and counters reads nothing
    bare = {"ranks": [{k: v for k, v in r.items()
                       if k not in ("span_device_s", "counters", "kernels")}
                      for r in ranks]}
    for m in ("comm.fetch_ms", "comm.link_pct", "mesh.mfu_pct"):
        assert spec.reader(m)(bare) is None


def test_runner_refuses_a_program_without_the_exchange_counter(monkeypatch):
    from repro_torch.dist import comm
    spawned = []
    monkeypatch.delattr(comm, "FETCH_BYTES")
    monkeypatch.setattr(comm, "spawn", lambda *a, **k: spawned.append(a))
    c = tiny_cell(CELL)
    runner = spec.module("runners", c.workload["runner"])
    t0 = time.perf_counter()
    with pytest.raises(SystemExit) as exit_:
        runner.run(c, SEED, 0.05, False, "cpu", time.perf_counter())
    assert exit_.value.code not in (0, None)
    assert spawned == [] and time.perf_counter() - t0 < 5.0


def test_runner_refuses_a_program_without_a_field_the_config_sets(
        monkeypatch):
    from repro_torch.dist import comm
    spawned = []
    monkeypatch.setattr(comm, "spawn", lambda *a, **k: spawned.append(a))
    c = tiny_cell(CELL)
    c.config["port"]["fields"]["no_such_field"] = "rms_norm_eps"
    runner = spec.module("runners", c.workload["runner"])
    with pytest.raises(SystemExit, match="no_such_field") as exit_:
        runner.run(c, SEED, 0.05, False, "cpu", time.perf_counter())
    assert exit_.value.code not in (0, None)
    assert spawned == []


@pytest.mark.parametrize("name,eps", [(CELL, 1e-6),
                                      ("dsmoe16b-d2n4.train", 1e-5)])
def test_program_and_reference_take_the_configs_norm_eps(name, eps):
    """The four-card configuration runs ``rms_norm_eps`` as published: the
    program's norms take it as ``norm_eps`` and the plain reference as its
    own; ``dsmoe16b-d2n4`` keeps the port's default, 1e-5."""
    c = spec.cell(name, ROOT)
    cfg, _ = program.program_configs(c.config, c.H)
    ref = spec.module("references", c.config["reference"]).sizes(c.config)
    assert cfg.norm_eps == ref.eps == eps
