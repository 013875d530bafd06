"""The spans and counters of the flat engine's train step
(``repro_torch.spans``) on a tiny MoE configuration with a sync every step:
their names and nesting, that tracing off leaves no trace, that tracing
changes no bit of the state, and that the counters equal plain counts; on a
ring of four gloo ranks, one node each, the row exchange's span and byte
counter."""
import dataclasses
from collections import Counter

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs.registry import get_config
from repro_torch.core import schedule, triggers
from repro_torch.dist import comm, sharding
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import moe

STEPS = 2
# every span of the program, with the spans it may lie directly inside
PARENTS = {"sparq.step": {None},
           "sparq.fwd_bwd": {"sparq.step"},
           "model.forward": {"sparq.fwd_bwd"},
           "model.backward": {"sparq.fwd_bwd"},
           # the forward, and the checkpointed recompute inside backward
           "moe.layer": {"model.forward", "model.backward"},
           "moe.route": {"moe.layer"},
           "sparq.local_step": {"sparq.step"},
           "sparq.sync": {"sparq.step"},
           "sparq.sync.diff": {"sparq.sync"},
           "sparq.sync.compress": {"sparq.sync"},
           "sparq.sync.mix": {"sparq.sync"},
           "comm.fetch": {"sparq.sync.mix"},
           "comm.fetch.wait": {"comm.fetch"},
           "sparq.sync.bits": {"sparq.sync"}}


def _run(n=2, on=True, threshold=None, remat=True, blocks=1, mesh=False):
    """STEPS steps at H = 1 of a two-layer MoE (one dense, one MoE layer)
    under the host profiler, with a log of every ``moe.route`` call; with
    ``mesh``, this rank's rows over a ``(node, fsdp 1, model 1)`` mesh of
    the process group. Returns the state, the spans ``(name, start,
    end)``, the counters, the route log ``(slot, cap)`` and the config."""
    cfg = dataclasses.replace(
        get_config("deepseek-moe-16b").reduced(n_layers=2, d_model=64,
                                               vocab=128),
        n_nodes=n, capacity_factor=0.5, compute_dtype="float32", remat=remat,
        moe_route_blocks=blocks)
    dcfg = DistSparqConfig(H=1, variant="ring", frac=0.25, use_kernel=True,
                           lr=schedule.fixed(0.05),
                           threshold=threshold or triggers.zero())
    grid = sharding.train_mesh(make_production_mesh(device_type="cpu"),
                               cfg) if mesh else None
    init_fn, step, _ = build_sparq(cfg, dcfg, device="cpu", mesh=grid)
    state = init_fn()
    rng = np.random.default_rng(0)
    batches = [{k: torch.from_numpy(rng.integers(0, cfg.vocab_size,
                                                 (n, 2, 16)))
                for k in ("tokens", "labels")} for _ in range(STEPS)]
    log = []
    real = moe.route

    def route(cfg_, w, x, **kw):
        out = real(cfg_, w, x, **kw)
        log.append((out[4].clone(), out[3]))
        return out

    moe.route = route
    try:
        P = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[P.CPU]) as prof, \
                spans.enabled(on):
            for b in batches:
                state, _ = step(state, b)
    finally:
        moe.route = real
    marks = [(e.name(), e.start_ns(), e.end_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name() in PARENTS]
    return state, sorted(marks, key=lambda s: (s[1], -s[2])), \
        spans.counters(), log, cfg


def _parent(marks, i):
    """The innermost span that holds span ``i`` (the latest to start)."""
    _, a, b = marks[i]
    held = [j for j, (_, a2, b2) in enumerate(marks)
            if j != i and a2 <= a and b <= b2]
    return marks[max(held, key=lambda j: (marks[j][1], -marks[j][2]))][0] \
        if held else None


@pytest.mark.parametrize("n", [2, 4])
def test_spans_of_a_step_and_their_nesting(n):
    _, marks, _, _, cfg = _run(n)
    names = Counter(name for name, _, _ in marks)
    routings = STEPS * n * (cfg.n_layers - cfg.first_k_dense)
    want = {"sparq.step": STEPS, "sparq.fwd_bwd": STEPS,
            "model.forward": STEPS * n, "model.backward": STEPS * n,
            "moe.layer": 2 * routings, "moe.route": 2 * routings,
            "sparq.local_step": STEPS, "sparq.sync": STEPS,
            "sparq.sync.diff": STEPS, "sparq.sync.compress": STEPS,
            "sparq.sync.mix": STEPS, "sparq.sync.bits": STEPS,
            # one rank holds every row and mixes them in one pass: only a
            # mesh's ranks fetch rows
            "comm.fetch": 0, "comm.fetch.wait": 0}
    assert set(want) == set(PARENTS)
    assert names == Counter({k: v for k, v in want.items() if v})
    for i, (name, _, _) in enumerate(marks):
        assert _parent(marks, i) in PARENTS[name], name


def test_tracing_off_records_no_span_and_no_counter():
    _, marks, counts, _, _ = _run(on=False)
    assert marks == [] and counts == {}


def test_tracing_leaves_the_state_bit_for_bit():
    on, _, _, _, _ = _run(on=True)
    off, _, _, _, _ = _run(on=False)
    assert on.keys() == off.keys()
    for k, v in on.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(v, off[k]), k
        else:
            assert v == off[k], k


@pytest.mark.parametrize("remat,blocks", [(True, 1), (False, 1), (True, 2)])
def test_moe_counters_count_the_forward_routings_once(remat, blocks):
    _, _, counts, log, cfg = _run(remat=remat, blocks=blocks)
    # checkpointed, every routing runs again, alike, in the recompute
    runs = 2 if remat else 1
    assert len(log) == runs * STEPS * 2 * blocks * (cfg.n_layers
                                                    - cfg.first_k_dense)
    dropped = sum(int((slot == cfg.n_experts * cap).sum())
                  for slot, cap in log)
    choices = sum(slot.numel() for slot, _ in log)
    assert counts["moe.dropped"] * runs == dropped > 0
    assert counts["moe.choices"] * runs == choices


@pytest.mark.parametrize("c0", [0.0, 1e30], ids=["all", "none"])
def test_rows_sent_are_the_triggers(c0):
    state, _, counts, _, _ = _run(threshold=triggers.constant(c0))
    assert counts["sparq.rows_compressed"] == STEPS * 2
    assert counts["sparq.rows_sent"] == int(state["triggers"]) == \
        (STEPS * 2 if c0 == 0.0 else 0)


def _ring_rank(rank):
    """One of four gloo ranks, one node each: ``_run``'s steps over the
    mesh, spans on."""
    state, marks, counts, _, _ = _run(n=4, mesh=True)
    return {"marks": marks, "counts": counts,
            "row_bytes": state["params"][0].numel() * 4}


@pytest.fixture(scope="module")
def ring_of_four():
    return comm.spawn(_ring_rank, 4, timeout_s=120.0, deadline_s=120.0)


def test_fetch_bytes_are_four_rows_a_sync_on_a_ring(ring_of_four):
    """Each sync sends the rank's row to both ring neighbours and takes
    theirs (one column chunk at this width): four rows' bytes; one rank
    holding every row exchanges none."""
    for r in ring_of_four:
        assert r["counts"]["comm.fetch_bytes"] == STEPS * 4 * r["row_bytes"]
    _, _, counts, _, _ = _run(n=4)
    assert counts.get("comm.fetch_bytes", 0) == 0


def test_fetch_wait_sits_inside_fetch(ring_of_four):
    for r in ring_of_four:
        marks = r["marks"]
        names = Counter(name for name, _, _ in marks)
        assert names["comm.fetch"] == names["comm.fetch.wait"] == STEPS
        for i, (name, _, _) in enumerate(marks):
            assert _parent(marks, i) in PARENTS[name], name
