"""A run of the harness with the timed path broken underneath comes out
not correct, under each cell's own limits: a step that hands its state
back unchanged, half of each node's batch left out (the mean taken over
the rest), the sync's mixing between the nodes left out, and the control
(the plain reference in float8 e4m3 in the program's place). The same run
with nothing broken comes out correct.

The harness runs here on the CPU at a tiny size, past its look for a
card, with the program's products in float32 so that the sound run lies
at rounding. Every cell has one chip: the exchange between its nodes is
the mixing on that card (``no_mixing``); no exchange between chips can be
left out."""
import time

import pytest
from conftest import SMALL, tiny_cell

from harness import cell as program
from harness import compare, reference, spec, traffic

CELLS = ["dsmoe16b-d2n4.train", "stablelm1.6b-n2.train",
         "dsmoe16b-d2n4.sync"]
SEED = 3_000_000_011


def run(name, **faults):
    c = tiny_cell(name, compute_dtype="float32")
    runner = spec.module("runners", c.workload["runner"])
    return runner.run(c, SEED, 0.05, False, "cpu", time.perf_counter(),
                      program.Faults(**faults))


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name, float32_scores):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["failed"] == 0 and out["attempted"] >= 1


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "no_mixing"])
@pytest.mark.parametrize("name", CELLS)
def test_fault_is_caught(name, fault, float32_scores):
    out = run(name, **{fault: True})
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_no_mixing_reads_about_one(name, float32_scores):
    out = run(name, no_mixing=True)
    assert 0.99 < out["checks"]["mix_gap"]["value"] <= 1.0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_caught(name):
    c = tiny_cell(name, sizes=SMALL, seq_len=64)
    pipe = traffic.pipeline(c.workload, int(c.config["vocab_size"]),
                            c.n_nodes, SEED)
    batches = [pipe.global_batch(t)
               for t in range(program.compared_steps(c.H))]
    low = reference.run(c.config, c.workload, SEED, batches, "cpu",
                        precision="fp8")
    ref = reference.run(c.config, c.workload, SEED, batches, "cpu")
    correct, checks = compare.judge(compare.numbers(low, ref),
                                    c.workload["limits"])
    assert not correct, checks
