"""The plain reference agrees with the program at tiny sizes on the CPU,
for both families and both trigger schedules: with the program's products
in float32 (and its attention scores too), every compared number lies at
float32 rounding; the plain SignTopK and the consensus step are the
program's."""
import math

import numpy as np
import pytest
import torch
from conftest import tiny_cell

from harness import cell as program
from harness import compare, reference, spec

# float32 on both sides: rounding alone (the sums run in other orders)
FLOAT32_GAPS = {"loss_gap": 1e-6, "grad_gap": 1e-5, "grad_err": 1e-5,
                "change_gap": 1e-5, "change_err": 1e-5, "xhat_gap": 1e-5,
                "xhat_err": 1e-5, "mix_gap": 1e-5, "bits_gap": 0.0,
                "trigger_gap": 0.0}


@pytest.mark.parametrize("name", ["dsmoe16b-d2n4.train",
                                  "stablelm1.6b-n2.train",
                                  "dsmoe16b-d2n4.sync"])
def test_reference_follows_the_program(name, float32_scores):
    c = tiny_cell(name, compute_dtype="float32")
    prog = program.Program(c, "cpu")
    state, ring, got = prog.start(seed=2**31 + 17)
    ref = reference.run(c.config, c.workload, 2**31 + 17,
                        prog.reference_batches(ring), "cpu")
    values = compare.numbers(got, ref)
    assert ref["triggers"] == c.n_nodes * sum(
        (t + 1) % c.H == 0 for t in range(program.compared_steps(c.H)))
    for key, limit in FLOAT32_GAPS.items():
        assert values[key] <= limit, (key, values[key])


def test_plain_sign_topk_is_the_programs():
    from repro_torch.kernels.sign_topk import sign_topk_blocks_plain
    g = torch.Generator().manual_seed(3)
    tiles = torch.randn((64, 1024), generator=g)
    tiles[:8] = torch.round(tiles[:8] * 2) / 2        # many ties
    tiles[8:12, 100:] = 0.0                           # fewer nonzeros than k
    tiles[12] = 0.0
    for k in (1, 103, 1024):
        q_ref = reference.sign_topk_plain(tiles, k)
        q_prog, _, _ = sign_topk_blocks_plain(tiles, None, 1.0, k)
        torch.testing.assert_close(q_ref, q_prog, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_consensus_step_is_the_programs(n):
    from repro_torch.core.topology import make_plan
    ring = spec.module("engines", "sparq_ring_sgd").ring_mixing(n)
    plan = make_plan("ring", n)
    np.testing.assert_allclose(ring, plan.ws[0], atol=1e-15)
    omega = 103 / 1024
    assert math.isclose(reference.consensus_step(ring, omega),
                        plan.gamma_star(omega), rel_tol=1e-12)
