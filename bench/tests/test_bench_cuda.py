"""On the card: the trace reduction finds the program's SignTopK kernel by
name in a profiled launch, with busy time inside the window, and the
reader gives a roofline share under 100 %. Skips without a card; run it
on one with ``PYTHONPATH=src python -m pytest -m cuda bench/tests``."""
import time

import pytest
import torch

from harness import spec, trace


@pytest.mark.cuda
def test_trace_reads_sign_topk(cuda_device):
    from repro_torch.kernels import ops
    diff = torch.randn((2, 64 * 1024), device=cuda_device)
    ops.sign_topk_ensemble(diff, 103)             # built and warm
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ops.sign_topk_ensemble(diff, 103)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    rec = trace.device(trace.events(prof), window_s)
    names = [n for n, _ in rec["kernels"]]
    assert any("sign_topk" in n for n in names), names
    assert 0 < rec["busy_s"] <= rec["window_s"]
    rec["sign_topk_tiles"] = 128
    share = spec.reader("sign_topk_roofline")(rec)
    assert 0 < share < 100
