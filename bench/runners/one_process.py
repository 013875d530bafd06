"""One run of a cell in one process on one card: set-up, the measured
window, the traced window, and the comparison with the plain reference,
for a workload whose ``runner`` is ``one_process``.

Set-up builds the program's one engine (:class:`harness.cell.Program`),
draws x^0 from the seed, makes the ring of batches on the device, runs the
compared steps through ``train_steps`` and the ring (reading the program's
state after them), and one more cycle of H steps so that every shape and
every allocation of the window has been met. Then the window runs whole
cycles of H steps until ``seconds`` have passed.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import torch

from harness import compare, reference, trace
from harness.cell import Faults, Program, free
from harness.sizes import BLOCK, layout
from harness.spec import Cell, reader


class _Traced:
    """``train_step`` inside a ``bench.step`` span, with its attributes."""

    def __init__(self, step) -> None:
        self.step = step
        self.device, self.rows = step.device, step.rows

    def __call__(self, state, batch):
        with torch.profiler.record_function(trace.STEP_SPAN):
            return self.step(state, batch)


def run(c: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, faults: Optional[Faults] = None) -> Dict[str, Any]:
    """One run of cell ``c``; returns the result line's fields and the
    checks (see ``bench/run.py``)."""
    prog = Program(c, device, faults)
    dev, eng, H, hook = prog.dev, prog.eng, c.H, prog.hook
    cuda = dev.type == "cuda"
    w = c.workload
    state, ring, got = prog.start(seed)
    # one cycle more: every shape and allocation of the window met
    i = prog.compared
    t_cycle = time.perf_counter()
    state, _, _ = prog.train_steps(prog.step, state, ring, i, i + H)
    i += H
    if cuda:
        torch.cuda.synchronize(dev)
    setup_s = time.perf_counter() - t_start
    phases = dict(prog.phases, cycle_s=time.perf_counter() - t_cycle,
                  setup_s=setup_s)

    record: Dict[str, Any] = {}
    losses: List[float] = []
    sync_s: List[float] = []
    t0 = time.perf_counter()
    if traced:
        record, i, traced_losses = _profile(prog, state, ring, i,
                                            int(w["profile_cycles"]))
        losses += traced_losses
        hook.timing = cuda
        t0 = time.perf_counter()
    n_steps = 0
    while True:
        state, _, rec = prog.train_steps(prog.step, state, ring, i, i + H,
                                         hook.step_end)
        for j, sec in enumerate(rec["s_per_step"]):
            if eng.syncs(i + j):
                sync_s.append(sec)
        losses += rec["losses"]
        i += H
        n_steps += H
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    failed = sum(not math.isfinite(v) for v in losses)

    # the program's state is freed before the reference runs
    batches = prog.reference_batches(ring)
    s = prog.s
    del state, ring, prog
    free(dev)
    t_ref = time.perf_counter()
    ref = reference.run(c.config, w, seed, batches, dev)
    phases["reference_s"] = time.perf_counter() - t_ref
    values = compare.numbers(got, ref)
    correct, checks = compare.judge(values, w.get("limits", {}))

    out: Dict[str, Any] = {"correct": correct, "attempted": len(losses),
                           "failed": failed, "checks": checks,
                           "memory_peak_bytes": int(peak), "phases": phases,
                           "losses": losses}
    tokens = c.tokens_per_step
    if not traced:
        out["metrics"] = {
            "tokens_per_s": tokens * n_steps / window_s,
            "sync_step_ms": 1e3 * sum(sync_s) / len(sync_s),
            "peak_mem_gb": peak / 1e9,
            "setup_s": setup_s}
        return out
    record.update(
        sync_ms=hook.sync_ms, tokens_per_step=tokens,
        flops_per_token=s.flops_per_token(int(w["seq_len"])),
        sign_topk_tiles=c.n_nodes * layout(s)[2] // BLOCK)
    out["metrics"] = {}
    for m in c.per_layer:
        value = reader(m["name"])(record)
        if value is not None:
            out["metrics"][m["name"]] = value
    out["busy_s"] = record["busy_s"]
    out["window_s"] = record["window_s"]
    out["breakdown"] = {"device_ops": record["device_ops"],
                        "idle_gaps": record["idle_gaps"]}
    return out


def _profile(prog: Program, state, ring, i: int, cycles: int):
    """The traced steps: ``cycles`` whole cycles under the profiler with
    the device's activities alone (the per-layer metrics' window, its
    length by the host clock), then one cycle with the host's operations
    too, whose idle gaps are named by what the host ran in them. Returns
    the record the readers read, the next step and the steps' losses."""
    H, cuda = prog.c.H, prog.dev.type == "cuda"
    P = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[P.CUDA] if cuda else [P.CPU]
                                ) as prof:
        t0 = time.perf_counter()
        _, _, rec = prog.train_steps(prog.step, state, ring, i,
                                     i + cycles * H)
        window_s = time.perf_counter() - t0
    record = trace.device(trace.events(prof), window_s)
    record["profiled_steps"] = cycles * H
    i += cycles * H
    with torch.profiler.profile(activities=[P.CPU] + ([P.CUDA] if cuda
                                                      else [])) as prof:
        _, _, named = prog.train_steps(_Traced(prog.step), state, ring, i,
                                       i + H)
    record["idle_gaps"] = trace.idle_gaps(trace.events(prof))
    return record, i + H, rec["losses"] + named["losses"]
