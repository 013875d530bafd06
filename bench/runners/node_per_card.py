"""One run of a cell whose nodes each have a card of their own, for a
workload whose ``runner`` is ``node_per_card``: one rank a node, started
with the program's ``repro_torch.dist.comm.spawn`` (NCCL between the cards,
gloo on the CPU), each running ``harness.ranks.main``: the program's engine
over a ``(node, fsdp 1, model 1)`` mesh, set-up, the measured window or
the traced cycles, and the plain reference of its own node.

Before anything is spawned the runner looks up what it reads of the
program, and ends the run at once when the program lacks it. Each of the
ranks' collectives has a deadline (``COLLECTIVE_S``), and so has their
join: a rank that dies or hangs ends the run within minutes.

The result: ``tokens_per_s`` is every node's tokens over the window's wall
time; ``sync_step_ms`` the mean over the window's sync steps of the slowest
rank's synchronized step; ``peak_mem_gb`` the fullest card's peak;
``setup_s`` from the run's process start, through the spawn, NCCL's set-up
and each rank's set-up, to the window's first step.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, List, Optional

import torch

from harness import compare, ranks, rows, sizes
from harness.cell import Faults
from harness.spec import Cell, reader

COLLECTIVE_S = 120.0    # each collective's deadline in the ranks
JOIN_S = 900.0          # the ranks' join deadline, past the window


def check_program(c: Cell) -> None:
    """Raise SystemExit unless the program counts the bytes its row
    exchanges move and spans their transfer, which the runner reads, and
    its ``ModelConfig`` has every field ``c``'s configuration sets."""
    from repro_torch.dist import comm
    from repro_torch.models.config import ModelConfig
    if getattr(comm, "FETCH_BYTES", None) != "comm.fetch_bytes" or \
            getattr(comm, "FETCH_WAIT", None) != "comm.fetch.wait":
        raise SystemExit("[bench] the program's row exchange counts no "
                         "comm.fetch_bytes and spans no comm.fetch.wait "
                         "(repro_torch.dist.comm): this runner reads both")
    lack = sorted(set(c.config["port"]["fields"]) - {
        f.name for f in dataclasses.fields(ModelConfig)})
    if lack:
        raise SystemExit(f"[bench] the program's ModelConfig has no "
                         f"{', '.join(lack)}, which {c.config['name']} sets")


def spawn(c: Cell, job: ranks.Job) -> List[Any]:
    """``job`` on ``c.chips`` ranks, every one's return value."""
    from repro_torch.dist import comm
    return comm.spawn(ranks.main, c.chips, (job,),
                      device_type=job.device_type, timeout_s=COLLECTIVE_S,
                      deadline_s=JOIN_S + job.seconds)


def run(c: Cell, seed: int, seconds: float, traced: bool, device,
        t_start: float, faults: Optional[Faults] = None) -> Dict[str, Any]:
    """One run of cell ``c``; returns the result line's fields and the
    checks (see ``bench/run.py``)."""
    check_program(c)
    device_type = torch.device(device).type
    if device_type == "cuda" and c.config["engine"]["use_kernel"]:
        from repro_torch import kernels
        kernels.build()            # once, before the ranks load it
    wall_start = time.time() - (time.perf_counter() - t_start)
    parts = spawn(c, ranks.Job(
        cell=c, seeds=(seed,), seconds=seconds, traced=traced,
        wall_start=wall_start, faults=faults or Faults(),
        device_type=device_type))
    got = [p["got"] for p in parts]
    prog = rows.merge(got, own=False)
    ref = rows.merge([p["ref"] for p in parts], own=True)
    values = compare.numbers(prog, ref)
    correct, checks = compare.judge(values, c.workload.get("limits", {}))
    losses = parts[0]["losses"]
    agree = rows.agree(got) and all(p["losses"] == losses for p in parts)
    peak = max(p["peak"] for p in parts)
    s = sizes.of(c.config)
    D_pad = sizes.layout(s)[2]
    out: Dict[str, Any] = {
        "correct": correct and agree, "attempted": len(losses),
        "failed": sum(not math.isfinite(v) for v in losses),
        "checks": checks, "memory_peak_bytes": peak, "losses": losses,
        "phases": dict(parts[0]["phases"], ranks_agree=agree,
                       setup_s=max(p["phases"]["setup_s"] for p in parts),
                       reference_s=max(p["phases"]["reference_s"]
                                       for p in parts),
                       row_bytes=4 * D_pad,
                       fetched_bytes_per_sync=[
                           p["fetched_bytes"] / max(1, p["syncs_compared"])
                           for p in parts])}
    if not traced:
        syncs = [max(step) for step in zip(*(p["sync_s"] for p in parts),
                                     strict=True)]
        out["metrics"] = {
            "tokens_per_s": c.tokens_per_step * parts[0]["steps"]
            / max(p["window_s"] for p in parts),
            "sync_step_ms": 1e3 * sum(syncs) / len(syncs),
            "peak_mem_gb": peak / 1e9,
            "setup_s": out["phases"]["setup_s"]}
        return out
    record = {"ranks": [p["record"] for p in parts],
              "tokens_per_step": c.tokens_per_step,
              "flops_per_token": s.flops_per_token(int(c.workload["seq_len"]))}
    out["metrics"] = {}
    for m in c.per_layer:
        value = reader(m["name"])(record)
        if value is not None:
            out["metrics"][m["name"]] = value
    slowest = max(record["ranks"], key=lambda r: r["window_s"])
    out["busy_s"] = slowest["busy_s"]
    out["window_s"] = slowest["window_s"]
    out["breakdown"] = {k: slowest.get(k) for k in
                        ("device_ops", "device_by_span", "idle_by_span")}
    out["record"] = record
    return out
