"""Put a cell's device time and idle time down to the program's spans, read
the span metrics, and time what the spans cost, in one process on the card.
Not run by the benchmark's runs, whose runner profiles with the spans off.

    python bench/tools/spans.py --workload dsmoe16b-d2n4.train --seed 7 \\
        --out runs/spans.jsonl

After the runner's set-up (x^0, the ring, the compared steps, one more
cycle), in blocks of whole cycles of at least ``STEPS`` steps:

* blocks under ``torch.profiler`` with host and device activity, spans off
  and on in turns (off, on, on, off): their wall time; the first block with
  the spans on gives the record (``harness.spans.record``), the span
  metrics' values, the share of device time the spans cover and the
  triggers counted by the state over the block;
* the same turns without the profiler: what the spans cost alone;
* one block with the sync hook timing, as the traced run's window takes
  ``sparq_dist.sync_ms``.

Prints one JSON line, appended to ``--out`` too.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
STEPS = 6
METRICS = ("model.fwd_bwd_ms", "moe.layer_ms", "moe.route_ms",
           "sparq_dist.local_step_ms", "sparq_dist.mix_ms", "moe.drop_pct",
           "sparq_dist.sent_rows_pct")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]
    import torch

    from harness import spec
    if not torch.cuda.is_available():
        print("[spans] the cell's sizes want the card", file=sys.stderr)
        return 2
    line = measure(spec.cell(args.workload, ROOT), args.seed,
                   torch.device("cuda", 0))
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "a") as f:
            f.write(text + "\n")
    print(text, flush=True)
    return 0


def measure(c, seed: int, dev, steps: int = STEPS) -> Dict[str, Any]:
    """The tool's line for cell ``c`` (a ``harness.spec.Cell``) on ``dev``,
    in blocks of at least ``steps`` steps; on the CPU the profile holds no
    device time."""
    import torch

    from harness import spans as span_trace
    from harness import spec
    from harness.cell import Program
    from repro_torch import spans

    prog = Program(c, dev)
    state, ring, _ = prog.start(seed)
    H, i = c.H, prog.compared
    block = H * -(-steps // H)
    P = torch.profiler.ProfilerActivity
    activities = [P.CPU] + ([P.CUDA] if dev.type == "cuda" else [])

    def run(on: bool, profiled: bool):
        nonlocal state, i
        prof = (torch.profiler.profile(activities=activities) if profiled
                else contextlib.nullcontext())
        with prof, spans.enabled(on):
            t0 = time.perf_counter()
            state, _, rec = prog.train_steps(prog.step, state, ring, i,
                                             i + block)
            wall = time.perf_counter() - t0
        i += block
        return wall, rec, prof

    state, _, _ = prog.train_steps(prog.step, state, ring, i, i + H)
    i += H
    walls: Dict[str, Dict[str, List[float]]] = {
        "profiled": {"off": [], "on": []},
        "unprofiled": {"off": [], "on": []}}
    record: Dict[str, Any] = {}
    for kind in ("profiled", "unprofiled"):
        for on in (False, True, True, False):
            before = int(state["triggers"])
            wall, rec, prof = run(on, kind == "profiled")
            walls[kind]["on" if on else "off"].append(wall)
            if kind == "profiled" and on and not record:
                record = span_trace.record(span_trace.events(prof),
                                           spans.counters())
                record["triggers"] = rec["triggers"][-1] - before
            del prof
    prog.hook.timing = dev.type == "cuda"
    state, _, _ = prog.train_steps(prog.step, state, ring, i, i + block,
                                   prog.hook.step_end)
    sync_ms = prog.hook.sync_ms

    dev_s = record.get("span_device_s", {})
    own, incl = dev_s.get("self", {}), dev_s.get("inclusive", {})
    total = sum(own.values())
    syncs = record["named_syncs"]
    return {
        "cell": c.name, "seed": seed,
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
        "steps": block,
        "metrics": {m: spec.reader(m)(record) for m in METRICS},
        "covered_pct": (100.0 * (1.0 - own.get(span_trace.OUTSIDE, 0.0)
                                 / total) if total else None),
        "sync_parts_ms": (1e3 * sum(incl.get(f"sparq.sync.{p}", 0.0)
                                    for p in ("compress", "mix", "bits"))
                          / syncs if syncs else None),
        "sync_ms": sum(sync_ms) / len(sync_ms) if sync_ms else None,
        "sent_by_triggers_pct": (100.0 * record["triggers"]
                                 / (syncs * prog.train_step.n_nodes)
                                 if syncs else None),
        "wall_s": walls, "record": record}


if __name__ == "__main__":
    sys.exit(main())
