"""Read the compared numbers of a cell whose nodes each have a card of
their own (runner ``node_per_card``) over many seeds, in one spawn of its
ranks, to set its limits: the program's (the lower readings), the
control's and each planted fault's (the upper readings). Not run by the
benchmark's runs; ``bench/tools/readings.py`` is its one-process twin.

    python bench/tools/rank_readings.py --workload dsmoe16b-d7n4.train4 \\
        --seeds 11,12,13 --as control,half_batch,no_mixing \\
        --out runs/readings.jsonl

``--as``: sides, each read on every seed: ``program`` the program as the
window drives it; ``control`` the plain reference computed in float8 e4m3
in the program's place; ``half_batch``, ``unchanged``, ``no_mixing`` the
program with that fault planted (``harness.cell.Faults``). One JSON line per
side and seed: the numbers and the seconds (with ``--out``, the per-leaf
readings too).
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
SIDES = ("program", "control", "half_batch", "unchanged", "no_mixing")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--as", dest="sides", default="program")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sides = tuple(args.sides.split(","))
    if set(sides) - set(SIDES):
        ap.error(f"--as takes {', '.join(SIDES)}")
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]
    import torch

    from harness import compare, ranks, rows, spec

    c = spec.cell(args.workload, ROOT)
    if args.device == "cuda":
        if torch.cuda.device_count() < c.chips:
            print(f"[rank_readings] the cell wants {c.chips} cards",
                  file=sys.stderr)
            return 2
        from repro_torch import kernels
        kernels.build()
    runner = spec.module("runners", c.workload["runner"])
    runner.check_program(c)
    parts = runner.spawn(c, ranks.Job(
        cell=c, seeds=tuple(int(s) for s in args.seeds.split(",")),
        kind="readings", sides=sides, device_type=args.device))
    sink = open(args.out, "a") if args.out else None
    try:
        for per_rank in zip(*parts, strict=True):
            got = rows.merge([p["got"] for p in per_rank],
                             own=per_rank[0]["side"] == "control")
            ref = rows.merge([p["ref"] for p in per_rank], own=True)
            values = compare.numbers(got, ref)
            head = {"cell": c.name, "as": per_rank[0]["side"],
                    "seed": per_rank[0]["seed"], **values,
                    "side_s": max(p["side_s"] for p in per_rank),
                    "ref_s": max(p["ref_s"] for p in per_rank)}
            print(json.dumps(head), flush=True)
            if sink:
                sink.write(json.dumps(dict(
                    head, leaves=ref["leaves"],
                    per_leaf=compare.per_leaf(got, ref))) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
