"""What the experiment entry points share: their flags (``--full``,
``--device``, ``--out``) and the JSON file of their rows.

A port artifact never takes a ``BENCH_*`` name: the reference's
``benchmarks/run.py --check-artifacts`` globs that pattern in the root and in
``results/`` and holds every row to the reference's columns.
"""
from __future__ import annotations

import argparse
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

from repro_torch.core import prng


def parse(description: str, argv: Optional[Sequence[str]]
          ) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=description)
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--quick", action="store_true",
                      help="the quick size (the default)")
    size.add_argument("--full", action="store_true",
                      help="the full size")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    ap.add_argument("--out", default="",
                    help="write the rows as JSON to this path (not "
                         "BENCH_*.json)")
    args = ap.parse_args(argv)
    if os.path.basename(args.out).startswith("BENCH_"):
        raise SystemExit(f"--out {args.out!r}: BENCH_* names belong to the "
                         f"reference's artifacts")
    return args


def contract_columns(cfg: Optional[Any], d: int, row: Dict, rounds: str
                     ) -> Dict[str, Any]:
    """A row's ``contract_status`` and ``bits_oracle`` (the reference's
    suites' ``contract_status(cfg, d, bits=..., sync_rounds=...,
    trigger_events=...)``), from the row's bits, its ``rounds`` column and
    its trigger events; the certificate draws on the row's device. A row
    with no ``SparqConfig`` (a vanilla baseline) has no contract: ``n/a``
    and None, as ``benchmarks/run.py:217`` gives it."""
    if cfg is None:
        return {"contract_status": "n/a", "bits_oracle": None}
    from repro_torch.analysis.contracts import contract_status
    return contract_status(cfg, d, bits=row["bits"],
                           sync_rounds=int(row[rounds]),
                           trigger_events=int(row["trigger_events"]),
                           device=row["device"])


def write(suite: str, rows: List[Dict], args: argparse.Namespace,
          elapsed_s: float) -> None:
    """``{"suite", "quick", "threefry_partitionable", "elapsed_s", "rows"}``
    to ``args.out`` when given."""
    if not args.out:
        return
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump({"suite": suite, "quick": not args.full,
                   "threefry_partitionable": prng.partitionable(),
                   "generated_unix": time.time(), "elapsed_s": elapsed_s,
                   "rows": rows}, f, indent=1)
    print(f"wrote {len(rows)} rows to {args.out}")
