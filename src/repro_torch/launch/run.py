"""Suite driver of the port (counterpart of ``benchmarks/run.py``): one suite
per paper table or figure, each the port's own module.

    PYTHONPATH=src python -m repro_torch.launch.run [--suite S] [--full] \\
        [--device cuda|cpu] [--out-dir D] [--no-artifacts]
    PYTHONPATH=src python -m repro_torch.launch.run --check-artifacts \\
        [--out-dir D]

  convex     -> launch/convex_bits     (Figure 1a/1b)
  nonconvex  -> launch/nonconvex_bits  (Figure 1c/1d)
  momentum   -> launch/momentum_bits   (the SQuARM-SGD study)
  ablation   -> launch/ablation_bits   (Remark 4)
  topology   -> launch/topology_bits   (footnote 5)
  faults     -> launch/faults_bits     (link drops, stragglers, dropout)
  kernels    -> launch/bench_kernels   (the hand-written kernels)
  roofline   -> launch/roofline        (the dry run's roofline terms)

Prints the reference's ``name,us_per_call,derived`` CSV and writes one
strict-JSON document per suite, ``suite_<suite>.json`` in ``--out-dir``
(default ``runs/suites``): the reference's header (``schema_version`` 3,
``suite``, ``quick``, ``generated_unix``, ``elapsed_s``, ``error``,
``rows``) and the port's ``threefry_partitionable`` and ``device``.
Non-finite floats become the strings ``"inf"``, ``"-inf"`` and ``"nan"``.
A file never takes a ``BENCH_*`` name (:func:`write_artifact` refuses one):
the root-level and ``results/`` ``BENCH_*.json`` are the reference's
trajectory, which ``benchmarks/run.py --check-artifacts`` holds to its own
columns, and the port never writes there. A suite that raises is reported,
the others still run and write their documents, and the process exits 1.
``--full`` runs each suite's full size.

``--check-artifacts`` re-validates the documents in ``--out-dir`` without
running anything (:func:`check_artifacts`).
"""
from __future__ import annotations

import argparse
import glob
import importlib
import json
import os
import sys
import time
from typing import Any, Callable, Dict, List, Optional, Sequence

# 3: the reference's schema (contract_status, bits_oracle, peak_hbm_bytes)
SCHEMA_VERSION = 3
DEFAULT_OUT_DIR = os.path.join("runs", "suites")
SUITES = {"convex": "convex_bits", "nonconvex": "nonconvex_bits",
          "momentum": "momentum_bits", "ablation": "ablation_bits",
          "topology": "topology_bits", "faults": "faults_bits",
          "kernels": "bench_kernels", "roofline": "roofline"}
SIGN_TOPK_ROWS = ("kernel_sign_topk", "kernel_fused_trigger")


def suite_fn(name: str) -> Callable[..., List[Dict[str, Any]]]:
    """``run_bench(quick, device)`` of suite ``name``."""
    return importlib.import_module(
        f"repro_torch.launch.{SUITES[name]}").run_bench


def _finite(obj: Any) -> Any:
    """Non-finite floats as strings, so the document is strict JSON (e.g.
    ``bits_to_target = inf`` when a method never reached the target)."""
    if isinstance(obj, float):
        if obj != obj:
            return "nan"
        if obj in (float("inf"), float("-inf")):
            return "inf" if obj > 0 else "-inf"
        return obj
    if isinstance(obj, dict):
        return {k: _finite(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_finite(v) for v in obj]
    return obj


def write_artifact(path: str, suite: str, quick: bool, rows: List[Dict],
                   elapsed_s: float, device: str, error: str = "") -> str:
    """One suite's document at ``path``; a ``BENCH_*`` name is refused."""
    if os.path.basename(path).startswith("BENCH_"):
        raise ValueError(f"{path!r}: BENCH_* names belong to the "
                         f"reference's artifacts")
    from repro_torch.core import prng
    doc = {"schema_version": SCHEMA_VERSION, "suite": suite, "quick": quick,
           "generated_unix": round(time.time(), 1),
           "elapsed_s": round(elapsed_s, 2), "error": error,
           "threefry_partitionable": prng.partitionable(),
           "device": device, "rows": _finite(rows)}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(doc, f, default=str, allow_nan=False)
    return path


def _finite_positive(v: Any) -> bool:
    return (isinstance(v, (int, float)) and not isinstance(v, bool)
            and v == v and v not in (float("inf"), float("-inf")) and v > 0)


def _check_row(doc: Dict, row: Dict) -> List[str]:
    name = row.get("name")
    bad = []
    status = str(row.get("contract_status", "n/a"))
    if status not in ("ok", "n/a") and not status.startswith("warn("):
        bad.append(f"row {name!r}: contract_status={status}")
    oracle = row.get("bits_oracle")
    if isinstance(oracle, dict):
        lo, hi = float(oracle["lo"]), float(oracle["hi"])
        bits = float(row.get("bits", oracle["bits"]))
        if not lo * (1 - 1e-6) <= bits <= hi * (1 + 1e-6):
            bad.append(f"row {name!r}: bits {bits:.1f} outside the oracle "
                       f"interval [{lo:.1f}, {hi:.1f}]")
    if int(doc.get("schema_version", 0)) >= 3 and doc.get("quick") and \
            str(doc.get("device", "")).startswith("cuda") and \
            not _finite_positive(row.get("peak_hbm_bytes")):
        bad.append(f"row {name!r}: peak_hbm_bytes="
                   f"{row.get('peak_hbm_bytes')!r} is not a finite positive "
                   f"number")
    if row.get("bit_equal_oracle") is False:
        bad.append(f"row {name!r}: bit_equal_oracle is false: the "
                   f"{row.get('device')!r} leg diverged from the oracle")
    return bad


def _check_kernels(doc: Dict) -> List[str]:
    """The kernels document must hold the card's leg, and on the card the
    hand-written SignTopK must be no slower than its oracle on one row."""
    rows = doc.get("rows") or []
    legs = {str(r.get("device", "")).split(":")[0] for r in rows}
    if "cuda" not in legs:
        return [f"kernels document has no cuda leg (legs={sorted(legs)})"]
    st = [r for r in rows if r.get("name") in SIGN_TOPK_ROWS]
    if st and not any(float(r["us_per_call"]) <= float(r["ref_us"])
                      for r in st):
        return ["the hand-written SignTopK is slower than its plain "
                "version on every row: " + str(
                    [(r["name"], r["us_per_call"], r["ref_us"]) for r in st])]
    return []


def check_artifacts(dirs: Sequence[str]) -> int:
    """Re-validate the port's suite documents (``suite_*.json``) in
    ``dirs`` without running anything; prints each fault and returns the
    number of bad rows. The reference's rules (``benchmarks/run.py:82``):

    * every row's ``contract_status`` is green (``ok``, ``n/a`` or
      ``warn(..)``), and its bits lie inside its ``bits_oracle``;
    * no row has ``bit_equal_oracle`` false;
    * every quick row of a document whose ``device`` is ``cuda`` has a
      finite positive ``peak_hbm_bytes`` (on the CPU the suites record
      None: there is no device watermark to read);
    * a kernels document holds its ``cuda`` leg (the reference asks for
      its compiled ``xla`` leg), and on the card SignTopK is no slower
      than its plain version on at least one row (the reference's "fused
      beats the unfused reference")."""
    bad = checked = 0
    for dir_ in dirs:
        for path in sorted(glob.glob(os.path.join(dir_, "suite_*.json"))):
            with open(path) as f:
                doc = json.load(f)
            faults = []
            for row in doc.get("rows", []):
                checked += 1
                faults += _check_row(doc, row)
            if doc.get("suite") == "kernels":
                faults += _check_kernels(doc)
            for msg in faults:
                print(f"[check] {path}: {msg}")
            bad += len(faults)
    print(f"[check] {checked} row(s) checked, {bad} bad")
    return bad


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.run")
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--check-artifacts", action="store_true",
                    help="validate the suite documents in --out-dir and "
                         "exit; no suite runs")
    ap.add_argument("--suite", default="all", choices=["all", *SUITES])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    ap.add_argument("--out-dir", default=DEFAULT_OUT_DIR)
    ap.add_argument("--no-artifacts", action="store_true",
                    help="CSV to stdout only; write no document")
    args = ap.parse_args(argv)
    quick = not args.full
    if args.check_artifacts:
        return 1 if check_artifacts([args.out_dir]) else 0

    from repro_torch.device import resolve_device
    device = str(resolve_device(args.device))
    names = list(SUITES) if args.suite == "all" else [args.suite]
    print("name,us_per_call,derived", flush=True)
    any_error = False
    for name in names:
        t0 = time.perf_counter()
        try:
            rows = suite_fn(name)(quick=quick, device=args.device)
            err = ""
        except Exception as e:  # noqa: BLE001 - report, run the rest
            rows, err = [], f"{type(e).__name__}: {e}"
            any_error = True
            print(f"{name}_ERROR,0,\"{err}\"", flush=True)
        elapsed = time.perf_counter() - t0
        for r in rows:
            # rows without a SparqConfig (vanilla baselines, kernels,
            # roofline) have no theory contract to certify
            r.setdefault("contract_status", "n/a")
            r.setdefault("bits_oracle", None)
        if not args.no_artifacts:
            write_artifact(os.path.join(args.out_dir, f"suite_{name}.json"),
                           name, quick, rows, elapsed, device, err)
        for r in rows:
            r = dict(r)
            row_name = r.pop("name")
            us = r.pop("us_per_call", 0)
            r.pop("trace", None)   # traces go to the document, not the CSV
            derived = json.dumps(_finite(r), default=str).replace('"', "'")
            print(f"{row_name},{us},\"{derived}\"", flush=True)
    return 1 if any_error else 0


if __name__ == "__main__":
    sys.exit(main())
