"""Run one cell of the benchmark once, on the card, and print its result.

    python bench/run.py --workload dsmoe16b-d2n4.train --seed 7 \\
        --seconds 20 --trace 0

The cell is an entry of ``BENCHMARK.json``; its workload, configuration,
runner and per-layer readers are found by name under ``bench/``. The program is
``src/repro_torch`` of the checkout this file lies in. ``--trace 0``
prints the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics
from a profiled window. The last line of standard output is the result,
one JSON object; the last lines of standard error are the numbers that
decided ``correct``, each beside its limit.

Exit codes: 0 with a result; 2 without a card (or with fewer than the cell
asks for), 3 when the run loaded JAX or the JAX package, 1 on any other
failure, all three with no result.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def _setup_paths() -> None:
    """The harness and the program from this checkout; every cache the
    program or its libraries keep inside it, at fixed paths."""
    sys.path.insert(0, str(ROOT / "bench"))
    sys.path.insert(0, str(ROOT / "src"))
    cache = ROOT / ".bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"


def _finite(x):
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _finite(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_finite(v) for v in x]
    return x


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _setup_paths()

    from harness import spec
    cell = spec.cell(args.workload, ROOT)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"[bench] {cell.name} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2

    runner = spec.module("runners", cell.workload["runner"], ROOT)
    out = runner.run(cell, args.seed, args.seconds, bool(args.trace),
                     "cuda:0", T_START)

    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"[bench] the run loaded {loaded}: the benchmark measures the "
              f"PyTorch port alone", file=sys.stderr)
        return 3

    units = {m["name"]: m["unit"]
             for m in cell.end_to_end + cell.per_layer}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device.update(busy_s=out["busy_s"], window_s=out["window_s"])
    line = {"correct": out["correct"], "attempted": out["attempted"],
            "failed": out["failed"],
            "metrics": {k: {"value": v, "unit": units[k]}
                        for k, v in out["metrics"].items()},
            "device": device}
    if args.trace and out.get("breakdown"):
        line["breakdown"] = out["breakdown"]
    line["checks"] = out["checks"]
    print(f"[bench] phases {json.dumps(_finite(out['phases']))}",
          file=sys.stderr)
    print(f"[bench] window losses {out['losses'][0]!r} .. "
          f"{out['losses'][-1]!r}", file=sys.stderr)
    print(json.dumps(_finite(line)), flush=True)
    for name, c in out["checks"].items():
        limit = "not compared" if c["limit"] is None else \
            f"limit {c['limit']!r}"
        print(f"[check] {name} {c['value']!r} {limit}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
