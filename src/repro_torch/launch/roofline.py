"""Roofline suite of the port (counterpart of ``benchmarks/roofline.py``):
the dry run's rows (``runs/dryrun/dryrun_*.json``) as per (arch x shape x
mesh) the three terms on the H100, the dominant one, MODEL_FLOPS against
the counted dot FLOPs, and the watermark.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--dir runs/dryrun]

When the port's dry-run directory holds no rows, :func:`ensure_artifacts`
makes them: ``python -m repro_torch.launch.dryrun`` in a subprocess for
each of qwen1.5-0.5b's ``train_4k`` and ``decode_32k`` (and ``prefill_32k``
in full mode), with ``--lint``, the processes side by side. It reads only the port's directory, never the
reference's ``results/dryrun_*.json``: those rows are TPU v5e terms, not the
card's. The directory is ``runs/dryrun`` under the working directory.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

DRYRUN_DIR = os.path.join("runs", "dryrun")
CI_ARCH = "qwen1.5-0.5b"
CI_SHAPES = ("train_4k", "decode_32k")
SRC = str(Path(__file__).resolve().parents[2])


def load_rows(directory: str = DRYRUN_DIR) -> List[Dict]:
    """Every row of the directory's ``dryrun_*.json``; a later file (by
    name) overrides an earlier one per (arch, shape, mesh)."""
    merged: Dict[tuple, Dict] = {}
    for path in sorted(glob.glob(os.path.join(directory, "dryrun_*.json"))):
        with open(path) as f:
            for r in json.load(f):
                merged[(r.get("arch"), r.get("shape"), r.get("mesh"))] = r
    return list(merged.values())


def table(rows: List[Dict], mesh: str = "16x16") -> str:
    out = ["| arch | shape | step | compute_s | memory_s | collective_s | "
           "dominant | useful_flops | watermark/rank | walk_s |",
           "|---|---|---|---|---|---|---|---|---|---|"]
    for r in rows:
        if r.get("mesh") != mesh or not r.get("ok"):
            continue
        uf = r.get("useful_flops_ratio")
        out.append(
            f"| {r['arch']} | {r['shape']} | {r.get('step', '-')} "
            f"| {r['compute_s']:.3e} | {r['memory_s']:.3e} "
            f"| {r['collective_s']:.3e} | {r['dominant'].replace('_s', '')} "
            f"| {f'{uf:.2f}' if uf else '-'} "
            f"| {r['memory']['watermark_bytes'] / 2**30:.2f}GiB "
            f"| {r['walk_seconds']} |")
    return "\n".join(out)


def ensure_artifacts(quick: bool = True, arch: str = CI_ARCH,
                     directory: str = DRYRUN_DIR, device: str = "cuda",
                     timeout_s: int = 900) -> List[str]:
    """Write ``dryrun_ci_<shape>.json`` through the dry run when the
    directory holds no dry-run rows, one process per shape, all started
    together and each killed at ``timeout_s``; returns the paths written
    (empty when rows were there). ``device`` is where ``--lint`` draws."""
    if glob.glob(os.path.join(directory, "dryrun_*.json")):
        return []
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + (os.pathsep + env["PYTHONPATH"]
                               if env.get("PYTHONPATH") else "")
    shapes = CI_SHAPES if quick else ("train_4k", "prefill_32k",
                                      "decode_32k")
    deadline = time.monotonic() + timeout_s
    procs = []
    try:
        for shape in shapes:
            out = os.path.join(directory, f"dryrun_ci_{shape}.json")
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--lint", "--device",
                   device, "--out", out]
            procs.append((shape, out, subprocess.Popen(
                cmd, env=env, stdout=subprocess.DEVNULL,
                stderr=subprocess.STDOUT)))
        written = []
        for shape, out, proc in procs:
            try:
                rc = proc.wait(timeout=max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = f"killed after {timeout_s} s"
            if rc == 0:
                written.append(out)
            else:
                print(f"[roofline] dryrun {arch}/{shape} failed: {rc}",
                      flush=True)
        return written
    finally:
        for _, _, proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


def run_bench(quick: bool = True, device: str = "cuda") -> List[Dict]:
    """The suite's rows: one per ``ok`` dry-run row, made first when there
    are none. ``peak_hbm_bytes`` is the dry run's watermark."""
    generated = ensure_artifacts(quick, device=device)
    summary = []
    for r in load_rows():
        if not r.get("ok"):
            continue
        lint = r.get("lint")
        summary.append({
            "name": f"roofline_{r['arch']}_{r['shape']}_{r['mesh']}",
            "device": "meta",
            "us_per_call": round(max(r["compute_s"], r["memory_s"],
                                     r["collective_s"]) * 1e6, 1),
            "dominant": r["dominant"],
            "compute_s": f"{r['compute_s']:.3e}",
            "memory_s": f"{r['memory_s']:.3e}",
            "collective_s": f"{r['collective_s']:.3e}",
            "dot_flops_per_rank": r["dot_flops_per_rank"],
            "hbm_bytes_per_rank": r["hbm_bytes_per_rank"],
            "collective_bytes_per_rank": r["collective_bytes_per_rank"],
            "useful_flops_ratio": r.get("useful_flops_ratio"),
            "peak_hbm_bytes": r["memory"]["watermark_bytes"],
            "memory": r["memory"],
            "walk_seconds": r["walk_seconds"],
            "lint_errors": lint.get("errors") if lint else None,
            "generated_here": bool(generated),
        })
    if not summary:
        summary.append({"name": "roofline_no_artifacts", "us_per_call": 0,
                        "note": "dryrun generation failed; see log above"})
    return summary


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.roofline")
    ap.add_argument("--dir", default=DRYRUN_DIR)
    args = ap.parse_args(argv)
    rows = load_rows(args.dir)
    nfail = [r for r in rows if not r.get("ok")]
    print(f"{len(rows)} dry-run rows, {len(nfail)} failures")
    for mesh in ("16x16", "2x16x16"):
        print(f"\n## mesh {mesh}\n")
        print(table(rows, mesh))
    if nfail:
        print("\nFailures:")
        for r in nfail:
            print(f"  {r['arch']} {r['shape']} {r['mesh']}: "
                  f"{r.get('error', '')[:200]}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
