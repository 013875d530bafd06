"""The SQuARM-SGD momentum study on the port (Singh et al., 2020; the rows
of ``benchmarks/bench_momentum.py``) over the non-convex LM workload:
SPARQ-SGD with plain SGD steps, SQuARM (SPARQ with heavyball or Nesterov
momentum 0.9), CHOCO-SGD with momentum and vanilla gossip with momentum, on
one ring.

    PYTHONPATH=src python -m repro_torch.launch.momentum_bits \\
        [--quick | --full] [--device cuda|cpu] [--out rows.json]

Sizes, timing and the threefry layout as in ``launch/nonconvex_bits.py``.
SQuARM must reach CHOCO+momentum's final-loss neighbourhood with fewer bits.
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core import baselines, prng
from repro_torch.core.compression import TopFrac
from repro_torch.core.sparq import SparqConfig, squarm_config
from repro_torch.core.triggers import piecewise
from repro_torch.launch import suite_io
from repro_torch.launch.lm_workload import LMWorkload, make_lm_workload
from repro_torch.launch.nonconvex_bits import run_sparq_row, run_vanilla_row
from repro_torch.optim.sgd import momentum


def configs(wl: LMWorkload) -> Dict[str, SparqConfig]:
    comp = TopFrac(frac=0.1)
    thr = piecewise(2.0, 1.0, every=max(wl.T // 6, 1), until=wl.T)
    return {
        "sparq": SparqConfig(topology=wl.topo, compressor=comp,
                             threshold=thr, lr=wl.lr, H=5),
        "squarm": squarm_config(wl.topo, comp, wl.lr, H=5, threshold=thr,
                                beta=0.9),
        "squarm_nesterov": squarm_config(wl.topo, comp, wl.lr, H=5,
                                         threshold=thr, beta=0.9,
                                         nesterov=True),
        "choco_mom": baselines.choco_config(wl.topo, comp, wl.lr,
                                            optimizer=momentum(0.9))}


def run_bench(quick: bool = True, device: str = "cuda") -> List[Dict]:
    wl = make_lm_workload(quick, device)
    rows = []
    for name, cfg in configs(wl).items():
        r = run_sparq_row(wl, name, cfg)
        r["optimizer"] = cfg.resolved_optimizer().name
        rows.append(r)
    r = run_vanilla_row(wl, "vanilla_mom")
    r["optimizer"] = momentum(0.9).name
    rows.append(r)
    squarm = next(r for r in rows if r["name"] == "squarm")
    choco = next(r for r in rows if r["name"] == "choco_mom")
    for r in rows:
        r["bits_ratio_vs_squarm"] = r["bits"] / squarm["bits"]
        r["loss_gap_vs_choco_mom"] = r["final_loss"] - choco["final_loss"]
        r["trace"] = r["trace"].to_dict()
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = suite_io.parse(__doc__.splitlines()[0], argv)
    t0 = time.perf_counter()
    rows = run_bench(quick=not args.full, device=args.device)
    print(f"{'method':18s} {'optimizer':>14s} {'final_loss':>10s} "
          f"{'bits':>12s} {'vs SQuARM':>9s} {'gap vs CHOCO':>12s} "
          f"{'us/step':>10s}")
    for r in rows:
        print(f"{r['name']:18s} {r['optimizer']:>14s} "
              f"{r['final_loss']:>10.4f} {r['bits']:>12.4e} "
              f"{r['bits_ratio_vs_squarm']:>9.1f} "
              f"{r['loss_gap_vs_choco_mom']:>+12.4f} "
              f"{r['us_per_call']:>10.1f}")
    print(f"threefry_partitionable={prng.partitionable()}")
    suite_io.write("momentum", rows, args, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
