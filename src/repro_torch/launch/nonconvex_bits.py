"""The paper's non-convex experiment on the port (Section 5.2, the Figure
1c-d analog; the rows of ``benchmarks/bench_nonconvex.py``): a reduced
transformer LM trained over an n-node ring with momentum 0.9, SignTopK of
10 % per node vector and a piecewise-increasing trigger, against CHOCO-SGD
with Sign and TopK and vanilla decentralized SGD, all with momentum.

    PYTHONPATH=src python -m repro_torch.launch.nonconvex_bits \\
        [--quick | --full] [--device cuda|cpu] [--out rows.json]

Quick: n = 4, T = 60; full: n = 8, T = 600 (``launch/lm_workload.py``).
Each row runs through ``core.engine.timed_run``: a warm-up run, then a timed
one, so ``us_per_call`` is the steady wall time per step. Every row records
the threefry layout it was drawn from (``JAX_THREEFRY_PARTITIONABLE``; the
committed ``BENCH_nonconvex.json`` was drawn with it off).
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Sequence

from repro_torch.core import baselines, engine, prng
from repro_torch.core.compression import Sign, TopFrac
from repro_torch.core.sparq import SparqConfig, make_step
from repro_torch.core.triggers import piecewise, zero
from repro_torch.launch import suite_io
from repro_torch.launch.lm_workload import LMWorkload, make_lm_workload
from repro_torch.optim.sgd import momentum


def configs(wl: LMWorkload) -> Dict[str, SparqConfig]:
    """The SPARQ and CHOCO rows' configurations."""
    thr = piecewise(2.0, 1.0, every=max(wl.T // 6, 1), until=wl.T)
    comp = TopFrac(frac=0.1)
    return {
        "sparq_signtop10_mom": SparqConfig(
            topology=wl.topo, compressor=comp, threshold=thr, lr=wl.lr, H=5,
            momentum=0.9),
        "sparq_no_trigger": SparqConfig(
            topology=wl.topo, compressor=comp, threshold=zero(), lr=wl.lr,
            H=5, momentum=0.9),
        "choco_sign": SparqConfig(
            topology=wl.topo, compressor=Sign(), threshold=zero(), lr=wl.lr,
            H=1, momentum=0.9),
        "choco_top10": SparqConfig(
            topology=wl.topo, compressor=comp, threshold=zero(), lr=wl.lr,
            H=1, momentum=0.9)}


def row(name: str, st, trace, us: float, mem, wl: LMWorkload) -> Dict:
    return {"name": name, "us_per_call": us,
            "final_loss": trace[-1][2], "bits": trace[-1][1],
            "trigger_events": int(getattr(st, "triggers", wl.T * wl.n)),
            "sync_rounds": int(getattr(st, "sync_rounds", wl.T)),
            "peak_hbm_bytes": mem["peak_hbm_bytes"] if mem else None,
            "threefry_partitionable": prng.partitionable(),
            "device": str(wl.flat0.device), "trace": trace}


def run_sparq_row(wl: LMWorkload, name: str, cfg: SparqConfig) -> Dict:
    runner = engine.make_runner(make_step(cfg, wl.grad_fn), wl.T,
                                record_every=wl.rec, eval_fn=wl.eval_fn)
    st, trace, us, mem = engine.timed_run(
        runner, lambda: cfg.init_state(wl.flat0), prng.PRNGKey(1), wl.T)
    r = row(name, st, trace, us, mem, wl)
    r.update(suite_io.contract_columns(cfg, wl.flat0.numel(), r,
                                       "sync_rounds"))
    return r


def run_vanilla_row(wl: LMWorkload, name: str) -> Dict:
    """Vanilla decentralized SGD with the same momentum: every node sends
    its dense vector every step (``trigger_events`` = T n by convention)."""
    vopt = momentum(0.9)
    runner = engine.make_runner(
        baselines.make_vanilla_step(wl.topo, wl.lr, wl.grad_fn,
                                    optimizer=vopt),
        wl.T, record_every=wl.rec, eval_fn=wl.eval_fn)
    st, trace, us, mem = engine.timed_run(
        runner, lambda: baselines.init_vanilla(wl.flat0, wl.n, vopt),
        prng.PRNGKey(1), wl.T)
    r = row(name, st, trace, us, mem, wl)
    r.update(suite_io.contract_columns(None, wl.flat0.numel(), r,
                                       "sync_rounds"))
    return r


def run_bench(quick: bool = True, device: str = "cuda") -> List[Dict]:
    wl = make_lm_workload(quick, device)
    rows = [run_sparq_row(wl, name, cfg)
            for name, cfg in configs(wl).items()]
    rows.append(run_vanilla_row(wl, "vanilla_decentralized"))
    sparq_bits = rows[0]["bits"]
    for r in rows:
        r["bits_ratio_vs_sparq"] = r["bits"] / sparq_bits
        r["trace"] = r["trace"].to_dict()
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = suite_io.parse(__doc__.splitlines()[0], argv)
    t0 = time.perf_counter()
    rows = run_bench(quick=not args.full, device=args.device)
    print(f"{'method':24s} {'final_loss':>10s} {'bits':>12s} "
          f"{'triggers':>8s} {'vs SPARQ':>8s} {'us/step':>10s}")
    for r in rows:
        print(f"{r['name']:24s} {r['final_loss']:>10.4f} {r['bits']:>12.4e} "
              f"{r['trigger_events']:>8d} {r['bits_ratio_vs_sparq']:>8.1f} "
              f"{r['us_per_call']:>10.1f}")
    print(f"threefry_partitionable={prng.partitionable()}")
    suite_io.write("nonconvex", rows, args, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
