"""The topology experiment on the port (counterpart of
``benchmarks/bench_topology.py``): SPARQ-SGD over static graphs (ring,
torus, expanders, complete) and time-varying gossip plans (random
matchings, edge-sampled expander subgraphs, a cycle of expanders) at equal
node count, the paper's Footnote 5 (expanders give a large spectral gap at
constant degree).

    PYTHONPATH=src python -m repro_torch.launch.topology_bits [--full] \\
        [--device cuda|cpu]

Each row reports the plan's spectral gap (``delta_eff`` of the round
average for a time-varying plan), gamma* (worst case over its rounds), the
bits (charged at the active round's degrees), the consensus error and the
final loss of SPARQ with SignTopK(k=10), zero threshold and H=5. n=16;
quick: 32 features x 10 classes, T=300; ``--full``: 128 x 10, T=2000, the
reference's sizes. Every row runs through ``core.engine.timed_run``.
Nothing is written to disk.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import engine, prng
from repro_torch.core.compression import SignTopK
from repro_torch.core.schedule import decaying
from repro_torch.core.sparq import SparqConfig, make_step
from repro_torch.core.topology import GossipPlan, make_plan
from repro_torch.core.triggers import zero
from repro_torch.data.synthetic import convex_dataset, logistic_loss_and_grad
from repro_torch.device import resolve_device
from repro_torch.launch import suite_io


def run_bench(quick: bool = True, device: str = "cuda") -> List[Dict]:
    dev = resolve_device(device)
    n = 16
    T = 300 if quick else 2000
    rec = max(T // 6, 1)
    f, c = (32, 10) if quick else (128, 10)
    X, Y = convex_dataset(n, 100, n_features=f, n_classes=c, seed=5)
    Xt, Yt = torch.tensor(X, device=dev), torch.tensor(Y, device=dev)
    _, make_grad_fn, full_loss = logistic_loss_and_grad(c)
    grad_fn = make_grad_fn(Xt, Yt, 8)
    lr = decaying(1.0, 100.0)
    x0 = torch.zeros(f * c, device=dev)

    def eval_fn(xbar):
        return full_loss(xbar, Xt, Yt)

    static = [(kind, make_plan(kind.split("_")[0], n, **kw))
              for kind, kw in (("ring", {}), ("torus2d", {}),
                               ("expander", {"deg": 4, "seed": 1}),
                               ("expander_deg3", {"deg": 3, "seed": 1}),
                               ("complete", {}))]
    dynamic = [
        ("dyn_matchings", GossipPlan.matchings(n, rounds=8, seed=1)),
        ("dyn_edges_expander",
         make_plan("expander", n, deg=4, seed=1, dynamic="edges",
                   rounds=8, edge_frac=0.5)),
        ("dyn_cycle_expanders",
         make_plan("expander", n, deg=4, seed=1, dynamic="cycle", rounds=4)),
    ]
    rows = []
    for kind, plan in static + dynamic:
        cfg = SparqConfig(plan=plan, compressor=SignTopK(k=10),
                          threshold=zero(), lr=lr, H=5)
        runner = engine.make_runner(make_step(cfg, grad_fn), T,
                                    record_every=rec, eval_fn=eval_fn)
        st, trace, us, mem = engine.timed_run(
            runner, lambda cfg=cfg: cfg.init_state(x0), prng.PRNGKey(0), T)
        xbar = torch.mean(st.x, 0)
        rows.append({
            "name": f"topology_{kind}", "device": str(dev),
            "us_per_call": us, "delta": plan.delta_eff,
            "gamma_star": plan.gamma_star(10 / (f * c)),
            "plan_rounds": plan.R,
            "final_loss": float(eval_fn(xbar)),
            "consensus_err": float(torch.linalg.norm(st.x - xbar[None])),
            "bits": float(st.bits), "rounds": st.sync_rounds,
            "trigger_events": int(st.triggers),
            "peak_hbm_bytes": mem["peak_hbm_bytes"] if mem else None,
            "trace": trace.to_dict()})
        rows[-1].update(suite_io.contract_columns(cfg, f * c, rows[-1],
                                                  "rounds"))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the reference's full size: d=1280, T=2000")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    args = ap.parse_args(argv)
    rows = run_bench(quick=not args.full, device=args.device)
    print(f"{'row':30s} {'R':>2s} {'delta':>7s} {'gamma*':>9s} "
          f"{'bits':>11s} {'consensus':>9s} {'final_loss':>10s} "
          f"{'us/step':>9s}")
    for r in rows:
        print(f"{r['name']:30s} {r['plan_rounds']:>2d} {r['delta']:>7.4f} "
              f"{r['gamma_star']:>9.5f} {r['bits']:>11.4e} "
              f"{r['consensus_err']:>9.4f} {r['final_loss']:>10.4f} "
              f"{r['us_per_call']:>9.1f}")
    print(f"\ndevice {rows[0]['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
