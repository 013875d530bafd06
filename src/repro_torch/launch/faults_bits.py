"""The fault-injection experiment on the port (counterpart of
``benchmarks/bench_faults.py``): SPARQ-SGD against CHOCO-SGD and vanilla
decentralized SGD on the convex problem of the convex experiment, under the
faults of :mod:`repro_torch.core.faults`.

    PYTHONPATH=src python -m repro_torch.launch.faults_bits [--full] \\
        [--device cuda|cpu]

Rows, the reference's: each method clean and at 10 % and 30 % link drop;
SPARQ with one and with two stragglers skipping half their steps; SPARQ
under the mixed plan (20 % drop, a straggler, node 2 offline for the second
quarter of the run). One added row, ``sparq_mixed_block``, runs SPARQ under
the mixed plan with ``BlockTopFrac(0.1)``, which reaches the SignTopK kernel
once per sync on the card (the reference's rows use the global
``SignTopK(k=10)``, which reaches no kernel); its ``loss_vs_clean`` is taken
against ``sparq_clean``.

Quick: n=12 ring, 120 samples x 64 features x 10 classes, T=400. ``--full``
is the reference's full size: n=32, 200 samples x 784 features x 10
classes (d=7840), T=2000. Every row runs through ``core.engine.timed_run``
(a warm-up run, then a timed one). The reference's ``contract_status``
columns wait for the audits slice. Nothing is written to disk.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Callable, Dict, List, Optional, Sequence

import torch

from repro_torch.core import baselines, engine, prng
from repro_torch.core.compression import BlockTopFrac, Compressor, SignTopK
from repro_torch.core.faults import DropoutWindow, FaultPlan
from repro_torch.core.schedule import LRSchedule, decaying
from repro_torch.core.sparq import SparqConfig, make_step
from repro_torch.core.topology import Topology, make_topology
from repro_torch.core.triggers import ThresholdSchedule, piecewise
from repro_torch.data.synthetic import convex_dataset, logistic_loss_and_grad
from repro_torch.device import resolve_device
from repro_torch.launch import suite_io


@dataclasses.dataclass(frozen=True)
class Problem:
    """One size of the experiment, its data on ``device``."""

    n: int
    d: int
    T: int
    rec: int
    grad_fn: Callable
    eval_fn: Callable
    x0: torch.Tensor
    topo: Topology
    lr: LRSchedule
    threshold: ThresholdSchedule
    mixed: FaultPlan
    device: torch.device

    def sparq(self, faults: Optional[FaultPlan],
              comp: Compressor = SignTopK(k=10)) -> SparqConfig:
        return SparqConfig(topology=self.topo, compressor=comp,
                           threshold=self.threshold, lr=self.lr, H=5,
                           faults=faults)


def problem(quick: bool = True, device: str = "cuda") -> Problem:
    """The reference's sizes (``bench_faults.py:44-47``)."""
    dev = resolve_device(device)
    if quick:
        n, m, f, c, T, mb, rec = 12, 120, 64, 10, 400, 8, 50
    else:
        n, m, f, c, T, mb, rec = 32, 200, 784, 10, 2000, 8, 200
    d = f * c
    X, Y = convex_dataset(n, m, n_features=f, n_classes=c, seed=0)
    Xt, Yt = torch.tensor(X, device=dev), torch.tensor(Y, device=dev)
    _, make_grad_fn, full_loss = logistic_loss_and_grad(c)
    c0 = 30.0 * d
    return Problem(
        n=n, d=d, T=T, rec=rec, grad_fn=make_grad_fn(Xt, Yt, mb),
        eval_fn=lambda xbar: full_loss(xbar, Xt, Yt),
        x0=torch.zeros(d, device=dev), topo=make_topology("ring", n),
        lr=decaying(1.0, 100.0),
        threshold=piecewise(c0, c0, every=max(T // 8, 1), until=T),
        mixed=FaultPlan(link_drop=0.2, stragglers=(1,), straggler_frac=0.5,
                        dropout=(DropoutWindow(2, T // 4, T // 2),), seed=1),
        device=dev)


def run_bench(quick: bool = True, device: str = "cuda") -> List[Dict]:
    p = problem(quick, device)
    n, T = p.n, p.T
    key = prng.PRNGKey(0)
    comp = SignTopK(k=10)

    def fault_cols(fp):
        if fp is None:
            return {"link_drop": 0.0, "stragglers": 0, "dropout_windows": 0}
        return {"link_drop": fp.link_drop, "stragglers": len(fp.stragglers),
                "dropout_windows": len(fp.dropout)}

    results = []

    def record(name: str, method: str, step_fn, init_state, faults,
               cfg=None) -> None:
        runner = engine.make_runner(step_fn, T, record_every=p.rec,
                                    eval_fn=p.eval_fn)
        st, trace, us, mem = engine.timed_run(runner, init_state, key, T)
        triggers = getattr(st, "triggers", None)
        results.append({
            "name": name, "method": method, "device": str(p.device),
            "us_per_call": us, "final_loss": trace[-1][2],
            "bits": trace[-1][1],
            "trigger_events": T * n if triggers is None else int(triggers),
            "sync_rounds": getattr(st, "sync_rounds", T),
            "peak_hbm_bytes": mem["peak_hbm_bytes"] if mem else None,
            **fault_cols(faults), "trace": trace})
        results[-1].update(suite_io.contract_columns(cfg, p.d, results[-1],
                                                     "sync_rounds"))

    def record_sparq(name: str, faults, c: Compressor = comp) -> None:
        cfg = p.sparq(faults, c)
        record(name, "sparq", make_step(cfg, p.grad_fn),
               lambda: cfg.init_state(p.x0), faults, cfg)

    def record_choco(name: str, faults) -> None:
        cfg = baselines.choco_config(p.topo, comp, p.lr, faults=faults)
        record(name, "choco", make_step(cfg, p.grad_fn),
               lambda: cfg.init_state(p.x0), faults, cfg)

    def record_vanilla(name: str, faults) -> None:
        record(name, "vanilla",
               baselines.make_vanilla_step(p.topo, p.lr, p.grad_fn,
                                           faults=faults),
               lambda: baselines.init_vanilla(p.x0, n), faults)

    drop10 = FaultPlan(link_drop=0.1, seed=1)
    drop30 = FaultPlan(link_drop=0.3, seed=1)
    stragg1 = FaultPlan(stragglers=(0,), straggler_frac=0.5, seed=1)
    stragg2 = FaultPlan(stragglers=(0, n // 2), straggler_frac=0.5, seed=1)

    record_sparq("sparq_clean", None)
    record_sparq("sparq_drop10", drop10)
    record_sparq("sparq_drop30", drop30)
    record_sparq("sparq_straggler1", stragg1)
    record_sparq("sparq_straggler2", stragg2)
    record_sparq("sparq_mixed", p.mixed)
    record_sparq("sparq_mixed_block", p.mixed, BlockTopFrac(frac=0.1))
    record_choco("choco_clean", None)
    record_choco("choco_drop10", drop10)
    record_choco("choco_drop30", drop30)
    record_vanilla("vanilla_clean", None)
    record_vanilla("vanilla_drop10", drop10)
    record_vanilla("vanilla_drop30", drop30)

    clean = {r["method"]: (r["final_loss"], r["bits"]) for r in results
             if r["name"].endswith("_clean")}
    for r in results:
        base_loss, base_bits = clean[r["method"]]
        # loss against the method's own fault-free run, and the bits the
        # dead links saved
        r["loss_vs_clean"] = r["final_loss"] - base_loss
        r["bits_ratio_vs_clean"] = r["bits"] / base_bits
        r["trace"] = r["trace"].to_dict()
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="the reference's full size: n=32, d=7840, T=2000")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    args = ap.parse_args(argv)
    rows = run_bench(quick=not args.full, device=args.device)
    print(f"{'row':20s} {'final_loss':>10s} {'vs clean':>9s} {'bits':>12s} "
          f"{'bits/clean':>10s} {'triggers':>8s} {'us/step':>9s}")
    for r in rows:
        print(f"{r['name']:20s} {r['final_loss']:>10.4f} "
              f"{r['loss_vs_clean']:>9.4f} {r['bits']:>12.4e} "
              f"{r['bits_ratio_vs_clean']:>10.3f} {r['trigger_events']:>8d} "
              f"{r['us_per_call']:>9.1f}")
    print(f"\ndevice {rows[0]['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
