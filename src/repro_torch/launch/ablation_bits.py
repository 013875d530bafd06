"""The trigger, H and k ablation on the port (Remark 4; the rows of
``benchmarks/bench_ablation.py``): SPARQ-SGD with SignTopK(k) on the convex
problem, over the local-step count H, the operator's k and the trigger
threshold. More local steps and the trigger should cut bits at equal loss.

    PYTHONPATH=src python -m repro_torch.launch.ablation_bits \\
        [--quick | --full] [--device cuda|cpu] [--out rows.json]

Quick: n = 8 ring, 80 samples per node, 32 features x 10 classes (d = 320),
T = 300; full: n = 20, 200 samples, 128 x 10 (d = 1280), T = 2000.
Minibatch 8, eta_t = 1/(t+100). Timing and the threefry layout as in
``launch/convex_bits.py`` (the committed ``BENCH_ablation.json`` was drawn
with ``JAX_THREEFRY_PARTITIONABLE`` off).
"""
from __future__ import annotations

import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.core import engine, prng
from repro_torch.core.compression import SignTopK
from repro_torch.core.schedule import decaying
from repro_torch.core.sparq import SparqConfig, make_step
from repro_torch.core.topology import make_topology
from repro_torch.core.triggers import constant, zero
from repro_torch.data.synthetic import convex_dataset, logistic_loss_and_grad
from repro_torch.device import resolve_device
from repro_torch.launch import suite_io

# (name, H, k, threshold c_0; 0 = no trigger)
ROWS: Tuple[Tuple[str, int, int, float], ...] = (
    ("H1_k10_c0", 1, 10, 0.0),
    ("H5_k10_c0", 5, 10, 0.0),
    ("H20_k10_c0", 20, 10, 0.0),
    ("H5_k10_trig", 5, 10, 200.0),
    ("H5_k40_c0", 5, 40, 0.0),
    ("H5_k3_c0", 5, 3, 0.0))


def problem(quick: bool = True, device: str = "cuda"):
    """(n, T, rec, grad_fn, eval_fn, x0) of the ablation's convex problem."""
    dev = resolve_device(device)
    n, m, f, c = (8, 80, 32, 10) if quick else (20, 200, 128, 10)
    T = 300 if quick else 2000
    X, Y = convex_dataset(n, m, n_features=f, n_classes=c, seed=3)
    Xt, Yt = torch.tensor(X, device=dev), torch.tensor(Y, device=dev)
    _, make_grad_fn, full_loss = logistic_loss_and_grad(c)
    return (n, T, max(T // 6, 1), make_grad_fn(Xt, Yt, 8),
            lambda xbar: full_loss(xbar, Xt, Yt),
            torch.zeros(f * c, device=dev))


def config(n: int, H: int, k: int, c0: float) -> SparqConfig:
    return SparqConfig(topology=make_topology("ring", n),
                       compressor=SignTopK(k=k),
                       threshold=constant(c0) if c0 else zero(),
                       lr=decaying(1.0, 100.0), H=H)


def run_bench(quick: bool = True, device: str = "cuda") -> List[Dict]:
    n, T, rec, grad_fn, eval_fn, x0 = problem(quick, device)
    rows = []
    for name, H, k, c0 in ROWS:
        cfg = config(n, H, k, c0)
        runner = engine.make_runner(make_step(cfg, grad_fn), T,
                                    record_every=rec, eval_fn=eval_fn)
        st, trace, us, mem = engine.timed_run(
            runner, lambda: cfg.init_state(x0), prng.PRNGKey(0), T)
        # the loss of the true step-T iterate (the last record sits at
        # (T // rec) rec, which is < T when rec does not divide T)
        rows.append({
            "name": f"ablate_{name}", "us_per_call": us,
            "final_loss": float(eval_fn(torch.mean(st.x, 0))),
            "bits": float(st.bits), "rounds": int(st.sync_rounds),
            "trigger_events": int(st.triggers),
            "peak_hbm_bytes": mem["peak_hbm_bytes"] if mem else None,
            "threefry_partitionable": prng.partitionable(),
            "device": str(x0.device), "trace": trace.to_dict()})
        rows[-1].update(suite_io.contract_columns(cfg, x0.numel(), rows[-1],
                                                  "rounds"))
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = suite_io.parse(__doc__.splitlines()[0], argv)
    t0 = time.perf_counter()
    rows = run_bench(quick=not args.full, device=args.device)
    print(f"{'row':22s} {'final_loss':>10s} {'bits':>12s} {'rounds':>6s} "
          f"{'triggers':>8s} {'us/step':>9s}")
    for r in rows:
        print(f"{r['name']:22s} {r['final_loss']:>10.4f} {r['bits']:>12.4e} "
              f"{r['rounds']:>6d} {r['trigger_events']:>8d} "
              f"{r['us_per_call']:>9.1f}")
    print(f"threefry_partitionable={prng.partitionable()}")
    suite_io.write("ablation", rows, args, time.perf_counter() - t0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
