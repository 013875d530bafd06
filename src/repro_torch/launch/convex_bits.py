"""The paper's convex experiment on the port (counterpart of
``examples/convex_bits.py`` with the rows of
``benchmarks/bench_convex.run_bench``): multinomial logistic regression on
heterogeneous data over a ring, SPARQ-SGD against CHOCO-SGD with Sign, TopK
and SignTopK and against vanilla decentralized SGD, as loss against bits and
the factor of bits each needs to reach a common target loss.

    PYTHONPATH=src python -m repro_torch.launch.convex_bits [--full] \\
        [--device cuda|cpu]

Quick: n=12 ring, d=640, T=400. ``--full`` is the paper's Section 5.1
setting: n=60 ring, m=200 samples per node, 784 features x 10 classes
(d=7840), T=4000, minibatch 5, SignTopK k=10, eta_t = 1/(t+100), H=5. Each
method runs through ``core.engine.timed_run``: one warm-up run, then a timed
one, so ``us_per_call`` is the steady wall time per step (on the card, ended
by a synchronize). The reference's ``contract_status`` columns wait for the
audits slice. Nothing is written to disk.
"""
from __future__ import annotations

import argparse
import sys
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.core import baselines, engine, prng
from repro_torch.core.compression import Sign, SignTopK, TopK
from repro_torch.core.schedule import decaying
from repro_torch.core.sparq import SparqConfig, make_step
from repro_torch.core.topology import make_topology
from repro_torch.core.triggers import piecewise, zero
from repro_torch.data.synthetic import convex_dataset, logistic_loss_and_grad
from repro_torch.device import resolve_device
from repro_torch.launch import suite_io


def run_bench(quick: bool = True, device: str = "cuda") -> List[Dict]:
    dev = resolve_device(device)
    if quick:
        n, m, f, c, T, mb, rec = 12, 120, 64, 10, 400, 8, 50
    else:
        n, m, f, c, T, mb, rec = 60, 200, 784, 10, 4000, 5, 200
    k = 10
    d = f * c
    X, Y = convex_dataset(n, m, n_features=f, n_classes=c, seed=0)
    Xt, Yt = torch.tensor(X, device=dev), torch.tensor(Y, device=dev)
    _, make_grad_fn, full_loss = logistic_loss_and_grad(c)
    grad_fn = make_grad_fn(Xt, Yt, mb)
    topo = make_topology("ring", n)
    lr = decaying(1.0, 100.0)
    x0 = torch.zeros(d, device=dev)
    key = prng.PRNGKey(0)

    def eval_fn(xbar):
        return full_loss(xbar, Xt, Yt)

    results = []

    def row(name, trace, us, mem, rounds, events, cfg=None):
        r = {"name": name, "device": str(dev), "us_per_call": us,
             "final_loss": trace[-1][2], "bits": trace[-1][1],
             "rounds": rounds, "trigger_events": events,
             "peak_hbm_bytes": mem["peak_hbm_bytes"] if mem else None,
             "trace": trace}
        r.update(suite_io.contract_columns(cfg, d, r, "rounds"))
        results.append(r)

    def record(name, cfg):
        runner = engine.make_runner(make_step(cfg, grad_fn), T,
                                    record_every=rec, eval_fn=eval_fn)
        st, trace, us, mem = engine.timed_run(
            runner, lambda: cfg.init_state(x0), key, T)
        row(name, trace, us, mem, st.sync_rounds, int(st.triggers), cfg)

    # SPARQ-SGD: H=5 local steps, the trigger and SignTopK. c_t eta_t^2 must
    # be commensurate with ||x_half - x_hat||^2 ~ d eta^2 G^2, so the
    # threshold scales with d (the reference's tuning)
    c0 = 30.0 * d
    record("sparq_signtopk", SparqConfig(
        topology=topo, compressor=SignTopK(k=k),
        threshold=piecewise(c0, c0, every=max(T // 8, 1), until=T),
        lr=lr, H=5))
    record("sparq_no_trigger", SparqConfig(
        topology=topo, compressor=SignTopK(k=k), threshold=zero(), lr=lr,
        H=5))
    record("choco_sign", baselines.choco_config(topo, Sign(), lr))
    record("choco_topk", baselines.choco_config(topo, TopK(k=k), lr))
    record("choco_signtopk", baselines.choco_config(topo, SignTopK(k=k), lr))
    vrunner = engine.make_runner(
        baselines.make_vanilla_step(topo, lr, grad_fn), T, record_every=rec,
        eval_fn=eval_fn)
    _, vtrace, vus, vmem = engine.timed_run(
        vrunner, lambda: baselines.init_vanilla(x0, n), key, T)
    row("vanilla_decentralized", vtrace, vus, vmem, T, T * n)

    # bits to reach the weakest method's final loss (unrounded losses)
    target = max(r["trace"][-1][2] for r in results) + 1e-9

    def bits_to_target(trace):
        for _t, bits, loss, *_rest in trace:
            if loss <= target:
                return bits
        return float("inf")

    sparq_bits = bits_to_target(results[0]["trace"])
    for r in results:
        b = bits_to_target(r["trace"])
        r["bits_to_target"] = b
        r["savings_vs_sparq"] = (round(b / sparq_bits, 1) if sparq_bits
                                 else None)
        r["trace"] = r["trace"].to_dict()
    return results


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="paper scale: n=60 ring, d=7840, T=4000")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    args = ap.parse_args(argv)
    rows = run_bench(quick=not args.full, device=args.device)
    print(f"{'method':24s} {'final_loss':>10s} {'total_bits':>12s} "
          f"{'bits_to_target':>14s} {'vs SPARQ':>9s} {'us/step':>9s}")
    for r in rows:
        fac = r["savings_vs_sparq"]
        print(f"{r['name']:24s} {r['final_loss']:>10.4f} {r['bits']:>12.3e} "
              f"{r['bits_to_target']:>14.3e} {fac if fac else '':>9} "
              f"{r['us_per_call']:>9.1f}")
    print(f"\n'vs SPARQ' = factor MORE bits that method needs to reach the "
          f"common target loss; device {rows[0]['device']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
