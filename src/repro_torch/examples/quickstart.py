"""Quickstart on the port: SPARQ-SGD against vanilla decentralized SGD
(counterpart of ``examples/quickstart.py``).

Decentralized logistic regression on 12 nodes in a ring, with event-triggered
SignTopK gossip, then vanilla SGD that sends every dense vector every step:

  PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

``REPRO_SMOKE=1`` shrinks the horizon from 1500 to 120 steps.
"""
import argparse
import os
import sys

import torch

from repro_torch.core import prng
from repro_torch.core.baselines import (init_vanilla, make_vanilla_step,
                                        run_generic)
from repro_torch.core.compression import SignTopK
from repro_torch.core.schedule import decaying
from repro_torch.core.sparq import SparqConfig, run
from repro_torch.core.topology import make_topology
from repro_torch.core.triggers import piecewise
from repro_torch.data.synthetic import convex_dataset, logistic_loss_and_grad
from repro_torch.device import resolve_device

N_NODES, N_CLASSES, N_FEATURES = 12, 10, 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    T = 120 if os.environ.get("REPRO_SMOKE") else 1500
    # heterogeneous per-node data (each node over-samples 2 classes)
    X, Y = convex_dataset(N_NODES, 150, n_features=N_FEATURES,
                          n_classes=N_CLASSES, seed=0)
    Xt, Yt = torch.tensor(X, device=dev), torch.tensor(Y, device=dev)
    _, make_grad_fn, full_loss = logistic_loss_and_grad(N_CLASSES)
    grad_fn = make_grad_fn(Xt, Yt, 8)
    topo = make_topology("ring", N_NODES)
    cfg = SparqConfig(
        topology=topo,
        compressor=SignTopK(k=10),                  # Section 5.1's operator
        threshold=piecewise(50.0, 50.0, every=100, until=T),   # trigger c_t
        lr=decaying(1.0, 100.0),                    # eta_t = 1/(t+100)
        H=5,                                        # local steps per sync
        gamma=0.3)                                  # consensus step size
    x0 = torch.zeros(N_FEATURES * N_CLASSES, device=dev)
    state, trace = run(cfg, grad_fn, x0, T, prng.PRNGKey(0),
                       record_every=T // 5,
                       eval_fn=lambda xb: full_loss(xb, Xt, Yt))
    for t, bits, loss, rounds, triggers in trace:
        print(f"  t={t:5d} loss {loss:.4f} bits {bits:.3e} "
              f"({triggers}/{rounds * N_NODES} node-syncs triggered)")
    xbar = torch.mean(state.x, 0)
    print(f"SPARQ-SGD   : loss {float(full_loss(xbar, Xt, Yt)):.4f} "
          f"bits {float(state.bits):.3e} ({int(state.triggers)}/"
          f"{state.sync_rounds * N_NODES} node-syncs triggered)")
    vstep = make_vanilla_step(topo, decaying(1.0, 100.0), grad_fn)
    vstate, _ = run_generic(vstep, init_vanilla(x0, N_NODES), T,
                            prng.PRNGKey(0))
    vbar = torch.mean(vstate.x, 0)
    print(f"vanilla SGD : loss {float(full_loss(vbar, Xt, Yt)):.4f} "
          f"bits {float(vstate.bits):.3e}")
    print(f"bit savings : {float(vstate.bits) / float(state.bits):.0f}x")
    return 0


if __name__ == "__main__":
    sys.exit(main())
