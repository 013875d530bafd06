"""SQuARM-SGD quickstart on the port: momentum local steps with
event-triggered, compressed gossip, against CHOCO-SGD with the same momentum
(counterpart of ``examples/squarm_quickstart.py``). The momentum buffers are
never communicated.

  PYTHONPATH=src python -m repro_torch.examples.squarm_quickstart \\
      [--device cpu]

``REPRO_SMOKE=1`` shrinks the horizon from 1500 to 120 steps.
"""
import argparse
import os
import sys

import torch

from repro_torch.core import prng
from repro_torch.core.baselines import choco_config
from repro_torch.core.compression import TopFrac
from repro_torch.core.schedule import decaying
from repro_torch.core.sparq import run, squarm_config
from repro_torch.core.topology import make_topology
from repro_torch.core.triggers import piecewise
from repro_torch.data.synthetic import convex_dataset, logistic_loss_and_grad
from repro_torch.device import resolve_device
from repro_torch.optim.sgd import momentum

N_NODES, N_CLASSES, N_FEATURES = 12, 10, 64


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    dev = resolve_device(ap.parse_args(argv).device)
    T = 120 if os.environ.get("REPRO_SMOKE") else 1500
    X, Y = convex_dataset(N_NODES, 150, n_features=N_FEATURES,
                          n_classes=N_CLASSES, seed=0)
    Xt, Yt = torch.tensor(X, device=dev), torch.tensor(Y, device=dev)
    _, make_grad_fn, full_loss = logistic_loss_and_grad(N_CLASSES)
    grad_fn = make_grad_fn(Xt, Yt, 8)
    topo = make_topology("ring", N_NODES)
    x0 = torch.zeros(N_FEATURES * N_CLASSES, device=dev)
    lr = decaying(0.5, 100.0)
    comp = TopFrac(frac=0.1)
    squarm = squarm_config(
        topo, comp, lr, H=5,                 # 5 momentum local steps per sync
        threshold=piecewise(50.0, 50.0, every=100, until=T),
        beta=0.9, gamma=0.3)                 # heavyball 0.9
    choco = choco_config(topo, comp, lr, gamma=0.3, optimizer=momentum(0.9))
    for name, cfg in (("SQuARM-SGD", squarm), ("CHOCO+momentum", choco)):
        state, _ = run(cfg, grad_fn, x0, T, prng.PRNGKey(0))
        xbar = torch.mean(state.x, 0)
        print(f"{name:15s}: loss {float(full_loss(xbar, Xt, Yt)):.4f} "
              f"bits {float(state.bits):.3e} ({int(state.triggers)}/"
              f"{state.sync_rounds * N_NODES} node-syncs triggered)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
