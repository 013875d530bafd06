"""The non-convex LM workload of the nonconvex and momentum experiments (the
port's copy of ``benchmarks/lm_workload.py``): one place defines the reduced
transformer, the per-node token pipeline, the flat gradient and evaluation
closures and the ring and LR recipe, so both suites stay comparable.

The n-node ensemble runs through the reference engine (``core/sparq.py``)
over flat ``(n, d)`` parameter rows on one device. x^0 is the reference's
``init_params(cfg, PRNGKey(0))``, raveled in its ``jax.tree.flatten`` order.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.configs.registry import get_config
from repro_torch.core import prng
from repro_torch.core.schedule import LRSchedule, warmup_piecewise
from repro_torch.core.topology import Topology, make_topology
from repro_torch.data.synthetic import TokenPipeline
from repro_torch.device import resolve_device
from repro_torch.dist.sparq_dist import _flatten_spec, grad_views, unravel
from repro_torch.models.transformer import init_params, lm_loss, param_shapes


class LMWorkload(NamedTuple):
    n: int
    T: int
    rec: int                # trace record interval
    flat0: torch.Tensor     # the flattened initial parameters (shared x^0)
    topo: Topology
    lr: LRSchedule
    grad_fn: Callable       # (x (n, d), t, key) -> (n, d) gradients
    eval_fn: Callable       # loss(x_bar) on node 0's fixed batch


def make_lm_workload(quick: bool = True, device: str = "cuda") -> LMWorkload:
    """Quick: n = 4 ring, T = 60; full: n = 8, T = 600. The reduced
    qwen1.5-0.5b (2 layers, d_model 128, vocab 256), sequences of 32 tokens,
    4 per node; each node holds one fixed batch."""
    dev = resolve_device(device)
    n = 4 if quick else 8
    T = 60 if quick else 600
    rec = max(T // 6, 1)
    cfg = get_config("qwen1.5-0.5b").reduced(n_layers=2, d_model=128,
                                             vocab=256)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=32,
                         batch_per_node=4, n_nodes=n, seed=0)
    slices, d = _flatten_spec(param_shapes(cfg))
    flat0 = torch.empty(d, dtype=torch.float32, device=dev)
    init_params(cfg, prng.PRNGKey(0), out=unravel(flat0, slices))
    # heterogeneous data: each node holds its own fixed batch (the quick
    # benchmark setting; batches vary per node, not per step)
    batches = [{k: torch.as_tensor(v).to(device=dev, dtype=torch.int64)
                for k, v in pipe.batch(i, 0).items()} for i in range(n)]

    def grad_fn(x_nd: torch.Tensor, t, key) -> torch.Tensor:
        g = torch.zeros_like(x_nd)
        with torch.enable_grad():
            for i in range(n):
                tree = grad_views(x_nd[i], g[i], slices)
                lm_loss(cfg, tree, batches[i])[0].backward()
        return g

    def eval_fn(xbar: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return lm_loss(cfg, unravel(xbar, slices), batches[0])[0]

    lr = warmup_piecewise(0.3, warmup=5, milestones=[T // 2, 3 * T // 4],
                          factor=0.2)
    return LMWorkload(n=n, T=T, rec=rec, flat0=flat0,
                      topo=make_topology("ring", n), lr=lr, grad_fn=grad_fn,
                      eval_fn=eval_fn)
