"""End-to-end decentralized training driver of the port (counterpart of
``repro/launch/train.py``): the same flags and defaults, plus ``--device``.

Without ``--devices`` the whole ``--nodes`` ensemble lives on one device,
``cuda`` unless ``--device cpu`` is given:

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen1.5-0.5b \\
      --nodes 4 --use-kernel --steps 6 --H 3

``--devices N`` runs N ranks over the reference's ``(node, fsdp, model)``
mesh, factored as the reference factors it (``n_nodes = min(n_nodes,
N)``, the model axis what the nodes leave over). The ranks come from
``torchrun``'s environment when it is set; otherwise the CLI starts N
processes itself. Rank ``r`` runs on ``cuda:{local_rank % cards}`` or on
the CPU; the backend is NCCL when every rank has a card of its own, and
gloo (CUDA blocks staged through pinned host buffers) when ranks share a
card or run on the CPU. Rank 0 logs; a failed rank fails the run:

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --devices 2 \\
      --device cpu --steps 6 --H 3
  PYTHONPATH=src torchrun --nproc-per-node 4 -m repro_torch.launch.train \\
      --devices 4 --nodes 4 --use-kernel --steps 6 --H 3

``--use-kernel`` compresses with the blockwise SignTopK kernel; without it
the run takes the generic path, a global SignTopK of ``--frac`` of each
node's flat vector. ``--dynamic`` picks a time-varying gossip plan and
``--link-drop``, ``--stragglers``/``--straggler-frac``, ``--dropout-window``
and ``--fault-seed`` inject faults. x^0 is the reference's
``init_params(cfg, PRNGKey(0))``, drawn from the threefry stream that
``JAX_THREEFRY_PARTITIONABLE`` selects (unset: partitionable).

``--ckpt-dir D --ckpt-every N`` saves the whole train state to
``D/step_<i>`` after every N-th step; ``--resume`` restores the latest one
and runs the steps left up to ``--steps``:

  PYTHONPATH=src python -m repro_torch.launch.train --reduced --nodes 4 \
      --use-kernel --steps 6 --H 3 --ckpt-dir ckpt --ckpt-every 4
  PYTHONPATH=src python -m repro_torch.launch.train --reduced --nodes 4 \
      --use-kernel --steps 6 --H 3 --ckpt-dir ckpt --resume

``--lint`` audits the configuration before the first step: the theory
contracts R6-R9 and the charged payload (R10) of ``repro_torch.analysis``;
an error ends the run. Under ``--devices`` rank 0 audits and the others wait
on its verdict.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import math
import os
import resource
import sys
import time
from typing import Any, Dict, List, Optional, Sequence

import torch

from repro_torch.core.faults import DropoutWindow, FaultPlan


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--devices", type=int, default=0,
                    help="run N ranks over the (node, fsdp, model) mesh")
    ap.add_argument("--reduced", action="store_true",
                    help="use the reduced smoke-test config")
    ap.add_argument("--nodes", type=int, default=0, help="override n_nodes")
    ap.add_argument("--layers", type=int, default=0,
                    help="override n_layers (the model's depth)")
    ap.add_argument("--batch-per-node", type=int, default=2)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--H", type=int, default=5)
    ap.add_argument("--frac", type=float, default=0.1)
    ap.add_argument("--variant", default="ring",
                    choices=["dense", "ring", "shift"],
                    help="mixing: dense product, or circulant row rolls "
                         "(dense off circulant graphs)")
    ap.add_argument("--topology", default="ring",
                    choices=["ring", "torus2d", "complete", "expander"])
    ap.add_argument("--deg", type=int, default=4,
                    help="expander degree (--topology expander)")
    ap.add_argument("--mixing", default="uniform",
                    choices=["uniform", "metropolis"])
    ap.add_argument("--dynamic", default="none",
                    choices=["none", "matchings", "edges", "cycle"],
                    help="time-varying gossip plan family (none = static)")
    ap.add_argument("--dynamic-rounds", type=int, default=8,
                    help="support size R of a --dynamic plan")
    ap.add_argument("--edge-frac", type=float, default=0.5,
                    help="per-round edge keep-probability (--dynamic edges)")
    ap.add_argument("--topo-seed", type=int, default=0,
                    help="graph sampling seed")
    ap.add_argument("--link-drop", type=float, default=0.0,
                    help="per-sync-round iid link-drop probability in [0, 1)")
    ap.add_argument("--stragglers", default="",
                    help="comma-separated node indices that straggle, e.g. "
                         "'0,3'")
    ap.add_argument("--straggler-frac", type=float, default=0.5,
                    help="fraction of local steps each straggler skips")
    ap.add_argument("--dropout-window", action="append", default=[],
                    metavar="NODE:START:END",
                    help="take NODE offline for steps START <= t < END "
                         "(repeatable)")
    ap.add_argument("--fault-seed", type=int, default=0,
                    help="fault-stream PRNG seed (links and stragglers)")
    ap.add_argument("--momentum", type=float, default=0.0,
                    help="SQuARM-SGD momentum beta (0 = plain SPARQ)")
    ap.add_argument("--nesterov", action="store_true")
    ap.add_argument("--lr", type=float, default=0.5)
    ap.add_argument("--threshold", type=float, default=2.0)
    ap.add_argument("--use-kernel", action="store_true",
                    help="the blockwise SignTopK CUDA kernel path")
    ap.add_argument("--lint", action="store_true",
                    help="audit the configuration (theory contracts R6-R9, "
                         "payload R10) before the first step")
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    return ap


def _fault_plan(args: argparse.Namespace) -> FaultPlan:
    """The fault flags as a plan, validated as the reference validates
    them (``repro/launch/train.py:142-163``)."""
    try:
        windows = tuple(
            DropoutWindow(*(int(p) for p in spec.split(":")))
            for spec in args.dropout_window)
    except (TypeError, ValueError):
        raise SystemExit(
            f"[train] --dropout-window needs integer NODE:START:END with "
            f"START < END, got {args.dropout_window!r}") from None
    try:
        straggler_ids = tuple(
            int(i) for i in args.stragglers.split(",") if i)
    except ValueError:
        raise SystemExit(
            f"[train] --stragglers needs comma-separated integer node "
            f"indices, got {args.stragglers!r}") from None
    return FaultPlan(
        link_drop=args.link_drop, stragglers=straggler_ids,
        straggler_frac=args.straggler_frac if args.stragglers else 0.0,
        dropout=windows, seed=args.fault_seed)


def host_peak_rss_gb() -> float:
    """The process's peak resident set so far (Linux reports KiB)."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def run(argv: Optional[Sequence[str]] = None, on_sync=None,
        on_checkpoint=None, *, mesh: Any = None) -> Dict[str, Any]:
    """Parse ``argv``, train, and return what the run produced: ``losses``,
    ``bits`` and ``triggers`` (one value per step run), the final ``state``
    and ``metrics``, the engine's ``train_step`` (its metadata attributes),
    ``s_per_step`` (host clock around each step, synchronized on CUDA),
    ``start`` (the step a resume began at), the ``saves`` and ``restore``
    records (path, GB, seconds, host peak RSS), and the ``mesh`` sizes
    (None in one process). ``on_sync`` is passed on to ``build_sparq``;
    ``on_checkpoint(kind, path, step, state)`` is called after every save
    (``"save"``) and after the restore (``"restore"``).

    With ``--devices N`` this process is one rank of N when a process group
    is up (or ``torchrun``'s environment names one); otherwise it starts
    the N ranks and returns rank 0's record without ``state``,
    ``train_step`` and ``metrics``. ``mesh``, a ``(node, fsdp, model)``
    mesh over the caller's process group, is trained on instead of the one
    ``--devices`` factors (e.g. with an ``fsdp`` axis); every rank calls
    ``run`` with it."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = _parser().parse_args(argv)
    if args.resume and not args.ckpt_dir:
        raise SystemExit("[train] --resume needs --ckpt-dir")
    if not args.devices and mesh is None:
        return _run(args, on_sync, on_checkpoint)
    import torch.distributed as dist

    from repro_torch.device import resolve_device
    from repro_torch.dist import comm
    dev_type = resolve_device(args.device).type
    if args.devices and not dist.is_initialized() and \
            "RANK" not in os.environ:
        if on_sync is not None or on_checkpoint is not None:
            raise ValueError("callbacks do not cross into the ranks this "
                             "run starts; start the ranks yourself")
        if dev_type == "cuda" and args.use_kernel:
            from repro_torch import kernels
            kernels.build()        # once, before the ranks load it
        # no deadline on the join: a hung rank fails its group's
        # collectives, and a rank that exits non-zero fails the run
        out = comm.spawn(_rank_main, args.devices, (argv,),
                         device_type=dev_type)
        return out[0]
    if not dist.is_initialized():           # torchrun's environment
        local = int(os.environ.get("LOCAL_RANK", 0))
        ranks = int(os.environ.get("LOCAL_WORLD_SIZE", args.devices))
        comm.init_rank(int(os.environ["RANK"]),
                       int(os.environ["WORLD_SIZE"]),
                       comm.backend_for(dev_type, ranks),
                       comm.rank_device(dev_type, local))
    if args.devices and dist.get_world_size() != args.devices:
        raise SystemExit(f"[train] --devices {args.devices} but the process "
                         f"group has {dist.get_world_size()} ranks")
    with contextlib.ExitStack() as stack:
        if dist.get_rank():                 # rank 0 logs
            stack.enter_context(contextlib.redirect_stdout(
                stack.enter_context(open(os.devnull, "w"))))
        return _run(args, on_sync, on_checkpoint, mesh)


SUMMARY_KEYS = ("losses", "bits", "triggers", "s_per_step", "start",
                "saves", "restore", "mesh", "cfg", "exchange_s")


def _rank_main(rank: int, argv: List[str]) -> Dict[str, Any]:
    """One rank of a run that ``run`` started: its record, on the host."""
    out = run(argv)
    return {k: out[k] for k in SUMMARY_KEYS}


def _configs(args: argparse.Namespace):
    """The model and engine configs the flags name (one process's view)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core.schedule import decaying
    from repro_torch.core.triggers import constant
    from repro_torch.dist.sparq_dist import DistSparqConfig

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.nodes:
        cfg = dataclasses.replace(cfg, n_nodes=args.nodes)
    if args.layers:
        cfg = dataclasses.replace(cfg, n_layers=args.layers)
    dcfg = DistSparqConfig(
        H=args.H, frac=args.frac, lr=decaying(args.lr, 100.0),
        threshold=constant(args.threshold), momentum=args.momentum,
        nesterov=args.nesterov, variant=args.variant,
        use_kernel=args.use_kernel, topology=args.topology, deg=args.deg,
        mixing=args.mixing, dynamic=args.dynamic, rounds=args.dynamic_rounds,
        edge_frac=args.edge_frac, topo_seed=args.topo_seed,
        faults=_fault_plan(args))
    return cfg, dcfg


def configs(argv: Sequence[str]):
    """``(cfg, dcfg)`` of a command line, e.g. to factor a mesh of one's
    own for ``run(argv, mesh=...)``."""
    return _configs(_parser().parse_args(list(argv)))


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def train_steps(train_step, state: Dict[str, Any], pipe, start: int,
                stop: int, on_step=None):
    """The training loop: for ``start <= i < stop``, step ``i`` on this
    rank's rows of the pipeline's batch ``i``, then ``on_step(i, state,
    metrics)``. Returns the final state, the last step's metrics (None when
    no step ran) and the per-step ``losses``, ``bits``, ``triggers`` and
    ``s_per_step`` (host clock around each step, synchronized on CUDA)."""
    dev = train_step.device
    lo, hi = train_step.rows
    losses: List[torch.Tensor] = []
    bits: List[torch.Tensor] = []
    trig: List[torch.Tensor] = []
    s_per_step: List[float] = []
    metrics: Optional[Dict[str, Any]] = None
    for i in range(start, stop):
        batch = pipe.rows_batch(i, lo, hi)       # this rank's nodes only
        _sync(dev)
        t0 = time.perf_counter()
        state, metrics = train_step(state, batch)
        _sync(dev)
        s_per_step.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].detach())
        bits.append(metrics["bits"].clone())
        trig.append(metrics["triggers"].clone())
        if on_step is not None:
            on_step(i, state, metrics)
    return state, metrics, {
        "losses": [float(v) for v in losses],
        "bits": [float(v) for v in bits],
        "triggers": [int(v) for v in trig], "s_per_step": s_per_step}


def _lint(dcfg, train_step, pshape, arch: str, ranked: bool) -> None:
    """``--lint``: the reference's contract leg (``train.py:223-251``, less
    its XLA module): R6-R9 over the config at the true d and n, and the
    charged payload against the flat-buffer derivation (R10). Raises
    SystemExit on an unsuppressed error. With ranks, rank 0 audits and
    broadcasts the error count."""
    n_errors = [0]
    if ranked:
        import torch.distributed as dist
    if not ranked or dist.get_rank() == 0:
        from repro_torch.analysis.comm_lint import lint_dist_payload
        from repro_torch.analysis.contracts import run_contract_lint
        from repro_torch.analysis.rules import ERROR
        program = f"train[{arch}]"
        contract = run_contract_lint(
            dcfg, d=train_step.d_model_total, n=train_step.n_nodes,
            program=program, device=train_step.device)
        payload = lint_dist_payload(train_step.compressor, pshape,
                                    train_step.payload_bits, program=program)
        for f in payload:
            print(f"  [lint {f.rule_id}/{f.severity.upper()}] {f.message}",
                  flush=True)
        n_errors[0] = contract["errors"] + sum(f.severity == ERROR
                                               for f in payload)
    if ranked:
        dist.broadcast_object_list(n_errors, src=0)
    if n_errors[0]:
        raise SystemExit(f"[train] --lint: {n_errors[0]} static-audit "
                         f"error(s) in the configuration (see findings "
                         f"above)")
    print("[train] --lint: the configuration passes the static audit "
          "(theory contracts R6-R9, payload R10)")


def _run(args: argparse.Namespace, on_sync, on_checkpoint, mesh: Any = None
         ) -> Dict[str, Any]:
    from repro_torch.checkpoint import ckpt
    from repro_torch.core import prng
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.device import resolve_device
    from repro_torch.dist.sparq_dist import build_sparq

    dev = resolve_device(args.device)
    if args.devices or mesh is not None:
        import torch.distributed as dist
        from repro_torch.dist.comm import rank_device
        dev = rank_device(dev.type, int(os.environ.get("LOCAL_RANK",
                                                       dist.get_rank())))
    if dev.type == "cuda":
        # float32 products stay in full float32 (no TF32), like the reference
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg, dcfg = _configs(args)
    faults = dcfg.faults
    if args.devices and mesh is None:
        from repro_torch.dist import sharding
        from repro_torch.launch.mesh import make_production_mesh
        n_nodes, model_par = sharding.cli_factoring(args.devices,
                                                    cfg.n_nodes)
        cfg = dataclasses.replace(cfg, n_nodes=n_nodes)
        mesh = sharding.train_mesh(
            make_production_mesh(model=model_par, device_type=dev.type), cfg)
    sizes = None
    if mesh is not None:
        from repro_torch.dist import sharding
        sizes = sharding.axis_sizes(mesh)
    init_fn, train_step, pshape = build_sparq(cfg, dcfg, device=dev,
                                              on_sync=on_sync, mesh=mesh)
    plan = init_fn.plan
    rows = None
    if mesh is None:
        print(f"[train] ensemble n={cfg.n_nodes} on {dev} "
              f"arch={cfg.arch_id} (~{init_fn.d_model_total / 1e6:.1f}M "
              f"params/node)")
    else:
        print(f"[train] mesh {sizes}  arch={cfg.arch_id} "
              f"(~{init_fn.d_model_total / 1e6:.1f}M params/node); "
              f"{train_step.comm.describe()}")
        rows = ckpt.Rows.of(train_step)
    print(f"[train] gossip plan {plan.name} (R={plan.R}) "
          f"delta_eff={plan.delta_eff:.4f}")
    print(f"[train] compressor {train_step.compressor.name} "
          f"(payload {train_step.payload_bits:.6e} bits per message)")
    if not faults.is_null:
        print(f"[train] faults: link_drop={faults.link_drop} "
              f"stragglers={faults.stragglers}@{faults.straggler_frac} "
              f"dropout={[(w.node, w.start, w.end) for w in faults.dropout]} "
              f"seed={faults.seed}")

    if args.lint:
        _lint(dcfg, train_step, pshape, cfg.arch_id, mesh is not None)

    start, last, restored = 0, None, None
    if args.resume:
        last = ckpt.latest_step(args.ckpt_dir)
        if last is None:
            print(f"[train] --resume: no checkpoint under "
                  f"{args.ckpt_dir!r}, starting fresh")
    if last is not None:
        # the whole train state (params, x_hat, optimizer buffers, t,
        # bits/bits_c, sync_rounds, triggers) read into a zero state: no
        # x^0 is drawn for it
        t0 = time.perf_counter()
        state = ckpt.restore(args.ckpt_dir, last, like=init_fn.zero_state(),
                             rows=rows)
        _sync(dev)
        path = f"{args.ckpt_dir}/step_{last}"
        restored = {"path": path, "step": last,
                    "gb": ckpt.nbytes(state) / 1e9,
                    "s": time.perf_counter() - t0,
                    "host_rss_gb": host_peak_rss_gb()}
        start = last
        print(f"[train] resumed full train state from step {last} "
              f"(t={state['t']}, bits={float(state['bits']):.3e}): "
              f"{restored['gb']:.3f} GB in {restored['s']:.2f} s, host peak "
              f"RSS {restored['host_rss_gb']:.2f} GB")
        if on_checkpoint is not None:
            on_checkpoint("restore", path, last, state)
    else:
        t0 = time.perf_counter()
        state = init_fn(key=prng.PRNGKey(0))
        _sync(dev)
        print(f"[train] x^0 = init_params(PRNGKey(0)) drawn in "
              f"{time.perf_counter() - t0:.2f} s")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=args.seq_len,
                         batch_per_node=args.batch_per_node,
                         n_nodes=train_step.n_nodes, seed=0)

    saves: List[Dict[str, Any]] = []
    t_start = time.perf_counter()

    def after_step(i, state, metrics):
        if (i + 1) % args.log_every == 0:
            print(f"[train] step {i + 1:5d} loss {float(metrics['loss']):.4f} "
                  f"eta {float(metrics['eta']):.4f} "
                  f"bits {float(metrics['bits']):.3e} "
                  f"triggers {int(metrics['triggers'])} "
                  f"({(time.perf_counter() - t_start) / (i + 1 - start):.2f}"
                  f"s/step)")
        if args.ckpt_dir and args.ckpt_every and \
                (i + 1) % args.ckpt_every == 0:
            t0 = time.perf_counter()
            path = ckpt.save(args.ckpt_dir, i + 1, state, rows=rows)
            rec = {"path": path, "step": i + 1,
                   "gb": ckpt.nbytes(state) / 1e9,
                   "s": time.perf_counter() - t0,
                   "host_rss_gb": host_peak_rss_gb()}
            saves.append(rec)
            print(f"[train] checkpoint -> {path}: {rec['gb']:.3f} GB in "
                  f"{rec['s']:.2f} s, host peak RSS {rec['host_rss_gb']:.2f} "
                  f"GB")
            if on_checkpoint is not None:
                on_checkpoint("save", path, i + 1, state)

    state, metrics, record = train_steps(train_step, state, pipe, start,
                                         args.steps, after_step)
    loss_values = record["losses"]
    if metrics is None:
        # steps <= start: --steps 0, or a resume that is already complete
        print(f"[train] DONE no steps run (start={start}, "
              f"steps={args.steps})")
    else:
        print(f"[train] DONE loss={loss_values[-1]:.4f} "
              f"total_bits={float(metrics['bits']):.3e} "
              f"trigger_events={int(metrics['triggers'])}")
    if any(not math.isfinite(v) for v in loss_values):
        raise SystemExit(f"[train] non-finite loss: {loss_values}")
    return {**record, "state": state, "metrics": metrics,
            "train_step": train_step, "cfg": cfg, "start": start,
            "saves": saves, "restore": restored, "mesh": sizes,
            "exchange_s": list(train_step.exchange_s)}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
