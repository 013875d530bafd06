"""Serving demo of the port (counterpart of ``examples/serve_demo.py``):
batched autoregressive decoding with a cache.

Draws the model from ``PRNGKey(0)`` (the reduced config unless ``--full``),
runs the prompt through the decode path token by token (a batched prefill
is ``dist/serve.build_prefill``), then decodes ``--gen`` greedy tokens per
sequence. ``--window W`` runs the sliding-window variant on a ring buffer
of W slots. ``--model N`` serves over a ``(data 1, model N)`` mesh of N
ranks (tensor parallelism, :mod:`repro_torch.models.parallel`): each rank holds
only its blocks of the weights and the cache; the ranks share the card (or
the CPU) over gloo and rank 0 prints.

  PYTHONPATH=src python -m repro_torch.examples.serve_demo [--arch ARCH] \\
      [--device cpu] [--full] [--window W] [--model N]
"""
import argparse
import dataclasses
import sys
import time
from typing import Any, Dict, Optional, Sequence

import torch

from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.dist.serve import build_decode, local_shard
from repro_torch.models.transformer import init_cache, init_params


def _parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen1.5-0.5b", choices=ARCH_IDS)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=24)
    ap.add_argument("--window", type=int, default=0,
                    help="sliding-window size (0 = full attention)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    ap.add_argument("--full", action="store_true",
                    help="the config's full width instead of .reduced()")
    ap.add_argument("--model", type=int, default=1,
                    help="ranks on the serve mesh's model axis (tensor "
                         "parallelism over gloo ranks)")
    return ap


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the demo; returns the prompt, the generated tokens (B, gen), the
    last logits and the cache (with ``--model N``, rank 0's, on the
    host)."""
    argv = list(sys.argv[1:] if argv is None else argv)
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    if args.model > 1:
        from repro_torch.dist import comm
        return comm.spawn(_rank, args.model, (argv,),
                          device_type=dev.type)[0]
    return _serve(args, dev, None)


def _rank(rank: int, argv: Sequence[str]) -> Dict[str, Any]:
    """One rank of ``--model N``: the demo on its blocks, kept on the
    host."""
    from repro_torch.dist import sharding
    from repro_torch.launch.mesh import make_production_mesh
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
    mesh = sharding.serve_mesh(make_production_mesh(model=args.model,
                                                    device_type=dev.type))
    out = _serve(args, dev, mesh)
    return {k: v if k == "cfg" else
            {n: {m: t.cpu() for m, t in sub.items()}
             for n, sub in v.items()} if k == "cache" else v.cpu()
            for k, v in out.items()}


def _serve(args: argparse.Namespace, dev: torch.device,
           mesh: Any) -> Dict[str, Any]:
    """The demo on ``dev``, or on this rank's blocks over ``mesh``."""
    cfg = get_config(args.arch)
    if not args.full:
        cfg = cfg.reduced()
    if args.window:
        cfg = dataclasses.replace(cfg, sliding_window=args.window)
    key = prng.PRNGKey(0)
    params = init_params(cfg, key.to(dev))
    max_len = args.prompt_len + args.gen
    cache_len = min(args.window, max_len) if args.window else max_len
    cache = init_cache(cfg, args.batch, cache_len, device=dev)
    prompt = prng.randint(key, (args.batch, args.prompt_len), 0,
                          cfg.vocab_size).to(dev)
    step, shardings = build_decode(cfg, dev if mesh is None else mesh)
    if mesh is not None:
        ps, cs, _, _, _ = shardings(params, cache, prompt[:, :1], None)
        params = local_shard(params, ps, mesh)
        cache = local_shard(cache, cs, mesh)
    # one rank prints
    say = print if mesh is None or not mesh.get_rank() else \
        (lambda *a: None)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the prompt through the decode path, token by token
    t0 = time.perf_counter()
    for t in range(args.prompt_len):
        logits, cache = step(params, cache, prompt[:, t:t + 1], None, t)
    sync()
    where = dev if mesh is None else f"{dev} (model {args.model})"
    say(f"[serve] {cfg.arch_id} on {where}: prefill {args.prompt_len} "
        f"tokens x{args.batch} in {time.perf_counter() - t0:.2f}s")
    out = []
    tok = torch.argmax(logits[:, -1:], dim=-1)
    t0 = time.perf_counter()
    for t in range(args.prompt_len, max_len):
        logits, cache = step(params, cache, tok, None, t)
        tok = torch.argmax(logits[:, -1:], dim=-1)
        out.append(tok)
    sync()
    dt = time.perf_counter() - t0
    gen = torch.cat(out, dim=1)
    say(f"[serve] generated {args.gen} tokens x{args.batch} in {dt:.2f}s "
        f"({args.gen * args.batch / dt:.1f} tok/s)")
    say("[serve] sample token ids:", gen[0].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("[serve] non-finite logits")
    say("[serve] OK")
    return {"cfg": cfg, "prompt": prompt, "tokens": gen, "logits": logits,
            "cache": cache}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
