"""Serving demo of the port (counterpart of ``examples/serve_demo.py``):
batched autoregressive decoding with a cache.

Draws the model from ``PRNGKey(0)`` (the reduced config unless ``--full``),
runs the prompt through the decode path token by token (a batched prefill
is ``dist/serve.build_prefill``), then decodes ``--gen`` greedy tokens per
sequence. ``--window W`` runs the sliding-window variant on a ring buffer
of W slots.

  PYTHONPATH=src python -m repro_torch.examples.serve_demo [--arch ARCH] \\
      [--device cpu] [--full] [--window W]
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
from repro_torch.dist.serve import build_decode
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
    return ap


def run(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Run the demo; returns the prompt, the generated tokens (B, gen), the
    last logits and the cache."""
    args = _parser().parse_args(argv)
    dev = resolve_device(args.device)
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
    step, _ = build_decode(cfg, dev)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    # the prompt through the decode path, token by token
    t0 = time.perf_counter()
    for t in range(args.prompt_len):
        logits, cache = step(params, cache, prompt[:, t:t + 1], None, t)
    sync()
    print(f"[serve] {cfg.arch_id} on {dev}: prefill {args.prompt_len} tokens "
          f"x{args.batch} in {time.perf_counter() - t0:.2f}s")
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
    print(f"[serve] generated {args.gen} tokens x{args.batch} in {dt:.2f}s "
          f"({args.gen * args.batch / dt:.1f} tok/s)")
    print("[serve] sample token ids:", gen[0].tolist())
    if not bool(torch.isfinite(logits).all()):
        raise SystemExit("[serve] non-finite logits")
    print("[serve] OK")
    return {"cfg": cfg, "prompt": prompt, "tokens": gen, "logits": logits,
            "cache": cache}


def main(argv: Optional[Sequence[str]] = None) -> int:
    run(argv)
    return 0


if __name__ == "__main__":
    sys.exit(main())
