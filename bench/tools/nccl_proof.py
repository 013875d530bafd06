"""``launch/train.py`` on one seed twice, on the cards of one host: one node
a card, ranks started by ``comm.spawn`` (NCCL when every rank has a card of
its own), over the ``(node, fsdp 1, model 1)`` mesh that ``--devices``
factors; then every node in one process on the first card. Prints each
run's losses, bits and triggers a step, whether they are equal, and each
row's largest difference in params and x_hat. Not run by the benchmark's
runs.

    python bench/tools/nccl_proof.py --out runs/nccl_proof.json -- \\
        --arch deepseek-moe-16b --layers 2 --nodes 4 --use-kernel \\
        --steps 6 --H 3 --batch-per-node 8 --seq-len 512

The flags after ``--`` are ``launch/train.py``'s, without ``--devices``
(the tool adds ``--devices`` with one rank a node; with ``--device cpu``
the ranks run on the CPU over gloo). Each rank keeps its
final rows on its card; rank 0 moves its own to the host and runs the
one-process run on its card, then takes each rank's rows over the group
and compares them there.
"""
from __future__ import annotations

import argparse
import gc
import json
import sys
from pathlib import Path
from typing import Any, Dict, List

ROOT = Path(__file__).resolve().parents[2]
KEYS = ("params", "x_hat")


def _rank(rank: int, argv: List[str]) -> Dict[str, Any]:
    import torch
    import torch.distributed as dist

    from repro_torch.launch import train

    world = dist.get_world_size()
    out = train.run(argv + ["--devices", str(world)])
    mine = {k: out["state"][k] for k in KEYS}
    got = {k: out[k] for k in ("losses", "bits", "triggers", "mesh")}
    del out
    if rank == 0:
        mine = {k: v.cpu() for k, v in mine.items()}
    gc.collect()
    torch.cuda.empty_cache()
    dist.barrier()
    if rank:
        for k in KEYS:
            dist.send(mine[k].contiguous(), dst=0)
        dist.barrier()
        return got
    one = train.run(argv)
    want = {k: one["state"][k] for k in KEYS}
    got["one"] = {k: one[k] for k in ("losses", "bits", "triggers")}
    del one
    gc.collect()
    largest = {k: [] for k in KEYS}
    for r in range(world):
        for k in KEYS:
            if r == 0:
                row = mine[k].to(want[k].device)
            else:
                row = torch.empty_like(want[k][r:r + 1])
                dist.recv(row, src=r)
            largest[k].append(float((row[0] - want[k][r]).abs().max()))
            del row
    dist.barrier()
    got["largest"] = largest
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="")
    ap.add_argument("train", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    train_argv = [a for a in args.train if a != "--"]
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch import kernels
    from repro_torch.dist import comm
    from repro_torch.launch.train import configs

    device_type = "cpu" if "cpu" in train_argv else "cuda"
    n = configs(train_argv)[0].n_nodes
    if device_type == "cuda" and n > torch.cuda.device_count():
        print(f"[nccl_proof] {n} nodes, {torch.cuda.device_count()} cards",
              file=sys.stderr)
        return 2
    if device_type == "cuda" and "--use-kernel" in train_argv:
        kernels.build()
    got = comm.spawn(_rank, n, (train_argv,), device_type=device_type,
                     deadline_s=1800.0)
    first = got[0]
    line = {
        "backend": comm.backend_for(device_type, n), "ranks": n,
        "cards": [torch.cuda.get_device_name(i) for i in range(n)
                  if device_type == "cuda"],
        "mesh": first["mesh"],
        "ranks_agree": all(g[k] == first[k] for g in got
                           for k in ("losses", "bits", "triggers")),
        "equal": all(first[k] == first["one"][k]
                     for k in ("losses", "bits", "triggers")),
        "mesh_run": {k: first[k] for k in ("losses", "bits", "triggers")},
        "one_process": first["one"], "largest_diff": first["largest"]}
    text = json.dumps(line)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(text + "\n")
    print(text, flush=True)
    return 0 if line["equal"] and line["ranks_agree"] else 1


if __name__ == "__main__":
    sys.exit(main())
