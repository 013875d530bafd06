"""End-to-end decentralized LM training on the port (counterpart of
``examples/decentralized_lm.py``): SPARQ-SGD over 4 nodes on one device,
ring gossip, SignTopK of 10 % of each node's vector, H = 5, the event
trigger, with a checkpoint every 30 steps (add ``--use-kernel`` for the
blockwise SignTopK kernel of 10 % per tile).

  PYTHONPATH=src python -m repro_torch.examples.decentralized_lm [--full] \\
      [train flags, e.g. --device cpu --steps 4]

The reduced qwen1.5-0.5b by default; ``--full`` trains the full-width
config (about 0.6 B parameters per node; 4 nodes fill most of an 80 GB
card) with momentum 0.9. Checkpoints go to ``runs/sparq_lm_ckpts`` unless
``--ckpt-dir`` says otherwise; add ``--resume`` to continue from the latest.
"""
import sys

from repro_torch.launch import train


def main(argv=None) -> int:
    args = list(sys.argv[1:] if argv is None else argv)
    cmd = ["--arch", "qwen1.5-0.5b", "--nodes", "4", "--variant", "ring",
           "--H", "5", "--frac", "0.1", "--threshold", "2.0",
           "--steps", "60", "--log-every", "10", "--seq-len", "128",
           "--ckpt-dir", "runs/sparq_lm_ckpts", "--ckpt-every", "30"]
    if "--full" in args:
        args.remove("--full")
        cmd += ["--momentum", "0.9"]
    else:
        cmd += ["--reduced"]
    cmd += args           # later flags win in argparse
    print("+ python -m repro_torch.launch.train", " ".join(cmd))
    return train.main(cmd)


if __name__ == "__main__":
    sys.exit(main())
