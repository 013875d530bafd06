"""Read a cell's compared numbers over many seeds in one process, to set
its limits: the program's (the lower readings), the control's and each
planted fault's (the upper readings). Not run by the benchmark's runs.

    python bench/tools/readings.py --workload dsmoe16b-d2n4.train \\
        --seeds 11,12,13 --as program --out chiprun_out/r.jsonl

``--as``: ``program`` the program as the window drives it; ``control``
the plain reference computed in float8 e4m3 in the program's place;
``half_batch`` the program with each node's rows halved; ``unchanged``
the program with its state handed back unchanged after every step;
``no_mixing`` the program with the sync's mixing left out (gamma 0). One
JSON line per seed: the numbers, the per-leaf readings and the seconds.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--as", dest="side", default="program",
                    choices=("program", "control", "half_batch",
                             "unchanged", "no_mixing"))
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT / "bench")]
    import torch

    from harness import cell as program
    from harness import compare, reference, spec, traffic

    c = spec.cell(args.workload, ROOT)
    if not torch.cuda.is_available():
        print("[readings] the cell's sizes want the card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    prog = None
    if args.side != "control":
        faults = program.Faults(**({args.side: True}
                                   if args.side != "program" else {}))
        prog = program.Program(c, dev, faults)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in (int(s) for s in args.seeds.split(",")):
            t0 = time.perf_counter()
            if prog is not None:
                state, ring, got = prog.start(seed)
                batches = prog.reference_batches(ring)
                del state, ring
            else:
                pipe = traffic.pipeline(c.workload, int(
                    c.config["vocab_size"]), c.n_nodes, seed)
                batches = [pipe.global_batch(t) for t in
                           range(program.compared_steps(c.H))]
                got = reference.run(c.config, c.workload, seed, batches, dev,
                                    precision="fp8")
            t1 = time.perf_counter()
            program.free(dev)
            ref = reference.run(c.config, c.workload, seed, batches, dev)
            t2 = time.perf_counter()
            program.free(dev)
            values = compare.numbers(got, ref)
            keys = ("losses", "grad0", "change", "xhat", "bits", "triggers",
                    "mix", "mix_norm")
            line = {"cell": c.name, "as": args.side, "seed": seed,
                    "numbers": values, "side_s": t1 - t0, "ref_s": t2 - t1,
                    "leaves": ref["leaves"],
                    "per_leaf": compare.per_leaf(got, ref),
                    "prog": {k: got[k] for k in keys},
                    "ref": {k: ref[k] for k in keys}}
            print(json.dumps({"seed": seed, "as": args.side, **values,
                              "side_s": t1 - t0, "ref_s": t2 - t1}),
                  flush=True)
            if sink:
                sink.write(json.dumps(line) + "\n")
                sink.flush()
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
