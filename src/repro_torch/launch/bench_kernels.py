"""Kernel suite of the port (counterpart of ``benchmarks/bench_kernels.py``):
one row for each of SignTopK, QSGD and the fused trigger, each held against
the port's ``kernels/ref.py`` oracle on the same inputs.

    PYTHONPATH=src python -m repro_torch.launch.bench_kernels [--full] \\
        [--device cuda|cpu]

64 tiles (64K elements), or 1024 tiles with ``--full``. On ``cuda`` (the
default) the rows run the hand-written kernels and ``us_per_call`` is timed
with CUDA events; on ``cpu`` they run the plain versions and the times are
host-clock times of PyTorch's CPU operations. Each row gives:

* ``us_per_call`` and ``ref_us``: the kernel's and the oracle's time per call;
* ``bit_equal_oracle``: for SignTopK and the fused trigger, whether q and
  x_hat_new equal the oracle's bit for bit (``max_abs_err`` says by how much
  they differ where not); for QSGD, the verdict of the comparator of
  ``kernels/parity.py``, with its count of one-level flips at a rounding
  boundary in ``boundary_flips``;
* ``omega_empirical``: ``1 - ||x - C(x)||^2 / ||x||^2`` of the oracle;
* ``peak_mem_bytes``: the card's peak allocation over one call (None on the
  CPU); ``numel``: elements per call.

Nothing is written to disk.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import prng
from repro_torch.device import resolve_device
from repro_torch.kernels import ops, parity, ref
from repro_torch.kernels.qsgd import qsgd_blocks
from repro_torch.kernels.sign_topk import BLOCK, sign_topk_blocks

K_B = 102          # ~10% of a tile, as the reference suite
S = 16


def _time_us(fn: Callable[[], object], dev: torch.device, reps: int = 20
             ) -> float:
    """Mean time per call after one warm-up call: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e6
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / reps * 1e3


def _peak_bytes(fn: Callable[[], object], dev: torch.device) -> Optional[int]:
    if dev.type != "cuda":
        return None
    torch.cuda.synchronize(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    fn()
    torch.cuda.synchronize(dev)
    return int(torch.cuda.max_memory_allocated(dev))


def _exact(got: Sequence[torch.Tensor], want: Sequence[torch.Tensor]
           ) -> tuple:
    equal = all(torch.equal(a, b) for a, b in zip(got, want, strict=True))
    err = max(float((a.float() - b.float()).abs().max())
              for a, b in zip(got, want, strict=True))
    return equal, err


def run_bench(quick: bool = True, device: str = "cuda") -> List[Dict]:
    dev = resolve_device(device)
    nb = 64 if quick else 1024
    rng = np.random.default_rng(0)
    xh = torch.tensor(rng.standard_normal((nb, BLOCK)), dtype=torch.float32,
                      device=dev)
    xe = 0.5 * torch.tensor(rng.standard_normal((nb, BLOCK)),
                            dtype=torch.float32, device=dev)
    u = prng.uniform(prng.fold_in(prng.PRNGKey(0), 2), (nb, BLOCK)).to(dev)
    flat_h, flat_e = xh.reshape(-1), xe.reshape(-1)

    def oracle():
        return ref.sign_topk_ref(flat_h, flat_e, 1.0, K_B)
    q_r, xn_r, _, _ = oracle()
    ref_us = _time_us(oracle, dev)
    diff = flat_h - flat_e
    omega = 1.0 - float(torch.sum((diff - q_r) ** 2) / torch.sum(diff ** 2))
    rows = []

    def row(name, fn, oracle_us, check, omega_emp):
        out = {"name": name, "device": str(dev),
               "us_per_call": _time_us(fn, dev), "ref_us": oracle_us}
        out.update(check)
        out.update({"omega_empirical": omega_emp,
                    "peak_mem_bytes": _peak_bytes(fn, dev),
                    "numel": nb * BLOCK})
        rows.append(out)

    def st_fn():
        return sign_topk_blocks(xh, xe, 1.0, K_B)
    q_k, xn_k, _ = st_fn()
    eq, err = _exact((q_k.reshape(-1), xn_k.reshape(-1)), (q_r, xn_r))
    row("kernel_sign_topk", st_fn, ref_us,
        {"bit_equal_oracle": eq, "max_abs_err": err}, omega)

    def q_fn():
        return qsgd_blocks(xh, u, S)

    def q_oracle():
        return ref.qsgd_ref(flat_h, u.reshape(-1), S)
    yq = q_oracle()
    omega_q = 1.0 - float(torch.sum((flat_h - yq) ** 2)
                          / torch.sum(flat_h ** 2))
    try:
        err_q, flips = parity.compare_qsgd(xh, u, S, q_fn(),
                                           yq.view(nb, BLOCK))
        verdict = {"bit_equal_oracle": True, "max_abs_err": err_q,
                   "boundary_flips": flips}
    except AssertionError as exc:
        verdict = {"bit_equal_oracle": False, "mismatch": str(exc)}
    row("kernel_qsgd", q_fn, _time_us(q_oracle, dev), verdict, omega_q)

    def f_fn():
        return ops.trigger_compress_update(flat_h, flat_e, 0.0, K_B)
    q_f, xn_f, _ = f_fn()
    eq_f, err_f = _exact((q_f, xn_f), (q_r, xn_r))
    row("kernel_fused_trigger", f_fn, ref_us,
        {"bit_equal_oracle": eq_f, "max_abs_err": err_f}, omega)
    return rows


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="1024 tiles (1M elements) instead of 64")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; cuda without a GPU raises")
    args = ap.parse_args(argv)
    for r in run_bench(quick=not args.full, device=args.device):
        print(json.dumps(r))
    return 0


if __name__ == "__main__":
    sys.exit(main())
