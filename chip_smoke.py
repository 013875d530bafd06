#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):

1. set-up: the card's name and power limit, and the build of every CUDA
   kernel from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a;
2. each kernel against its plain PyTorch version on the card, on the cases
   of the reference's kernel tests, then timed at the main path's shape and
   held against the plain version there on every tile;
   then the flat-buffer engine on a small float32 model, its CUDA kernel path
   against its plain path on the CPU;
3. the main path: the port's train entry at the full width of qwen1.5-0.5b
   (24 layers, d_model 1024, vocab 151,936; random weights from seed 0),
   4 nodes on the one card, 6 steps with a sync every 3; the kernel launch
   counts are set to 0 just before and read just after; then a profiled
   run of 3 steps, whose sync's real diff is kept, and the kernel held
   against its plain version on every tile of that diff;
4. one JSON line of per-kernel numbers, the card's name and power limit, and
   last the JSON result line.

It imports only torch, numpy and the port (never jax or the JAX package),
and exits non-zero without a result when there is no CUDA device or when
the port's sources are not beside it.
"""
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# NVIDIA H100 SXM data sheet: HBM3 rate, and the float32 rate outside the
# tensor cores. The sheet gives no int32 rate: an SM has 64 INT32 lanes to
# 128 FP32 lanes, so int32 runs at half the float32 rate
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
INT32_OPS_PER_S = F32_OPS_PER_S / 2
# SignTopK per element: 31 radix passes of an integer compare and add on the
# bit patterns (62), about 6 more integer operations for the support and tie
# masks; about 4 float32 operations for |diff|, the sum and q. The two kinds
# issue to separate pipes, so the least time is the larger of the two
SIGN_TOPK_INT_OPS = 68
SIGN_TOPK_F32_OPS = 4
PLAIN_ROWS = 1 << 16          # tiles per call of the plain version
MAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--nodes", "4", "--use-kernel",
             "--steps", "6", "--H", "3", "--batch-per-node", "2",
             "--seq-len", "128", "--log-every", "1", "--device", "cuda"]


def log(msg: str) -> None:
    print(f"[smoke] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` launches, after a warm-up,
    by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print("chip_smoke: the port's sources (src/repro_torch) are not "
              "beside this script", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "runs the port on a CUDA device only", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import numpy as np

    from repro_torch import kernels
    from repro_torch.configs.registry import get_config
    from repro_torch.core import schedule, triggers
    from repro_torch.dist.sparq_dist import (DistSparqConfig, _flatten_spec,
                                             build_sparq)
    from repro_torch.kernels import parity
    from repro_torch.kernels.sign_topk import (BLOCK, sign_topk_blocks,
                                               sign_topk_blocks_plain)
    from repro_torch.launch import train
    from repro_torch.models.transformer import init_params, param_shapes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_all = time.perf_counter()

    # ---------------------------------------------------------- 1. set-up
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = kernels.build()
    regs = [ln.strip() for ln in built.log.splitlines() if "registers" in ln]
    log(f"sign_topk.cu built in {time.perf_counter() - t0:.2f} s (nvcc "
        f"{built.seconds:.2f} s); {'; '.join(regs)}")

    # ------------------------------------------- 2. kernel vs plain, timing
    max_err = 0.0
    n_cases = 0
    for _, err in parity.check_all_sign_topk(dev):
        max_err = max(max_err, err)
        n_cases += 1
    parity.check_ensemble_matches_rows(dev)
    parity.check_payload_reconstructs(dev)
    torch.cuda.synchronize()
    log(f"sign_topk kernel == plain version on {n_cases} cases "
        f"(+ ensemble == rows, payload rebuilds q); max abs err {max_err:.3e}")

    cfg = get_config("qwen1.5-0.5b")
    n_nodes = 4
    k_b = math.ceil(0.1 * BLOCK)
    _, D = _flatten_spec(param_shapes(cfg))
    d_pad = -(-D // BLOCK) * BLOCK
    rows = n_nodes * d_pad // BLOCK
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((rows, BLOCK), generator=gen, device=dev)
    kernel_ms = time_ms(torch, lambda: sign_topk_blocks(x, None, 1.0, k_b), 10)

    def plain_full():
        # the plain version's temporaries at the full shape would not fit,
        # so it runs over every tile PLAIN_ROWS tiles per call
        for lo in range(0, rows, PLAIN_ROWS):
            sign_topk_blocks_plain(x[lo:lo + PLAIN_ROWS], None, 1.0, k_b)
    plain_ms = time_ms(torch, plain_full, 2)
    topk_ms = time_ms(torch, lambda: torch.topk(x.abs(), k_b, dim=1), 3)
    elements = rows * BLOCK
    bytes_moved = elements * (4 + 4) + rows * 4   # diff in; q and scales out
    bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(elements * SIGN_TOPK_INT_OPS / INT32_OPS_PER_S,
                 elements * SIGN_TOPK_F32_OPS / F32_OPS_PER_S) * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    log(f"main-path shape ({rows}, {BLOCK}) f32, k_b={k_b}, ensemble mode:")
    log(f"  kernel_ms {kernel_ms:.4f}")
    log(f"  plain_ms {plain_ms:.4f} (every tile, {PLAIN_ROWS} tiles per "
        f"call)")
    log(f"  bound_ms {bound_ms:.4f} (bytes {bytes_moved / 1e9:.2f} GB -> "
        f"{bytes_ms:.4f} ms; operations -> {ops_ms:.4f} ms)")
    log(f"  torch.topk(|diff|, {k_b}) selection only: {topk_ms:.4f} ms")
    full_err = parity.check_sign_topk_chunked(x, k_b, PLAIN_ROWS,
                                              spec="main-path shape")
    max_err = max(max_err, full_err)
    log(f"  kernel == plain version on all {rows} tiles: max abs err "
        f"{full_err:.3e}")
    del x
    torch.cuda.empty_cache()

    # the flat-buffer engine, kernel path on the card vs plain path on the
    # CPU, on a small float32 model from the same weights: the repo's own
    # reference for the slice. frac = 1 selects every nonzero entry, so the
    # comparison has no selection boundary that a rounding difference in the
    # gradients could cross (phase 2 covers the selection itself)
    import dataclasses
    small = dataclasses.replace(cfg.reduced(n_layers=1, d_model=128,
                                            vocab=256),
                                n_nodes=4, compute_dtype="float32")
    dcfg = DistSparqConfig(H=2, variant="ring", frac=1.0, use_kernel=True,
                           gamma=0.3, lr=schedule.fixed(0.01),
                           threshold=triggers.zero())
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, 256, (4, 2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    cpu_gen = torch.Generator()
    cpu_gen.manual_seed(0)
    p0 = init_params(small, cpu_gen)
    out = {}
    for where in ("cuda", "cpu"):
        init_fn, step, _ = build_sparq(small, dcfg, device=where)
        state = init_fn(params=p0)
        losses = []
        for _ in range(4):
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        out[where] = state, losses
    (a, la), (b, lb) = out["cuda"], out["cpu"]
    small_err = float((a["params"].cpu() - b["params"]).abs().max())
    if small_err > 5e-4:
        raise AssertionError(f"small engine: CUDA params differ from the "
                             f"plain path by {small_err:.3e} > 5e-4")
    if any(abs(u - v) > 1e-3 * abs(v) for u, v in zip(la, lb)):
        raise AssertionError(f"small engine: losses {la} != {lb}")
    if int(a["triggers"]) != int(b["triggers"]) or \
            a["sync_rounds"] != b["sync_rounds"]:
        raise AssertionError("small engine: trigger or sync counts differ")
    if abs(float(a["bits"]) - float(b["bits"])) > 1e-6 * float(b["bits"]):
        raise AssertionError("small engine: bit totals differ")
    log(f"small engine, CUDA kernel path == plain CPU path over 4 steps "
        f"(max |params| diff {small_err:.3e}, triggers {int(a['triggers'])})")
    del out, a, b
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 3. main path
    torch.cuda.reset_peak_memory_stats(dev)
    sign_topk_blocks.launches = 0
    result = train.run(MAIN_ARGS)
    launches = sign_topk_blocks.launches
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    state, step = result["state"], result["train_step"]
    losses = result["losses"]
    log(f"main path: losses {losses}")
    if len(losses) != 6 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"main path: losses {losses}")
    if abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"first loss {losses[0]} is not within 1.0 of "
                             f"ln({cfg.vocab_size})")
    if step.d_model_total != D or step.n_nodes != n_nodes:
        raise AssertionError("main path: unexpected model size")
    if state["sync_rounds"] != 2 or launches != state["sync_rounds"]:
        raise AssertionError(f"main path: {launches} kernel launches for "
                             f"{state['sync_rounds']} syncs (want 2)")
    trig = int(state["triggers"])
    if trig <= 0:
        raise AssertionError("main path: no node triggered")
    degs = step.plan.degrees[0]
    if not np.all(degs == degs[0]):
        raise AssertionError("main path: expected a regular ring")
    want_bits = float(degs[0]) * (n_nodes * state["sync_rounds"]
                                  + trig * step.payload_bits)
    got_bits = float(state["bits"])
    if abs(got_bits - want_bits) > 1e-6 * want_bits:
        raise AssertionError(f"main path: bits {got_bits} != {want_bits} "
                             f"reckoned from {trig} triggers")
    if state["params"][:, D:].any() or state["x_hat"][:, D:].any():
        raise AssertionError("main path: the padded tail is not zero")
    s_step = result["s_per_step"]
    log(f"main path: {launches} kernel launches, {trig} triggers, bits "
        f"{got_bits:.6e} == reckoned {want_bits:.6e}")
    log(f"main path: s/step {[round(v, 4) for v in s_step]} (first step "
        f"includes CUDA/cuBLAS start-up); steady mean "
        f"{sum(s_step[1:]) / len(s_step[1:]):.4f} s")
    log(f"main path: peak memory allocated {peak_gb:.2f} GB")

    k_b_main = step.k_b
    del result, state, step
    torch.cuda.empty_cache()

    # where a step's time goes: one more run of the main path (3 steps, one
    # sync) under torch.profiler, after the counts were read. Device time is
    # summed over the kernels themselves; the idle share compares it with
    # the un-profiled steady wall time above (the profiler slows the host).
    # Its sync's diff, the kernel's real input on the main path, is kept
    # (one 9.9 GB device copy, in the profiled time) to check the kernel on
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    prof_args = list(MAIN_ARGS)
    prof_args[prof_args.index("--steps") + 1] = "3"
    captured = []
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        train.run(prof_args,
                  on_sync=lambda diff: captured.append(diff.clone()))
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_s = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA) / 1e6 / 3
    launches_per_step = sum(e.count for e in events
                            if e.device_type == DeviceType.CUDA) / 3
    steady = sum(s_step[1:]) / len(s_step[1:])
    log(f"profiled 3 steps: device time {device_s:.4f} s/step over "
        f"{launches_per_step:.0f} kernels/step; against the steady "
        f"{steady:.4f} s/step the device is idle "
        f"{100 * (1 - device_s / steady):.1f}% of the time")
    print(events.table(sort_by="self_device_time_total", row_limit=12),
          flush=True)
    print(events.table(sort_by="self_cpu_time_total", row_limit=8),
          flush=True)

    if len(captured) != 1 or captured[0].shape != (n_nodes, d_pad):
        raise AssertionError("profiled run: expected one sync's (n, D_pad) "
                             "diff")
    diff_tiles = captured.pop().view(-1, BLOCK)
    real_err = parity.check_sign_topk_chunked(diff_tiles, k_b_main,
                                              PLAIN_ROWS,
                                              spec="main-path diff")
    max_err = max(max_err, real_err)
    log(f"kernel == plain version on every tile of the first sync's diff "
        f"({diff_tiles.shape[0]} tiles): max abs err {real_err:.3e}")
    del diff_tiles

    # ------------------------------------------------------------- 4. report
    report = {"kernels": [{
        "name": "sign_topk_blocks", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sign_topk.cu",
        "replaces": "src/repro/kernels/sign_topk.py:122",
        "launches": launches, "max_abs_err": max_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
        "plain_tiles_per_call": PLAIN_ROWS, "bytes_ms": bytes_ms,
        "ops_ms": ops_ms, "topk_selection_only_ms": topk_ms,
        "shape": [rows, BLOCK], "k_b": k_b}]}
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(report))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
