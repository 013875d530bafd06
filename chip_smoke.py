#!/usr/bin/env python3
"""Run the PyTorch port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing falls back):

1. set-up: the card's name and power limit, and the build of every CUDA
   kernel from ``src/repro_torch/kernels/csrc`` with nvcc for sm_90a, one
   nvcc per source, all at once, with each kernel's register and spill
   lines;
2. each kernel against its plain PyTorch version on the card, on the cases
   of the reference's kernel tests, then timed at the main path's shape,
   (2,420,196, 1024) float32, and held against the plain version there on
   every tile; then the flat-buffer engine on a small float32 model, its
   CUDA kernel path against its plain path on the CPU;
3. the paths, each driven with every launch count set to 0 just before and
   read just after, and failed if a kernel of the path was never launched:
   a. the trainer (the main path): the port's train entry at the full width
      of qwen1.5-0.5b (24 layers, d_model 1024, vocab 151,936; random
      weights from seed 0), 4 nodes on the one card, 6 steps with a sync
      every 3 (SignTopK); then 3 more steps of the run profiled, whose
      sync's real diff is kept, and the kernel timed on that diff and held
      against its plain version on every tile of it;
   b. the faulty, time-varying trainer at the same full width, cut to
      depth 8 of 24 (the smoke's time limit): a random matchings plan of
      4 rounds, 30 % link drop, node 1 straggling half
      its steps, node 2 offline for steps 1-3 (SignTopK once per sync);
      every sync's repaired matrix, degrees and liveness held against the
      plan's own repair on the host, and the bits against the reckoning
      from them and the triggers; then, at depth 6 of 24, 4 steps and 3
      more profiled (the profiler's host cost grows with the launches);
   c. the same flags at reduced width, on the card and on the CPU;
   d. the generic path at full width: no ``--use-kernel``, a global
      SignTopK of 10 % of each node's 619,570,176 entries, one sync;
   e. the kernel suite (``launch/bench_kernels.py --full``: SignTopK, QSGD
      and the fused trigger against the oracle);
   f. the reference engine: the golden cases ``sparq``, ``squarm``,
      ``choco`` and ``sparq_faults`` held against ``tests/golden/*.json``,
      then SPARQ with BlockTopFrac at the paper's convex scale (n=60 ring,
      d=7840, T=4000; SignTopK once per sync) against the port's CPU run of
      the same config; then the convex experiment at its quick size
      (``launch/convex_bits.py``) in the committed file's threefry layout,
      its bits, triggers and rounds against ``BENCH_convex.json`` (its rows
      use the global operators and launch no kernel);
   g. the fault experiment (``launch/faults_bits.py --full``: n=32,
      d=7840, T=2000), whose BlockTopFrac row launches SignTopK once per
      sync, and a profiled run of that row for its idle share; the topology
      experiment (``launch/topology_bits.py``) at its quick size; then both
      in quick mode on the card and on the CPU, row against row;
   h. x^0 at full width: ``init_fn(key=PRNGKey(0))`` timed, with its
      transient peak; the card's uniform bits of the first 2^20 values of
      the embedding and of every layer's ``wo`` equal to a numpy draw on the
      host, and the values within 4 ulps of the host's truncated normals;
   i. checkpoint and resume at full width, cut to depth 8 of 24, through
      the kernel (the main path's flags and momentum 0.9): 6 unbroken steps
      saving at step 4, then ``--resume`` from step 4 across the sync of
      t = 6; the files
      read back chunk by chunk against the live buffers after the save and
      after the restore (bit for bit), and the resumed run's final state
      (kept on the host) against a repeat of the unbroken run's: integer
      channels exact, float buffers bit for bit or boundary flips only;
   j. the nonconvex, momentum and ablation experiments at their quick size
      in the committed files' threefry layout, their bits, triggers and
      sync rounds against ``BENCH_{nonconvex,momentum,ablation}.json``; two
      rows on the card against the CPU in float32 over 30 steps; the
      headline row profiled for its idle share;
   k. the MoE family and the new dense configs: deepseek-moe-16b at full
      width (d_model 2048, 64 routed experts top-6 of width 1408, 2 shared,
      vocab 102,400) cut to one dense and one MoE layer, 4 nodes, the main
      path's flags through the train entry: SignTopK twice, bits against
      the reckoning, every step's dropped choices and aux, the recomputed
      routing equal to the forward's, the kernel timed on the last sync's
      real diff and held against its plain version on every tile of it
      chunk by chunk, then 3 more steps of the run profiled, and the kernel
      timed at the same shape on Gaussian tiles; stablelm-1.6b at
      full width and depth, 2 nodes, 3 steps; then at reduced width in
      float32 on the card against the CPU: deepseek-moe-16b at n = 4 for 6
      steps (the first routing of every node equal exactly, losses within
      1e-4, x_hat and params up to boundary flips) and minitron-4b,
      stablelm-1.6b, qwen1.5-32b, musicgen-large and chameleon-34b at
      d_model 128, vocab 256 for 3 steps (losses within 1e-4);
   l. the SSM family and the hybrid: mamba2-370m at full width (d_model
      1024, 32 SSM heads of 64, state 128, vocab 50,280) cut to depth 12 of
      48 (the smoke's time limit), 8 nodes, and zamba2-7b at full width (d_model 3584, 112 SSM
      heads, state 64, 32 attention heads, d_ff 14,336) cut to 12 layers,
      so that its shared attention block runs after layers 5 and 11, 3
      nodes; the main path's flags through the train entry: SignTopK
      twice, bits against the reckoning, the shared block's uses counted,
      the kernel timed on the last sync's real diff and held against its
      plain version on every tile of it chunk by chunk; mamba2-370m at
      depth 6 profiled for its idle share; then both at reduced width in
      float32 on the card against the CPU for 6 steps (x^0 within 4 ulps,
      losses within 1e-4, x_hat and params up to boundary flips);
   m. serving (prefill, then cached decode) through ``dist/serve.py``'s
      ``build_prefill`` and ``build_decode``, x^0 drawn on the card from
      PRNGKey(0): qwen1.5-0.5b at full width and depth (4 prompts of 2,048
      tokens, then 32 decode steps at cache_len 4,096 teacher-forced on
      the prompt; then a decode_32k cache at batch 8, 8 steps at positions
      32,760..32,767; then long_500k's sliding window of 4,096 as a ring
      buffer at batch 1, 16 steps across a multiple of the window, slots
      reused); deepseek-v3-671b at full width (MLA with the absorbed
      decode, 256 experts, bfloat16 weights) cut to depth 4, 2 x 512
      tokens and 32 steps (its float32 check at capacity factor 8.0);
      mamba2-370m at full width and depth (4 x 2,048, 32 recurrent steps);
      zamba2-7b at full width and all 81 layers (2 x 1,024, 32 steps, 13
      shared-block caches); each with its prefill
      and decode times, tokens/s, peak and decode-vs-prefill gap, then
      again in float32 compute and scores on the same weights, where each
      decode step's logits are held against prefill's within 1e-3 of the
      largest (decode 3 steps profiled at 4,096 and 32,768 slots). Then
      every config's reduced decode in float32 on the card against the CPU
      (16 greedy steps: logits within 1e-5 relative, pos and tokens equal)
      and deepseek-v3-671b's reduced trainer with its MTP loss on the card
      against the CPU (6 steps, SignTopK twice and held against its plain
      version, bits against the reckoning, losses within 1e-4);
   n. sharding (``dist/sharding.py``, ``dist/comm.py``, the engine over a
      ``(node, fsdp, model)`` mesh): four ranks share the card over gloo
      (their rows staged through pinned host buffers) and train
      qwen1.5-0.5b at full width and depth through the train entry with
      phase a's flags and ``--devices 4``, one node per rank: per-step
      losses, bits and triggers and a checksum of every row of params and
      x_hat equal phase a's, SignTopK held against its plain version on
      each rank's tiles at the last sync, per-rank s/step, exchange seconds
      per sync and peak memory; then at reduced width: the engine under an
      NCCL group of one rank equal to the unsharded card run bit for bit;
      (node 2, fsdp 2) over four ranks against one process (bits and
      triggers exactly, params up to boundary flips); the faulty
      time-varying trainer over two ranks, mixing through the row gather,
      equal to one process bit for bit; a checkpoint saved at
      ``--devices 4``, restored in one process and continued, equal to the
      unbroken run bit for bit; the serve builders over a (data 2,
      model 1) mesh against one process in float32; tensor-parallel
      serve over (data 1, model 2), each of the two ranks holding only its
      blocks of the parameters and the cache: qwen1.5-0.5b at full width
      and depth (prefill 1 x 512, 16 teacher-forced decode steps) and the
      reduced MoE, MLA with MTP, SSM and hybrid configs, the dense one with
      its cache on the slots and with the embedding over d_model, in
      float32 against the one-process card run (logits within 1e-5 of the
      largest, cache shards against their blocks, pos exactly; parameter
      bytes, peak and times per rank, the times a correctness run's); and
      reduced deepseek-moe-16b trained over (node 1, fsdp 2), every MoE
      layer routing the node's whole microbatch over the pair: the first
      step's tables joined over the ranks equal to the one-process run's,
      losses within 1e-5, x_hat within the flips rule, SignTopK held
      against its plain version on each rank's tiles;
   o. the audits (``repro_torch.analysis``): the omega certificates of the
      nine registry compressors at the main path's d, drawn on the card
      (SignTopK launched for BlockTopFrac's) and held against the same
      call on the CPU, field by field, worst ratio and bound within 1e-6;
      the bits oracle's two fixtures (R10) on the card; K1's probes of
      both kernels in every dtype (NaN-filled outputs on views one guard
      tile short: every tile written, the guard untouched, equal to the
      plain version) and K3's attributes against the sources' closed
      form; the contract lint (R6-R9) of phase a's config at full width;
      ``train --lint`` on the reduced config for one step. Phases f, g and
      j hold every suite row's contract_status and bits_oracle (the convex
      and LM rows equal to the committed files');
   p. the suite driver and the roofline (``launch/run.py``,
      ``launch/dryrun.py``, ``launch/op_walk.py``): the kernels suite
      (quick) through the driver into a temporary directory, then
      ``--check-artifacts`` on it with no bad row; the roofline suite
      through the driver, started in a process of its own before phase e
      so that it runs beside e-o, which dry-runs qwen1.5-0.5b at
      ``train_4k`` and ``decode_32k`` on ``meta`` over the reference's 16x16
      grid (with ``--lint``), its terms printed; one sync step of the reduced float32 qwen1.5-0.5b trainer
      (4 nodes, the kernel path) counted on the card and on ``meta``: dot
      FLOPs, bytes and the kernel's closed-form charge equal; and, as
      context, the full-width main path's FLOPs and bytes per step (phase
      a's run, 3 more steps counted on the card by the cost walk) beside
      phase a's measured s/step;
4. one JSON line of per-kernel numbers, the card's name and power limit, and
   last the JSON result line.

It imports only torch, numpy and the port (never jax or the JAX package),
and exits non-zero without a result when there is no CUDA device or when
the port's sources are not beside it.
"""
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

# bound_ms is the least time the card could take for a kernel's function:
# the bytes it must move (each input read once, each output written once)
# over the H100 SXM data sheet's HBM3 rate. Both kernels move far more bytes
# than their function needs operations for.
HBM_BYTES_PER_S = 3.35e12
# design_ops_ms, a diagnosis and not a bound, logged and left out of the
# kernels line: an estimate, from the source, of the instructions one design
# issues, priced at the pipe rates of NVIDIA's arithmetic-instruction
# throughput table for compute capability 9.0 at 132 SMs and 1.98 GHz.
# 32-bit integer add, compare, shift, logic and select: 64 results per clock
# per SM; float32 add and multiply without a fused add: 128 per clock per SM
# (the data sheet's 67 TFLOP/s counts a fused multiply-add as two)
SM_CLOCKS_PER_S = 132 * 1.98e9
INT32_OPS_PER_S = 64 * SM_CLOCKS_PER_S            # 16.7 TOP/s
F32_OPS_PER_S = 128 * SM_CLOCKS_PER_S             # 33.5 TFLOP/s
# SignTopK per element, counted from csrc/sign_topk.cu (not from SASS): the
# |diff| pattern and sign mask 3; the histogram's word, half and address 5;
# the candidate test 3; the support and tie masks 6 (float compares issue
# at the integer rate); the scale's and q's mask tests 4; the clear, the two
# suffix scans and the 20 one-bit passes over the candidates, spread over
# the tile's 1024 elements, about 4. Float32: the support's sum and q's
# select, about 3. The pipes run side by side, so the larger one counts
SIGN_TOPK_INT_OPS = 25
SIGN_TOPK_F32_OPS = 3
# QSGD per element: a square and add for the norm, then |x|, a divide, a
# multiply, floor, a subtract, a compare, an add, a divide, the sign and two
# multiplies: about 12 float32 operations
QSGD_F32_OPS = 12
PLAIN_ROWS = 1 << 16          # tiles per call of the plain version
MAIN_ARGS = ["--arch", "qwen1.5-0.5b", "--nodes", "4", "--use-kernel",
             "--steps", "6", "--H", "3", "--batch-per-node", "2",
             "--seq-len", "128", "--log-every", "1", "--device", "cuda"]
FAULT_FLAGS = ["--dynamic", "matchings", "--dynamic-rounds", "4",
               "--link-drop", "0.3", "--stragglers", "1",
               "--straggler-frac", "0.5", "--dropout-window", "2:1:4",
               "--fault-seed", "4"]
FAULT_ARGS = MAIN_ARGS + FAULT_FLAGS
# phase 3i: the main path's flags with momentum, so the opt rows are real
CKPT_ARGS = MAIN_ARGS + ["--momentum", "0.9"]
# the depth of 24 that phases 3b and 3i keep, to hold the smoke inside its
# time limit (the main path, 3a and 3n, keeps all 24 layers)
CUT_DEPTH = 8
# the depth of 48 that 3l's mamba2-370m trainer keeps, for the same reason
# (cut when phase 3p brought a call's total past 1,100 s)
MAMBA2_DEPTH = 12
# phase 3o: an omega certificate's f32 sums, card against CPU
CERT_RTOL = 1e-6
# phase 3o: --lint through the train entry on the reduced config, one step
LINT_ARGS = ["--arch", "qwen1.5-0.5b", "--reduced", "--nodes", "4",
             "--use-kernel", "--steps", "1", "--H", "1", "--device", "cuda",
             "--lint"]
# the isotropic draws of BlockTopFrac's omega certificate (trials=6, no
# one-hot: an isotropic proxy), each a SignTopK launch on the card
BLOCK_CERT_LAUNCHES = 6
ULPS = 4           # x^0 against the host's draw (tests/test_torch_init.py)
LM_RTOL = 1e-3     # LM rows, card against CPU (tests/test_torch_suites.py)
# the generic path: no --use-kernel, one sync in 3 steps
GENERIC_ARGS = [a for a in MAIN_ARGS if a != "--use-kernel"]
GENERIC_ARGS[GENERIC_ARGS.index("--steps") + 1] = "3"


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


def with_arg(argv, flag, value):
    """``argv`` with ``flag``'s value replaced (or ``flag`` appended)."""
    out = list(argv)
    if flag in out:
        out[out.index(flag) + 1] = value
    else:
        out += [flag, value]
    return out


def run_logged(train, argv):
    """The train entry with every sync's engine record kept on the host
    (the diff itself is not copied)."""
    import torch
    syncs = []

    def keep(diff, info):
        syncs.append({k: v.detach().cpu() if isinstance(v, torch.Tensor)
                      else v for k, v in info.items()})
    return train.run(argv, on_sync=keep), syncs


def reckoned_bits(syncs, payload) -> float:
    """flag + trig * payload to each live neighbour, in float64."""
    return sum(float(((1.0 + s["trig"].double() * payload)
                      * s["deg"].double()).sum()) for s in syncs)


def flips_only(card, cpu, atol=5e-4, block=1024, per_tile=8,
               tile_share=0.01):
    """Hold the card's final ``params`` and ``x_hat`` against the CPU's run
    of the same flags. The two sum float32 gradients in other orders, so
    where two |diff| entries of a tile lie within that noise of each other
    at the k-th place, the runs select different entries (a boundary flip)
    and x_hat differs there by a whole step. So x_hat may differ beyond
    ``atol`` only on a few entries of a few tiles (a wrong selection touches
    about k_b of a tile), and params only in the columns where some node's
    x_hat differs at all: mixing moves a column by its own x_hat only.
    Returns the counts and the largest gaps."""
    dx = (card["x_hat"].float().cpu() - cpu["x_hat"].float()).abs()
    far = (dx > atol).view(dx.shape[0], -1, block).sum(-1)
    n_tiles = int((far > 0).sum())
    if int(far.max()) > per_tile or n_tiles > tile_share * far.numel():
        raise AssertionError(
            f"card against CPU: x_hat differs beyond {atol} in {n_tiles} of "
            f"{far.numel()} tiles, up to {int(far.max())} entries in one")
    cols = (dx > 1e-6).any(0)
    dp = (card["params"].float().cpu() - cpu["params"].float()).abs()
    rest = dp[:, ~cols]
    if rest.numel() and float(rest.max()) > atol:
        raise AssertionError(f"card against CPU: params differ by "
                             f"{float(rest.max())} outside the flipped "
                             f"columns")
    return {"flip_tiles": n_tiles, "tiles": far.numel(),
            "xhat_far": int(far.sum()), "flip_cols": int(cols.sum()),
            "xhat_gap": float(dx.max()), "params_gap": float(dp.max()),
            "params_gap_rest": float(rest.max()) if rest.numel() else 0.0}


ALLOC_KEYS = ("num_device_alloc", "num_device_free", "num_alloc_retries")


def alloc_counts(torch):
    """The caching allocator's cudaMalloc and cudaFree calls, and its
    free-everything-and-retry events, so far in the process."""
    stats = torch.cuda.memory_stats()
    return {k: stats.get(k, 0) for k in ALLOC_KEYS}


def median(values):
    v = sorted(values)
    mid = len(v) // 2
    return v[mid] if len(v) % 2 else (v[mid - 1] + v[mid]) / 2


def step_times(name, s_step, before, after) -> str:
    """One run's step times, their steady mean and median (steps 2 on),
    and the allocator's calls during the run."""
    rest = s_step[1:]
    calls = {k: after[k] - before[k] for k in ALLOC_KEYS}
    return (f"{name}: s/step {[round(v, 4) for v in s_step]}; steps 2 on: "
            f"mean {sum(rest) / len(rest):.4f} s, median "
            f"{median(rest):.4f} s; allocator during the run {calls}")


def profiled(torch, fn, steps, wall_s_per_step, tables=()):
    """Run ``fn`` under torch.profiler and print its key averages sorted by
    each ``(sort_by, row_limit)`` of ``tables``: returns (device s per step,
    device activities per step, idle share against the unprofiled wall time
    per step). The profiler's events hold reference cycles, so they are
    collected here, timed, and not in a later measured run."""
    import gc
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    device_s = sum(e.self_device_time_total for e in events
                   if e.device_type == DeviceType.CUDA) / 1e6 / steps
    acts = sum(e.count for e in events
               if e.device_type == DeviceType.CUDA) / steps
    for sort_by, rows in tables:
        print(events.table(sort_by=sort_by, row_limit=rows), flush=True)
    del prof, events
    t0 = time.perf_counter()
    freed = gc.collect()
    log(f"freeing the profile: gc.collect() took "
        f"{time.perf_counter() - t0:.3f} s for {freed} objects")
    return device_s, acts, 1.0 - device_s / wall_s_per_step


def check_golden(got_state, trace, want, case) -> None:
    """The golden test's comparison (tests/test_golden_traces.py): integer
    channels exact, bits rtol 1e-9, losses and the final fingerprint rtol
    2e-4."""
    import numpy as np
    import torch
    got = trace.to_dict()
    for col in ("t", "sync_rounds", "triggers"):
        if got[col] != want["trace"][col]:
            raise AssertionError(f"golden {case}: {col} {got[col]} != "
                                 f"{want['trace'][col]}")
    np.testing.assert_allclose(got["bits"], want["trace"]["bits"], rtol=1e-9)
    np.testing.assert_allclose(got["loss"], want["trace"]["loss"], rtol=2e-4,
                               atol=1e-6, err_msg=f"golden {case} loss")
    xbar = torch.mean(got_state.x, dim=0).double().cpu().numpy()
    fin = want["final"]
    if got_state.sync_rounds != fin["sync_rounds"] or \
            int(got_state.triggers) != fin["triggers"]:
        raise AssertionError(f"golden {case}: final counts differ")
    np.testing.assert_allclose(float(got_state.bits), fin["bits"], rtol=1e-9)
    np.testing.assert_allclose(np.linalg.norm(xbar), fin["x_bar_norm"],
                               rtol=2e-4)
    np.testing.assert_allclose(xbar[:4], fin["x_bar_head"], rtol=2e-4,
                               atol=1e-6)
    np.testing.assert_allclose(xbar[-4:], fin["x_bar_tail"], rtol=2e-4,
                               atol=1e-6)


def ulps(got, want) -> int:
    """The largest distance in float32 steps between two float32 tensors."""
    import torch

    def ordered(x):
        i = x.contiguous().view(torch.int32).to(torch.int64)
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
    return int((ordered(got) - ordered(want)).abs().max())


def phase_x0(torch, dev, counts, zero_counts, read_counts) -> None:
    """3h: x^0 of qwen1.5-0.5b at full width, drawn on the card, against the
    host's draws of the same keys."""
    import dataclasses
    from repro_torch.configs.registry import get_config
    from repro_torch.core import prng
    from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq
    from repro_torch.models.layers import dense_init
    from repro_torch.models.transformer import init_keys
    cfg = dataclasses.replace(get_config("qwen1.5-0.5b"), n_nodes=4)
    init_fn, _, _ = build_sparq(cfg, DistSparqConfig(H=3, frac=0.1,
                                                     use_kernel=True),
                                device=dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    state = init_fn(key=prng.PRNGKey(0))
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["x0"] = read_counts()
    held = torch.cuda.memory_allocated(dev) - base
    transient = torch.cuda.max_memory_allocated(dev) - base - held
    log(f"x^0: init_fn(key=PRNGKey(0)) at n=4, D={init_fn.d_model_total}: "
        f"{wall:.3f} s host wall, {start.elapsed_time(end) / 1e3:.3f} s "
        f"between its device events; state {held / 1e9:.2f} GB, transient "
        f"peak above it {transient / 1e9:.3f} GB")
    params = state["params"]
    if not bool((params[1:] == params[0]).all()) or \
            params[:, init_fn.d_model_total:].any():
        raise AssertionError("x^0: rows differ or the tail is not zero")
    # the card's uniform bits against numpy's on the host. In the
    # partitionable layout a flat index's bits do not depend on the draw's
    # size, so the host draws the first 2^20 only
    if not prng.partitionable():
        raise AssertionError("x^0: phase 3h runs the default layout")
    keys = init_keys(cfg, prng.PRNGKey(0))
    row = init_fn.unravel(params[0])
    k_emb = keys[("embed", "embedding")]
    emb = row["embed"]["embedding"]
    n0 = min(1 << 20, emb.numel())
    card_bits = prng.bits_range(prng.key_words(k_emb), emb.numel(), 0, n0,
                                dev).cpu()
    host_bits = prng.random_bits(k_emb, (n0,))
    if not torch.equal(card_bits, host_bits):
        raise AssertionError("x^0: embedding bits differ from the host's")
    gap = ulps(emb.reshape(-1)[:n0].cpu(),
               prng.truncated_normal_of_bits(host_bits, -2.0, 2.0) * 0.02)
    wo_scale = 0.02 / math.sqrt(2 * cfg.n_layers)
    wo = row["seg0"]["attn"]["wo"]
    for li in range(cfg.n_layers):
        k = keys[("seg0", "attn", "wo")][li]
        shape = tuple(wo.shape[1:])
        n = wo[li].numel()
        if not torch.equal(prng.bits_range(prng.key_words(k), n, 0, n,
                                           dev).cpu(),
                           prng.random_bits(k, shape).reshape(-1)):
            raise AssertionError(f"x^0: wo[{li}] bits differ")
        gap = max(gap, ulps(wo[li].cpu(), dense_init(k, shape,
                                                     torch.float32,
                                                     wo_scale)))
    if gap > ULPS:
        raise AssertionError(f"x^0: {gap} ulps from the host's draw")
    log(f"x^0: uniform bits == the host's numpy draw on {n0} embedding "
        f"values and all {cfg.n_layers} x {wo[0].numel()} of wo; values "
        f"within {gap} ulps of the host's truncated normals (bound {ULPS})")
    del state, params, row, emb, wo
    torch.cuda.empty_cache()


def _bits(x):
    """``x`` viewed as integers of its width, for bitwise comparison."""
    import torch
    return x.view({1: torch.uint8, 2: torch.int16, 4: torch.int32,
                   8: torch.int64}[x.element_size()])


def host_pairs(state, host):
    """``ckpt.compare``'s walk for a state kept on the host: a function of
    ``visit`` that calls it with (key, lo, hi, live chunk, host chunk on the
    live tensor's device) for every chunk of every leaf, in ``keys`` order
    when given."""
    import torch
    from repro_torch.checkpoint import ckpt

    def walk(visit, keys=None):
        live, kept = dict(ckpt._leaves(state)), dict(ckpt._leaves(host))
        for key in keys or sorted(live):
            a, b = ckpt._as_tensor(live[key]), ckpt._as_tensor(kept[key])
            if a.shape != b.shape or a.dtype != b.dtype:
                raise AssertionError(f"{key}: {a.dtype} {tuple(a.shape)} "
                                     f"!= {b.dtype} {tuple(b.shape)}")
            fa, fb = a.view(-1), b.view(-1)
            for lo, hi in ckpt._ranges(a, 1 << 24):
                visit(key, lo, hi, fa[lo:hi], fb[lo:hi].to(a.device))
    return walk


def saved_pairs(directory, step, state):
    """The same walk over a checkpoint's files (``ckpt.compare``)."""
    from repro_torch.checkpoint import ckpt

    def walk(visit, keys=None):
        ckpt.compare(directory, step, state, visit, keys=keys)
    return walk


def differing(walk):
    """Per key: (entries whose bits differ, largest absolute difference)."""
    out = {}

    def visit(key, lo, hi, live, other):
        n, gap = out.get(key, (0, 0.0))
        bad = _bits(live) != _bits(other)
        k = int(bad.sum())
        if k:
            gap = max(gap, float((live.double() - other.double()).abs()
                                 .max()))
        out[key] = (n + k, gap)
    walk(visit)
    return out


def flips_only_walk(walk, state, atol=5e-4, block=1024, per_tile=8,
                    tile_share=0.01):
    """``flips_only`` over a chunk walk: x_hat may differ beyond ``atol`` on
    a few entries of a few tiles, params and the optimizer rows only in the
    columns where some node's x_hat differs."""
    import torch
    d_pad = state["x_hat"].shape[1]
    cols = torch.zeros(d_pad, dtype=torch.bool, device=state["x_hat"].device)
    acc = {"tiles": 0, "flip_tiles": 0, "worst": 0, "far": 0, "rest": 0.0}

    def visit(key, lo, hi, live, other):
        d = (live.float() - other.float()).abs()
        c = slice(lo % d_pad, lo % d_pad + (hi - lo))
        if key == "x_hat":
            far = (d > atol).view(-1, block).sum(-1)
            acc["tiles"] += far.numel()
            acc["flip_tiles"] += int((far > 0).sum())
            acc["far"] += int(far.sum())
            acc["worst"] = max(acc["worst"], int(far.max()))
            cols[c] |= d > 1e-6
            return
        rest = d[~cols[c]]
        if rest.numel():
            acc["rest"] = max(acc["rest"], float(rest.max()))
    # x_hat first: its flipped columns excuse params and the opt rows there
    walk(visit, keys=["x_hat", "params"] + _opt_keys(state))
    if acc["worst"] > per_tile or acc["flip_tiles"] > tile_share * \
            acc["tiles"] or acc["rest"] > atol:
        raise AssertionError(f"beyond boundary flips: {acc}")
    return acc


def _opt_keys(state):
    from repro_torch.checkpoint import ckpt
    return [k for k, v in ckpt._leaves({"opt": state["opt"]})
            if hasattr(v, "dim") and v.dim() == 2]


def phase_ckpt(torch, dev, train, counts, zero_counts, read_counts) -> None:
    """3i: the full-width trainer with momentum at depth ``CUT_DEPTH`` of
    24, saved at step 4 of 6 and resumed from there across the sync of t =
    6. The phase writes one full-width checkpoint (29.7 GB at all 24 layers)
    and not two, to keep the run's disk writes under 45 GiB, and the card
    cannot hold two trainers' states; so the resumed run's final state is
    kept on the host and the unbroken run is repeated (no checkpoint) to
    compare with it, after its counters were checked against the first."""
    import dataclasses
    tmp = tempfile.mkdtemp(prefix="sparq_ckpt_")
    cut = ArchRegistry(lambda c: dataclasses.replace(c, n_layers=CUT_DEPTH))
    try:
        du = shutil.disk_usage(tmp)
        log(f"checkpoint: {tmp} on a disk of {du.total / 1e9:.1f} GB, "
            f"{du.free / 1e9:.1f} GB free")
        checks = []

        def read_back(kind, path, step, state):
            t0 = time.perf_counter()
            diff = differing(saved_pairs(os.path.dirname(path), step, state))
            checks.append((kind, step, time.perf_counter() - t0))
            bad = {k: v for k, v in diff.items() if v[0]}
            if bad:
                raise AssertionError(f"checkpoint {kind} at step {step}: "
                                     f"files differ from the live state: "
                                     f"{bad}")

        def counters(st):
            return {k: (int(st[k]) if k in ("t", "sync_rounds") else
                        float(st[k])) for k in ("t", "sync_rounds",
                                                "triggers", "bits", "bits_c")}
        args = CKPT_ARGS + ["--ckpt-dir", tmp]
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        with cut:
            r1 = train.run(args + ["--ckpt-every", "4"],
                           on_checkpoint=read_back)
        counts["ckpt_unbroken"] = read_counts()
        peak1 = torch.cuda.max_memory_allocated(dev) / 1e9
        if [s["step"] for s in r1["saves"]] != [4]:
            raise AssertionError(f"checkpoint: saves {r1['saves']}")
        want = counters(r1["state"])
        steps1, save = r1["s_per_step"], r1["saves"][0]
        del r1
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        zero_counts()
        with cut:
            r2 = train.run(args + ["--resume"], on_checkpoint=read_back)
        counts["ckpt_resumed"] = read_counts()
        peak2 = torch.cuda.max_memory_allocated(dev) / 1e9
        rest = r2["restore"]
        launches = counts["ckpt_resumed"]["sign_topk_blocks"]
        if r2["start"] != 4 or len(r2["losses"]) != 2 or launches != 1:
            raise AssertionError(f"resume: start {r2['start']}, losses "
                                 f"{r2['losses']}, {launches} SignTopK "
                                 f"launches (want 1)")
        got = counters(r2["state"])
        if got != want:
            raise AssertionError(f"resume: {got} != unbroken {want}")
        resumed = {k: v.cpu() if isinstance(v, torch.Tensor) else v
                   for k, v in r2["state"].items()}
        steps2 = r2["s_per_step"]
        del r2
        shutil.rmtree(tmp)
        torch.cuda.empty_cache()
        with cut:
            r3 = train.run(CKPT_ARGS)
        if counters(r3["state"]) != want:
            raise AssertionError(f"unbroken again: {counters(r3['state'])} "
                                 f"!= {want}")
        t0 = time.perf_counter()
        walk = host_pairs(r3["state"], resumed)
        diff = differing(walk)
        if any(n for n, _ in diff.values()):
            fl = flips_only_walk(walk, r3["state"])
            verdict = f"boundary flips only: {fl}"
        else:
            verdict = "bit for bit"
        cmp_s = time.perf_counter() - t0
        rest_steps = steps1[1:]
        log(f"checkpoint, unbroken run at depth {CUT_DEPTH} of 24: save at "
            f"step 4 of {save['gb']:.3f} "
            f"GB in {save['s']:.2f} s ({save['gb'] / save['s']:.2f} GB/s), "
            f"host peak RSS {save['host_rss_gb']:.2f} GB; s/step "
            f"{[round(v, 4) for v in steps1]}, steps 2..6 mean "
            f"{sum(rest_steps) / len(rest_steps):.4f} s; device peak "
            f"{peak1:.2f} GB; SignTopK {counts['ckpt_unbroken']}")
        log(f"checkpoint, resumed run: restore of {rest['gb']:.3f} GB in "
            f"{rest['s']:.2f} s ({rest['gb'] / rest['s']:.2f} GB/s), host "
            f"peak RSS {rest['host_rss_gb']:.2f} GB; s/step "
            f"{[round(v, 4) for v in steps2]}; device peak {peak2:.2f} GB; "
            f"SignTopK launches {launches}")
        log("checkpoint: files == live buffers after " + ", ".join(
            f"the {k} at step {st} (read back in {t:.2f} s)"
            for k, st, t in checks))
        log(f"checkpoint: resumed == unbroken: counters {got}; float "
            f"buffers {verdict}; per key (entries differing, largest gap) "
            f"{diff} (compared in {cmp_s:.2f} s)")
        del r3, resumed, walk
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()


class Float32Reduced:
    """A registry config whose ``reduced()`` computes in float32, at the
    sizes given here unless the caller gives its own; with
    ``param_dtype``, its weights in that dtype too."""

    def __init__(self, cfg, param_dtype=None, **sizes):
        self.cfg, self.sizes = cfg, sizes
        self.param_dtype = param_dtype or cfg.param_dtype

    def reduced(self, **kw):
        import dataclasses
        return dataclasses.replace(self.cfg.reduced(**{**self.sizes, **kw}),
                                   compute_dtype="float32",
                                   param_dtype=self.param_dtype)


def phase_suites(torch, dev, counts, zero_counts, read_counts) -> None:
    """3j: the nonconvex, momentum and ablation experiments in the
    committed files' layout."""
    import functools
    import numpy as np
    from repro_torch.core import engine, prng
    from repro_torch.core.sparq import make_step
    from repro_torch.launch import (ablation_bits, lm_workload,
                                    momentum_bits, nonconvex_bits)
    from repro_torch.models import attention
    with prng.threefry_partitionable(False):
        for mod, suite, rounds in ((nonconvex_bits, "nonconvex",
                                    "sync_rounds"),
                                   (momentum_bits, "momentum", "sync_rounds"),
                                   (ablation_bits, "ablation", "rounds")):
            with open(os.path.join(ROOT, f"BENCH_{suite}.json")) as f:
                want = {r["name"]: r for r in json.load(f)["rows"]}
            zero_counts()
            t0 = time.perf_counter()
            rows = mod.run_bench(quick=True, device="cuda")
            counts[f"{suite}_bits"] = read_counts()
            if mod is nonconvex_bits:
                nonconvex = rows
            for r in rows:
                w = want[r["name"]]
                cols = ("bits", "trigger_events", rounds, "contract_status",
                        "bits_oracle")
                if any(r[c] != w[c] for c in cols):
                    raise AssertionError(
                        f"{suite} {r['name']}: {[r[c] for c in cols]} != "
                        f"BENCH_{suite}.json's {[w[c] for c in cols]}")
                if not math.isfinite(r["final_loss"]):
                    raise AssertionError(f"{suite} {r['name']}: loss")
                log(f"{suite} {r['name']:22s} bits {r['bits']:.6e} triggers "
                    f"{r['trigger_events']} rounds {r[rounds]} final_loss "
                    f"{r['final_loss']:.6f} (file {w['final_loss']}) "
                    f"us_per_call {r['us_per_call']:.1f} peak "
                    f"{r['peak_hbm_bytes']}")
            check_contract_columns(rows, f"{suite} quick")
            log(f"{suite} quick: {len(rows)} rows == BENCH_{suite}.json in "
                f"bits, triggers, rounds and contract columns; launches "
                f"{counts[f'{suite}_bits']} ({time.perf_counter() - t0:.1f} "
                f"s)")
        # two rows on the card against the CPU over the CPU tests' 30 steps,
        # in float32 compute and float32 scores, as those tests hold them
        # against the reference (the two rows have one configuration:
        # SPARQ with momentum 0.9 is SQuARM)
        get_config, chunked = lm_workload.get_config, \
            attention.chunked_attention
        try:
            lm_workload.get_config = lambda n: Float32Reduced(get_config(n))
            attention.chunked_attention = functools.partial(
                chunked, score_dtype=torch.float32)
            wls = {w: lm_workload.make_lm_workload(True, w)._replace(
                T=30, rec=10) for w in ("cuda", "cpu")}
            for name, cfgs in (("sparq_signtop10_mom",
                                nonconvex_bits.configs),
                               ("squarm", momentum_bits.configs)):
                traces = {}
                for where, wl in wls.items():
                    cfg = cfgs(wl)[name]
                    runner = engine.make_runner(
                        make_step(cfg, wl.grad_fn), wl.T,
                        record_every=wl.rec, eval_fn=wl.eval_fn)
                    traces[where] = runner(cfg.init_state(wl.flat0),
                                           prng.PRNGKey(1))[1].to_dict()
                g, c = traces["cuda"], traces["cpu"]
                for col in ("t", "bits", "sync_rounds", "triggers"):
                    if g[col] != c[col]:
                        raise AssertionError(f"{name}: card and CPU {col} "
                                             f"differ")
                np.testing.assert_allclose(g["loss"], c["loss"],
                                           rtol=LM_RTOL, err_msg=name)
                gap = max(abs(a - b) / abs(b) for a, b in zip(g["loss"],
                                                              c["loss"]))
                log(f"{name}, float32, card == CPU in bits, triggers and "
                    f"rounds; losses {g['loss']} (CPU {c['loss']}), largest "
                    f"relative gap {gap:.3e}")
        finally:
            lm_workload.get_config = get_config
            attention.chunked_attention = chunked
        # where a quick LM step goes: 20 steps of the headline row under
        # the profiler, against its unprofiled time per step above
        wl = lm_workload.make_lm_workload(True, "cuda")
        cfg = nonconvex_bits.configs(wl)["sparq_signtop10_mom"]
        us = next(r["us_per_call"] for r in nonconvex
                  if r["name"] == "sparq_signtop10_mom")
        steps = 20
        dev_s, acts, idle = profiled(
            torch, lambda: engine.make_runner(make_step(cfg, wl.grad_fn),
                                              steps)(
                cfg.init_state(wl.flat0), prng.PRNGKey(1)), steps, us / 1e6,
            tables=(("self_cpu_time_total", 8),))
        log(f"nonconvex quick sparq_signtop10_mom, profiled {steps} steps: "
            f"device {dev_s * 1e6:.1f} us/step over {acts:.0f} "
            f"activities/step; against the unprofiled {us:.1f} us/step the "
            f"device is idle {100 * idle:.1f}%")
    torch.cuda.empty_cache()


class RouteLog:
    """Every call of ``moe.route`` while installed, in order: the slot table
    and the aux kept on the device (no host sync inside a step), the token
    count, top-k and the caller's rank in its fsdp group (None in one
    process)."""

    def __init__(self):
        self.calls = []

    def __enter__(self):
        from repro_torch.models import moe
        self.real = moe.route

        def route(cfg, w, x, **kw):
            out = self.real(cfg, w, x, **kw)
            group = kw.get("group")
            self.calls.append((out[0].detach().clone(), out[2].detach(),
                               x.shape[0], cfg.moe_top_k,
                               None if group is None else group.rank))
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        from repro_torch.models import moe
        moe.route = self.real


class ArchRegistry:
    """``registry.get_config`` answering ``make(cfg)`` for every arch while
    installed: the train entry reads the registry when it is called."""

    def __init__(self, make):
        self.make = make

    def __enter__(self):
        from repro_torch.configs import registry
        self.real = registry.get_config
        registry.get_config = lambda arch: self.make(self.real(arch))
        return self

    def __exit__(self, *exc):
        from repro_torch.configs import registry
        registry.get_config = self.real


def sign_topk_bound_ms(rows) -> float:
    """SignTopK's byte bound at (rows, 1024) float32 in ensemble mode: the
    diff read once, q and the per-tile scale written once
    (``kernels.sign_topk.work_bytes``, the closed form the cost walk
    charges)."""
    import torch
    from repro_torch.kernels.sign_topk import work_bytes
    return work_bytes(rows, torch.float32, False) / HBM_BYTES_PER_S * 1e3


def sync_kernel_check(torch, t_check, spec):
    """An ``on_sync`` hook for the train entry, and the record it fills. At
    the sync of step index ``t_check`` SignTopK is timed on the real diff,
    then one launch at the path's own shape is held against the plain
    version on every tile, chunk by chunk (a full copy of the diff would
    not fit beside the kernel's q). These launches are a comparison, not
    the path: the count is restored. ``hook_s`` is the hook's host time,
    which the step that holds it gives back."""
    from repro_torch.kernels import parity
    from repro_torch.kernels.sign_topk import BLOCK, sign_topk_blocks
    k_b = math.ceil(0.1 * BLOCK)
    rec = {}

    def hook(diff, info):
        if info["t"] != t_check:
            return
        torch.cuda.synchronize()
        t_hook = time.perf_counter()
        tiles = diff.view(-1, BLOCK)
        launches = sign_topk_blocks.launches
        rec["ms"] = time_ms(
            torch, lambda: sign_topk_blocks(tiles, None, 1.0, k_b), 3)
        t0 = time.perf_counter()
        rec["err"] = parity.check_sign_topk_chunked(tiles, k_b, PLAIN_ROWS,
                                                    spec=spec)
        torch.cuda.synchronize()
        rec["check_s"] = time.perf_counter() - t0
        sign_topk_blocks.launches = launches
        rec["tiles"] = tiles.shape[0]
        rec["hook_s"] = time.perf_counter() - t_hook
    return hook, rec


def phase_archs(torch, dev, train, counts, zero_counts, read_counts):
    """3k: deepseek-moe-16b at full width (depth 2) and stablelm-1.6b at
    full width and depth through the train entry, then each new config at
    reduced width on the card against the CPU. Returns the SignTopK record
    at the MoE trainer's shape."""
    import dataclasses
    import functools
    import numpy as np
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.kernels.sign_topk import BLOCK, sign_topk_blocks
    from repro_torch.models import attention, moe
    from repro_torch.configs import registry
    from repro_torch.dist.sparq_dist import _flatten_spec
    from repro_torch.models.transformer import param_shapes
    out = {}

    # which served configs fit: four (n, D_pad) float32 buffers (params,
    # x_hat, grads, the kernel's q) at the smallest ring, n = 2
    for arch in registry.ARCH_IDS:
        d = _flatten_spec(param_shapes(registry.get_config(arch)))[1]
        gb = 4 * 2 * (-(-d // BLOCK) * BLOCK) * 4 / 1e9
        log(f"fit: {arch}: D = {d} per node; four (2, D_pad) float32 "
            f"buffers {gb:.1f} GB of the card's 80")

    # ---- deepseek-moe-16b, full width, one dense and one MoE layer, 4 nodes
    moe_args = with_arg(with_arg(MAIN_ARGS, "--arch", "deepseek-moe-16b"),
                        "--nodes", "4")
    depth2 = ArchRegistry(lambda c: dataclasses.replace(c, n_layers=2))
    k_b = math.ceil(0.1 * BLOCK)
    # the kernel check at the last sync (step 6, left out of the steady mean)
    on_sync, sync_rec = sync_kernel_check(torch, 5, "moe trainer diff")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    alloc0 = alloc_counts(torch)
    with depth2, RouteLog() as routes:
        result = train.run(moe_args, on_sync=on_sync)
    alloc1 = alloc_counts(torch)
    counts["moe_trainer"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    state, step, cfg = result["state"], result["train_step"], result["cfg"]
    losses, s_step = result["losses"], result["s_per_step"]
    n = step.n_nodes
    launches = counts["moe_trainer"]["sign_topk_blocks"]
    log(f"moe trainer: {cfg.arch_id} n_layers={cfg.n_layers} (first_k_dense "
        f"{cfg.first_k_dense}), d_model {cfg.d_model}, {cfg.n_experts} "
        f"experts top-{cfg.moe_top_k} of width {cfg.moe_d_ff}, "
        f"{cfg.n_shared_experts} shared, vocab {cfg.vocab_size}; D = "
        f"{step.d_model_total} per node, D_pad {step.d_pad}, n = {n}")
    if not (cfg.n_layers == 2 and cfg.first_k_dense == 1
            and cfg.d_model == 2048 and cfg.moe_d_ff == 1408):
        raise AssertionError("moe trainer: not the full-width config")
    if len(losses) != 6 or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"moe trainer: losses {losses}")
    if launches != 2 or state["sync_rounds"] != 2:
        raise AssertionError(f"moe trainer: {launches} SignTopK launches for "
                             f"{state['sync_rounds']} syncs (want 2)")
    trig = int(state["triggers"])
    degs = step.plan.degrees[0]
    want_bits = float(degs[0]) * (n * state["sync_rounds"]
                                  + trig * step.payload_bits)
    got_bits = float(state["bits"])
    if abs(got_bits - want_bits) > 1e-6 * want_bits or trig <= 0:
        raise AssertionError(f"moe trainer: bits {got_bits} != reckoned "
                             f"{want_bits} from {trig} triggers")
    if state["params"][:, step.d_model_total:].any() or \
            state["x_hat"][:, step.d_model_total:].any():
        raise AssertionError("moe trainer: the padded tail is not zero")
    # routing: per step and node one forward and, under recomputation, one
    # re-route in the backward, which must give the same table
    calls = routes.calls
    if len(calls) != 6 * n * 2:
        raise AssertionError(f"moe trainer: {len(calls)} route calls, want "
                             f"{6 * n * 2} (6 steps x {n} nodes x forward "
                             f"and recomputation)")
    for si in range(6):
        dropped, auxs = [], []
        for i in range(n):
            (fw, aux, t_count, k, _), (re, aux_re, _, _, _) = \
                calls[(si * n + i) * 2:(si * n + i) * 2 + 2]
            if not torch.equal(fw, re) or not torch.equal(aux, aux_re):
                raise AssertionError(f"moe trainer: step {si + 1} node {i}: "
                                     f"the recomputed routing differs")
            dropped.append(t_count * k - int((fw < t_count).sum()))
            auxs.append(float(aux))
        if not all(math.isfinite(a) for a in auxs):
            raise AssertionError(f"moe trainer: aux {auxs}")
        log(f"moe trainer step {si + 1}: loss {losses[si]:.6f}; per node, "
            f"of {t_count} x {k} choices dropped at capacity "
            f"{moe.capacity(cfg, t_count)}: {dropped}; aux {auxs}")
    steady = s_step[1:5]
    log(f"moe trainer: {launches} SignTopK launches, {trig} triggers, bits "
        f"{got_bits:.6e} == reckoned {want_bits:.6e}; device peak "
        f"{peak:.2f} GB")
    log(f"moe trainer: s/step {[round(v, 4) for v in s_step]}; steps 2..5 "
        f"(step 6 holds the kernel check) mean {sum(steady) / 4:.4f} s, "
        f"median {median(steady):.4f} s; allocator during the run "
        f"{ {k: alloc1[k] - alloc0[k] for k in ALLOC_KEYS} }")
    rows = sync_rec["tiles"]
    bound_ms = sign_topk_bound_ms(rows)
    log(f"moe trainer: SignTopK on the last sync's real diff ({rows}, "
        f"{BLOCK}) f32: {sync_rec['ms']:.4f} ms against the byte bound "
        f"{bound_ms:.4f} ms ({bound_ms * HBM_BYTES_PER_S / 1e12:.2f} GB at "
        f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; "
        f"{100 * bound_ms / sync_rec['ms']:.1f}% of its speed); kernel == "
        f"plain version on every tile, max abs err {sync_rec['err']:.3e} "
        f"({sync_rec['check_s']:.1f} s)")
    out.update(moe_ms=sync_rec["ms"], moe_bound_ms=bound_ms,
               moe_shape=[rows, BLOCK], moe_max_abs_err=sync_rec["err"])
    # where a step goes: 3 more steps of the same run (t = 6..8, one sync)
    # under the profiler, after the counts were read; a fresh run's window
    # would hold the x^0 draw, about 1.5 s of device time
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=128,
                         batch_per_node=2, n_nodes=n, seed=0)

    def more_steps():
        st = state
        for i in range(6, 9):
            st, _ = step(st, pipe.global_batch(i))
    dev_s, acts, idle = profiled(torch, more_steps, 3, sum(steady) / 4,
                                 tables=(("self_device_time_total", 10),))
    log(f"moe trainer, profiled steps 7..9: device time {dev_s:.4f} s/step "
        f"over {acts:.0f} device activities/step; against the steady "
        f"{sum(steady) / 4:.4f} s/step the device is idle {100 * idle:.1f}%")
    del result, state, step
    torch.cuda.empty_cache()
    # the kernel at the same shape on Gaussian tiles, beside the real diff's
    # time above: the select's work depends on the data
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    x = torch.randn((rows, BLOCK), generator=gen, device=dev)
    launches = sign_topk_blocks.launches
    out["moe_randn_ms"] = time_ms(
        torch, lambda: sign_topk_blocks(x, None, 1.0, k_b), 10)
    sign_topk_blocks.launches = launches
    log(f"SignTopK at ({rows}, {BLOCK}) on Gaussian tiles: "
        f"{out['moe_randn_ms']:.4f} ms against the bound {bound_ms:.4f} ms "
        f"({100 * bound_ms / out['moe_randn_ms']:.1f}% of its speed)")
    del x
    torch.cuda.empty_cache()

    # ---- stablelm-1.6b at full width and depth, 2 nodes, one sync
    sl_args = with_arg(with_arg(with_arg(MAIN_ARGS, "--arch", "stablelm-1.6b"),
                                "--nodes", "2"), "--steps", "3")
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    result = train.run(sl_args)
    counts["stablelm_trainer"] = read_counts()
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    state, step, cfg = result["state"], result["train_step"], result["cfg"]
    losses = result["losses"]
    trig = int(state["triggers"])
    if len(losses) != 3 or not all(math.isfinite(v) for v in losses) or \
            abs(losses[0] - math.log(cfg.vocab_size)) > 1.0:
        raise AssertionError(f"stablelm trainer: losses {losses}")
    if counts["stablelm_trainer"]["sign_topk_blocks"] != 1 or \
            state["sync_rounds"] != 1:
        raise AssertionError(f"stablelm trainer: launches "
                             f"{counts['stablelm_trainer']}")
    want_bits = float(step.plan.degrees[0][0]) * (
        step.n_nodes + trig * step.payload_bits)
    if abs(float(state["bits"]) - want_bits) > 1e-6 * want_bits:
        raise AssertionError(f"stablelm trainer: bits {float(state['bits'])}"
                             f" != reckoned {want_bits}")
    log(f"stablelm trainer: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.norm}, rope_pct {cfg.rope_pct}, vocab {cfg.vocab_size}; D = "
        f"{step.d_model_total}, n = {step.n_nodes}; losses {losses}; "
        f"{trig} triggers, bits {float(state['bits']):.6e} == reckoned; "
        f"s/step {[round(v, 4) for v in result['s_per_step']]}; device peak "
        f"{peak:.2f} GB")
    del result, state, step
    torch.cuda.empty_cache()

    # ---- the card against the CPU at reduced width, float32 compute and
    # scores: deepseek-moe-16b at n = 4 for 6 steps, then each new dense
    # config at d_model 128, vocab 256 for 3 steps
    chunked = attention.chunked_attention
    attention.chunked_attention = functools.partial(
        chunked, score_dtype=torch.float32)
    try:
        runs = {}
        red_args = MAIN_ARGS + ["--reduced"]
        f32 = ArchRegistry(lambda c: Float32Reduced(c))
        for where in ("cuda", "cpu"):
            zero_counts()
            with f32, RouteLog() as routes:
                res, syncs = run_logged(train, with_arg(with_arg(
                    red_args, "--arch", "deepseek-moe-16b"), "--device",
                    where))
            runs[where] = (res, syncs, routes.calls, read_counts())
        (a, sa, ra, ca), (b, sb, rb, _) = runs["cuda"], runs["cpu"]
        counts["moe_reduced_card"] = ca
        n = a["train_step"].n_nodes
        for i in range(n):       # the first step's forward of each node
            ta, tb = ra[i][0].cpu(), rb[i][0]
            if not torch.equal(ta, tb):
                raise AssertionError(
                    f"reduced moe: node {i}'s first routing differs on the "
                    f"card; tokens {moe.flipped_tokens(ta, tb, ra[i][2])}")
        sa_, sb_ = a["state"], b["state"]
        if (int(sa_["triggers"]), sa_["sync_rounds"], float(sa_["bits"])) \
                != (int(sb_["triggers"]), sb_["sync_rounds"],
                    float(sb_["bits"])) or ca["sign_topk_blocks"] != 2:
            raise AssertionError("reduced moe: card and CPU differ in "
                                 "triggers, syncs or bits")
        np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4,
                                   err_msg="reduced moe: losses")
        gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                       b["losses"]))
        fl = flips_only(sa_, sb_)
        log(f"reduced deepseek-moe-16b, float32, card == CPU: first routing "
            f"of all {n} nodes equal ({ra[0][0].numel()} slots each), "
            f"{int(sa_['triggers'])} triggers, {sa_['sync_rounds']} syncs, "
            f"bits {float(sa_['bits']):.6e}; losses {a['losses']} (CPU "
            f"{b['losses']}), largest relative gap {gap:.3e}; x_hat beyond "
            f"5e-4 on {fl['xhat_far']} entries in {fl['flip_tiles']} of "
            f"{fl['tiles']} tiles; params gap {fl['params_gap']:.3e}, "
            f"{fl['params_gap_rest']:.3e} outside flipped columns")
        del runs, a, b, sa_, sb_
        small = ArchRegistry(lambda c: Float32Reduced(c, d_model=128,
                                                      vocab=256))
        zero_counts()
        for arch in ("minitron-4b", "stablelm-1.6b", "qwen1.5-32b",
                     "musicgen-large", "chameleon-34b"):
            got = {}
            for where in ("cuda", "cpu"):
                with small:
                    r = train.run(with_arg(with_arg(with_arg(
                        red_args, "--arch", arch), "--device", where),
                        "--steps", "3"))
                got[where] = (r["losses"], int(r["state"]["triggers"]),
                              float(r["state"]["bits"]), r["cfg"])
            (la, ta, ba, c), (lb, tb, bb, _) = got["cuda"], got["cpu"]
            if (ta, ba) != (tb, bb):
                raise AssertionError(f"reduced {arch}: card and CPU differ "
                                     f"in triggers or bits")
            np.testing.assert_allclose(la, lb, rtol=1e-4,
                                       err_msg=f"reduced {arch}: losses")
            log(f"reduced {arch} (d_model {c.d_model}, vocab "
                f"{c.vocab_size}, {c.norm}, {c.act}, rope_pct "
                f"{c.rope_pct}, qk_norm {c.qk_norm}, param_dtype "
                f"{c.param_dtype}), float32, card == CPU: losses {la} (CPU "
                f"{lb}), largest relative gap "
                f"{max(abs(x - y) / abs(y) for x, y in zip(la, lb)):.3e}")
        counts["dense_reduced_card"] = read_counts()
    finally:
        attention.chunked_attention = chunked
    torch.cuda.empty_cache()
    return out


class SharedLog:
    """Counts the hybrid layers that apply the shared attention block while
    installed: the forward's and the recomputation's."""

    def __enter__(self):
        from repro_torch.models import transformer
        self.real, self.calls = transformer._hybrid_block, 0

        def block(cfg, bp, x, positions, shared, **kw):
            self.calls += shared is not None
            return self.real(cfg, bp, x, positions, shared, **kw)
        transformer._hybrid_block = block
        return self

    def __exit__(self, *exc):
        from repro_torch.models import transformer
        transformer._hybrid_block = self.real


def phase_ssm(torch, dev, train, counts, zero_counts, read_counts):
    """3l: mamba2-370m at full width cut to MAMBA2_DEPTH of its 48 layers
    (8 nodes) and zamba2-7b at full width cut to 12 layers (3 nodes)
    through the train entry, then both at reduced width on the card
    against the CPU. Returns the SignTopK record at each trainer's
    shape."""
    import dataclasses
    import functools
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.core import prng
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.models import attention
    from repro_torch.models.transformer import _tree_items, init_params
    out = {}

    def trainer(name, argv, want_layers, want_shared):
        """6 steps with the kernel check at the last sync; the run's
        checks and logs. Returns the run's result and its steady steps."""
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        on_sync, rec = sync_kernel_check(torch, 5, f"{name} trainer diff")
        zero_counts()
        alloc0 = alloc_counts(torch)
        with SharedLog() as shared:
            result = train.run(argv, on_sync=on_sync)
        alloc1 = alloc_counts(torch)
        counts[f"{name}_trainer"] = read_counts()
        peak = torch.cuda.max_memory_allocated(dev) / 1e9
        state, step, cfg = result["state"], result["train_step"], \
            result["cfg"]
        losses, n = result["losses"], step.n_nodes
        launches = counts[f"{name}_trainer"]["sign_topk_blocks"]
        log(f"{name} trainer: {cfg.arch_id} {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, d_inner {cfg.d_inner}, {cfg.ssm_heads} SSM "
            f"heads of {cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
            f"{cfg.ssm_chunk}, conv {cfg.ssm_conv}, attention heads "
            f"{cfg.n_heads}, attn_every {cfg.attn_every}, vocab "
            f"{cfg.vocab_size}; D = {step.d_model_total} per node, D_pad "
            f"{step.d_pad}, n = {n}")
        if cfg.n_layers != want_layers:
            raise AssertionError(f"{name} trainer: {cfg.n_layers} layers")
        if len(losses) != 6 or not all(math.isfinite(v) for v in losses):
            raise AssertionError(f"{name} trainer: losses {losses}")
        if launches != 2 or state["sync_rounds"] != 2:
            raise AssertionError(f"{name} trainer: {launches} SignTopK "
                                 f"launches for {state['sync_rounds']} "
                                 f"syncs (want 2)")
        # 6 steps x n nodes x the forward and its recomputation
        if shared.calls != want_shared * 6 * n * 2:
            raise AssertionError(f"{name} trainer: the shared block ran "
                                 f"{shared.calls} times")
        trig = int(state["triggers"])
        want_bits = float(step.plan.degrees[0][0]) * (
            n * state["sync_rounds"] + trig * step.payload_bits)
        got_bits = float(state["bits"])
        if abs(got_bits - want_bits) > 1e-6 * want_bits or trig <= 0:
            raise AssertionError(f"{name} trainer: bits {got_bits} != "
                                 f"reckoned {want_bits} from {trig} "
                                 f"triggers")
        if state["params"][:, step.d_model_total:].any() or \
                state["x_hat"][:, step.d_model_total:].any():
            raise AssertionError(f"{name} trainer: the padded tail is not "
                                 f"zero")
        # step 6 holds the kernel check: its hook time is given back
        s_step = list(result["s_per_step"])
        s_step[5] -= rec["hook_s"]
        steady = s_step[1:]
        rows = rec["tiles"]
        bound = sign_topk_bound_ms(rows)
        log(f"{name} trainer: losses {losses}; {launches} SignTopK "
            f"launches, {trig} triggers, bits {got_bits:.6e} == reckoned "
            f"{want_bits:.6e}; shared block applied {shared.calls} times; "
            f"device peak {peak:.2f} GB")
        log(f"{name} trainer: s/step {[round(v, 4) for v in s_step]} (step "
            f"6 less its kernel check's {rec['hook_s']:.2f} s); steps 2..6 "
            f"mean {sum(steady) / 5:.4f} s, median {median(steady):.4f} s; "
            f"allocator during the run "
            f"{ {k: alloc1[k] - alloc0[k] for k in ALLOC_KEYS} }")
        log(f"{name} trainer: SignTopK on the last sync's real diff ({rows}, "
            f"1024) f32: {rec['ms']:.4f} ms against the byte bound "
            f"{bound:.4f} ms ({(rows * 1024 * 8 + rows * 4) / 1e9:.2f} GB at "
            f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s; {100 * bound / rec['ms']:.1f}"
            f"% of its speed); kernel == plain version on every tile, max "
            f"abs err {rec['err']:.3e} ({rec['check_s']:.1f} s)")
        out[name] = {"ms": rec["ms"], "bound_ms": bound, "shape": [rows, 1024],
                     "max_abs_err": rec["err"], "peak_gb": peak}
        return result, steady

    # ---- mamba2-370m at full width, cut to MAMBA2_DEPTH of 48 layers, 8
    # nodes
    ssm_args = with_arg(with_arg(MAIN_ARGS, "--arch", "mamba2-370m"),
                        "--nodes", "8")
    depth = ArchRegistry(lambda c: dataclasses.replace(
        c, n_layers=MAMBA2_DEPTH))
    with depth:
        result, steady = trainer("mamba2", ssm_args, MAMBA2_DEPTH, 0)
    del result
    torch.cuda.empty_cache()
    # where a step goes: the profiler's host cost grows with its events
    # (about 145 K launches per step here), so as in 3b a depth-6 run of 4
    # steps gives the wall time and its steps t = 4..6 (one sync) are
    # profiled
    with ArchRegistry(lambda c: dataclasses.replace(c, n_layers=6)):
        d6 = train.run(with_arg(ssm_args, "--steps", "4"))
    d6_state, d6_step = d6["state"], d6["train_step"]
    d6_wall = sum(d6["s_per_step"][1:]) / 3
    pipe = TokenPipeline(vocab_size=d6["cfg"].vocab_size, seq_len=128,
                         batch_per_node=2, n_nodes=8, seed=0)

    def d6_steps():
        st = d6_state
        for i in range(4, 7):
            st, _ = d6_step(st, pipe.global_batch(i))
    dev_s, acts, idle = profiled(torch, d6_steps, 3, d6_wall,
                                 tables=(("self_device_time_total", 8),))
    log(f"mamba2 trainer at depth 6 of 48: s/step "
        f"{[round(v, 4) for v in d6['s_per_step']]}; profiled steps 5..7: "
        f"device time {dev_s:.4f} s/step over {acts:.0f} device "
        f"activities/step; idle {100 * idle:.1f}% against the depth-6 steady "
        f"mean {d6_wall:.4f} s/step (steps 2..4)")
    del d6, d6_state, d6_step
    torch.cuda.empty_cache()

    # ---- zamba2-7b at full width, 12 layers (the shared block after layers
    # 5 and 11), 3 nodes
    with ArchRegistry(lambda c: dataclasses.replace(c, n_layers=12)):
        result, _ = trainer("zamba2", with_arg(with_arg(
            MAIN_ARGS, "--arch", "zamba2-7b"), "--nodes", "3"), 12, 2)
    del result
    torch.cuda.empty_cache()

    # ---- the card against the CPU at reduced width, float32 compute and
    # scores: mamba2-370m.reduced() and zamba2-7b.reduced(n_layers=4) (the
    # shared block after layers 1 and 3) at n = 4 for 6 steps
    chunked = attention.chunked_attention
    attention.chunked_attention = functools.partial(
        chunked, score_dtype=torch.float32)
    try:
        red_args = MAIN_ARGS + ["--reduced"]
        for name, arch, sizes in (("mamba2", "mamba2-370m", {}),
                                  ("zamba2", "zamba2-7b", {"n_layers": 4})):
            f32 = ArchRegistry(lambda c, s=sizes: Float32Reduced(c, **s))
            with f32:
                cfg = registry.get_config(arch).reduced()
            card = dict(_tree_items(init_params(
                cfg, prng.PRNGKey(0).to(dev))))
            host = dict(_tree_items(init_params(cfg, prng.PRNGKey(0))))
            x0_gap = max(ulps(card[k].cpu(), v) for k, v in host.items())
            if x0_gap > ULPS:
                raise AssertionError(f"reduced {arch}: x^0 {x0_gap} ulps "
                                     f"from the CPU's draw")
            runs = {}
            for where in ("cuda", "cpu"):
                zero_counts()
                with f32:
                    res = train.run(with_arg(with_arg(
                        red_args, "--arch", arch), "--device", where))
                runs[where] = (res, read_counts())
            (a, ca), (b, _) = runs["cuda"], runs["cpu"]
            counts[f"{name}_reduced_card"] = ca
            sa, sb = a["state"], b["state"]
            if (int(sa["triggers"]), sa["sync_rounds"], float(sa["bits"])) \
                    != (int(sb["triggers"]), sb["sync_rounds"],
                        float(sb["bits"])) or ca["sign_topk_blocks"] != 2:
                raise AssertionError(f"reduced {arch}: card and CPU differ "
                                     f"in triggers, syncs or bits")
            np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4,
                                       err_msg=f"reduced {arch}: losses")
            gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                           b["losses"]))
            fl = flips_only(sa, sb)
            log(f"reduced {arch} ({cfg.n_layers} layers, d_model "
                f"{cfg.d_model}, {cfg.ssm_heads} SSM heads of "
                f"{cfg.ssm_head_dim}, state {cfg.ssm_state}, chunk "
                f"{cfg.ssm_chunk}, attn_every {cfg.attn_every}), float32, "
                f"card == CPU: x^0 within {x0_gap} ulps; "
                f"{int(sa['triggers'])} triggers, {sa['sync_rounds']} syncs, "
                f"bits {float(sa['bits']):.6e}; losses {a['losses']} (CPU "
                f"{b['losses']}), largest relative gap {gap:.3e}; x_hat "
                f"beyond 5e-4 on {fl['xhat_far']} entries in "
                f"{fl['flip_tiles']} of {fl['tiles']} tiles; params gap "
                f"{fl['params_gap']:.3e}, {fl['params_gap_rest']:.3e} "
                f"outside flipped columns")
            del runs, a, b, sa, sb, card, host
    finally:
        attention.chunked_attention = chunked
    torch.cuda.empty_cache()
    return out


# decode against prefill at full width: in float32 compute and scores,
# within 1e-3 of the largest logit (measured 8.7e-6 on qwen1.5-0.5b). The
# config's own bfloat16 gap is reported, not held: the reference's TOL 0.05
# (tests/test_decode_consistency.py) is set for 2-layer reduced configs,
# and at full depth the two paths' bfloat16 roundings (batched and
# one-token products) differ by more, from position 0, where attention is
# exact in both (measured 0.08-0.13 on qwen1.5-0.5b's logits of 3.2)
SERVE_F32_RTOL = 1e-3
RED_DECODE_RTOL = 1e-5   # reduced decode, card against CPU, float32


def _sync(torch, dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def serve_run(torch, dev, cfg, batch, prompt_len, cache_len, steps,
              params=None, seed=0):
    """One config through the serve entry points: x^0 from PRNGKey(0) on
    ``dev`` unless ``params`` are given, ``build_prefill`` on ``batch``
    prompts of ``prompt_len`` tokens (a cold call, then a timed warm one),
    then ``steps`` decode steps through ``build_decode`` from an empty
    cache of ``cache_len`` slots, teacher-forced on the prompt, each
    step's logits against prefill's at its position. Returns the weights,
    the times, tokens/s, the largest gap and logit, the device peak and the
    last cache."""
    import numpy as np
    from repro_torch.core import prng
    from repro_torch.dist.serve import build_decode, build_prefill
    from repro_torch.models.transformer import init_cache, init_params
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(torch, dev)
    t0 = time.perf_counter()
    if params is None:
        params = init_params(cfg, prng.PRNGKey(0).to(dev))
    _sync(torch, dev)
    x0_s = time.perf_counter() - t0
    toks = torch.tensor(np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (batch, prompt_len)), device=dev)
    (prefill, _), (decode, _) = build_prefill(cfg, dev), build_decode(cfg, dev)
    pre_s = []
    for _ in range(2):
        _sync(torch, dev)
        t0 = time.perf_counter()
        logits = prefill(params, toks)
        _sync(torch, dev)
        pre_s.append(time.perf_counter() - t0)
    ref = logits[:, :steps].float()
    finite = bool(torch.isfinite(logits).all())
    del logits
    cache = init_cache(cfg, batch, cache_len, device=dev)
    step_s, gap = [], 0.0
    for t in range(steps):
        _sync(torch, dev)
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, toks[:, t:t + 1], None, t)
        _sync(torch, dev)
        step_s.append(time.perf_counter() - t0)
        gap = max(gap, float((lg[:, 0].float() - ref[:, t]).abs().max()))
        finite = finite and bool(torch.isfinite(lg).all())
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else float("nan"))
    med = median(step_s[1:])
    return {"params": params, "cache": cache, "x0_s": x0_s,
            "prefill_s": pre_s, "prefill_tok_s": batch * prompt_len
            / pre_s[1], "decode_ms": med * 1e3, "decode_tok_s": batch / med,
            "decode_first_ms": step_s[0] * 1e3, "gap": gap, "peak_gb": peak,
            "finite": finite, "ref_scale": float(ref.abs().max())}


def timed_decode(torch, dev, decode, params, cache, tokens, positions):
    """Decode steps at the given positions; returns the median of the
    steps after the first, in ms, and the last logits."""
    step_s = []
    for i, p in enumerate(positions):
        _sync(torch, dev)
        t0 = time.perf_counter()
        lg, cache = decode(params, cache, tokens[:, i:i + 1], None, p)
        _sync(torch, dev)
        step_s.append(time.perf_counter() - t0)
    return median(step_s[1:]) * 1e3, lg


def reduced_decode_pair(torch, dev, arch, steps=16):
    """``arch``'s ``reduced()`` config in float32 compute: the same weights
    (drawn on the host) on the card and on the CPU, ``steps`` greedy decode
    steps each from the same first token. Returns the largest logit gap
    relative to the largest logit, whether the ``pos`` leaves and the
    greedy tokens are equal."""
    import dataclasses
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.core import prng
    from repro_torch.dist.serve import build_decode
    from repro_torch.models.transformer import (_tree_items, init_cache,
                                                init_params)
    cfg = dataclasses.replace(registry.get_config(arch).reduced(),
                              compute_dtype="float32")
    host = init_params(cfg, prng.PRNGKey(0))
    first = torch.tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 1)))
    runs = {}
    for where in (dev, torch.device("cpu")):
        params = host if where.type == "cpu" else _to(host, where)
        cache = init_cache(cfg, 2, steps, device=where)
        decode, _ = build_decode(cfg, where)
        tok, logits, toks = first.to(where), [], []
        for t in range(steps):
            lg, cache = decode(params, cache, tok, None, t)
            tok = torch.argmax(lg[:, -1:], dim=-1)
            logits.append(lg.float().cpu())
            toks.append(tok.cpu())
        runs[where.type] = (torch.cat(logits, 1), torch.cat(toks, 1),
                            {k: v.cpu() for k, v in _tree_items(cache)})
    (la, ta, ca), (lb, tb, cb) = runs[dev.type], runs["cpu"]
    rel = float((la - lb).abs().max() / lb.abs().max())
    pos_equal = all(torch.equal(ca[k], cb[k]) for k in cb if k[-1] == "pos")
    return rel, pos_equal, bool(torch.equal(ta, tb))


def _to(tree, dev):
    return {k: _to(v, dev) if isinstance(v, dict) else v.to(dev)
            for k, v in tree.items()}


def phase_serve(torch, dev, train, counts, zero_counts, read_counts):
    """3m: the serving path. qwen1.5-0.5b, mamba2-370m and zamba2-7b at
    full width and depth and deepseek-v3-671b at full width cut to depth 4:
    x^0, batched prefill and cached decode against it; qwen's decode_32k
    cache and long_500k ring buffer; every config's reduced decode on the
    card against the CPU; deepseek-v3-671b's reduced trainer on the card
    against the CPU. Serving launches no kernel of the port."""
    import dataclasses
    import functools
    import numpy as np
    from repro_torch.configs import registry
    from repro_torch.dist.serve import build_decode
    from repro_torch.models import attention
    from repro_torch.models.transformer import init_cache
    card = card_line()
    out = {}

    def report(name, cfg, batch, prompt_len, cache_len, r):
        log(f"serve {name}: {cfg.arch_id}, {cfg.n_layers} layers, d_model "
            f"{cfg.d_model}, {cfg.param_dtype} params, {cfg.compute_dtype} "
            f"compute; x^0 {r['x0_s']:.3f} s; prefill {batch} x "
            f"{prompt_len}: cold {r['prefill_s'][0]:.4f} s, warm "
            f"{r['prefill_s'][1]:.4f} s ({r['prefill_tok_s']:.1f} tokens/s);"
            f" decode at cache_len {cache_len}: first step "
            f"{r['decode_first_ms']:.3f} ms, median of steps 2..N "
            f"{r['decode_ms']:.3f} ms/step ({r['decode_tok_s']:.1f} "
            f"tokens/s); decode-vs-prefill max |logit gap| {r['gap']:.4e} "
            f"(largest |logit| {r['ref_scale']:.3f}); device peak "
            f"{r['peak_gb']:.2f} GB [{card}]")
        if not r["finite"]:
            raise AssertionError(f"serve {name}: non-finite logits")

    def run(name, cfg, batch, prompt_len, cache_len, steps, **check):
        """The config's own numerics, timed; then the same weights and
        prompts in float32 compute and scores (and the fields ``check``),
        decode held against prefill."""
        zero_counts()
        r = serve_run(torch, dev, cfg, batch, prompt_len, cache_len, steps)
        counts[f"serve_{name}"] = read_counts()
        report(name, cfg, batch, prompt_len, cache_len, r)
        out[name] = {k: v for k, v in r.items()
                     if k not in ("params", "cache")}
        chunked = attention.chunked_attention
        attention.chunked_attention = functools.partial(
            chunked, score_dtype=torch.float32)
        try:
            r32 = serve_run(torch, dev, dataclasses.replace(
                cfg, compute_dtype="float32", **check), batch, prompt_len,
                cache_len, steps, params=r["params"])
        finally:
            attention.chunked_attention = chunked
        rel = r32["gap"] / r32["ref_scale"]
        log(f"serve {name}, float32 compute and scores, the same weights: "
            f"decode-vs-prefill max |logit gap| {r32['gap']:.4e}, "
            f"{rel:.3e} of the largest |logit| {r32['ref_scale']:.3f} "
            f"(bound {SERVE_F32_RTOL}); bfloat16 gap above "
            f"{r['gap']:.4e} [{card}]")
        if not r32["finite"] or rel > SERVE_F32_RTOL:
            raise AssertionError(f"serve {name}: float32 gap {rel:.3e} of "
                                 f"the largest logit > {SERVE_F32_RTOL}")
        out[name]["f32_gap_rel"] = rel
        del r32
        return r

    # ---- qwen1.5-0.5b at full width and depth
    qwen = registry.get_config("qwen1.5-0.5b")
    r = run("qwen", qwen, 4, 2048, 4096, 32)
    params, cache = r.pop("params"), r.pop("cache")
    del r
    decode, _ = build_decode(qwen, dev)

    def decode_window(cache, first):
        """3 more decode steps on ``cache``, to be profiled."""
        toks = torch.randint(0, qwen.vocab_size, (cache["kv"]["k"].shape[1],
                                                  3), device=dev)

        def steps():
            for i in range(3):
                decode(params, cache, toks[:, i:i + 1], None, first + i)
        return steps
    dev_s, acts, idle = profiled(torch, decode_window(cache, 32), 3,
                                 out["qwen"]["decode_ms"] / 1e3)
    log(f"serve qwen decode, 3 steps profiled: device time "
        f"{dev_s * 1e3:.3f} ms/step over {acts:.0f} device activities/step; "
        f"idle {100 * idle:.1f}% against the median "
        f"{out['qwen']['decode_ms']:.3f} ms/step [{card}]")
    out["qwen"].update(device_ms=dev_s * 1e3, activities=acts, idle=idle)
    del cache
    torch.cuda.empty_cache()
    # decode_32k's cache at batch 8 (the shape's 128 would be 412 GB):
    # every step scores all 32,768 slots
    shape = registry.shape_by_name("decode_32k")
    clen = registry.cache_len(qwen, shape)
    torch.cuda.reset_peak_memory_stats(dev)
    cache = init_cache(qwen, 8, clen, device=dev)
    cache_gb = sum(v.numel() * v.element_size()
                   for v in cache["kv"].values()) / 1e9
    toks = torch.randint(0, qwen.vocab_size, (8, 8), device=dev)
    zero_counts()
    ms, lg = timed_decode(torch, dev, decode, params, cache, toks,
                          range(clen - 8, clen))
    counts["serve_qwen_decode_32k"] = read_counts()
    dev_s, acts, idle = profiled(torch, decode_window(cache, clen - 3), 3,
                                 ms / 1e3,
                                 tables=(("self_device_time_total", 6),))
    log(f"serve qwen decode_32k, 3 steps profiled: device time "
        f"{dev_s * 1e3:.3f} ms/step over {acts:.0f} device activities/step; "
        f"idle {100 * idle:.1f}% against the median {ms:.3f} ms/step "
        f"[{card}]")
    pos = cache["kv"]["pos"]
    if not bool(torch.isfinite(lg).all()) or pos[:, -8:].tolist() != [
            list(range(clen - 8, clen))] * qwen.n_layers:
        raise AssertionError("serve decode_32k: logits or pos")
    log(f"serve qwen decode_32k: B 8, cache_len {clen} ({cache_gb:.2f} GB "
        f"of KV cache), positions {clen - 8}..{clen - 1}: median of steps "
        f"2..8 {ms:.3f} ms/step ({8 / ms * 1e3:.1f} tokens/s); device peak "
        f"{torch.cuda.max_memory_allocated(dev) / 1e9:.2f} GB [{card}]")
    out["qwen_decode_32k"] = {"decode_ms": ms, "cache_gb": cache_gb,
                              "peak_gb": torch.cuda.max_memory_allocated(
                                  dev) / 1e9, "device_ms": dev_s * 1e3,
                              "idle": idle}
    del cache, pos, lg
    torch.cuda.empty_cache()
    # long_500k: the sliding window of for_shape, B = 1, a ring buffer of
    # 4096 slots; 16 steps across a multiple of the window, so that slots
    # 0..7 are reused by the positions past it
    shape = registry.shape_by_name("long_500k")
    swa = registry.for_shape(qwen, shape)
    clen = registry.cache_len(swa, shape)
    p0 = 127 * clen - 8
    cache = init_cache(swa, shape.global_batch, clen, device=dev)
    toks = torch.randint(0, qwen.vocab_size, (1, 16), device=dev)
    zero_counts()
    ms, lg = timed_decode(torch, dev, build_decode(swa, dev)[0], params, cache,
                          toks, range(p0, p0 + 16))
    counts["serve_qwen_long_500k"] = read_counts()
    pos = cache["kv"]["pos"][0].tolist()
    last = p0 + 15
    want = {s: p for p in range(p0, p0 + 16) for s in [p % clen]}
    if pos[:8] != list(range(127 * clen, 127 * clen + 8)) or any(
            pos[s] != want.get(s, -1) for s in range(clen)) or any(
            p < last - clen for p in pos if p >= 0) or \
            not bool(torch.isfinite(lg).all()):
        raise AssertionError("serve long_500k: ring slots")
    log(f"serve qwen long_500k: sliding window {swa.sliding_window}, B "
        f"{shape.global_batch}, a ring of {clen} slots; positions {p0}.."
        f"{last}: slots 0..7 reused by {pos[0]}..{pos[7]}, every written "
        f"slot >= {last} - {clen}; median of steps 2..16 {ms:.3f} ms/step "
        f"[{card}]")
    out["qwen_long_500k"] = {"decode_ms": ms}
    del cache, params, lg
    torch.cuda.empty_cache()

    # ---- deepseek-v3-671b at full width, depth 61 -> 4 (three dense MLA
    # layers and one MoE layer of 256 experts), bfloat16 weights. The
    # float32 check runs at capacity factor 8.0, so that routing 2 tokens
    # per step and 1024 at once drops no choice in either
    # (tests/test_decode_consistency.py); the timed run at the config's own
    dsv3 = dataclasses.replace(registry.get_config("deepseek-v3-671b"),
                               n_layers=4)
    log("serve dsv3: the float32 decode-vs-prefill check below runs at "
        "capacity_factor 8.0, as the reference's decode test; the timed "
        f"run at the config's {dsv3.capacity_factor}")
    r = run("dsv3", dsv3, 2, 512, 512, 32, capacity_factor=8.0)
    del r
    torch.cuda.empty_cache()
    # ---- mamba2-370m at full width and depth: the recurrent decode
    r = run("mamba2", registry.get_config("mamba2-370m"), 4, 2048, 2048, 32)
    del r
    torch.cuda.empty_cache()
    # ---- zamba2-7b at full width, all 81 layers: 13 shared-block caches
    zamba = registry.get_config("zamba2-7b")
    r = run("zamba2", zamba, 2, 1024, 1024, 32)
    if r["cache"]["attn"]["k"].shape[0] != 13 or bool(
            (r["cache"]["attn"]["pos"][:, :32] < 0).any()):
        raise AssertionError("serve zamba2: shared-block caches")
    del r
    torch.cuda.empty_cache()

    # ---- every config's reduced decode, the card against the CPU
    t0 = time.perf_counter()
    worst = 0.0
    zero_counts()
    for arch in registry.ARCH_IDS:
        rel, pos_eq, tok_eq = reduced_decode_pair(torch, dev, arch)
        if rel > RED_DECODE_RTOL or not pos_eq or not tok_eq:
            raise AssertionError(f"reduced decode {arch}: logit gap {rel}, "
                                 f"pos equal {pos_eq}, tokens equal "
                                 f"{tok_eq}")
        worst = max(worst, rel)
    counts["serve_reduced_card"] = read_counts()
    log(f"reduced decode, all {len(registry.ARCH_IDS)} configs, float32, "
        f"16 greedy steps, card == CPU: logits within {worst:.3e} of the "
        f"largest (bound {RED_DECODE_RTOL}), pos leaves and greedy tokens "
        f"equal ({time.perf_counter() - t0:.1f} s)")
    out["reduced_decode_rel"] = worst

    # ---- deepseek-v3-671b's reduced trainer, the card against the CPU: one
    # dense and one MoE MLA layer and the MTP head, float32 compute, scores
    # and weights (bfloat16 weights would round the gradients into ties
    # that either side may break: tests/test_torch_mla.py)
    chunked = attention.chunked_attention
    attention.chunked_attention = functools.partial(
        chunked, score_dtype=torch.float32)
    f32 = ArchRegistry(lambda c: Float32Reduced(c, param_dtype="float32"))
    argv = with_arg(MAIN_ARGS + ["--reduced"], "--arch", "deepseek-v3-671b")
    check, rec = sync_kernel_check(torch, 5, "dsv3 reduced trainer diff")
    t0 = time.perf_counter()
    try:
        runs = {}
        for where in ("cuda", "cpu"):
            syncs = []

            def on_sync(diff, info, syncs=syncs, where=where):
                syncs.append({k: v.detach().cpu()
                              if isinstance(v, torch.Tensor) else v
                              for k, v in info.items()})
                if where == "cuda":
                    check(diff, info)
            zero_counts()
            with f32:
                res = train.run(with_arg(argv, "--device", where),
                                on_sync=on_sync)
            runs[where] = (res, read_counts(), syncs)
    finally:
        attention.chunked_attention = chunked
    (a, ca, syncs), (b, _, _) = runs["cuda"], runs["cpu"]
    counts["dsv3_reduced_card"] = ca
    sa, sb = a["state"], b["state"]
    step = a["train_step"]
    want_bits = reckoned_bits(syncs, step.payload_bits)
    if ca["sign_topk_blocks"] != 2 or sa["sync_rounds"] != 2 or \
            abs(float(sa["bits"]) - want_bits) > 1e-6 * want_bits or \
            (int(sa["triggers"]), float(sa["bits"])) != \
            (int(sb["triggers"]), float(sb["bits"])):
        raise AssertionError(f"reduced dsv3 trainer: {ca} launches, "
                             f"{sa['sync_rounds']} syncs, bits "
                             f"{float(sa['bits'])} (reckoned {want_bits}, "
                             f"CPU {float(sb['bits'])})")
    np.testing.assert_allclose(a["losses"], b["losses"], rtol=1e-4,
                               err_msg="reduced dsv3 trainer: losses")
    gap = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    fl = flips_only(sa, sb)
    cfg = a["cfg"]
    log(f"reduced dsv3 trainer ({cfg.n_layers} MLA layers, the first dense, "
        f"{cfg.n_experts} experts top-{cfg.moe_top_k}, MTP coef "
        f"{cfg.mtp_coef}, d_model {cfg.d_model}), float32, n = "
        f"{cfg.n_nodes}, card == CPU: {int(sa['triggers'])} triggers, "
        f"{sa['sync_rounds']} syncs, bits {float(sa['bits']):.6e} == "
        f"reckoned {want_bits:.6e}; SignTopK launched "
        f"{ca['sign_topk_blocks']} times, == its plain version on every "
        f"tile of the last sync ({rec['tiles']} tiles, max abs err "
        f"{rec['err']:.3e}); losses {a['losses']} (CPU {b['losses']}), "
        f"largest relative gap {gap:.3e}; x_hat beyond 5e-4 on "
        f"{fl['xhat_far']} entries; params gap {fl['params_gap']:.3e} "
        f"({time.perf_counter() - t0:.1f} s)")
    out["dsv3_trainer"] = {"max_abs_err": rec["err"], "loss_gap": gap}
    del runs, a, b, sa, sb
    torch.cuda.empty_cache()
    return out


# ------------------------------------------------------------ 3n. sharding
# the main path's flags over four ranks on the one card; the reduced runs
SHARD_ARGS = MAIN_ARGS + ["--devices", "4"]
SHARD_TIMEOUT_S = 240.0      # every group's and every join's deadline
# a row's checksum: the sum over its float32 bit patterns v_j, as int64,
# of v_j * w_j with odd per-position weights w_j = (j * M + A) | 1, in
# wrapping int64 arithmetic: an integer sum is the same in any order, and a
# change of one element always changes it (w_j is odd, so invertible
# modulo 2^64)
CHECKSUM_M = -7046029254386353131       # 0x9E3779B97F4A7C15 as int64
CHECKSUM_A = 1442695040888963407
SERVE_SHARD_RTOL = 1e-5    # data-sharded serve against one process, float32


def row_checksums(torch, buf, chunk=1 << 22):
    """One :data:`CHECKSUM_M` checksum per row of a float32 ``(rows, D)``
    buffer, computed on its device a column chunk at a time."""
    out = []
    for row in buf:
        h = torch.zeros((), dtype=torch.int64, device=row.device)
        for lo in range(0, row.numel(), chunk):
            v = row[lo:lo + chunk].view(torch.int32).to(torch.int64)
            w = torch.arange(lo, lo + v.numel(), dtype=torch.int64,
                             device=row.device) * CHECKSUM_M + CHECKSUM_A
            h += (v * (w | 1)).sum()
        out.append(int(h))
    return out


def _host_rows(state):
    return {k: state[k].detach().cpu() for k in ("params", "x_hat")}


def _shard_full_rank(rank, argv, k_b):
    """Phase 3n run 1, one rank: the train entry over the process group,
    SignTopK held against its plain version on this rank's tiles at the
    last sync (those launches not counted), row checksums, peak memory."""
    import torch
    from repro_torch.kernels import parity
    from repro_torch.kernels.sign_topk import BLOCK, sign_topk_blocks
    from repro_torch.launch import train
    dev = torch.device("cuda", torch.cuda.current_device())
    torch.cuda.reset_peak_memory_stats(dev)
    check = {}

    def at_sync(diff, info):
        if info["t"] == 5:                  # the last sync of 6 steps, H 3
            before = sign_topk_blocks.launches
            t0 = time.perf_counter()
            check["err"] = parity.check_sign_topk_chunked(
                diff.view(-1, BLOCK), k_b, PLAIN_ROWS,
                spec=f"rank {rank} last sync")
            check["s"] = time.perf_counter() - t0
            check["tiles"] = diff.numel() // BLOCK
            # timed while the other ranks share the card
            check["ms"] = time_ms(torch, lambda: sign_topk_blocks(
                diff.view(-1, BLOCK), None, 1.0, k_b), 5)
            sign_topk_blocks.launches = before
    sign_topk_blocks.launches = 0
    out = train.run(argv, on_sync=at_sync)
    launches = sign_topk_blocks.launches
    st, step = out["state"], out["train_step"]
    return {"losses": out["losses"], "bits": out["bits"],
            "triggers": out["triggers"], "s_per_step": out["s_per_step"],
            "exchange_s": out["exchange_s"], "rows": step.rows,
            "mesh": out["mesh"], "describe": step.comm.describe(),
            "checksums": {k: row_checksums(torch, st[k])
                          for k in ("params", "x_hat")},
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "launches": launches, "check": check}


def _shard_quad_rank(rank, fsdp_argv, ckpt_argv):
    """Phase 3n runs 3 and 5, one rank of four: the reduced main path over
    (node 2, fsdp 2) through the train entry, then the checkpointed run through
    the train entry at --devices 4 (saving at step 4)."""
    from repro_torch.dist import sharding
    from repro_torch.kernels.sign_topk import sign_topk_blocks
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_production_mesh
    cfg, _ = train.configs(fsdp_argv)
    mesh = sharding.train_mesh(make_production_mesh(), cfg)
    sign_topk_blocks.launches = 0
    r = train.run(fsdp_argv, mesh=mesh)
    fsdp = {k: r[k] for k in ("losses", "bits", "triggers")}
    fsdp.update(rows=r["train_step"].rows, coords=sharding.coordinates(mesh),
                launches=sign_topk_blocks.launches, **_host_rows(r["state"]))
    del r
    sign_topk_blocks.launches = 0
    saved = train.run(ckpt_argv)
    return {"fsdp": fsdp, "ckpt_losses": saved["losses"],
            "ckpt_launches": sign_topk_blocks.launches,
            "ckpt_saves": saved["saves"]}


# runs 7-9 of phase 3n, in the pair of ranks: tensor-parallel serve over
# (data 1, model 2), and the MoE trainer over (node 1, fsdp 2)
TP_FULL_PROMPT, TP_FULL_STEPS = 512, 16     # qwen1.5-0.5b at full width
TP_RED_PROMPT, TP_RED_STEPS = 16, 8         # the reduced families
# (arch, embed_mode, cache_mode) of the reduced tensor-parallel serves
TP_RED_CASES = (("deepseek-moe-16b", "vocab", "auto"),
                ("deepseek-v3-671b", "vocab", "auto"),
                ("mamba2-370m", "vocab", "auto"),
                ("zamba2-7b", "vocab", "auto"),
                ("qwen1.5-0.5b", "vocab", "seq"),
                ("qwen1.5-0.5b", "dmodel", "auto"))
TP_LABEL = ("gloo through pinned host buffers, two ranks on one card: a "
            "correctness run, not a speed figure")
MOE_FSDP_ARGS = [a if a != "qwen1.5-0.5b" else "deepseek-moe-16b"
                 for a in MAIN_ARGS] + ["--reduced"]
MOE_FSDP_ARGS[MOE_FSDP_ARGS.index("--nodes") + 1] = "1"
MOE_FSDP_RTOL = 1e-5        # its losses against one process, float32


def _tree_bytes(tree):
    if isinstance(tree, dict):
        return sum(_tree_bytes(v) for v in tree.values())
    return tree.numel() * tree.element_size()


def _to_host(tree):
    if isinstance(tree, dict):
        return {k: _to_host(v) for k, v in tree.items()}
    return tree.cpu()


def tp_serve(torch, dev, cfg, mesh, toks, steps, cache_len,
             embed_mode="vocab", cache_mode="auto"):
    """Prefill of ``toks`` and ``steps`` teacher-forced decode steps from an
    empty cache of ``cache_len`` slots, through the serve builders on
    ``mesh``: a serve ``DeviceMesh`` (the rank's blocks are cut from the
    whole trees with ``serve.local_shard`` and the whole trees dropped) or
    ``dev`` (one process). Returns the logits and the cache on the host,
    the bytes of the prefill's parameter tree, the peak after the cut, and
    the times."""
    from repro_torch.core import prng
    from repro_torch.dist import serve
    from repro_torch.models.transformer import init_cache, init_params
    prefill, pre_sh = serve.build_prefill(cfg, mesh, embed_mode=embed_mode)
    decode, dec_sh = serve.build_decode(cfg, mesh, cache_mode=cache_mode)
    params = init_params(cfg, prng.PRNGKey(0).to(dev))
    cache = init_cache(cfg, toks.shape[0], cache_len, device=dev)
    whole_bytes = _tree_bytes(params)
    pre = dec = params
    if mesh is not dev:
        ps, _, _ = pre_sh(params, toks, None)
        pre = serve.local_shard(params, ps, mesh)
        ps, cs, _, _, _ = dec_sh(params, cache, toks[:, :1], None)
        dec = pre if embed_mode == "vocab" else \
            serve.local_shard(params, ps, mesh)
        cache = serve.local_shard(cache, cs, mesh)
        del params
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    held = _tree_bytes(pre)
    _sync(torch, dev)
    t0 = time.perf_counter()
    first = prefill(pre, toks)
    _sync(torch, dev)
    prefill_s = time.perf_counter() - t0
    logits, step_s = [first.cpu()], []
    del first
    for t in range(steps):
        t0 = time.perf_counter()
        lg, cache = decode(dec, cache, toks[:, t:t + 1], None, t)
        _sync(torch, dev)
        step_s.append(time.perf_counter() - t0)
        logits.append(lg.cpu())
    return {"logits": logits, "cache": _to_host(cache), "param_bytes": held,
            "whole_bytes": whole_bytes,
            "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9,
            "prefill_s": prefill_s, "step_s": step_s}


def _tp_rank(torch, dev, full_toks, red_toks):
    """Runs 7 and 8 on one rank of the pair: qwen1.5-0.5b at full width and
    the reduced families over (data 1, model 2), float32 compute and
    scores."""
    import dataclasses
    import functools
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import sharding
    from repro_torch.kernels.qsgd import qsgd_blocks
    from repro_torch.kernels.sign_topk import sign_topk_blocks
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import attention
    smesh = sharding.serve_mesh(make_production_mesh(model=2))
    kernels = (sign_topk_blocks, qsgd_blocks)
    for fn in kernels:
        fn.launches = 0
    chunked = attention.chunked_attention
    attention.chunked_attention = functools.partial(
        chunked, score_dtype=torch.float32)
    try:
        qwen = dataclasses.replace(get_config("qwen1.5-0.5b"),
                                   compute_dtype="float32")
        full = tp_serve(torch, dev, qwen, smesh, torch.as_tensor(full_toks),
                        TP_FULL_STEPS, TP_FULL_PROMPT)
        if sharding.coordinates(smesh)["model"]:
            full["logits"][0] = None    # rank 0's whole prefill logits
        red = {}
        for arch, emb, cm in TP_RED_CASES:
            cfg = Float32Reduced(get_config(arch),
                                 param_dtype="float32").reduced()
            red[(arch, emb, cm)] = tp_serve(
                torch, dev, cfg, smesh, torch.as_tensor(red_toks[arch]),
                TP_RED_STEPS, TP_RED_PROMPT, emb, cm)
    finally:
        attention.chunked_attention = chunked
    return {"coords": sharding.coordinates(smesh), "full": full,
            "reduced": red,
            "launches": {fn.__name__: fn.launches for fn in kernels}}


def _moe_fsdp_rank(rank, torch, k_b):
    """Run 9 on one rank of the pair: reduced deepseek-moe-16b in float32
    compute and scores through the train entry over (node 1, fsdp 2); the
    first step's routing tables, SignTopK held against its plain version on
    the rank's tiles at the last sync (those launches not counted)."""
    import functools
    from repro_torch.dist import sharding
    from repro_torch.kernels import parity
    from repro_torch.kernels.sign_topk import BLOCK, sign_topk_blocks
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import attention
    check = {}

    def at_sync(diff, info):
        if info["t"] == 5:
            before = sign_topk_blocks.launches
            check["err"] = parity.check_sign_topk_chunked(
                diff.view(-1, BLOCK), k_b, PLAIN_ROWS,
                spec=f"moe fsdp rank {rank} last sync")
            check["tiles"] = diff.numel() // BLOCK
            sign_topk_blocks.launches = before
    chunked = attention.chunked_attention
    attention.chunked_attention = functools.partial(
        chunked, score_dtype=torch.float32)
    try:
        with ArchRegistry(lambda c: Float32Reduced(c)):
            cfg, _ = train.configs(MOE_FSDP_ARGS)
            mesh = sharding.train_mesh(make_production_mesh(), cfg)
            sign_topk_blocks.launches = 0
            with RouteLog() as routes:
                r = train.run(MOE_FSDP_ARGS, mesh=mesh, on_sync=at_sync)
    finally:
        attention.chunked_attention = chunked
    per_step = len(routes.calls) // 6
    out = {k: r[k] for k in ("losses", "bits", "triggers", "mesh")}
    out.update(rows=r["train_step"].rows, coords=sharding.coordinates(mesh),
               launches=sign_topk_blocks.launches, check=check,
               routes=[(c[0].cpu(), c[2], c[4]) for c in
                       routes.calls[:per_step]], **_host_rows(r["state"]))
    return out


def _shard_pair_rank(rank, fault_argv, serve_tokens, decode_steps,
                     tp_full_toks, tp_red_toks, k_b):
    """Phase 3n runs 4 and 6-9, one rank of two: the reduced faulty,
    time-varying trainer over (node 2) through the train entry (dense mixing
    through the row gather), the reduced serve over (data 2, model 1) in
    float32 compute, the tensor-parallel serves over (data 1, model 2)
    (runs 7 and 8) and the reduced MoE trainer over (node 1, fsdp 2) (run
    9)."""
    import dataclasses
    import torch
    from repro_torch.configs.registry import get_config
    from repro_torch.core import prng
    from repro_torch.dist import serve, sharding
    from repro_torch.kernels.sign_topk import sign_topk_blocks
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import (init_cache, init_params,
                                                param_shapes)
    dev = torch.device("cuda", torch.cuda.current_device())
    cfg, _ = train.configs(fault_argv)
    prod = make_production_mesh()
    mesh = sharding.train_mesh(prod, cfg)
    syncs = []
    sign_topk_blocks.launches = 0
    r = train.run(fault_argv, mesh=mesh,
                  on_sync=lambda d, info: syncs.append(
                      {"trig": info["trig"].cpu(), "W": info["W"].cpu()}))
    dense = {k: r[k] for k in ("losses", "bits", "triggers")}
    dense.update(rows=r["train_step"].rows, syncs=syncs,
                 exchange_s=r["train_step"].exchange_s,
                 launches=sign_topk_blocks.launches, **_host_rows(r["state"]))
    del r
    smesh = sharding.serve_mesh(prod)
    scfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               compute_dtype="float32")
    params = init_params(scfg, prng.PRNGKey(0).to(dev))
    prefill, _ = serve.build_prefill(scfg, smesh)
    decode, shardings = serve.build_decode(scfg, smesh)
    toks = torch.as_tensor(serve_tokens)
    B = toks.shape[0]
    glob = init_cache(scfg, B, decode_steps, device=dev)
    _, cs, _, _, _ = shardings(param_shapes(scfg), glob, toks[:, :1], None)
    cache = serve.local_shard(glob, cs, smesh)
    logits = [prefill(params, toks).cpu()]
    for t in range(decode_steps):
        lg, cache = decode(params, cache, toks[:, t:t + 1], None, t)
        logits.append(lg.cpu())
    out = {"dense": dense, "serve_logits": logits,
           "serve_cache": {k: {kk: vv.cpu() for kk, vv in v.items()}
                           for k, v in cache.items()},
           "serve_coords": sharding.coordinates(smesh)}
    del params, cache, logits
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["tp"] = _tp_rank(torch, dev, tp_full_toks, tp_red_toks)
    out["tp"]["wall_s"] = time.perf_counter() - t0
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["moe_fsdp"] = _moe_fsdp_rank(rank, torch, k_b)
    out["moe_fsdp"]["wall_s"] = time.perf_counter() - t0
    return out


def check_contract_columns(rows, suite) -> None:
    """Every row of a suite carries the reference's contract columns: a
    status of ok, warn(..) or n/a, and where there is an oracle, one that
    brackets the row's bits."""
    for r in rows:
        status, oracle = r["contract_status"], r["bits_oracle"]
        if status not in ("ok", "n/a") and not status.startswith("warn("):
            raise AssertionError(f"{suite} {r['name']}: contract_status "
                                 f"{status}")
        if (status == "n/a") != (oracle is None):
            raise AssertionError(f"{suite} {r['name']}: status {status} "
                                 f"with bits_oracle {oracle}")
        if oracle is not None and not (
                oracle["lo"] * (1 - 1e-6) <= r["bits"]
                <= oracle["hi"] * (1 + 1e-6)):
            raise AssertionError(f"{suite} {r['name']}: bits {r['bits']} "
                                 f"outside the oracle {oracle}")
    log(f"{suite}: {len(rows)} rows carry contract_status "
        f"{sorted({r['contract_status'] for r in rows})} and an oracle "
        f"bracketing their bits")


def phase_audits(torch, dev, train, counts, zero_counts, read_counts, D):
    """3o: the audits on the card (``repro_torch.analysis``)."""
    import contextlib
    import io
    from repro_torch.analysis import comm_lint, contracts, kernel_lint
    from repro_torch.core.compression import omega_certificate
    t0 = time.perf_counter()
    # the nine registry compressors at the main path's d, card against CPU
    same = ("name", "d", "omega", "kind", "qualifier", "d_test", "trials",
            "refuted")
    for comp in comm_lint.registry_probes():
        if comp.name == "signtopk_block":
            zero_counts()
        card = omega_certificate(comp, D, device=dev)
        if comp.name == "signtopk_block":
            counts["omega_certificate"] = read_counts()
            if counts["omega_certificate"]["sign_topk_blocks"] <= 0:
                raise AssertionError("signtopk_block's certificate launched "
                                     "no SignTopK kernel")
        cpu = omega_certificate(comp, D, device="cpu")
        for f in same:
            if getattr(card, f) != getattr(cpu, f):
                raise AssertionError(f"certificate {comp.name}: {f} "
                                     f"{getattr(card, f)} on the card, "
                                     f"{getattr(cpu, f)} on the CPU")
        for f in ("worst_ratio", "bound"):
            a, b = getattr(card, f), getattr(cpu, f)
            if abs(a - b) > CERT_RTOL * abs(b):
                raise AssertionError(f"certificate {comp.name}: {f} {a} on "
                                     f"the card, {b} on the CPU")
        if card.refuted or card.kind != "analytic":
            raise AssertionError(f"certificate {comp.name}: {card}")
        log(f"omega certificate {comp.name:15s} d {D} omega {card.omega:.6g} "
            f"{card.kind}/{card.qualifier} trials {card.trials} worst "
            f"{card.worst_ratio:.6f} (CPU {cpu.worst_ratio:.6f}) bound "
            f"{card.bound:.6f}")
    log(f"nine certificates card == CPU; signtopk_block's launches "
        f"{counts['omega_certificate']} ({time.perf_counter() - t0:.1f} s)")
    # R10's fixtures on the card
    t1 = time.perf_counter()
    f10, m10 = comm_lint.lint_bits_oracle(program="3o", device=dev)
    want = {"clean": (11808.0, 6, 48), "faulty": (8364.0, 6, 46)}
    for name, fx in m10["fixtures"].items():
        got = tuple(fx["trace"][k] for k in ("bits", "sync_rounds",
                                             "triggers"))
        oracle = tuple(fx["oracle"][k] for k in ("bits", "sync_rounds",
                                                 "triggers"))
        if got != oracle or got != want[name]:
            raise AssertionError(f"R10 {name}: trace {got}, oracle {oracle}, "
                                 f"want {want[name]}")
        log(f"R10 {name} fixture on the card: bits, syncs, triggers {got} "
            f"== oracle")
    if f10 or m10["payload_checks"] != 27:
        raise AssertionError(f"R10: {[f.message for f in f10]}")
    log(f"R10: {m10['payload_checks']} payload checks, no finding "
        f"({time.perf_counter() - t1:.1f} s)")
    # K1 and K3 on both kernels and every dtype
    t1 = time.perf_counter()
    f1, m1 = kernel_lint.lint_coverage_card(dev, program="3o")
    f3, m3 = kernel_lint.lint_budget_card(program="3o")
    for f in f1 + f3:
        log(f"[{f.rule_id}/{f.severity.upper()}] {f.message}")
    errors = [f for f in f1 + f3 if f.severity == "error"]
    if errors:
        raise AssertionError(f"K1/K3: {len(errors)} error(s)")
    for entry, r in m1.items():
        log(f"K1 {entry}: grid cap {r['grid_cap']} x {r['block']} threads; "
            f"tiles {r['tiles']} written, guard tile untouched, == plain "
            f"(max abs err {r['max_abs_err']:.3e}, {r['boundary_flips']} "
            f"boundary flips)")
    for entry, a in m3.items():
        cf = a["closed_form"]
        log(f"K3 {entry}: {a['num_regs']} registers (cap "
            f"{cf['max_registers']}), {a['shared_bytes']} B static shared "
            f"(closed form {cf['static_shared_bytes']}), {a['local_bytes']} "
            f"B local, {a['blocks_per_sm']} blocks per SM (asks "
            f"{cf['min_blocks'] or 1}), at most {a['max_threads']} threads")
    log(f"K1 and K3 card legs: {time.perf_counter() - t1:.1f} s")
    # the contract lint of phase 3a's flat-buffer config at full width
    _, dcfg = train.configs(MAIN_ARGS)
    res = contracts.run_contract_lint(dcfg, d=D, n=4, program="3o",
                                      device=dev)
    if res["errors"]:
        raise AssertionError(f"phase 3a's config: {res['findings']}")
    log(f"contract lint of phase 3a's config (d {D}, n 4): "
        f"{[(f['rule_id'], f['severity']) for f in res['findings']]}")
    # --lint through the train entry, reduced, one step
    buf = io.StringIO()
    zero_counts()
    with contextlib.redirect_stdout(buf):
        out = train.run(LINT_ARGS)
    counts["train_lint"] = read_counts()
    text = buf.getvalue()
    if "passes the static audit" not in text or len(out["losses"]) != 1:
        raise AssertionError(f"train --lint: {text}")
    log(f"train --lint, reduced, one step: "
        f"{[ln for ln in text.splitlines() if 'lint' in ln]}; loss "
        f"{out['losses'][0]:.4f}; launches {counts['train_lint']}")
    return {"coverage": m1, "attributes": m3}


def start_roofline(tmp: str) -> subprocess.Popen:
    """Phase 3p's roofline suite through the driver, started in a process
    of its own (its two dry runs walk on ``meta``, on the host's other
    cores) so that it runs beside phases 3e-3o; its working directory is
    ``tmp``, where its dry-run rows and its document go. It is killed at
    exit if it is still running."""
    import atexit
    env = dict(os.environ, PYTHONPATH=SRC)
    with open(os.path.join(tmp, "roofline.log"), "w") as out:
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.run", "--suite",
             "roofline", "--out-dir", os.path.join(tmp, "suites")],
            cwd=tmp, env=env, stdout=out, stderr=subprocess.STDOUT)
    atexit.register(lambda: proc.poll() is None and (proc.kill(),
                                                     proc.wait()))
    return proc


def phase_driver(torch, train, counts, zero_counts, read_counts,
                 main_counted, card, roof, roof_tmp):
    """Phase 3p: the suite driver, the roofline suite (``roof``, the
    process :func:`start_roofline` started in ``roof_tmp``) and the cost
    walk (see the module doc)."""
    import contextlib
    import dataclasses
    import io
    from repro_torch.data.synthetic import TokenPipeline
    from repro_torch.dist.sparq_dist import build_sparq
    from repro_torch.kernels.sign_topk import sign_topk_blocks
    from repro_torch.launch import op_walk
    from repro_torch.launch import run as run_mod
    from repro_torch.launch.mesh import HBM_BW, PEAK_FLOPS_BF16
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        # the kernels suite through the driver, then its static check
        out_dir = os.path.join(tmp, "suites")
        zero_counts()
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = run_mod.main(["--suite", "kernels", "--out-dir", out_dir])
        counts["driver_kernels"] = read_counts()
        if rc or min(counts["driver_kernels"].values()) == 0:
            raise AssertionError(f"driver --suite kernels: exit {rc}, "
                                 f"launches {counts['driver_kernels']}\n"
                                 f"{buf.getvalue()}")
        for ln in buf.getvalue().splitlines():
            log(f"driver: {ln}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            bad = run_mod.check_artifacts([out_dir])
        log(f"driver --check-artifacts: {buf.getvalue().strip()}")
        if bad:
            raise AssertionError(f"driver --check-artifacts: {bad} bad "
                                 f"row(s)")
    # the roofline suite, started before 3e: the dry runs' rows in a fresh
    # directory (they live under the working directory's runs/dryrun)
    t1 = time.perf_counter()
    rc = roof.wait(timeout=600)
    with open(os.path.join(roof_tmp, "roofline.log")) as f:
        text = f.read()
    with open(os.path.join(roof_tmp, "suites", "suite_roofline.json")) as f:
        rows = json.load(f)["rows"]
    names = sorted(r["name"] for r in rows)
    want = ["roofline_qwen1.5-0.5b_decode_32k_16x16",
            "roofline_qwen1.5-0.5b_train_4k_16x16"]
    if rc or names != want or any(r["lint_errors"] for r in rows):
        raise AssertionError(f"driver --suite roofline: exit {rc}, rows "
                             f"{names}\n{text}")
    for r in sorted(rows, key=lambda r: r["name"]):
        log(f"roofline {r['name']}: compute {r['compute_s']} s, memory "
            f"{r['memory_s']} s, collective {r['collective_s']} s "
            f"({r['dominant']}); dot FLOPs/rank "
            f"{r['dot_flops_per_rank']:.6e}, bytes/rank "
            f"{r['hbm_bytes_per_rank']:.6e}, collective bytes/rank "
            f"{r['collective_bytes_per_rank']:.6e}; watermark "
            f"{r['peak_hbm_bytes']} B; walk {r['walk_seconds']} s; lint "
            f"errors {r['lint_errors']}")
    log(f"roofline suite: {time.perf_counter() - t1:.1f} s of waiting in "
        f"this phase (it ran beside 3e-3o)")
    # one sync step of the reduced trainer, counted on the card and on meta
    t1 = time.perf_counter()
    cfg, dcfg = train.configs(["--reduced", "--nodes", "4", "--use-kernel",
                               "--H", "1", "--device", "cuda"])
    cfg = dataclasses.replace(cfg, compute_dtype="float32")
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=128,
                         batch_per_node=2, n_nodes=4, seed=0)
    batch = {k: torch.as_tensor(v, dtype=torch.int32)
             for k, v in pipe.global_batch(0).items()}
    walks = {}
    for where in ("cuda", "meta"):
        init_fn, step, _ = build_sparq(cfg, dcfg, device=where)
        state = init_fn() if where == "cuda" else init_fn.zero_state()
        b = batch if where == "cuda" else {
            k: torch.empty(v.shape, dtype=v.dtype, device="meta")
            for k, v in batch.items()}
        before = sign_topk_blocks.launches
        with op_walk.OpWalk(where) as w:
            step(state, b)
            if where == "cuda":
                torch.cuda.synchronize()
        launched = sign_topk_blocks.launches - before
        # a comparison, not a path: the count is restored
        sign_topk_blocks.launches = before
        walks[where] = (w.result(), launched)
        del state
    (card_w, card_n), (meta_w, meta_n) = walks["cuda"], walks["meta"]
    for key in ("dot_flops", "hbm_bytes", "kernels", "collective_bytes"):
        if card_w[key] != meta_w[key]:
            raise AssertionError(f"reduced step: {key} {card_w[key]} on the "
                                 f"card, {meta_w[key]} on meta")
    if card_n != 1 or meta_n != 0 or \
            card_w["kernels"]["sign_topk"]["launches"] != 1:
        raise AssertionError(f"reduced step: {card_n} launches on the card, "
                             f"{meta_n} on meta, charges "
                             f"{card_w['kernels']}")
    log(f"reduced step counted on the card == on meta: dot FLOPs "
        f"{card_w['dot_flops']}, bytes {card_w['hbm_bytes']}, SignTopK "
        f"charged {card_w['kernels']['sign_topk']} both times, "
        f"{card_w['ops']} / {meta_w['ops']} operations; one launch on the "
        f"card (restored) ({time.perf_counter() - t1:.1f} s)")
    torch.cuda.empty_cache()
    # context, not a gate: the main path's counted work per step (phase
    # a's steps 10..12, one sync) beside phase a's measured time
    flops, nbytes = main_counted["dot_flops"], main_counted["hbm_bytes"]
    sec = main_counted["s_per_step"]
    log(f"main path counted on the card (steps 10-12, one sync): "
        f"{flops:.6e} dot FLOPs and {nbytes:.6e} bytes per step; phase a's "
        f"median {sec:.4f} s/step -> {flops / sec / 1e12:.3f} TFLOP/s "
        f"({100 * flops / sec / PEAK_FLOPS_BF16:.2f}% of the bf16 peak) "
        f"and {nbytes / sec / 1e9:.1f} GB/s ({100 * nbytes / sec / HBM_BW:.2f}"
        f"% of HBM3) on {card}; SignTopK charged "
        f"{main_counted['kernels']}")
    log(f"phase 3p: {time.perf_counter() - t0:.1f} s")


def phase_shard(torch, dev, train, counts, zero_counts, read_counts,
                main_rec):
    """Phase 3n: the sharded engine on the one card (see the module doc);
    returns the numbers for the report."""
    import dataclasses
    import numpy as np
    from repro_torch.configs.registry import get_config
    from repro_torch.core import prng
    from repro_torch.dist import comm, serve, sharding
    from repro_torch.kernels.sign_topk import sign_topk_blocks
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models.transformer import init_cache, init_params
    card = card_line()
    torch.cuda.empty_cache()
    rec = {}

    # ---- run 1: qwen1.5-0.5b at full width and depth, 4 ranks x 1 node
    t0 = time.perf_counter()
    ranks = comm.spawn(_shard_full_rank, 4, (SHARD_ARGS, main_rec["k_b"]),
                       device_type="cuda", timeout_s=SHARD_TIMEOUT_S,
                       deadline_s=SHARD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    log(f"sharded trainer: [train] mesh {r0['mesh']}; {r0['describe']} "
        f"({card})")
    for key in ("losses", "bits", "triggers"):
        if any(r[key] != main_rec[key] for r in ranks):
            raise AssertionError(f"sharded trainer: per-step {key} "
                                 f"{[r[key] for r in ranks]} != phase "
                                 f"3a's {main_rec[key]}")
    for r in ranks:
        lo, hi = r["rows"]
        for key in ("params", "x_hat"):
            if r["checksums"][key] != main_rec["checksums"][key][lo:hi]:
                raise AssertionError(f"sharded trainer: rows {lo}:{hi} of "
                                     f"{key} differ from phase 3a's")
        if r["launches"] != 2 or r["check"].get("tiles", 0) * 1024 != \
                (hi - lo) * main_rec["d_pad"]:
            raise AssertionError(f"sharded trainer rank rows {lo}:{hi}: "
                                 f"{r['launches']} launches, check "
                                 f"{r['check']}")
        rest = r["s_per_step"][1:]
        log(f"sharded trainer rank rows {lo}:{hi}: s/step "
            f"{[round(v, 4) for v in r['s_per_step']]}, median of steps "
            f"2..6 {median(rest):.4f} s; exchange per sync "
            f"{[round(v, 3) for v in r['exchange_s']]} s; peak "
            f"{r['peak_gb']:.2f} GB; SignTopK == plain on its "
            f"{r['check']['tiles']} tiles at t=5, max abs err "
            f"{r['check']['err']:.3e} ({r['check']['s']:.1f} s), kernel "
            f"{r['check']['ms']:.4f} ms there beside the other ranks "
            f"({card})")
    log(f"sharded trainer: losses, bits and triggers per step == phase 3a's "
        f"{main_rec['losses']}; row checksums of params and x_hat == phase "
        f"3a's; {wall:.1f} s for the 4 ranks' run ({card})")
    counts["sharded_trainer"] = {
        "sign_topk_blocks": sum(r["launches"] for r in ranks),
        "qsgd_blocks": 0}
    rec["trainer"] = {
        "mesh": r0["mesh"], "describe": r0["describe"],
        "s_per_step_median": [median(r["s_per_step"][1:]) for r in ranks],
        "exchange_s": [r["exchange_s"] for r in ranks],
        "peak_gb": [r["peak_gb"] for r in ranks],
        "max_abs_err": max(r["check"]["err"] for r in ranks),
        "kernel_ms": [r["check"]["ms"] for r in ranks],
        "tiles_per_rank": r0["check"]["tiles"], "wall_s": wall}
    del ranks

    # ---- run 2: NCCL with one rank, reduced: == the unsharded card run
    t0 = time.perf_counter()
    red = MAIN_ARGS + ["--reduced"]
    cfg, _ = train.configs(red)
    one = train.run(red)
    with comm.single_rank_group("nccl", dev, timeout_s=SHARD_TIMEOUT_S):
        zero_counts()
        mesh = sharding.train_mesh(make_production_mesh(), cfg)
        nccl = train.run(red, mesh=mesh)
        counts["sharded_nccl"] = read_counts()
        backend = nccl["train_step"].comm.backend
    for key in ("losses", "bits", "triggers"):
        if nccl[key] != one[key]:
            raise AssertionError(f"NCCL one rank: {key} {nccl[key]} != "
                                 f"{one[key]}")
    for key in ("params", "x_hat"):
        if not torch.equal(nccl["state"][key], one["state"][key]):
            raise AssertionError(f"NCCL one rank: {key} differs")
    log(f"NCCL group of one rank ({backend}, mesh "
        f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}): reduced main path "
        f"== the unsharded card run bit for bit (losses {nccl['losses']}); "
        f"launches {counts['sharded_nccl']} ({time.perf_counter() - t0:.1f} "
        f"s; {card})")
    del one, nccl

    # ---- runs 3 and 5: fsdp over gloo; the checkpoint saved at 4 ranks
    t0 = time.perf_counter()
    fsdp_argv = with_arg(red, "--nodes", "2")
    tmp = tempfile.mkdtemp(prefix="shard_ckpt_")
    ck = CKPT_ARGS + ["--reduced", "--ckpt-dir", tmp]
    quad = comm.spawn(_shard_quad_rank, 4,
                      (fsdp_argv, with_arg(ck, "--steps", "4") +
                       ["--ckpt-every", "4", "--devices", "4"]),
                      device_type="cuda", timeout_s=SHARD_TIMEOUT_S,
                      deadline_s=SHARD_TIMEOUT_S)
    fone = train.run(fsdp_argv)
    parts = [q["fsdp"] for q in quad if q["fsdp"]["coords"]["fsdp"] == 0]
    got = {k: torch.cat([p[k] for p in sorted(parts, key=lambda p:
                                               p["rows"])])
           for k in ("params", "x_hat")}
    f0 = quad[0]["fsdp"]
    if f0["bits"] != fone["bits"] or f0["triggers"] != fone["triggers"]:
        raise AssertionError(f"fsdp: bits {f0['bits']} / triggers "
                             f"{f0['triggers']} != {fone['bits']} / "
                             f"{fone['triggers']}")
    np.testing.assert_allclose(f0["losses"], fone["losses"], rtol=1e-4,
                               err_msg="fsdp: losses")
    fl = flips_only(got, _host_rows(fone["state"]))
    log(f"fsdp over gloo (node 2 x fsdp 2, 4 ranks): bits and triggers == "
        f"the one-process card run; losses {f0['losses']} (one process "
        f"{fone['losses']}); x_hat beyond 5e-4 on {fl['xhat_far']} entries "
        f"in {fl['flip_tiles']} of {fl['tiles']} tiles; params largest gap "
        f"{fl['params_gap']:.3e}, {fl['params_gap_rest']:.3e} outside the "
        f"flipped columns ({card})")
    counts["sharded_fsdp"] = {"sign_topk_blocks": sum(
        q["fsdp"]["launches"] for q in quad), "qsgd_blocks": 0}
    resumed = train.run(ck + ["--resume"])
    unbroken = train.run(CKPT_ARGS + ["--reduced"])
    a, b = resumed["state"], unbroken["state"]
    for key in ("params", "x_hat", "opt", "bits", "bits_c", "triggers"):
        if not torch.equal(a[key], b[key]):
            raise AssertionError(f"checkpoint: resumed {key} != unbroken")
    if (a["t"], a["sync_rounds"]) != (b["t"], b["sync_rounds"]) or \
            resumed["start"] != 4:
        raise AssertionError("checkpoint: step counters differ")
    if quad[0]["ckpt_losses"] != unbroken["losses"][:4]:
        raise AssertionError("checkpoint: the 4-rank run's losses differ")
    shutil.rmtree(tmp, ignore_errors=True)
    log(f"checkpoint: saved at --devices 4 (step 4, {quad[0]['ckpt_saves']}"
        f"), restored in one process and run to step 6 == the unbroken run "
        f"bit for bit (params, x_hat, momentum, bits, triggers); "
        f"{time.perf_counter() - t0:.1f} s for runs 3 and 5 ({card})")
    counts["sharded_ckpt"] = {"sign_topk_blocks": sum(
        q["ckpt_launches"] for q in quad), "qsgd_blocks": 0}
    del quad, fone, resumed, unbroken, a, b

    # ---- runs 4 and 6: dense mixing over gloo; the data-sharded serve
    t0 = time.perf_counter()
    fault_argv = FAULT_ARGS + ["--reduced"]
    rng = np.random.default_rng(3)
    scfg = dataclasses.replace(get_config("qwen1.5-0.5b").reduced(),
                               compute_dtype="float32")
    toks = rng.integers(0, scfg.vocab_size, (4, 32)).astype(np.int64)
    steps = 8
    qwen_vocab = get_config("qwen1.5-0.5b").vocab_size
    tp_full_toks = rng.integers(0, qwen_vocab, (1, TP_FULL_PROMPT))
    tp_red_toks = {arch: rng.integers(
        0, Float32Reduced(get_config(arch)).reduced().vocab_size,
        (2, TP_RED_PROMPT)) for arch, _, _ in TP_RED_CASES}
    pair = comm.spawn(_shard_pair_rank, 2,
                      (fault_argv, toks, steps, tp_full_toks, tp_red_toks,
                       main_rec["k_b"]),
                      device_type="cuda", timeout_s=SHARD_TIMEOUT_S,
                      deadline_s=SHARD_TIMEOUT_S)
    done = train.run(fault_argv)
    d0 = pair[0]["dense"]
    for key in ("losses", "bits", "triggers"):
        if any(p["dense"][key] != done[key] for p in pair):
            raise AssertionError(f"dense mixing: {key} != one process")
    got = {k: torch.cat([p["dense"][k] for p in pair]) for k in
           ("params", "x_hat")}
    for key, want in _host_rows(done["state"]).items():
        if not torch.equal(got[key], want):
            raise AssertionError(f"dense mixing: {key} differs from one "
                                 f"process")
    log(f"dense mixing over gloo (node 2, 2 rows per rank, "
        f"{done['train_step'].plan.name}, faults): losses, bits, triggers "
        f"and every row bit for bit == the one-process card run (losses "
        f"{d0['losses']}); gather per sync {d0['exchange_s']} s ({card})")
    counts["sharded_dense"] = {"sign_topk_blocks": sum(
        p["dense"]["launches"] for p in pair), "qsgd_blocks": 0}
    params = init_params(scfg, prng.PRNGKey(0).to(dev))
    prefill, _ = serve.build_prefill(scfg, dev)
    decode, _ = serve.build_decode(scfg, dev)
    gt = torch.as_tensor(toks)
    want = [prefill(params, gt).cpu()]
    cache = init_cache(scfg, gt.shape[0], steps, device=dev)
    for t in range(steps):
        lg, cache = decode(params, cache, gt[:, t:t + 1], None, t)
        want.append(lg.cpu())
    sizes = {"data": 2, "model": 1}
    cspecs = sharding.cache_specs(cache, sizes)
    gap = 0.0
    for p in pair:
        c = p["serve_coords"]
        rows = slice(2 * c["data"], 2 * c["data"] + 2)
        for g, w in zip(p["serve_logits"], want, strict=True):
            err = float((g - w[rows]).abs().max())
            gap = max(gap, err / float(w.abs().max()))
        for k, sub in cache.items():
            for kk, w in sub.items():
                ix = sharding.local_index(cspecs[k][kk], tuple(w.shape),
                                          sizes, c)
                g, w = p["serve_cache"][k][kk], w[ix].cpu()
                if kk == "pos":
                    if not torch.equal(g, w):
                        raise AssertionError("serve: pos slots differ")
                elif float((g - w).abs().max()) > SERVE_SHARD_RTOL * float(
                        w.abs().max()):
                    raise AssertionError(f"serve: cache {k}/{kk} differs")
    if gap > SERVE_SHARD_RTOL:
        raise AssertionError(f"serve: logits differ by {gap:.3e} of the "
                             f"largest")
    log(f"serve over (data 2, model 1), reduced qwen1.5-0.5b float32: "
        f"prefill and {steps} decode steps of each rank's 2 rows == the "
        f"one-process logits (largest gap {gap:.3e} of the largest logit) "
        f"and cache; {time.perf_counter() - t0:.1f} s for runs 4 and 6 "
        f"({card})")
    rec["serve_gap"] = gap
    del want, cache
    torch.cuda.empty_cache()
    rec["tp"] = check_tp_serve(torch, dev, pair, tp_full_toks, tp_red_toks,
                               card)
    counts["tp_serve"] = {name: sum(p["tp"]["launches"][name] for p in pair)
                          for name in ("sign_topk_blocks", "qsgd_blocks")}
    rec["moe_fsdp"] = check_moe_fsdp(torch, dev, train, pair,
                                     main_rec["k_b"], counts, card)
    return rec


def _cache_gap(torch, got, want, spec_tree, sizes, coords, what):
    """The largest gap of a rank's cache shard from the one-process cache's
    block, over the block's largest entry; ``pos`` must be equal."""
    from repro_torch.dist import sharding
    gap = 0.0
    for k, sub in want.items():
        if isinstance(sub, dict):
            gap = max(gap, _cache_gap(torch, got[k], sub, spec_tree[k],
                                      sizes, coords, f"{what}/{k}"))
            continue
        w = sub[sharding.local_index(spec_tree[k].spec, tuple(sub.shape),
                                     sizes, coords)]
        g = got[k]
        if tuple(g.shape) != tuple(w.shape):
            raise AssertionError(f"{what}/{k}: shard {tuple(g.shape)} != "
                                 f"block {tuple(w.shape)}")
        if k == "pos":
            if not torch.equal(g, w):
                raise AssertionError(f"{what}/pos differs")
            continue
        scale = float(w.abs().max()) or 1.0
        gap = max(gap, float((g.float() - w.float()).abs().max()) / scale)
    return gap


def check_tp_serve(torch, dev, pair, full_toks, red_toks, card):
    """Runs 7 and 8 against the one-process card run: logits within
    ``SERVE_SHARD_RTOL`` of the largest, each rank's cache shard against
    its block, ``pos`` exactly; the parameter bytes each rank holds."""
    import dataclasses
    import functools
    from repro_torch.configs.registry import get_config
    from repro_torch.dist import serve
    from repro_torch.models import attention
    from repro_torch.models.transformer import param_shapes
    sizes = {"data": 1, "model": 2}
    ranks = sorted((p["tp"] for p in pair), key=lambda r:
                   r["coords"]["model"])
    chunked = attention.chunked_attention
    attention.chunked_attention = functools.partial(
        chunked, score_dtype=torch.float32)
    out = {}
    try:
        cases = [("qwen1.5-0.5b full", dataclasses.replace(
            get_config("qwen1.5-0.5b"), compute_dtype="float32"),
            full_toks, TP_FULL_STEPS, TP_FULL_PROMPT, "vocab", "auto",
            [r["full"] for r in ranks])]
        for arch, emb, cm in TP_RED_CASES:
            cfg = Float32Reduced(get_config(arch),
                                 param_dtype="float32").reduced()
            cases.append((f"{arch} reduced {emb}/{cm}", cfg, red_toks[arch],
                          TP_RED_STEPS, TP_RED_PROMPT, emb, cm,
                          [r["reduced"][(arch, emb, cm)] for r in ranks]))
        for name, cfg, toks, steps, clen, emb, cm, got in cases:
            toks = torch.as_tensor(toks)
            want = tp_serve(torch, dev, cfg, dev, toks, steps, clen, emb, cm)
            gap = 0.0
            for r in got:
                for g, w in zip(r["logits"], want["logits"], strict=True):
                    if g is None:
                        continue
                    gap = max(gap, float((g - w).abs().max())
                              / float(w.abs().max()))
            _, dec_sh = serve.build_decode(cfg, sizes, cache_mode=cm)
            _, cspecs, _, _, _ = dec_sh(param_shapes(cfg), want["cache"],
                                        toks[:, :1], None)
            cgap = max(_cache_gap(torch, r["cache"], want["cache"], cspecs,
                                  sizes, {"data": 0, "model": m}, name)
                       for m, r in enumerate(got))
            if gap > SERVE_SHARD_RTOL or cgap > SERVE_SHARD_RTOL:
                raise AssertionError(f"tensor-parallel serve {name}: logits "
                                     f"gap {gap:.3e}, cache gap {cgap:.3e} "
                                     f"of the largest")
            out[name] = {"gap": gap, "cache_gap": cgap,
                         "param_bytes": [r["param_bytes"] for r in got],
                         "whole_bytes": want["whole_bytes"],
                         "peak_gb": [r["peak_gb"] for r in got],
                         "one_peak_gb": want["peak_gb"],
                         "prefill_s": [r["prefill_s"] for r in got],
                         "step_s_median": [median(r["step_s"])
                                           for r in got],
                         "one_prefill_s": want["prefill_s"],
                         "one_step_s_median": median(want["step_s"])}
            o = out[name]
            log(f"tensor-parallel serve (data 1, model 2), {name}, float32 "
                f"({toks.shape[0]} x {toks.shape[1]} prefill, {steps} "
                f"decode steps, embed {emb}, cache {cm}): logits == one "
                f"process within {gap:.3e} of the largest, cache shards "
                f"within {cgap:.3e}, pos equal; parameter bytes per rank "
                f"{o['param_bytes']} of {o['whole_bytes']} whole; peak per "
                f"rank {[round(v, 3) for v in o['peak_gb']]} GB (one "
                f"process {o['one_peak_gb']:.3f}); prefill "
                f"{[round(v, 4) for v in o['prefill_s']]} s, decode median "
                f"{[round(v, 4) for v in o['step_s_median']]} s/step (one "
                f"process {o['one_prefill_s']:.4f} s, "
                f"{o['one_step_s_median']:.4f} s/step) -- {TP_LABEL} "
                f"({card})")
            del want
            torch.cuda.empty_cache()
    finally:
        attention.chunked_attention = chunked
    log(f"tensor-parallel serve: the pair's runs 7 and 8 took "
        f"{[round(r['wall_s'], 1) for r in ranks]} s ({card})")
    return out


def check_moe_fsdp(torch, dev, train, pair, k_b, counts, card):
    """Run 9 against the one-process card run: the first step's routing
    tables joined over the pair equal to the whole microbatch's, losses
    within ``MOE_FSDP_RTOL``, bits and triggers equal, x_hat within the
    flips rule, SignTopK == plain on every rank's tiles at the last
    sync."""
    import functools
    import numpy as np
    from repro_torch.models import attention
    ranks = sorted((p["moe_fsdp"] for p in pair), key=lambda r:
                   r["coords"]["fsdp"])
    chunked = attention.chunked_attention
    attention.chunked_attention = functools.partial(
        chunked, score_dtype=torch.float32)
    try:
        with ArchRegistry(lambda c: Float32Reduced(c)), RouteLog() as log_:
            one = train.run(MOE_FSDP_ARGS)
    finally:
        attention.chunked_attention = chunked
    want = [(c[0].cpu(), c[2]) for c in log_.calls[:len(ranks[0]["routes"])]]
    for i, (w_tfs, w_t) in enumerate(want):
        joined = torch.full_like(w_tfs, w_t)
        base = 0
        for r in ranks:
            tfs, t, grank = r["routes"][i]
            if grank != r["coords"]["fsdp"]:
                raise AssertionError("moe fsdp: a route without its group")
            own = tfs < t
            if bool((own & (joined < w_t)).any()):
                raise AssertionError("moe fsdp: a slot held by two ranks")
            joined = torch.where(own, tfs + base, joined)
            base += t
        if base != w_t or not torch.equal(joined, w_tfs):
            raise AssertionError(f"moe fsdp: routing call {i} differs from "
                                 f"the whole microbatch's")
    for r in ranks:
        if r["bits"] != one["bits"] or r["triggers"] != one["triggers"]:
            raise AssertionError("moe fsdp: bits or triggers differ")
        np.testing.assert_allclose(r["losses"], one["losses"],
                                   rtol=MOE_FSDP_RTOL,
                                   err_msg="moe fsdp: losses")
        if r["launches"] != 2 or "err" not in r["check"]:
            raise AssertionError(f"moe fsdp: {r['launches']} launches, "
                                 f"check {r['check']}")
    fl = flips_only(ranks[0], _host_rows(one["state"]))
    gap = max(abs(x - y) / abs(y) for x, y in zip(ranks[0]["losses"],
                                                   one["losses"]))
    k = one["cfg"].moe_top_k
    dropped = [w_t * k - int((w_tfs < w_t).sum()) for w_tfs, w_t in want]
    counts["sharded_moe_fsdp"] = {"sign_topk_blocks": sum(
        r["launches"] for r in ranks), "qsgd_blocks": 0}
    log(f"moe fsdp (node 1 x fsdp 2, reduced deepseek-moe-16b, float32): "
        f"mesh {ranks[0]['mesh']}; the first step's routing joined over the "
        f"pair == the whole microbatch's ({want[0][0].numel()} slots, "
        f"{dropped} choices dropped); losses {ranks[0]['losses']} (one "
        f"process {one['losses']}), largest relative gap {gap:.3e}; bits "
        f"and triggers equal; x_hat beyond 5e-4 on {fl['xhat_far']} entries "
        f"in {fl['flip_tiles']} of {fl['tiles']} tiles; params gap "
        f"{fl['params_gap']:.3e}; SignTopK == plain on each rank's "
        f"{ranks[0]['check']['tiles']} tiles at t=5, max abs err "
        f"{max(r['check']['err'] for r in ranks):.3e}; launches "
        f"{counts['sharded_moe_fsdp']}; {ranks[0]['wall_s']:.1f} s ({card})")
    return {"loss_gap": gap, "max_abs_err": max(r["check"]["err"]
                                                for r in ranks),
            "flips": fl}


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
    from repro_torch.core import prng, schedule, triggers
    from repro_torch.dist.sparq_dist import (DistSparqConfig, _flatten_spec,
                                             build_sparq)
    from repro_torch.kernels import parity
    from repro_torch.kernels.qsgd import qsgd_blocks, qsgd_blocks_plain
    from repro_torch.kernels.qsgd import work_bytes as qsgd_work_bytes
    from repro_torch.kernels.sign_topk import (BLOCK, sign_topk_blocks,
                                               sign_topk_blocks_plain)
    from repro_torch.kernels.sign_topk import \
        work_bytes as sign_topk_work_bytes
    from repro_torch.launch import (bench_kernels, convex_bits, faults_bits,
                                    topology_bits, train)
    from repro_torch.models.transformer import init_params, param_shapes

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.empty(0, device=dev)       # the context, before any memory query
    t_all = time.perf_counter()

    # ---------------------------------------------------------- 1. set-up
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}")
    t0 = time.perf_counter()
    built = kernels.build()
    log(f"{len(built)} kernel sources built in {time.perf_counter() - t0:.2f}"
        f" s, one nvcc each, all at once")
    for name, b in built.items():
        regs = [ln.strip() for ln in b.log.splitlines()
                if "registers" in ln or "spill" in ln]
        log(f"  {name}.cu: nvcc {b.seconds:.2f} s; {'; '.join(regs)}")
    launch_counts = (sign_topk_blocks, qsgd_blocks)

    def zero_counts():
        for fn in launch_counts:
            fn.launches = 0

    def read_counts():
        return {fn.__name__: fn.launches for fn in launch_counts}

    counts = {}

    # ------------------------------------------- 2. kernel vs plain, timing
    # the cases reach magnitudes of 1e35, so their absolute error is kept
    # apart from the main path's (max_err)
    cases_err = 0.0
    n_cases = 0
    for _, err in parity.check_all_sign_topk(dev):
        cases_err = max(cases_err, err)
        n_cases += 1
    parity.check_ensemble_matches_rows(dev)
    parity.check_payload_reconstructs(dev)
    torch.cuda.synchronize()
    log(f"sign_topk kernel == plain version on {n_cases} cases "
        f"(+ ensemble == rows, payload rebuilds q); max abs err "
        f"{cases_err:.3e}")

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
    # diff in; q and scales out
    bytes_moved = sign_topk_work_bytes(rows, torch.float32, False)
    bound_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
    ops_ms = max(elements * SIGN_TOPK_INT_OPS / INT32_OPS_PER_S,
                 elements * SIGN_TOPK_F32_OPS / F32_OPS_PER_S) * 1e3
    log(f"main-path shape ({rows}, {BLOCK}) f32, k_b={k_b}, ensemble mode:")
    log(f"  kernel_ms {kernel_ms:.4f} ({100 * bound_ms / kernel_ms:.1f}% of "
        f"the bound's speed)")
    log(f"  plain_ms {plain_ms:.4f} (every tile, {PLAIN_ROWS} tiles per "
        f"call)")
    log(f"  bound_ms {bound_ms:.4f} (bytes: {bytes_moved / 1e9:.2f} GB); "
        f"design_ops_ms {ops_ms:.4f} (an estimate: {SIGN_TOPK_INT_OPS} int32 "
        f"operations per element, counted from the source, at "
        f"{INT32_OPS_PER_S / 1e12:.1f} TOP/s)")
    log(f"  torch.topk(|diff|, {k_b}) selection only: {topk_ms:.4f} ms")
    full_err = parity.check_sign_topk_chunked(x, k_b, PLAIN_ROWS,
                                              spec="main-path shape")
    max_err = full_err
    log(f"  kernel == plain version on all {rows} tiles: max abs err "
        f"{full_err:.3e}")
    del x
    torch.cuda.empty_cache()

    # QSGD: the reference's kernel cases (nb in {1, 4, 16} x s in {4, 16,
    # 64} x f32/bf16, and a zero tile), ops.qsgd on ragged lengths with
    # threefry noise, and the unbiasedness check over 256 keys
    t_q = time.perf_counter()
    q_err, q_flips, n_q = 0.0, 0, 0
    for _, err, flips in parity.check_all_qsgd(dev):
        q_err, q_flips, n_q = max(q_err, err), q_flips + flips, n_q + 1
    err, flips = parity.check_ops_qsgd_ragged(dev)
    q_err, q_flips = max(q_err, err), q_flips + flips
    gap = parity.check_qsgd_unbiased(dev)
    torch.cuda.synchronize()
    log(f"qsgd kernel == plain version on {n_q} cases + ops.qsgd at d in "
        f"{parity.QSGD_RAGGED_D}: max abs err {q_err:.3e}, {q_flips} "
        f"boundary flips; mean of 256 draws within {gap:.4f} of x")

    # at the main path's buffer shape: x, u and out take 29.7 GB. u comes
    # from torch.rand on the card (the threefry port's int64 temporaries at
    # 2.48e9 elements would not fit); the threefry draws are checked above
    x = torch.randn((rows, BLOCK), generator=gen, device=dev)
    u = torch.rand((rows, BLOCK), generator=gen, device=dev)
    qsgd_ms = time_ms(torch, lambda: qsgd_blocks(x, u, 16), 10)

    def qsgd_plain_full():
        for lo in range(0, rows, PLAIN_ROWS):
            qsgd_blocks_plain(x[lo:lo + PLAIN_ROWS], u[lo:lo + PLAIN_ROWS], 16)
    qsgd_plain_ms = time_ms(torch, qsgd_plain_full, 2)
    q_bytes = qsgd_work_bytes(rows, torch.float32)   # x and u in; out
    q_bound_ms = q_bytes / HBM_BYTES_PER_S * 1e3
    q_ops_ms = elements * QSGD_F32_OPS / F32_OPS_PER_S * 1e3
    log(f"qsgd at ({rows}, {BLOCK}) f32, s=16:")
    log(f"  kernel_ms {qsgd_ms:.4f} ({100 * q_bound_ms / qsgd_ms:.1f}% of "
        f"the bound's speed)")
    log(f"  plain_ms {qsgd_plain_ms:.4f} (every tile, {PLAIN_ROWS} tiles "
        f"per call)")
    log(f"  bound_ms {q_bound_ms:.4f} (bytes: {q_bytes / 1e9:.2f} GB); "
        f"design_ops_ms {q_ops_ms:.4f} (an estimate: {QSGD_F32_OPS} float32 "
        f"operations per element, counted from the source, at "
        f"{F32_OPS_PER_S / 1e12:.1f} TFLOP/s)")
    full_q_err, full_flips = parity.check_qsgd_chunked(
        x, u, 16, PLAIN_ROWS, spec="main-path shape")
    q_err, q_flips = max(q_err, full_q_err), q_flips + full_flips
    log(f"  kernel == plain version on all {rows} tiles: max abs err "
        f"{full_q_err:.3e} where they agree, {full_flips} boundary flips "
        f"({time.perf_counter() - t_q:.1f} s for the QSGD phase)")
    del x, u
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
    p0 = init_params(small, prng.PRNGKey(0))
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
    log(f"phases 1-2: {time.perf_counter() - t_all:.1f} s")
    t_p = time.perf_counter()
    del out, a, b
    torch.cuda.empty_cache()

    # ---------------------------------------------------------- 3. main path
    # the profiled steps below keep their sync's diff: the kernel's real
    # input on the main path (one 9.9 GB device copy, in the profiled time)
    captured, capturing = [], []

    def keep_diff(diff, info):
        if capturing:
            captured.append(diff.clone())
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    alloc0 = alloc_counts(torch)
    result = train.run(MAIN_ARGS, on_sync=keep_diff)
    alloc1 = alloc_counts(torch)
    counts["train"] = read_counts()
    launches = counts["train"]["sign_topk_blocks"]
    peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    state, step = result["state"], result["train_step"]
    losses = result["losses"]
    # what phase 3n's four ranks must reproduce: per-step channels and a
    # checksum of every row, before the profiled steps below move the state
    main_rec = {"losses": losses, "bits": result["bits"],
                "triggers": result["triggers"], "k_b": step.k_b,
                "d_pad": step.d_pad,
                "checksums": {k: row_checksums(torch, state[k])
                              for k in ("params", "x_hat")}}
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
    log(step_times("main path", s_step, alloc0, alloc1))
    log(f"main path: peak memory allocated {peak_gb:.2f} GB")

    k_b_main = step.k_b

    # where a step's time goes: 3 more steps of the same run (t = 6..8, one
    # sync) under torch.profiler, after the counts were read (a fresh run's
    # window would hold the x^0 draw). Device time is summed over the
    # kernels themselves; the idle share compares it with the un-profiled
    # steady wall time above (the profiler slows the host)
    from repro_torch.data.synthetic import TokenPipeline
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=128,
                         batch_per_node=2, n_nodes=n_nodes, seed=0)

    def more_steps():
        st = state
        capturing.append(True)
        for i in range(6, 9):
            st, _ = step(st, pipe.global_batch(i))
        capturing.clear()
    steady = sum(s_step[1:]) / len(s_step[1:])
    device_s, launches_per_step, idle = profiled(
        torch, more_steps, 3, steady,
        tables=(("self_device_time_total", 12), ("self_cpu_time_total", 8)))
    log(f"profiled steps 7..9: device time {device_s:.4f} s/step over "
        f"{launches_per_step:.0f} kernels/step; against the steady "
        f"{steady:.4f} s/step the device is idle {100 * idle:.1f}% of the "
        f"time")
    # phase 3p's context: 3 more steps (t = 9..11, one sync) under the cost
    # walk, which slows the host; their work counted, not their time
    from repro_torch.launch import op_walk
    with op_walk.OpWalk("cuda") as walk:
        for i in range(9, 12):
            state, _ = step(state, pipe.global_batch(i))
        torch.cuda.synchronize()
    main_counted = {"dot_flops": walk.dot_flops / 3,
                    "hbm_bytes": walk.hbm_bytes / 3,
                    "kernels": walk.kernels,
                    "s_per_step": median(s_step[1:])}
    del result, state, step
    torch.cuda.empty_cache()

    if len(captured) != 1 or captured[0].shape != (n_nodes, d_pad):
        raise AssertionError("profiled steps: expected one sync's (n, D_pad) "
                             "diff")
    diff_tiles = captured.pop().view(-1, BLOCK)
    # the kernel's time on this real diff, beside the Gaussian tiles' above:
    # the select's work depends on the data
    real_ms = time_ms(torch, lambda: sign_topk_blocks(diff_tiles, None, 1.0,
                                                      k_b_main), 10)
    log(f"kernel on the profiled sync's real diff: {real_ms:.4f} ms "
        f"({100 * bound_ms / real_ms:.1f}% of the bound's speed)")
    real_err = parity.check_sign_topk_chunked(diff_tiles, k_b_main,
                                              PLAIN_ROWS,
                                              spec="main-path diff")
    max_err = max(max_err, real_err)
    log(f"kernel == plain version on every tile of the profiled sync's diff "
        f"({diff_tiles.shape[0]} tiles): max abs err {real_err:.3e}")
    del diff_tiles
    torch.cuda.empty_cache()
    log(f"phase 3a: {time.perf_counter() - t_p:.1f} s")
    t_p = time.perf_counter()

    # ------------------- 3b. the faulty, time-varying trainer at full width
    from repro_torch.core import topology as topo_mod
    from repro_torch.core.faults import DropoutWindow, FaultPlan
    # a repaired or time-varying W mixes by the dense product, a float32
    # GEMM of (4, 4) by one column chunk; its first call in the process is
    # timed apart from the trainer's steps
    w4 = torch.rand((n_nodes, n_nodes), device=dev)
    chunk = torch.rand((n_nodes, 1 << 22), device=dev)
    mix_s = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        torch.tensordot(w4, chunk, dims=1)
        torch.cuda.synchronize()
        mix_s.append(time.perf_counter() - t0)
    log(f"dense mix of one (4, 4194304) float32 chunk: first call "
        f"{mix_s[0]:.4f} s, then {mix_s[1] * 1e3:.3f} and "
        f"{mix_s[2] * 1e3:.3f} ms")
    del w4, chunk
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    alloc0 = alloc_counts(torch)
    with ArchRegistry(lambda c: dataclasses.replace(c, n_layers=CUT_DEPTH)):
        result, syncs = run_logged(train, FAULT_ARGS)
    alloc1 = alloc_counts(torch)
    counts["faulty_trainer"] = read_counts()
    f_launches = counts["faulty_trainer"]["sign_topk_blocks"]
    f_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    state, step = result["state"], result["train_step"]
    f_losses, f_step_s = result["losses"], result["s_per_step"]
    log(f"faulty trainer at depth {CUT_DEPTH} of {cfg.n_layers}: plan "
        f"{step.plan.name}, losses {f_losses}")
    if len(f_losses) != 6 or not all(math.isfinite(v) for v in f_losses):
        raise AssertionError(f"faulty trainer: losses {f_losses}")
    if not (state["sync_rounds"] == len(syncs) == f_launches == 2):
        raise AssertionError(f"faulty trainer: {f_launches} kernel launches "
                             f"for {state['sync_rounds']} syncs (want 2)")
    # the plan and its faults rebuilt here from the flags' values, and each
    # sync's repair redone on the host
    plan = topo_mod.make_plan("ring", n_nodes, dynamic="matchings", rounds=4,
                              seed=0)
    fplan = FaultPlan(link_drop=0.3, stragglers=(1,), straggler_frac=0.5,
                      dropout=(DropoutWindow(2, 1, 4),), seed=4)
    np.testing.assert_array_equal(step.plan.ws, plan.ws)
    for s in syncs:
        W, deg, live = fplan.apply(
            torch.tensor(plan.ws[s["sync_round"] % plan.R],
                         dtype=torch.float32), s["t"], s["sync_round"])
        if not (torch.equal(s["W"], W) and torch.equal(s["deg"], deg)
                and torch.equal(s["live"], live)):
            raise AssertionError(f"faulty trainer: sync {s['sync_round']} "
                                 f"differs from the plan's own repair")
        if (s["trig"] & ~live).any():
            raise AssertionError("faulty trainer: an offline node sent")
        log(f"faulty trainer: sync {s['sync_round']} at t={s['t']}: "
            f"deg_eff {deg.tolist()}, live {live.tolist()}, triggers "
            f"{s['trig'].tolist()}")
    first = syncs[0]
    if first["t"] != 2 or first["live"][2] or first["trig"][2] or \
            first["deg"][2] != 0:
        raise AssertionError("faulty trainer: node 2 was not silent at the "
                             "sync of t=2")
    f_trig = int(state["triggers"])
    f_want = reckoned_bits(syncs, step.payload_bits)
    f_bits = float(state["bits"])
    if f_trig != sum(int(s["trig"].sum()) for s in syncs) or \
            abs(f_bits - f_want) > 1e-6 * f_want:
        raise AssertionError(f"faulty trainer: bits {f_bits} != reckoned "
                             f"{f_want} from {f_trig} triggers")
    f_D = step.d_model_total
    if state["params"][:, f_D:].any() or state["x_hat"][:, f_D:].any():
        raise AssertionError("faulty trainer: the padded tail is not zero")
    f_steady = sum(f_step_s[1:]) / len(f_step_s[1:])
    log(f"faulty trainer: {f_launches} kernel launches, {f_trig} triggers, "
        f"bits {f_bits:.6e} == reckoned {f_want:.6e}; peak memory allocated "
        f"{f_peak_gb:.2f} GB")
    log(step_times("faulty trainer", f_step_s, alloc0, alloc1))
    del result, state, step
    torch.cuda.empty_cache()
    # where a faulty step goes, at full width and depth 6 of 24: the
    # profiler's host cost grows with the launches (a 24-layer window took
    # about 100 s of the smoke). An unprofiled depth-6 run of 4 steps gives
    # the wall time, and its steps t = 4..6 (one sync) are profiled; a
    # fresh run's window would hold the x^0 draw
    from repro_torch.data.synthetic import TokenPipeline
    with ArchRegistry(lambda c: dataclasses.replace(c, n_layers=6)):
        d6 = train.run(with_arg(FAULT_ARGS, "--steps", "4"))
    d6_state, d6_step = d6["state"], d6["train_step"]
    d6_wall = d6["s_per_step"][1:]
    d6_pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=128,
                            batch_per_node=2, n_nodes=n_nodes, seed=0)

    def d6_steps():
        st = d6_state
        for i in range(4, 7):
            st, _ = d6_step(st, d6_pipe.global_batch(i))
    f_steady6 = sum(d6_wall) / len(d6_wall)
    f_device_s, f_acts, f_idle = profiled(
        torch, d6_steps, 3, f_steady6,
        tables=(("self_device_time_total", 8),))
    log(f"faulty trainer at depth 6: s/step "
        f"{[round(v, 4) for v in d6['s_per_step']]}; profiled steps 5..7: "
        f"device time {f_device_s:.4f} s/step over "
        f"{f_acts:.0f} kernels/step; idle {100 * f_idle:.1f}% against the "
        f"depth-6 steady mean {f_steady6:.4f} s/step (steps 2..4)")
    del d6, d6_state, d6_step
    torch.cuda.empty_cache()
    log(f"phase 3b: {time.perf_counter() - t_p:.1f} s")
    t_p = time.perf_counter()

    # ------------- 3c. the same flags at reduced width, the card against CPU
    red = {}
    for where in ("cuda", "cpu"):
        argv = with_arg(FAULT_ARGS + ["--reduced"], "--device", where)
        out, red_syncs = run_logged(train, argv)
        red[where] = (out["state"], out["losses"], red_syncs)
    (a, la, sa), (b, lb, sb) = red["cuda"], red["cpu"]
    same = (int(a["triggers"]) == int(b["triggers"])
            and a["sync_rounds"] == b["sync_rounds"]
            and float(a["bits"]) == float(b["bits"])
            and [s["trig"].tolist() for s in sa]
            == [s["trig"].tolist() for s in sb]
            and all(torch.equal(x["W"], y["W"]) for x, y in zip(sa, sb)))
    if not same:
        raise AssertionError("reduced faulty trainer: card and CPU differ in "
                             "triggers, sync rounds, mixing or bits")
    # the card's float32 sums run in another order than the CPU's: the
    # losses have differed by at most 1.8e-5 relative (PERF.md); the final
    # iterate and x_hat are held at the parity tests' atol up to boundary
    # flips (flips_only)
    loss_gap = max(abs(x - y) / abs(y) for x, y in zip(la, lb))
    np.testing.assert_allclose(la, lb, rtol=1e-4,
                               err_msg="reduced faulty trainer: losses")
    fl = flips_only(a, b)
    log(f"reduced faulty trainer, card == CPU: {int(a['triggers'])} "
        f"triggers, {a['sync_rounds']} syncs, bits {float(a['bits']):.6e}; "
        f"losses {la} (CPU {lb}), largest relative gap {loss_gap:.3e}; "
        f"x_hat beyond 5e-4 on {fl['xhat_far']} entries in "
        f"{fl['flip_tiles']} of {fl['tiles']} tiles (largest gap "
        f"{fl['xhat_gap']:.3e}); params largest gap {fl['params_gap']:.3e}, "
        f"{fl['params_gap_rest']:.3e} outside the {fl['flip_cols']} flipped "
        f"columns")
    del red, a, b
    log(f"phase 3c: {time.perf_counter() - t_p:.1f} s")
    t_p = time.perf_counter()

    # ------------------------------- 3d. the generic path at full width
    torch.cuda.reset_peak_memory_stats(dev)
    zero_counts()
    alloc0 = alloc_counts(torch)
    result, g_syncs = run_logged(train, GENERIC_ARGS)
    alloc1 = alloc_counts(torch)
    counts["generic_trainer"] = read_counts()
    g_peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
    state, step = result["state"], result["train_step"]
    g_losses, g_step_s = result["losses"], result["s_per_step"]
    if len(g_losses) != 3 or not all(math.isfinite(v) for v in g_losses):
        raise AssertionError(f"generic path: losses {g_losses}")
    if step.use_kernel or any(counts["generic_trainer"].values()):
        raise AssertionError(f"generic path launched a kernel: "
                             f"{counts['generic_trainer']}")
    g_trig = int(state["triggers"])
    g_want = reckoned_bits(g_syncs, step.payload_bits)
    g_bits = float(state["bits"])
    if state["sync_rounds"] != 1 or abs(g_bits - g_want) > 1e-6 * g_want:
        raise AssertionError(f"generic path: bits {g_bits} != reckoned "
                             f"{g_want}")
    # x_hat starts at 0, so after one sync a triggered node's row holds
    # exactly its k = ceil(0.1 D) selected entries
    k_glob = math.ceil(0.1 * D)
    moved = (state["x_hat"] != 0).sum(dim=1).tolist()
    want_moved = [k_glob if t else 0 for t in g_syncs[0]["trig"].tolist()]
    if moved != want_moved:
        raise AssertionError(f"generic path: x_hat moved on {moved} "
                             f"entries, want {want_moved}")
    g_sync_s = g_step_s[2] - g_step_s[1]
    log(f"generic path (global TopFrac(0.1), k={k_glob} of D={D}): losses "
        f"{g_losses}, {g_trig} triggers, bits {g_bits:.6e} == reckoned; "
        f"s/step {[round(v, 4) for v in g_step_s]}: the sync step takes "
        f"{g_sync_s:.4f} s more than the local step before it; peak memory "
        f"allocated {g_peak_gb:.2f} GB")
    log(step_times("generic path", g_step_s, alloc0, alloc1))
    del result, state, step
    torch.cuda.empty_cache()
    log(f"phase 3d: {time.perf_counter() - t_p:.1f} s")

    # phase 3p's roofline suite, in a process of its own beside 3e-3o
    roof_dir = tempfile.TemporaryDirectory()
    roof = start_roofline(roof_dir.name)
    # ------------------------------------------------ 3e. the kernel suite
    t_p = time.perf_counter()
    zero_counts()
    suite = bench_kernels.run_bench(quick=False, device="cuda")
    torch.cuda.synchronize()
    counts["kernel_suite"] = read_counts()
    for r in suite:
        log(f"kernel suite: {json.dumps(r)}")
        if not r["bit_equal_oracle"] and r["name"] == "kernel_qsgd":
            raise AssertionError(f"kernel suite: qsgd != oracle: {r}")
    if min(counts["kernel_suite"].values()) == 0:
        raise AssertionError(f"kernel suite launched no kernel of a kind: "
                             f"{counts['kernel_suite']}")
    log(f"kernel suite: launches {counts['kernel_suite']} "
        f"({time.perf_counter() - t_p:.1f} s)")

    # --------------------------------------------- 3f. the reference engine
    from repro_torch.core import baselines, prng, sparq, topology
    from repro_torch.core.compression import BlockTopFrac, SignTopK
    from repro_torch.data import synthetic
    t_p = time.perf_counter()
    zero_counts()
    _, make_grad_fn, full_loss = synthetic.logistic_loss_and_grad(4)
    X, Y = synthetic.convex_dataset(6, 40, n_features=16, n_classes=4,
                                    seed=0)
    Xg, Yg = torch.tensor(X, device=dev), torch.tensor(Y, device=dev)
    ring6 = topology.make_topology("ring", 6)
    thr = triggers.piecewise(30.0 * 64, 30.0 * 64, every=10, until=60)
    lr = schedule.decaying(1.0, 50.0)
    golden_cfgs = {
        "sparq": sparq.SparqConfig(topology=ring6,
                                   compressor=SignTopK(k=6), threshold=thr,
                                   lr=lr, H=5, gamma=0.3),
        "squarm": sparq.squarm_config(ring6, SignTopK(k=6), lr, H=5,
                                      threshold=thr, beta=0.9,
                                      nesterov=True, gamma=0.3),
        "choco": baselines.choco_config(ring6, SignTopK(k=6), lr, gamma=0.3),
        "sparq_faults": sparq.SparqConfig(
            topology=ring6, compressor=SignTopK(k=6), threshold=thr, lr=lr,
            H=5, gamma=0.3, faults=FaultPlan(
                link_drop=0.3, stragglers=(1,), straggler_frac=0.5,
                dropout=(DropoutWindow(2, 10, 25),), seed=4))}
    for case, gcfg in golden_cfgs.items():
        with open(os.path.join(ROOT, "tests", "golden", f"{case}.json")) as f:
            want = json.load(f)
        # the committed goldens were drawn from JAX's original threefry
        # stream (jax_threefry_partitionable off)
        with prng.threefry_partitionable(False):
            g_state, g_trace = sparq.run(
                gcfg, make_grad_fn(Xg, Yg, 4), torch.zeros(64, device=dev),
                want["T"], prng.PRNGKey(0),
                record_every=want["record_every"],
                eval_fn=lambda xb: full_loss(xb, Xg, Yg))
        check_golden(g_state, g_trace, want, case)
        log(f"golden {case} on the card == tests/golden/{case}.json "
            f"(losses {[round(float(v), 6) for v in g_trace.loss]})")

    # SPARQ with BlockTopFrac at the paper's convex scale, on the card and
    # on the CPU: the card's run launches SignTopK once per sync
    n_c, m_c, f_c, c_c, T_c, mb_c, rec_c = 60, 200, 784, 10, 4000, 5, 200
    d_c = f_c * c_c
    _, make_grad_c, full_loss_c = synthetic.logistic_loss_and_grad(c_c)
    Xc, Yc = synthetic.convex_dataset(n_c, m_c, n_features=f_c,
                                      n_classes=c_c, seed=0)
    ccfg = sparq.SparqConfig(
        topology=topology.make_topology("ring", n_c),
        compressor=BlockTopFrac(frac=0.1),
        threshold=triggers.piecewise(30.0 * d_c, 30.0 * d_c,
                                     every=T_c // 8, until=T_c),
        lr=schedule.decaying(1.0, 100.0), H=5)
    paper = {}
    for where in ("cuda", "cpu"):
        on = dev if where == "cuda" else torch.device("cpu")
        Xw, Yw = torch.tensor(Xc, device=on), torch.tensor(Yc, device=on)
        zero_counts()
        if where == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        c_state, c_trace = sparq.run(
            ccfg, make_grad_c(Xw, Yw, mb_c), torch.zeros(d_c, device=on),
            T_c, prng.PRNGKey(0), record_every=rec_c,
            eval_fn=lambda xb, Xw=Xw, Yw=Yw: full_loss_c(xb, Xw, Yw))
        if where == "cuda":
            torch.cuda.synchronize()
        paper[where] = (c_state, c_trace,
                        (time.perf_counter() - t0) / T_c * 1e6,
                        read_counts())
    (s_g, tr_g, us_g, cnt_g), (s_c, tr_c, us_c, _) = paper["cuda"], \
        paper["cpu"]
    counts["reference_engine"] = cnt_g
    if not (cnt_g["sign_topk_blocks"] == s_g.sync_rounds == T_c // 5):
        raise AssertionError(f"paper scale: {cnt_g} launches for "
                             f"{s_g.sync_rounds} syncs (want {T_c // 5})")
    same = (tr_g.t.tolist() == tr_c.t.tolist()
            and tr_g.sync_rounds.tolist() == tr_c.sync_rounds.tolist()
            and tr_g.triggers.tolist() == tr_c.triggers.tolist()
            and tr_g.bits.tolist() == tr_c.bits.tolist()
            and float(s_g.bits) == float(s_c.bits))
    if not same:
        raise AssertionError(f"paper scale: card and CPU channels differ: "
                             f"triggers {tr_g.triggers.tolist()} vs "
                             f"{tr_c.triggers.tolist()}")
    np.testing.assert_allclose(tr_g.loss, tr_c.loss, rtol=1e-3,
                               err_msg="paper scale: card vs CPU losses")
    if not np.all(np.isfinite(tr_g.loss)) or tr_g.loss[-1] >= tr_g.loss[0]:
        raise AssertionError(f"paper scale: losses {tr_g.loss.tolist()}")
    log(f"reference engine, SPARQ + BlockTopFrac at n={n_c}, d={d_c}, "
        f"T={T_c}: {cnt_g['sign_topk_blocks']} SignTopK launches for "
        f"{s_g.sync_rounds} syncs, {int(s_g.triggers)} triggers, bits "
        f"{float(s_g.bits):.6e}, == the CPU run; final loss "
        f"{tr_g.loss[-1]:.6f} (CPU {tr_c.loss[-1]:.6f}); us_per_step "
        f"{us_g:.1f} on the card, {us_c:.1f} on the host CPU")

    # where a reference-engine step goes: 100 steps (20 syncs) under the
    # profiler, after the counts were read, and the threefry draws of one
    # step's minibatches timed alone on the host
    Xw, Yw = torch.tensor(Xc, device=dev), torch.tensor(Yc, device=dev)
    grad_w = make_grad_c(Xw, Yw, mb_c)
    dev_s, n_dev, idle_c = profiled(
        torch, lambda: sparq.run(ccfg, grad_w, torch.zeros(d_c, device=dev),
                                 100, prng.PRNGKey(0)), 100, us_g / 1e6,
        tables=(("self_cpu_time_total", 8),))
    dev_us = dev_s * 1e6
    t0 = time.perf_counter()
    for i in range(200):
        prng.randint(prng.split(prng.PRNGKey(i), n_c), (mb_c,), 0, m_c)
    draw_us = (time.perf_counter() - t0) / 200 * 1e6
    log(f"reference engine, profiled 100 steps: device time {dev_us:.1f} "
        f"us/step over {n_dev:.1f} device activities/step; against the "
        f"unprofiled {us_g:.1f} us/step the device is idle "
        f"{100 * idle_c:.1f}%; one step's minibatch draws "
        f"(split + randint, on the host) {draw_us:.1f} us")

    # the convex experiment at its quick size (the paper-scale engine runs
    # above), in the committed file's layout and held against it
    with open(os.path.join(ROOT, "BENCH_convex.json")) as f:
        want_convex = {r["name"]: r for r in json.load(f)["rows"]}
    zero_counts()
    with prng.threefry_partitionable(False):
        convex = convex_bits.run_bench(quick=True, device="cuda")
    counts["convex"] = read_counts()
    for r in convex:
        log(f"convex {r['name']:22s} final_loss {r['final_loss']:.6f} bits "
            f"{r['bits']:.6e} bits_to_target {r['bits_to_target']:.6e} "
            f"savings_vs_sparq {r['savings_vs_sparq']} us_per_call "
            f"{r['us_per_call']:.1f} peak {r['peak_hbm_bytes']}")
        loss = np.asarray(r["trace"]["loss"])
        if not np.all(np.isfinite(loss)) or loss[-1] >= loss[0]:
            raise AssertionError(f"convex {r['name']}: losses {loss}")
        w = want_convex[r["name"]]
        cols = ("bits", "trigger_events", "rounds", "contract_status",
                "bits_oracle")
        if any(r[c] != w[c] for c in cols):
            raise AssertionError(f"convex {r['name']}: {[r[c] for c in cols]}"
                                 f" != BENCH_convex.json's "
                                 f"{[w[c] for c in cols]}")
    check_contract_columns(convex, "convex quick")
    log(f"convex experiment, quick: {len(convex)} rows == BENCH_convex.json "
        f"in bits, triggers, rounds and contract columns; launches "
        f"{counts['convex']} (its rows "
        f"use the global operators); reference-engine phase "
        f"{time.perf_counter() - t_p:.1f} s")

    # ----------------------------- 3g. the fault and topology experiments
    t_p = time.perf_counter()
    zero_counts()
    fault_rows = faults_bits.run_bench(quick=False, device="cuda")
    counts["faults_bits"] = read_counts()
    for r in fault_rows:
        log(f"faults {r['name']:18s} final_loss {r['final_loss']:.6f} "
            f"loss_vs_clean {r['loss_vs_clean']:+.6f} bits {r['bits']:.6e} "
            f"bits_vs_clean {r['bits_ratio_vs_clean']:.4f} triggers "
            f"{r['trigger_events']} us_per_call {r['us_per_call']:.1f}")
        if not math.isfinite(r["final_loss"]):
            raise AssertionError(f"faults {r['name']}: loss not finite")
    block = next(r for r in fault_rows if r["name"] == "sparq_mixed_block")
    # the block row's warm-up run and timed run, one launch per sync each,
    # and the draws of its row's omega certificate (the contract columns)
    want_launches = 2 * block["sync_rounds"] + BLOCK_CERT_LAUNCHES
    if counts["faults_bits"]["sign_topk_blocks"] != want_launches:
        raise AssertionError(f"faults: {counts['faults_bits']} launches for "
                             f"2 x {block['sync_rounds']} block-row syncs "
                             f"and {BLOCK_CERT_LAUNCHES} certificate draws")
    check_contract_columns(fault_rows, "faults full")
    fp_full = faults_bits.problem(quick=False, device="cuda")
    b_cfg = fp_full.sparq(fp_full.mixed, BlockTopFrac(frac=0.1))
    b_dev_s, b_acts, b_idle = profiled(
        torch, lambda: sparq.run(b_cfg, fp_full.grad_fn, fp_full.x0, 200,
                                 prng.PRNGKey(0)), 200,
        block["us_per_call"] / 1e6, tables=(("self_cpu_time_total", 8),))
    log(f"faults sparq_mixed_block, profiled 200 steps (40 syncs): device "
        f"time {b_dev_s * 1e6:.1f} us/step over {b_acts:.1f} device "
        f"activities/step; against the unprofiled "
        f"{block['us_per_call']:.1f} us/step the device is idle "
        f"{100 * b_idle:.1f}%")
    # the topology experiment runs its quick size on the card (n=16,
    # d=320, T=300), which keeps the smoke inside its time
    zero_counts()
    topo_rows = topology_bits.run_bench(quick=True, device="cuda")
    counts["topology_bits"] = read_counts()
    for r in topo_rows:
        log(f"topology {r['name']:30s} R={r['plan_rounds']} delta "
            f"{r['delta']:.4f} gamma* {r['gamma_star']:.6f} bits "
            f"{r['bits']:.6e} consensus {r['consensus_err']:.4f} final_loss "
            f"{r['final_loss']:.6f} us_per_call {r['us_per_call']:.1f}")
        if not math.isfinite(r["final_loss"]):
            raise AssertionError(f"topology {r['name']}: loss not finite")
    check_contract_columns(topo_rows, "topology quick")
    # quick mode, the card's rows against the CPU's: integer channels and
    # bits equal
    for bench, rows_g in ((faults_bits, None), (topology_bits, topo_rows)):
        rows_g = rows_g or bench.run_bench(quick=True, device="cuda")
        rows_c = bench.run_bench(quick=True, device="cpu")
        for rg, rc in zip(rows_g, rows_c, strict=True):
            for col in ("name", "bits", "trigger_events", "contract_status",
                        "bits_oracle"):
                if rg[col] != rc[col]:
                    raise AssertionError(f"{bench.__name__} quick "
                                         f"{rc['name']}: {col} {rg[col]} on "
                                         f"the card, {rc[col]} on the CPU")
            for col in ("t", "sync_rounds", "triggers", "bits"):
                if rg["trace"][col] != rc["trace"][col]:
                    raise AssertionError(f"{bench.__name__} quick "
                                         f"{rc['name']}: trace {col} differs")
        log(f"{bench.__name__.split('.')[-1]} quick: {len(rows_g)} rows, "
            f"card == CPU in triggers, sync rounds and bits")
        if bench is faults_bits:
            # the full size's block row never triggers (threshold 30 d), so
            # this quick row is where SignTopK's output reaches x_hat under
            # faults
            qb = next(r for r in rows_g if r["name"] == "sparq_mixed_block")
            if qb["trigger_events"] <= 0:
                raise AssertionError("faults quick sparq_mixed_block: no "
                                     "trigger, the kernel's output never "
                                     "reached x_hat")
            log(f"faults quick sparq_mixed_block: {qb['trigger_events']} "
                f"triggers in {qb['sync_rounds']} syncs")
    log(f"fault and topology experiments: launches "
        f"{counts['faults_bits']} and {counts['topology_bits']} "
        f"({time.perf_counter() - t_p:.1f} s)")

    # ------------------------- 3h-3j. x^0, checkpoint/resume, LM suites
    for name, phase, args in (
            ("3h", phase_x0, ()), ("3i", phase_ckpt, (train,)),
            ("3j", phase_suites, ())):
        t0 = time.perf_counter()
        phase(torch, dev, *args, counts, zero_counts, read_counts)
        log(f"phase {name}: {time.perf_counter() - t0:.1f} s")
    # ------------------ 3k. the MoE family and the new dense configs
    t0 = time.perf_counter()
    moe_rec = phase_archs(torch, dev, train, counts, zero_counts, read_counts)
    max_err = max(max_err, moe_rec["moe_max_abs_err"])
    log(f"phase 3k: {time.perf_counter() - t0:.1f} s")
    # ------------------------ 3l. the SSM family and the hybrid
    t0 = time.perf_counter()
    ssm_rec = phase_ssm(torch, dev, train, counts, zero_counts, read_counts)
    max_err = max([max_err] + [r["max_abs_err"] for r in ssm_rec.values()])
    log(f"phase 3l: {time.perf_counter() - t0:.1f} s")
    # ------------------------------------ 3m. serving, and MLA with MTP
    t0 = time.perf_counter()
    serve_rec = phase_serve(torch, dev, train, counts, zero_counts,
                            read_counts)
    max_err = max(max_err, serve_rec["dsv3_trainer"]["max_abs_err"])
    log(f"phase 3m: {time.perf_counter() - t0:.1f} s")
    # ---------------------------------------------------- 3n. sharding
    t0 = time.perf_counter()
    shard_rec = phase_shard(torch, dev, train, counts, zero_counts,
                            read_counts, main_rec)
    max_err = max(max_err, shard_rec["trainer"]["max_abs_err"],
                  shard_rec["moe_fsdp"]["max_abs_err"])
    log(f"phase 3n: {time.perf_counter() - t0:.1f} s")
    # ------------------------------------------------------- 3o. the audits
    t0 = time.perf_counter()
    audit_rec = phase_audits(torch, dev, train, counts, zero_counts,
                             read_counts, D)
    log(f"phase 3o: {time.perf_counter() - t0:.1f} s")
    # ----------------------------------- 3p. the suite driver and roofline
    phase_driver(torch, train, counts, zero_counts, read_counts,
                 main_counted, card, roof, roof_dir.name)
    roof_dir.cleanup()

    # ------------------------------------------------------------- 4. report
    def by_path(name):
        return {path: c[name] for path, c in counts.items()}

    def audits(source):
        # phase 3o's K1 probe and K3 attributes of each instantiation
        return {e: {"k1": audit_rec["coverage"][e],
                    "k3": audit_rec["attributes"][e]}
                for e in audit_rec["coverage"] if e.startswith(source)}
    report = {"kernels": [{
        "name": "sign_topk_blocks", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/sign_topk.cu",
        "replaces": "src/repro/kernels/sign_topk.py:122",
        "launches": launches,
        "launches_by_path": by_path("sign_topk_blocks"),
        "max_abs_err": max_err, "cases_max_abs_err": cases_err,
        "ms": kernel_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "plain_tiles_per_call": PLAIN_ROWS,
        "topk_selection_only_ms": topk_ms,
        "shape": [rows, BLOCK], "k_b": k_b, "main_path_diff_ms": real_ms,
        "moe_trainer_shape": moe_rec["moe_shape"],
        "moe_trainer_ms": moe_rec["moe_ms"],
        "moe_trainer_bound_ms": moe_rec["moe_bound_ms"],
        "moe_trainer_shape_gaussian_ms": moe_rec["moe_randn_ms"],
        **{f"{name}_trainer_{k}": r[k] for name, r in ssm_rec.items()
           for k in ("shape", "ms", "bound_ms")},
        "sharded_rank_shape": [shard_rec["trainer"]["tiles_per_rank"], BLOCK],
        "sharded_rank_bound_ms": sign_topk_bound_ms(
            shard_rec["trainer"]["tiles_per_rank"]),
        "sharded_rank_contended_ms": shard_rec["trainer"]["kernel_ms"],
        "audits": audits("sign_topk")}, {
        "name": "qsgd_blocks", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/qsgd.cu",
        "replaces": "src/repro/kernels/qsgd.py:41",
        "launches": counts["kernel_suite"]["qsgd_blocks"],
        "launches_by_path": by_path("qsgd_blocks"),
        "max_abs_err": q_err, "boundary_flips": q_flips,
        "ms": qsgd_ms, "plain_ms": qsgd_plain_ms, "bound_ms": q_bound_ms,
        "bound_by": "bytes", "library_ms": None,
        "library_note": "no single PyTorch call computes blockwise QSGD",
        "plain_tiles_per_call": PLAIN_ROWS,
        "shape": [rows, BLOCK], "s": 16, "audits": audits("qsgd")}]}
    log(f"total {time.perf_counter() - t_all:.1f} s")
    print(json.dumps(report))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
