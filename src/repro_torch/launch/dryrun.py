"""Dry run of the port (counterpart of ``repro/launch/dryrun.py``): one
rank's program of every (arch x input shape x mesh) combination, counted on
``meta`` tensors, and its roofline terms on the H100.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-0.5b \\
        --shape train_4k [--multi-pod | --both-meshes] [--variant dense|ring] \\
        [--opts micro2,xhat_bf16] [--lint [--device cuda|cpu]] [--out F]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all \\
        --shape all --out runs/dryrun/all.json

The reference lowers and compiles each combination against its production
mesh with ``ShapeDtypeStruct`` inputs and reads the compiled module. The
port runs the step itself on ``meta`` tensors (shapes and dtypes, no memory:
nothing is drawn, nothing is computed) under
:class:`repro_torch.launch.op_walk.OpWalk`, which counts each operation as
often as it runs:

* **train** (``dryrun_train``): the flat engine (``build_sparq``) on the
  main path (the fused SignTopK kernel at the train CLI's ``--frac`` 0.1;
  the kernel is charged its closed-form bytes), one sync step from a zero
  state with every node's compression done, counted. The reference compiles
  the sync branch too, as the heavier one (``hlo_walk.py:20-21``).
* **serve** (``dryrun_serve``): ``build_prefill`` or ``build_decode`` on
  ``serve_shapes``' tensors, each leaf cut to rank 0's block. Decode writes
  the last slot of a full cache (``pos = cache_len - 1``), so it reads the
  whole cache.

**The mesh.** The rank counted is rank 0 of the reference's grid, ``16x16``
or, under ``--multi-pod``, ``2x16x16``. Its share comes from the pure
shape functions ``dist.sharding.train_mesh_shape`` (``(node, fsdp,
model)``; the train view keeps ``model`` as replicas, as the reference's
``P("node")`` rows are) and ``serve_mesh_shape`` (``(data, model)``, the
model axis tensor-parallel), not from live ranks. The collectives are
counted where the port issues them: ``NodeComm``'s row gathers, shifted
rows, vector gathers and fsdp sums (:class:`CountingNodeComm`) and the
models' :class:`repro_torch.models.parallel.Collectives`
(:class:`CountingCollectives`), each returning ``meta`` results of the
right shapes and adding its result bytes to the walk, as ``hlo_walk``
counts a collective's result type.

**The terms**, from the H100 data sheet's constants in
:mod:`repro_torch.launch.mesh`: ``compute_s = dot_flops / PEAK_FLOPS_BF16``,
``memory_s = hbm_bytes / HBM_BW``, ``collective_s = collective_bytes /
NVLINK_BW``. A 16-wide model axis spans two 8-card NVLink domains, so
``collective_s`` is a lower bound; the reference divides every axis by one
ICI figure in the same way. ``hbm_bytes`` counts each eager operation's
inputs and outputs (no fusion), not the reference's ``cost_analysis``
bytes scaled by a trip factor (``repro/launch/dryrun.py:85-86``).

**memory**: ``state_bytes`` (the train state, or the rank's parameters and
decode cache), ``input_bytes`` (the batch), ``peak_live_bytes`` (the
largest live set of the step's own outputs the walk saw) and their sum,
``watermark_bytes``: the port's counterpart of the compiled module's
``memory_analysis()``.

``--opts`` takes the knobs that mean something in the port: ``microN``
(train microbatches), ``xhat_bf16`` (x_hat storage), ``embed_dmodel``
(prefill's embedding on d_model), ``causalN`` (``causal_parts``),
``routeN`` (``moe_route_blocks``), ``pod_fsdp`` (``pod_axis_to``) and
``cache_seq``/``cache_inner`` (decode's cache placement); ``epin`` and
``no_epin`` are accepted and change nothing, as the port's spec rules put
the expert dim on ``model`` either way. Any other raises.
``--lint`` runs the port's R6-R9 (:mod:`repro_torch.analysis.contracts`)
on the train config at the true ``d`` and ``n``; their certificates draw on
``--device`` (the HLO rules are not applicable). A failing combination is
recorded with its error and traceback and the sweep goes on. Nothing is set
in the environment.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.configs.registry import (ARCH_IDS, cache_len, for_shape,
                                          get_config, shape_by_name)
from repro_torch.dist import serve as serve_mod
from repro_torch.dist import sharding as sh
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq
from repro_torch.launch.mesh import HBM_BW, NVLINK_BW, PEAK_FLOPS_BF16
from repro_torch.launch.op_walk import OpWalk, tree_bytes
from repro_torch.models.config import INPUT_SHAPES, InputShape, ModelConfig
from repro_torch.models.transformer import param_shapes

META = torch.device("meta")
# the production grids of the reference (repro/launch/mesh.py)
MESHES = {False: (16, 16), True: (2, 16, 16)}
TRAIN_FRAC = 0.1       # the train CLI's --frac: the main path's SignTopK


# ------------------------------------------------------------------ counts

def param_count(cfg: ModelConfig) -> int:
    """Parameters of one node's model (the reference's ``init_params``
    shapes, which ``param_shapes`` equals)."""
    def total(tree) -> int:
        if isinstance(tree, dict):
            return sum(total(v) for v in tree.values())
        return math.prod(tree)
    return total(param_shapes(cfg))


def active_param_count(cfg: ModelConfig) -> int:
    """Active parameters per token (MoE: the top-k of the routed experts)."""
    total = param_count(cfg)
    if not cfg.n_experts:
        return total
    n_moe_layers = cfg.n_layers - cfg.first_k_dense
    per_expert = 3 * cfg.d_model * cfg.moe_d_ff
    routed = n_moe_layers * cfg.n_experts * per_expert
    active_routed = n_moe_layers * cfg.moe_top_k * per_expert
    return total - routed + active_routed


def model_flops(cfg: ModelConfig, shape: InputShape) -> float:
    """MODEL_FLOPS = 6 N D for training, 2 N D for inference (N the active
    parameters, D the tokens processed). Attention's quadratic term is not
    in it, so the useful-FLOPs ratio reads low for long prefill."""
    n_params = active_param_count(cfg)
    tokens = shape.global_batch if shape.is_decode else \
        shape.global_batch * shape.seq_len
    factor = 6.0 if shape.kind == "train" else 2.0
    return factor * n_params * tokens


# ------------------------------------------------- counting collectives

def _bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CountingCollectives:
    """The models' :class:`~repro_torch.models.parallel.Collectives` for
    the first rank of a group of ``size``, with no group behind it: each
    call returns a result of the right shape on the input's device
    (``meta``) and adds its result bytes to ``walk``."""

    def __init__(self, walk: OpWalk, size: int):
        self.walk, self.size, self.rank = walk, int(size), 0

    def all_reduce(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        out = t.contiguous().clone()
        self.walk.charge_collective("all-reduce", _bytes(out))
        return out

    def all_gather(self, t: torch.Tensor, dim: int) -> torch.Tensor:
        shape = list(t.shape)
        shape[dim] *= self.size
        out = t.new_empty(shape)
        self.walk.charge_collective("all-gather", _bytes(out))
        return out


class CountingNodeComm:
    """What the flat engine reads of ``NodeComm`` (its axes, its position
    and its collectives) for the first rank of a ``(node, fsdp, model)``
    mesh of ``sizes``, the collectives counted into ``walk``."""

    def __init__(self, walk: OpWalk, sizes: Tuple[int, int, int]):
        self.walk = walk
        self.node_ax, self.fsdp, _ = (int(s) for s in sizes)
        self.node_index = self.fsdp_index = 0
        self.fsdp_comm = (CountingCollectives(walk, self.fsdp)
                          if self.fsdp > 1 else None)
        self.seconds = 0.0

    def gather_vec(self, v: torch.Tensor) -> torch.Tensor:
        if self.node_ax == 1:
            return v
        out = v.new_empty((self.node_ax * v.shape[0],))
        self.walk.charge_collective("all-gather", _bytes(out))
        return out

    def gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        if self.node_ax == 1:
            return x
        out = x.new_empty((self.node_ax * x.shape[0], x.shape[1]))
        self.walk.charge_collective("all-gather", _bytes(out))
        return out

    def fetch_shifts(self, x: torch.Tensor, shifts: Sequence[int]
                     ) -> List[torch.Tensor]:
        if self.node_ax == 1:
            return [torch.roll(x, -s, dims=0) for s in shifts]
        outs = [torch.empty_like(x) for _ in shifts]
        for o in outs:
            self.walk.charge_collective("collective-permute", _bytes(o))
        return outs

    def sum_fsdp(self, t: torch.Tensor) -> None:
        if self.fsdp > 1:
            self.walk.charge_collective("all-reduce", _bytes(t))


class CountedServeMesh:
    """Rank 0 of a ``(data, model)`` serve mesh of ``sizes`` on ``meta``,
    for the serve builders: the ``DeviceMesh`` attributes they read, and
    the ``model`` axis's collectives counted into ``walk``."""

    device_type = "meta"
    mesh_dim_names = sh.SERVE_AXES

    def __init__(self, walk: OpWalk, sizes: Tuple[int, int]):
        self.walk = walk
        self.shape = tuple(int(s) for s in sizes)

    def get_coordinate(self) -> List[int]:
        return [0] * len(self.shape)

    def collectives(self, axis: str) -> CountingCollectives:
        return CountingCollectives(
            self.walk, self.shape[self.mesh_dim_names.index(axis)])


# ------------------------------------------------------------------ terms

def analyse(res: Dict[str, Any], n_ranks: int, cfg: ModelConfig,
            shape: InputShape) -> Dict[str, Any]:
    """The roofline terms of one rank's walk (the reference's
    ``analyse``)."""
    flops = float(res["dot_flops"])
    terms = {"compute_s": flops / PEAK_FLOPS_BF16,
             "memory_s": res["hbm_bytes"] / HBM_BW,
             "collective_s": res["collective_bytes"] / NVLINK_BW}
    mf = model_flops(cfg, shape)
    return {
        "dot_flops_per_rank": flops,
        "hbm_bytes_per_rank": float(res["hbm_bytes"]),
        "collective_bytes_per_rank": float(res["collective_bytes"]),
        "collectives": {k: float(v) for k, v in res["collectives"].items()},
        "kernels": res["kernels"],
        "ops": res["ops"],
        **terms,
        "dominant": max(terms, key=lambda k: terms[k]),
        "model_flops_global": mf,
        "useful_flops_ratio": (mf / (flops * n_ranks)) if flops else None,
        "n_ranks": n_ranks,
    }


def _memory(state: Any, inputs: Any, peak_live: int) -> Dict[str, int]:
    state_b, input_b = tree_bytes(state), tree_bytes(inputs)
    return {"state_bytes": state_b, "input_bytes": input_b,
            "peak_live_bytes": int(peak_live),
            "watermark_bytes": state_b + input_b + int(peak_live)}


def _opts(opts: str) -> List[str]:
    known = ("xhat_bf16", "embed_dmodel", "no_epin", "epin", "pod_fsdp",
             "cache_seq", "cache_inner")
    out = [o for o in opts.split(",") if o]
    for o in out:
        num = next((p for p in ("micro", "causal", "route")
                    if o.startswith(p) and o[len(p):].isdigit()), None)
        if o not in known and num is None:
            raise ValueError(f"unknown opt {o!r}")
    return out


def _num(opts: List[str], prefix: str) -> Optional[int]:
    return next((int(o[len(prefix):]) for o in opts
                 if o.startswith(prefix)), None)


def make_batch(cfg: ModelConfig, shape: InputShape, rows: int,
               n_nodes: int) -> Dict[str, torch.Tensor]:
    """``rows`` nodes' share of the global batch, as ``meta`` tensors: int32
    tokens and labels, or float32 frontend embeddings for the audio and
    VLM configs (the reference's ``make_batch_sds``)."""
    per_node = shape.global_batch // n_nodes
    lead = (rows, per_node, shape.seq_len)
    b = {"labels": torch.empty(lead, dtype=torch.int32, device=META)}
    if cfg.family in ("audio", "vlm"):
        b["embeds"] = torch.empty(lead + (cfg.d_model,), dtype=torch.float32,
                                  device=META)
    else:
        b["tokens"] = torch.empty(lead, dtype=torch.int32, device=META)
    return b


# ------------------------------------------------------------------ steps

def dryrun_train(cfg: ModelConfig, shape: InputShape,
                 prod_shape: Tuple[int, ...], variant: str = "dense",
                 opts: str = "", lint: bool = False,
                 device: str = "cuda") -> Dict[str, Any]:
    o = _opts(opts)
    route = _num(o, "route")
    if route:
        cfg = dataclasses.replace(cfg, moe_route_blocks=route)
    sizes = sh.train_mesh_shape(prod_shape, cfg.n_nodes, cfg.pod_axis_to)
    dcfg = DistSparqConfig(
        variant=variant, use_kernel=True, frac=TRAIN_FRAC,
        microbatches=_num(o, "micro") or 1,
        xhat_dtype="bfloat16" if "xhat_bf16" in o else "float32")
    w = OpWalk("meta")
    comm = CountingNodeComm(w, sizes)
    init_fn, train_step, _ = build_sparq(cfg, dcfg, device=META, comm=comm)
    n = train_step.n_nodes
    lo, hi = train_step.rows
    state = init_fn.zero_state()
    batch = make_batch(cfg, shape, hi - lo, n)
    t0 = time.perf_counter()
    with w:
        train_step(state, batch)
    dt = time.perf_counter() - t0
    res = analyse(w.result(), math.prod(prod_shape), cfg, shape)
    res.update(step="train_step", n_nodes=n, rows_per_rank=hi - lo,
               train_mesh=dict(zip(sh.TRAIN_AXES, sizes)), variant=variant,
               memory=_memory(state, batch, w.peak_live_bytes),
               walk_seconds=round(dt, 2))
    if lint:
        from repro_torch.analysis.contracts import run_contract_lint
        res["lint"] = run_contract_lint(
            dcfg, d=train_step.d_model_total, n=n,
            program=f"dryrun_train[{cfg.arch_id}]", device=device)
    return res


def dryrun_serve(cfg: ModelConfig, shape: InputShape,
                 prod_shape: Tuple[int, ...], opts: str = ""
                 ) -> Dict[str, Any]:
    o = _opts(opts)
    sizes = sh.serve_mesh_shape(prod_shape)
    w = OpWalk("meta")
    mesh = CountedServeMesh(w, sizes)
    clen = cache_len(cfg, shape)
    pshape, cshape, tok, emb, _ = serve_mod.serve_shapes(cfg, shape, clen)
    if shape.is_decode:
        cache_mode = ("seq" if "cache_seq" in o else
                      "inner" if "cache_inner" in o else "auto")
        decode, shardings = serve_mod.build_decode(cfg, mesh,
                                                   cache_mode=cache_mode)
        ps, cs, _, _, _ = shardings(pshape, cshape, tok, emb)
        params = serve_mod.local_shard(pshape, ps, mesh)
        cache = serve_mod.local_shard(cshape, cs, mesh)
        state, inputs = (params, cache), (tok, emb)
        t0 = time.perf_counter()
        with w:
            decode(params, cache, tok, emb, clen - 1)
        step_name = "serve_step(decode)"
    else:
        embed_mode = "dmodel" if "embed_dmodel" in o else "vocab"
        prefill, shardings = serve_mod.build_prefill(cfg, mesh,
                                                     embed_mode=embed_mode)
        ps, _, _ = shardings(pshape, tok, emb)
        params = serve_mod.local_shard(pshape, ps, mesh)
        state, inputs = params, (tok, emb)
        t0 = time.perf_counter()
        with w:
            prefill(params, tok, emb)
        step_name = "serve_step(prefill)"
    dt = time.perf_counter() - t0
    res = analyse(w.result(), math.prod(prod_shape), cfg, shape)
    res.update(step=step_name, serve_mesh=dict(zip(sh.SERVE_AXES, sizes)),
               cache_len=clen if shape.is_decode else None,
               memory=_memory(state, inputs, w.peak_live_bytes),
               walk_seconds=round(dt, 2))
    return res


def run_one(arch: str, shape_name: str, multi_pod: bool, variant: str,
            opts: str = "", lint: bool = False,
            device: str = "cuda") -> Dict[str, Any]:
    shape = shape_by_name(shape_name)
    cfg = for_shape(get_config(arch), shape)
    base = {"arch": arch, "shape": shape_name,
            "mesh": "2x16x16" if multi_pod else "16x16", "variant": variant,
            "opts": opts}
    try:
        o = _opts(opts)
        causal = _num(o, "causal")
        if causal:
            cfg = dataclasses.replace(cfg, causal_parts=causal)
        if "pod_fsdp" in o:
            cfg = dataclasses.replace(cfg, pod_axis_to="fsdp")
        prod = MESHES[multi_pod]
        if shape.kind == "train":
            res = dryrun_train(cfg, shape, prod, variant, opts, lint, device)
        else:
            res = dryrun_serve(cfg, shape, prod, opts)
        return {**base, **res, "ok": True}
    except Exception as e:  # noqa: BLE001 - report, don't stop the sweep
        return {**base, "ok": False, "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun")
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--variant", default="dense", choices=["dense", "ring"])
    ap.add_argument("--opts", default="",
                    help="comma list: microN, xhat_bf16, embed_dmodel, "
                         "causalN, routeN, epin, no_epin, pod_fsdp, "
                         "cache_seq, cache_inner")
    ap.add_argument("--lint", action="store_true",
                    help="R6-R9 (repro_torch.analysis) over each train "
                         "config; lint errors fail the sweep")
    ap.add_argument("--device", default="cuda",
                    help="where --lint's certificates draw: cuda (default) "
                         "or cpu; the walk itself runs on meta")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.out and os.path.basename(args.out).startswith("BENCH_"):
        raise SystemExit(f"--out {args.out!r}: BENCH_* names belong to the "
                         f"reference's artifacts")

    archs = list(ARCH_IDS) if args.arch == "all" else [args.arch]
    shapes = list(INPUT_SHAPES) if args.shape == "all" else [args.shape]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    results = []
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                r = run_one(arch, shape_name, mp, args.variant, args.opts,
                            args.lint, args.device)
                status = "OK" if r["ok"] else "FAIL " + r["error"]
                print(f"[dryrun] {arch:18s} {shape_name:12s} {r['mesh']:8s} "
                      f"{status}", flush=True)
                if r["ok"]:
                    print(f"  terms: compute {r['compute_s']:.3e}s  memory "
                          f"{r['memory_s']:.3e}s  collective "
                          f"{r['collective_s']:.3e}s  dominant="
                          f"{r['dominant']}  walk {r['walk_seconds']}s",
                          flush=True)
                    print(f"  memory: {r['memory']}", flush=True)
                results.append(r)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
        print(f"wrote {args.out}")
    nfail = sum(1 for r in results if not r["ok"])
    nlint = sum(r.get("lint", {}).get("errors", 0) for r in results)
    if nlint:
        print(f"[dryrun] {nlint} lint error(s)")
    return 1 if (nfail or nlint) else 0


if __name__ == "__main__":
    sys.exit(main())
