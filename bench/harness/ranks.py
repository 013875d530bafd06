"""One rank of a cell whose nodes each have a card of their own (the
``node_per_card`` runner): the program's engine over a ``(node, fsdp 1,
model 1)`` mesh, its readings of the rank's rows, the window, the traced
cycles and the plain reference of the rank's node.

The runner starts the ranks with ``repro_torch.dist.comm.spawn`` (NCCL when
every rank has a card of its own, gloo on the CPU), so that this module's
:func:`main` runs in each of them; it returns what the runner merges. The
program's engine is ``build_sparq(..., mesh=...)`` driven by
``launch/train.py``'s ``train_steps``, each rank stepping its own rows of a
frozen ``TokenPipeline``. A second group over the same ranks, the runner's
own, carries the window's agreement to stop, the readings' gathers of the
new x_hat and the plain reference's exchange (``bench/engines/
sparq_ring_sgd_node.py``), never the program's collectives.

The program is imported inside the functions, as ``harness.cell`` does.
"""
from __future__ import annotations

import contextlib
import dataclasses
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from harness import cell, sizes, spans, spec, trace, traffic
from harness.cell import Faults, free
from harness.rows import RowsMixReading, gather_rows
from harness.spec import Cell
from harness.weights import as_tree, draw_x0


@dataclasses.dataclass(frozen=True)
class Job:
    """What every rank does: ``kind`` ``run`` (one run of the cell at
    ``seeds[0]``) or ``readings`` (the compared numbers' readings of each
    of ``seeds`` by each of ``sides``: ``program``, ``control`` or a
    planted fault)."""

    cell: Cell
    seeds: Tuple[int, ...]
    kind: str = "run"
    seconds: float = 0.0
    traced: bool = False
    wall_start: float = 0.0          # the run's process start, wall clock
    faults: Faults = dataclasses.field(default_factory=Faults)
    sides: Tuple[str, ...] = ("program",)
    device_type: str = "cuda"


class RankRing:
    """Steps ``0 .. steps - 1`` of a pipeline's rows ``lo:hi`` (the rank's
    nodes) as int64 tensors on the device, drawn for those nodes alone;
    step ``i`` reads entry ``i % steps``. ``rows_batch(step, lo, hi)`` is
    what ``train_steps`` calls."""

    def __init__(self, pipe: traffic.TokenPipeline, steps: int,
                 rows: Tuple[int, int], device) -> None:
        self.pipe, self.rows = pipe, rows
        self.host = [self._draw(t) for t in range(steps)]
        self.batches = [{k: torch.from_numpy(v).to(device)
                         for k, v in b.items()} for b in self.host]

    def _draw(self, step: int) -> Dict[str, np.ndarray]:
        per = [self.pipe.batch(i, step) for i in range(*self.rows)]
        return {k: np.stack([b[k] for b in per]) for k in per[0]}

    def __len__(self) -> int:
        return len(self.batches)

    def rows_batch(self, step: int, lo: int, hi: int):
        if (lo, hi) != self.rows:
            raise ValueError(f"rows {lo}:{hi}, the ring holds "
                             f"{self.rows[0]}:{self.rows[1]}")
        return self.batches[step % len(self)]

    def node_batches(self, steps: int) -> List[Dict[str, np.ndarray]]:
        """The first node's batches of steps ``0 .. steps - 1``, as the
        generator drew them (the plain reference's, one node a rank)."""
        return [{k: v[0] for k, v in self.host[t % len(self)].items()}
                for t in range(steps)]


class RankReadings(cell.Readings):
    """``harness.cell.Readings`` of the rank's rows: the first sync's
    mixing is read in those rows against the new x_hat of every node,
    gathered a column block at a time over the runner's group."""

    def __init__(self, s, seed: int, unravel, steps: int, eng, device,
                 rows: Tuple[int, int], group) -> None:
        super().__init__(s, seed, unravel, steps, eng, device)
        w, gamma = eng.mixing()
        self.mix = RowsMixReading(self.leaves, self.mix.D_pad, w, gamma,
                                  device, rows)
        self.group = group

    def on_step(self, i: int, state, metrics) -> None:
        if self.diff is not None:
            with torch.no_grad():
                params, x_hat = state["params"], state["x_hat"]
                for j, c in self.mix.chunks():
                    if j is None:
                        continue
                    every = gather_rows(x_hat[:, c].float(), self.group)
                    self.mix.add(j, self.diff[:, c], params[:, c], every)
            self.diff = None
        super().on_step(i, state, metrics)


class MeshProgram:
    """The program's engine for one cell on this rank, built once over a
    ``(node, fsdp 1, model 1)`` mesh of every rank: ``start(seed)`` draws
    x^0, makes the rank's ring and runs the compared steps, reading them."""

    def __init__(self, c: Cell, device, group,
                 faults: Optional[Faults] = None) -> None:
        from repro_torch.dist import sharding
        from repro_torch.dist.sparq_dist import build_sparq
        from repro_torch.launch.mesh import make_production_mesh
        from repro_torch.launch.train import train_steps

        t0 = time.perf_counter()
        faults = faults or Faults()
        self.c, self.dev, self.group = c, torch.device(device), group
        torch.backends.cuda.matmul.allow_tf32 = False   # as launch/train.py
        torch.backends.cudnn.allow_tf32 = False
        self.s = sizes.of(c.config)
        self.eng = cell.engine(c)
        self.compared = cell.compared_steps(c.H)
        self.tap = cell.GradTap(c.config["engine"]["optimizer"])
        cfg, dcfg = cell.program_configs(c.config, c.H, self.tap.optimizer,
                                         0.0 if faults.no_mixing else None)
        self.mesh = sharding.train_mesh(
            make_production_mesh(model=1, device_type=self.dev.type), cfg)
        self.hook = cell.SyncHook()
        self.init_fn, self.train_step, _ = build_sparq(
            cfg, dcfg, device=self.dev, on_sync=self.hook, mesh=self.mesh)
        self.step = cell._planted(self.train_step, faults)
        self.rows = self.train_step.rows
        self.train_steps = train_steps
        self.phases = {"build_s": time.perf_counter() - t0}

    def start(self, seed: int):
        """``(state, ring, readings)`` after the compared steps from the
        x^0 and the batches of ``seed``."""
        t0 = time.perf_counter()
        x0, leaves = draw_x0(self.s, seed, self.dev)
        state = self.init_fn(params=as_tree(x0, leaves))
        del x0
        t1 = time.perf_counter()
        pipe = traffic.pipeline(self.c.workload, self.s.vocab,
                                self.train_step.n_nodes, seed)
        ring = RankRing(pipe, cell.RING_STEPS, self.rows, self.dev)
        t2 = time.perf_counter()
        got = RankReadings(self.s, seed, self.train_step.unravel,
                           self.compared, self.eng, self.dev, self.rows,
                           self.group)
        self.tap.take = got.first_grad
        self.hook.take = got.first_sync
        state, _, first = self.train_steps(self.step, state, ring, 0,
                                           self.compared, got.on_step)
        self.phases.update(x0_s=t1 - t0, ring_s=t2 - t1,
                           compared_s=time.perf_counter() - t2,
                           compared_steps_s=first["s_per_step"])
        return state, ring, got.readings(first["losses"])


def main(rank: int, job: Job) -> Dict[str, Any]:
    """One rank's part of ``job`` (``comm.spawn`` has joined it to the
    default group and made its card current); its stdout goes to stderr,
    so that the run's last line stays the result."""
    from repro_torch.dist import comm
    dev = comm.rank_device(job.device_type, rank)
    group = dist.new_group(list(range(dist.get_world_size())))
    with contextlib.redirect_stdout(sys.stderr):
        if job.kind == "readings":
            return _readings(job, dev, group)
        return _run(job, dev, group)


def _stop(elapsed: bool, dev, group) -> bool:
    """Whether any rank's window has passed: every rank then stops after
    the same cycle."""
    flag = torch.tensor([float(elapsed)], device=dev)
    dist.all_reduce(flag, op=dist.ReduceOp.MAX, group=group)
    return bool(flag.item())


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _run(job: Job, dev, group) -> Dict[str, Any]:
    from repro_torch import spans as program_spans
    from repro_torch.dist.comm import FETCH_BYTES

    c, H, seed = job.cell, job.cell.H, job.seeds[0]
    prog = MeshProgram(c, dev, group, job.faults)
    # the compared steps count the bytes the row exchanges move
    with program_spans.enabled():
        state, ring, got = prog.start(seed)
    fetched = program_spans.counters().get(FETCH_BYTES, 0.0)
    i = prog.compared
    t_cycle = time.perf_counter()
    state, _, _ = prog.train_steps(prog.step, state, ring, i, i + H)
    i += H
    _sync(dev)
    dist.barrier(group=group)
    setup_s = time.time() - job.wall_start
    phases = dict(prog.phases, cycle_s=time.perf_counter() - t_cycle,
                  setup_s=setup_s)
    out: Dict[str, Any] = {"fetched_bytes": fetched, "syncs_compared": sum(
        prog.eng.syncs(t) for t in range(prog.compared))}
    losses: List[float] = []
    sync_s: List[float] = []
    steps = 0
    t0 = time.perf_counter()
    if job.traced:
        out["record"], losses = _profile(prog, state, ring, i,
                                         int(c.workload["profile_cycles"]))
    else:
        while True:
            state, _, rec = prog.train_steps(prog.step, state, ring, i,
                                             i + H)
            sync_s += [sec for j, sec in enumerate(rec["s_per_step"])
                       if prog.eng.syncs(i + j)]
            losses += rec["losses"]
            i += H
            steps += H
            if _stop(time.perf_counter() - t0 >= job.seconds, dev, group):
                break
    window_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # the program's state is freed before the reference runs
    batches = ring.node_batches(prog.compared)
    del state, ring, prog
    free(dev)
    t_ref = time.perf_counter()
    ref = _engine(c).run_node(c.config, c.workload, seed, batches, dev,
                              "float32", group)
    phases["reference_s"] = time.perf_counter() - t_ref
    out.update(got=got, ref=ref, losses=losses, sync_s=sync_s, steps=steps,
               window_s=window_s, peak=int(peak), phases=phases)
    return out


def _engine(c: Cell):
    return spec.module("engines", c.config["engine"]["reference"])


def _profile(prog: MeshProgram, state, ring, i: int, cycles: int):
    """The traced steps: ``cycles`` whole cycles under the profiler with
    the device's activities alone (busy time, kernels, the host clock of
    the steps), then as many with the host's too and the program's spans
    on (device time by span, the counters). Returns the rank's record and
    the steps' losses."""
    from repro_torch import spans as program_spans

    H, cuda = prog.c.H, prog.dev.type == "cuda"
    P = torch.profiler.ProfilerActivity
    with torch.profiler.profile(activities=[P.CUDA] if cuda else [P.CPU]
                                ) as prof:
        t0 = time.perf_counter()
        _, _, rec = prog.train_steps(prog.step, state, ring, i,
                                     i + cycles * H)
        window_s = time.perf_counter() - t0
    dev = trace.device(trace.events(prof), window_s)
    del prof
    record = {"busy_s": dev["busy_s"], "window_s": window_s,
              "kernels": len(dev["kernels"]),
              "device_ops": dev["device_ops"], "profiled_steps": cycles * H}
    i += cycles * H
    with torch.profiler.profile(activities=[P.CPU] + ([P.CUDA] if cuda
                                                      else [])) as prof, \
            program_spans.enabled():
        _, _, named = prog.train_steps(prog.step, state, ring, i,
                                       i + cycles * H)
    record.update(spans.record(spans.events(prof),
                               program_spans.counters()))
    return record, rec["losses"] + named["losses"]


def _readings(job: Job, dev, group) -> List[Dict[str, Any]]:
    """Each side's readings of each seed on this rank: the side's (the
    program, with its planted fault, or the control) and the plain
    reference's."""
    c = job.cell
    eng = _engine(c)
    lo = dist.get_rank(group)
    out = []
    for side in job.sides:
        prog = None
        if side != "control":
            faults = Faults(**({side: True} if side != "program" else {}))
            prog = MeshProgram(c, dev, group, faults)
        for seed in job.seeds:
            t0 = time.perf_counter()
            if prog is not None:
                state, ring, got = prog.start(seed)
                batches = ring.node_batches(prog.compared)
                del state, ring
            else:
                pipe = traffic.pipeline(c.workload,
                                        int(c.config["vocab_size"]),
                                        c.n_nodes, seed)
                batches = [pipe.batch(lo, t)
                           for t in range(cell.compared_steps(c.H))]
                got = eng.run_node(c.config, c.workload, seed, batches, dev,
                                   "fp8", group)
            t1 = time.perf_counter()
            free(dev)
            ref = eng.run_node(c.config, c.workload, seed, batches, dev,
                               "float32", group)
            free(dev)
            out.append({"side": side, "seed": seed, "got": got, "ref": ref,
                        "side_s": t1 - t0,
                        "ref_s": time.perf_counter() - t1})
        del prog
    return out
