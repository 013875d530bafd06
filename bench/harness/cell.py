"""The program's engine for one cell, built once, and its readings of the
compared steps.

The engine is the ``train_step`` of ``repro_torch.dist.sparq_dist.
build_sparq``, which ``repro_torch.launch.train.train_steps`` drives: the
loop that ``launch/train.py`` runs, a synchronize around each step.
:class:`Program` builds it from the configuration file, draws x^0 from
the seed, makes the ring of batches on the device and runs the compared
steps through the same loop and the same ring, reading the program's
state after them. A runner (``bench/runners/<name>.py``) then hands the
same state to its window.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from harness import reference, sizes, spec, traffic
from harness.spec import Cell
from harness.weights import as_tree, draw_x0

RING_STEPS = 12       # distinct steps of batches held on the device


def compared_steps(H: int) -> int:
    """The steps compared with the plain reference: three, and at least
    one whole cycle, so that a sync is among them."""
    return max(3, H)


def engine(c: Cell):
    """The plain engine of the cell's configuration (its ``Engine``
    object: ``syncs(t)``, ``mixing()``)."""
    name = c.config["engine"]["reference"]
    return spec.module("engines", name).Engine.of(c.config, c.H)


def program_configs(config: Dict[str, Any], H: int, optimizer=None,
                    gamma: Optional[float] = None):
    """The program's ``(ModelConfig, DistSparqConfig)`` for a configuration
    file: its registry entry (``port.arch``) with the file's sizes under
    the program's field names (``port.fields``: field -> file key) and the
    values ``port.set`` gives; the engine's knobs as ``launch/train.py``'s
    flags set them, its schedules by name (``[name, *args]``)."""
    from repro_torch.configs.registry import get_config
    from repro_torch.core import schedule, triggers
    from repro_torch.dist.sparq_dist import DistSparqConfig

    port = config["port"]
    for key, value in port["fixed"].items():
        if config[key] != value:
            raise ValueError(f"the program has {key} {value!r} alone, the "
                             f"configuration {config[key]!r}")
    fields = {f: config[k] for f, k in port["fields"].items()}
    fields.update(port["set"])
    cfg = dataclasses.replace(get_config(port["arch"]), **fields)
    e = config["engine"]
    built = ("lr", "threshold", "optimizer", "gamma")
    knobs = {f.name: e[f.name] for f in dataclasses.fields(DistSparqConfig)
             if f.name in e and f.name not in built}
    lr, th = e["lr"], e["threshold"]
    dcfg = DistSparqConfig(
        H=H, lr=getattr(schedule, lr[0])(*lr[1:]),
        threshold=getattr(triggers, th[0])(*th[1:]), optimizer=optimizer,
        gamma=gamma, **knobs)
    return cfg, dcfg


class SyncHook:
    """The ``on_sync`` callback of the engine: off, it does nothing; with
    ``timing`` it synchronizes and stamps the host clock (the sync then
    lasts to the step's end, stamped by :meth:`step_end`). ``take``, when
    set, is handed the sync's diff once and cleared."""

    def __init__(self) -> None:
        self.timing = False
        self.stamp: Optional[float] = None
        self.sync_ms: List[float] = []
        self.take: Optional[Callable[[torch.Tensor], None]] = None

    def __call__(self, diff: torch.Tensor, info: Dict[str, Any]) -> None:
        if self.take is not None:
            self.take(diff)
            self.take = None
        if self.timing:
            torch.cuda.synchronize(diff.device)
            self.stamp = time.perf_counter()

    def step_end(self, i, state, metrics) -> None:
        if self.stamp is not None:
            self.sync_ms.append((time.perf_counter() - self.stamp) * 1e3)
            self.stamp = None


class GradTap:
    """The engine's optimizer, the program's own one that the configuration
    names, with a tap: ``take``, when set, reads the gradient the
    optimizer is given once, before the update, and is cleared."""

    def __init__(self, name: str) -> None:
        from repro_torch.optim.sgd import Optimizer, make_optimizer
        self.inner = make_optimizer(name)
        self.take: Optional[Callable[[torch.Tensor], None]] = None
        self.optimizer = Optimizer(self.inner.init, self.update,
                                   self.inner.name)

    def update(self, grads, state, params, lr):
        if self.take is not None:
            self.take(grads)
            self.take = None
        return self.inner.update(grads, state, params, lr)


class Readings:
    """The program's readings of the compared steps, from its own state:
    the first gradient as the optimizer got it; the first sync's mixing
    (x after the step against the sync's diff, which is x before the
    mixing while x_hat is still 0, held to the plain engine's W and gamma
    over the program's new x_hat); x - x^0 and x_hat after the last
    compared step; its losses, bits and triggers."""

    def __init__(self, s, seed: int, unravel, steps: int, eng, device
                 ) -> None:
        self.s, self.seed, self.steps = s, seed, steps
        self.unravel = unravel
        self.leaves, _, D_pad = sizes.layout(s)
        self.reader = reference.LeafReader(self.leaves, device)
        w, gamma = eng.mixing()
        self.mix = reference.MixReading(self.leaves, D_pad, w, gamma, device)
        self.diff: Optional[torch.Tensor] = None
        self.got: Dict[str, Any] = {}

    def _rows(self, rows: torch.Tensor, x0=None):
        out = []
        for i in range(rows.shape[0]):
            tree = self.unravel(rows[i])
            out.append(self.reader.read(
                lambda leaf: _get(tree, leaf.path).reshape(-1), x0))
        return out

    def first_grad(self, grads: torch.Tensor) -> None:
        self.got["grad0"] = self._rows(grads)

    def first_sync(self, diff: torch.Tensor) -> None:
        self.diff = diff          # held to the step's end, not copied

    def on_step(self, i: int, state, metrics) -> None:
        if self.diff is not None:
            with torch.no_grad():
                params, x_hat = state["params"], state["x_hat"]
                for j, c in self.mix.chunks():
                    if j is not None:
                        self.mix.add(j, self.diff[:, c], params[:, c],
                                     x_hat[:, c])
            self.diff = None
        if i == self.steps - 1:
            x0, _ = draw_x0(self.s, self.seed, state["params"].device)
            self.got["change"] = self._rows(state["params"], x0)
            del x0
            self.got["xhat"] = self._rows(state["x_hat"].float())
            self.got["bits"] = float(state["bits"])
            self.got["triggers"] = int(state["triggers"])

    def readings(self, losses: List[float]) -> Dict[str, Any]:
        g = self.got
        return reference.readings(losses, g["grad0"], g["change"], g["xhat"],
                                  g["bits"], g["triggers"], self.leaves,
                                  self.mix.result())


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@dataclasses.dataclass
class Faults:
    """Faults planted under the timed path (the harness's own tests)."""

    unchanged: bool = False          # the step hands its state back as is
    half_batch: bool = False         # each node trains on half its rows
    no_mixing: bool = False          # the sync leaves the mixing out


def _planted(train_step, faults: Faults):
    if not (faults.unchanged or faults.half_batch):
        return train_step

    def step(state, batch):
        if faults.half_batch:
            batch = {k: v[:, :v.shape[1] // 2] for k, v in batch.items()}
        if not faults.unchanged:
            return train_step(state, batch)
        kept = {k: (v.clone() if isinstance(v, torch.Tensor) else v)
                for k, v in state.items()}
        _, metrics = train_step(state, batch)
        for k, v in kept.items():
            if isinstance(v, torch.Tensor):
                state[k].copy_(v)
            else:
                state[k] = v
        return state, metrics
    step.device, step.rows = train_step.device, train_step.rows
    step.unravel = train_step.unravel
    return step


class Program:
    """The program's engine for one cell, built once: ``start(seed)`` draws
    x^0, makes the ring and runs the compared steps, reading them."""

    def __init__(self, c: Cell, device, faults: Optional[Faults] = None
                 ) -> None:
        from repro_torch.dist.sparq_dist import build_sparq
        from repro_torch.launch.train import train_steps

        t0 = time.perf_counter()
        faults = faults or Faults()
        self.c, self.dev = c, torch.device(device)
        torch.backends.cuda.matmul.allow_tf32 = False   # as launch/train.py
        torch.backends.cudnn.allow_tf32 = False
        self.s = sizes.of(c.config)
        self.eng = engine(c)
        self.compared = compared_steps(c.H)
        self.tap = GradTap(c.config["engine"]["optimizer"])
        cfg, dcfg = program_configs(c.config, c.H, self.tap.optimizer,
                                    0.0 if faults.no_mixing else None)
        self.hook = SyncHook()
        self.init_fn, self.train_step, _ = build_sparq(
            cfg, dcfg, device=self.dev, on_sync=self.hook)
        self.step = _planted(self.train_step, faults)
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
        ring = traffic.Ring(pipe, RING_STEPS, self.dev)
        t2 = time.perf_counter()
        got = Readings(self.s, seed, self.train_step.unravel, self.compared,
                       self.eng, self.dev)
        self.tap.take = got.first_grad
        self.hook.take = got.first_sync
        state, _, first = self.train_steps(self.step, state, ring, 0,
                                           self.compared, got.on_step)
        self.phases.update(x0_s=t1 - t0, ring_s=t2 - t1,
                           compared_s=time.perf_counter() - t2,
                           compared_steps_s=first["s_per_step"])
        return state, ring, got.readings(first["losses"])

    def reference_batches(self, ring: traffic.Ring) -> List[Dict[str, Any]]:
        return [ring.host_batch(t) for t in range(self.compared)]


def free(dev: torch.device) -> None:
    """Let go of what was deleted, so that the reference finds the card's
    memory free."""
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
