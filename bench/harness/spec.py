"""What a run measures, found by name: the cell in ``BENCHMARK.json``, its
workload file ``bench/workloads/<cell>.json``, its configuration file
``bench/configs/<config>.json``, and the modules these name:

* ``bench/metrics/<metric>.py``: a per-layer metric's reader;
* ``bench/references/<name>.py``: a model family's sizes, parameter
  layout, plain model and FLOP count (a configuration's ``reference``);
* ``bench/engines/<name>.py``: the plain SPARQ-SGD loop a configuration's
  ``engine.reference`` names (topology, optimizer, schedules);
* ``bench/runners/<name>.py``: how a workload's ``runner`` runs a cell
  (processes, set-up, the window).

A later cell, configuration, family, engine, runner or metric is new
files and new entries in ``BENCHMARK.json``; nothing here names one. This
module imports neither torch nor the program.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import sys
import types
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> Dict[str, Any]:
    return load_json(root / "BENCHMARK.json")


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of ``BENCHMARK.json`` with its files."""

    name: str
    chips: int
    workload: Dict[str, Any]        # bench/workloads/<name>.json
    config: Dict[str, Any]          # bench/configs/<config>.json
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]

    @property
    def H(self) -> int:
        return int(self.workload["H"])

    @property
    def n_nodes(self) -> int:
        return int(self.config["n_nodes"])

    @property
    def tokens_per_step(self) -> int:
        w = self.workload
        return self.n_nodes * int(w["batch_per_node"]) * int(w["seq_len"])


def _applies(metric: Dict[str, Any], cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of the benchmark at ``root``; raises KeyError when
    ``BENCHMARK.json`` has no such workload."""
    bench = benchmark(root)
    entry = {w["name"]: w for w in bench["workloads"]}[name]
    workload = load_json(root / "bench" / "workloads" / f"{name}.json")
    cfg_entry = {c["name"]: c for c in bench["configs"]}[entry["config"]]
    config = load_json(root / cfg_entry["file"])
    for key in ("config", "chips"):
        if workload[key] != entry[key]:
            raise ValueError(f"{name}: workload file says {key}="
                             f"{workload[key]!r}, BENCHMARK.json "
                             f"{entry[key]!r}")
    return Cell(name=name, chips=int(entry["chips"]), workload=workload,
                config=config,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


_LOADED: Dict[Path, types.ModuleType] = {}


def module(kind: str, name: str, root: Path = ROOT) -> types.ModuleType:
    """``bench/<kind>/<name>.py``, loaded once per process."""
    path = root / "bench" / kind / f"{name}.py"
    if path not in _LOADED:
        spec = importlib.util.spec_from_file_location(
            f"bench_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
        if spec is None or spec.loader is None or not path.exists():
            raise FileNotFoundError(path)
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod        # dataclasses look it up there
        spec.loader.exec_module(mod)
        _LOADED[path] = mod
    return _LOADED[path]


def reader(metric: str, root: Path = ROOT
           ) -> Callable[[Dict[str, Any]], Optional[float]]:
    """The ``read(record)`` function of ``bench/metrics/<metric>.py``."""
    return module("metrics", metric, root).read
