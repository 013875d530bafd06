"""BENCHMARK.json, the configuration and workload files and the metric
readers agree with each other and with the benchmark's contract."""
import json
import re

import pytest
from conftest import ROOT

from harness import compare, spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
WIDTH = re.compile(r"^(.*hidden_size|.*intermediate_size|.*latent.*|"
                   r".*state_size|.*proj.*|.*_dim|.*_rank|.*head_size|"
                   r".*expan.*|num_experts_per_tok)$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for word in BENCH["command"]:
        assert not word.startswith("/") and ".." not in word
    names = [x["name"] for key in ("configs", "workloads", "end_to_end",
                                   "per_layer") for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                         "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                         "layer", "moves"}
        assert m["moves"] in e2e
        assert set(m["workloads"]) <= set(CELLS)
        assert (ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
        assert spec.reader(m["name"], ROOT)({}) is None
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_agree(cell):
    entry = {w["name"]: w for w in BENCH["workloads"]}[cell]
    c = spec.cell(cell, ROOT)
    assert c.workload["name"] == cell
    assert c.workload["why"] == entry["why"] and len(entry["why"]) <= 200
    assert cell == f"{entry['config']}.{entry['traffic']}"
    assert (ROOT / "bench" / "runners"
            / f"{c.workload['runner']}.py").exists()
    # every compared number has its limit, or null where it is not compared
    limits = c.workload["limits"]
    assert set(limits) == set(compare.NAMES)
    assert all(v is None or v >= 0 for v in limits.values())
    assert entry["chips"] in (1, 4)
    assert {m["name"] for m in c.end_to_end} >= {"setup_s"}
    assert c.per_layer


@pytest.mark.parametrize("entry", BENCH["configs"],
                         ids=[c["name"] for c in BENCH["configs"]])
def test_config_files(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    cfg = spec.load_json(ROOT / entry["file"])
    assert cfg["name"] == entry["name"]
    assert entry["file"].startswith("bench/")
    assert cfg["source"] == entry["source"]
    assert cfg["reduced"] == entry["reduced"]
    # every reduced key is in the file, with its published value beside it
    assert set(entry["reduced"]) == set(cfg["published"])
    for key in entry["reduced"]:
        assert key in cfg and cfg[key] != cfg["published"][key]
        assert not WIDTH.search(key), key
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])
    # the family and the engine it names are files of their own
    assert (ROOT / "bench" / "references" / f"{cfg['reference']}.py").exists()
    assert (ROOT / "bench" / "engines"
            / f"{cfg['engine']['reference']}.py").exists()
    # every size the program is given comes from a key of the file
    assert set(cfg["port"]["fields"].values()) <= set(cfg)


def test_null_limit_is_not_compared_and_a_missing_one_fails():
    values = dict.fromkeys(compare.NAMES, 0.5)
    limits = dict.fromkeys(compare.NAMES, 1.0)
    assert compare.judge(values, limits)[0]
    assert compare.judge(values, dict(limits, xhat_err=None))[0]
    assert not compare.judge(dict(values, xhat_err=2.0), limits)[0]
    del limits["xhat_err"]
    assert not compare.judge(values, limits)[0]
