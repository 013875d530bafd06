"""The port's train entry point on the CPU at a tiny size: the kernel path,
the generic path, the fault and time-varying-plan flags with their effect,
``--devices`` on the CPU, ``--lint``'s audit of the configuration, and the
rule that nothing drops to the CPU or to a plain version on its own."""
import ast
import dataclasses
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
from repro_torch.core.compression import TopFrac  # noqa: E402
from repro_torch.core.faults import FaultPlan  # noqa: E402
from repro_torch.dist import sparq_dist  # noqa: E402
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.sign_topk import sign_topk_blocks  # noqa: E402
from repro_torch.launch import train  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--reduced", "--nodes", "4", "--use-kernel", "--steps", "4", "--H",
        "2", "--seq-len", "32", "--log-every", "2", "--device", "cpu"]


def test_train_entry_runs_on_cpu():
    before = sign_topk_blocks.launches
    out = train.run(TINY)
    losses = out["losses"]
    assert len(losses) == 4 and all(math.isfinite(v) for v in losses)
    assert abs(losses[0] - math.log(out["cfg"].vocab_size)) < 1.0
    assert sign_topk_blocks.launches == before    # CPU tensors: plain path
    state, step = out["state"], out["train_step"]
    assert state["sync_rounds"] == 2 and int(state["triggers"]) > 0
    # bits from the trigger counts: every node of the ring has 2 neighbours
    trig = int(state["triggers"])
    want = 2 * (2 * 4 + trig * step.payload_bits)
    assert float(state["bits"]) == pytest.approx(want, rel=1e-6)
    assert not state["params"][:, step.d_model_total:].any()


@pytest.mark.parametrize("layers", [2, 7])
def test_layers_flag_sets_the_depth(layers):
    """``--layers`` overrides the depth and leaves every width: deepseek-
    moe-16b keeps its leading dense layer and the rest are MoE layers."""
    cfg = train.configs(["--arch", "deepseek-moe-16b", "--layers",
                         str(layers)])[0]
    full = train.configs(["--arch", "deepseek-moe-16b"])[0]
    assert (cfg.n_layers, cfg.first_k_dense) == (layers, 1)
    assert cfg == dataclasses.replace(full, n_layers=layers)


@pytest.mark.parametrize("flags,passes", [
    (["--lint"], True),
    # a negative threshold feeds constant(-1): c_t < 0 is an R8 error
    (["--lint", "--threshold", "-1"], False)], ids=["clean", "negative-c_t"])
def test_lint_flag_audits_the_config(flags, passes, capsys):
    """``--lint`` runs R6-R9 and the payload's R10 before the first step: a
    clean config prints the pass line and trains, an R8 error aborts."""
    if passes:
        out = train.run(TINY + flags)
        assert len(out["losses"]) == 4
        assert "passes the static audit" in capsys.readouterr().out
    else:
        with pytest.raises(SystemExit, match="static-audit error"):
            train.run(TINY + flags)
        assert "[lint R8/ERROR]" in capsys.readouterr().out


def test_devices_flag_runs_on_cpu():
    """``--devices 2 --device cpu`` starts two ranks over gloo (the CLI's
    own processes) and trains: the reference's factoring puts the reduced
    config's 4 nodes on 2 (``n_nodes = min(n_nodes, devices)``), one per
    rank, and rank 0's record comes back."""
    i = TINY.index("--nodes")
    out = train.run(TINY[:i] + TINY[i + 2:] + ["--devices", "2"])
    assert out["mesh"] == {"node": 2, "fsdp": 1, "model": 1}
    assert out["cfg"].n_nodes == 2
    assert len(out["losses"]) == 4 and all(math.isfinite(v)
                                           for v in out["losses"])
    assert out["triggers"][-1] > 0 and out["bits"][-1] > 0


def _run_logged(argv):
    """train.run with every sync's engine record kept."""
    syncs = []
    out = train.run(argv, on_sync=lambda diff, info: syncs.append(
        {k: v.clone() if isinstance(v, torch.Tensor) else v
         for k, v in info.items()}))
    return out, syncs


def _reckoned_bits(syncs, payload):
    """flag + trig * payload to each live neighbour, summed in float64."""
    return sum(float(((1.0 + s["trig"].double() * payload)
                      * s["deg"].double()).sum()) for s in syncs)


def _x0_row(cfg):
    init_fn, _, _ = sparq_dist.build_sparq(
        cfg, sparq_dist.DistSparqConfig(use_kernel=True), device="cpu")
    return init_fn()["params"][0]


@pytest.mark.parametrize("flags", [
    ["--link-drop", "0.5", "--fault-seed", "3"],
    ["--stragglers", "0", "--straggler-frac", "1.0", "--H", "5"],
    ["--dropout-window", "0:0:4"],
    ["--dynamic", "matchings", "--dynamic-rounds", "3"]],
    ids=lambda f: f[0])
def test_fault_and_plan_flags_run(flags):
    """Each flag at the tiny size on the CPU, and its effect: bits charged
    on the surviving links of the plan's own repair only; a straggler that
    skips every step keeps x^0 exactly (no sync in 4 steps at H=5); an
    offline node keeps x^0 through the syncs and sends nothing; a matchings
    plan of R=3 gossips over round r's matrix at sync r."""
    out, syncs = _run_logged(TINY + flags)
    state, step, cfg = out["state"], out["train_step"], out["cfg"]
    assert all(math.isfinite(v) for v in out["losses"])
    assert state["sync_rounds"] == len(syncs)
    got = float(state["bits"])
    assert got == pytest.approx(_reckoned_bits(syncs, step.payload_bits),
                                rel=1e-6)
    assert int(state["triggers"]) == sum(int(s["trig"].sum()) for s in syncs)
    ring = torch.tensor(step.plan.ws[0], dtype=torch.float32)
    if flags[0] == "--link-drop":
        plan = FaultPlan(link_drop=0.5, seed=3)
        for s in syncs:
            W, deg, live = plan.apply(ring, s["t"], s["sync_round"])
            assert torch.equal(s["W"], W) and torch.equal(s["deg"], deg)
            assert bool(live.all())
        assert sum(float(s["deg"].sum()) for s in syncs) < 2 * 4 * len(syncs)
    elif flags[0] == "--stragglers":
        assert not syncs
        assert torch.equal(state["params"][0], _x0_row(cfg))
        assert not torch.equal(state["params"][1], state["params"][0])
    elif flags[0] == "--dropout-window":
        assert len(syncs) == 2
        assert torch.equal(state["params"][0], _x0_row(cfg))
        for s in syncs:
            assert not s["live"][0] and not s["trig"][0]
            assert s["deg"][0] == 0 and s["W"][0, 0] == 1.0
        assert not state["x_hat"][0].any()
    else:
        assert step.plan.R == 3 and step.plan.name == "matchings(R=3)"
        for s in syncs:
            want = torch.tensor(step.plan.ws[s["sync_round"] % 3],
                                dtype=torch.float32)
            assert torch.equal(s["W"], want) and s["live"] is None
            assert torch.equal(s["deg"], torch.ones(4))


def test_run_without_kernel_takes_generic_path():
    """No --use-kernel: a global SignTopK of --frac of each node's flat
    vector (TopFrac), which launches no kernel, charged at its payload."""
    argv = [a for a in TINY if a != "--use-kernel"]
    before = sign_topk_blocks.launches
    out, syncs = _run_logged(argv)
    state, step = out["state"], out["train_step"]
    assert not step.use_kernel and step.compressor == TopFrac(frac=0.1)
    assert step.payload_bits == TopFrac(frac=0.1).bits(step.d_model_total)
    assert sign_topk_blocks.launches == before
    assert state["sync_rounds"] == len(syncs) == 2
    trig = int(state["triggers"])
    assert trig > 0
    want = 2 * (2 * 4 + trig * step.payload_bits)
    assert float(state["bits"]) == pytest.approx(want, rel=1e-6)
    assert not state["params"][:, step.d_model_total:].any()
    # each node moved x_hat on exactly k = ceil(0.1 D) coordinates per sync
    k = math.ceil(0.1 * step.d_model_total)
    moved = (state["x_hat"] != 0).sum(dim=1)
    assert bool((moved <= 2 * k).all()) and bool((moved > 0).all())


def test_cuda_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: nothing to refuse")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device(None)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="cuda"):
        train.run(argv)
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")


def test_missing_nvcc_raises(monkeypatch):
    monkeypatch.setattr(kernels.shutil, "which", lambda _: None)
    monkeypatch.setattr(kernels.os.path, "exists", lambda _: False)
    with pytest.raises(kernels.KernelBuildError):
        kernels.find_nvcc()
    with pytest.raises(kernels.KernelBuildError):
        kernels.build()


def test_wrapper_refuses_devices_without_a_path():
    meta = torch.zeros((2, 1024), device="meta")
    # meta alone has a path, the dry run's: meta outputs, nothing runs
    q, x_hat_new, scale = sign_topk_blocks(meta, None, 1.0, 8)
    assert q.device.type == "meta" and q.shape == (2, 1024)
    assert x_hat_new is None and scale.shape == (2,)
    with pytest.raises(ValueError):
        sign_topk_blocks(torch.zeros((2, 1024)), meta, 1.0, 8)
    with pytest.raises(ValueError):
        sign_topk_blocks(meta, torch.zeros((2, 1024)), 1.0, 8)


def _port_files():
    base = os.path.join(ROOT, "src", "repro_torch")
    for dirpath, _, files in os.walk(base):
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)
    yield os.path.join(ROOT, "chip_smoke.py")


def test_port_sources_import_neither_jax_nor_repro():
    for path in _port_files():
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "repro"), (path, name)


def test_importing_every_port_module_loads_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
