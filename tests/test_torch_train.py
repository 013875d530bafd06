"""The port's train entry point on the CPU at a tiny size, its refusals of
flags whose features are not ported yet, and the rule that nothing drops to
the CPU or to a plain version on its own."""
import ast
import math
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402
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


@pytest.mark.parametrize("flags", [
    ["--link-drop", "0.1"], ["--stragglers", "0"],
    ["--dropout-window", "0:1:2"], ["--dynamic", "matchings"],
    ["--ckpt-dir", "ckpt"], ["--resume"], ["--lint"], ["--devices", "8"]],
    ids=lambda f: f[0])
def test_unported_flags_refuse(flags):
    with pytest.raises(SystemExit, match="not ported"):
        train.run(TINY + flags)


def test_run_without_kernel_refuses():
    argv = [a for a in TINY if a != "--use-kernel"]
    with pytest.raises(SystemExit, match="not ported"):
        train.run(argv)


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
    with pytest.raises(ValueError):
        sign_topk_blocks(meta, None, 1.0, 8)
    with pytest.raises(ValueError):
        sign_topk_blocks(torch.zeros((2, 1024)), meta, 1.0, 8)


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
