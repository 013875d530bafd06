"""K1 and K3 of the port's CUDA kernels (``repro_torch.analysis.
kernel_lint``): the source legs here on the CPU, against the committed
``kernels/csrc`` and against copies broken on purpose; K4 on the committed
tree and on a small tree of its own; the card legs under
the ``cuda`` marker (skipped without a card), run on the card with

    PYTHONPATH=src python -m pytest -m cuda -q tests/test_torch_kernel_lint.py
"""
import shutil

import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis import kernel_lint as kl  # noqa: E402
from repro_torch.analysis.__main__ import main as analysis_main  # noqa: E402
from repro_torch.kernels.qsgd import qsgd_blocks  # noqa: E402
from repro_torch.kernels.sign_topk import sign_topk_blocks  # noqa: E402


def ids(findings):
    return sorted((f.rule_id, f.severity) for f in findings)


@pytest.fixture
def csrc_copy(tmp_path):
    out = tmp_path / "csrc"
    shutil.copytree(kl.CSRC, out)
    return out


def test_committed_sources_pass_k1_source_leg():
    out, meta = kl.lint_registry(program="t")
    assert out == []
    assert meta["sources"]["sign_topk"]["kernels"] == ["sign_topk_kernel"]
    assert meta["sources"]["qsgd"]["entries"] == [
        "qsgd_bf16", "qsgd_bf16_attributes", "qsgd_bf16_launch_config",
        "qsgd_f32", "qsgd_f32_attributes", "qsgd_f32_launch_config"]


def test_unregistered_kernel_is_a_k1_error(csrc_copy):
    src = csrc_copy / "qsgd.cu"
    src.write_text(src.read_text().replace(
        "template <typename T>\nint launch_config",
        "__global__ void rogue_kernel(float* x) { x[threadIdx.x] = 0.0f; }"
        "\n\ntemplate <typename T>\nint launch_config", 1))
    out, _ = kl.lint_registry(csrc_copy, program="t")
    assert ids(out) == [("K1", "error")]
    assert "rogue_kernel" in out[0].message and "qsgd.cu" in out[0].location


def test_launch_entry_without_its_probe_functions_is_a_k1_error(csrc_copy):
    src = csrc_copy / "sign_topk.cu"
    src.write_text(src.read_text().replace("sign_topk_bf16_launch_config",
                                           "renamed_config"))
    out, _ = kl.lint_registry(csrc_copy, program="t")
    msgs = [f.message for f in out]
    # the entry lost its config; the renamed function reads as a launch
    # entry of no probe, with neither probe function of its own
    assert ids(out) == [("K1", "error")] * 4
    assert any("exports no sign_topk_bf16_launch_config" in m for m in msgs)
    assert any("renamed_config belongs to no probe" in m for m in msgs)


def test_wrapper_that_accepts_a_ragged_view_is_a_k1_error():
    lax = kl.Probe("qsgd", "qsgd_kernel", kl.qsgd,
                   lambda x: None)
    out, _ = kl.lint_registry(probes=(kl.PROBES[0], lax), program="t")
    assert ids(out) == [("K1", "error")] and "(tiles, 1024)" in \
        out[0].message


def test_closed_form_budgets():
    """SignTopK: kWarps * kWords * 4 + kWarps * 4 B of static shared memory
    per 128-thread block, and __launch_bounds__(128, 4) caps the registers
    at 65,536 / (128 * 4); QSGD: none, 256 threads."""
    out, meta = kl.lint_budget(program="t")
    assert out == []
    st = meta["kernels"]["sign_topk_kernel"]
    assert st == {"static_shared_bytes": 4 * 1024 * 4 + 4 * 4,
                  "dynamic_shared_bytes": 0, "threads": 128,
                  "min_blocks": 4, "max_registers": 128}
    assert st["static_shared_bytes"] == 16_400
    q = meta["kernels"]["qsgd_kernel"]
    assert (q["static_shared_bytes"], q["dynamic_shared_bytes"],
            q["threads"], q["min_blocks"]) == (0, 0, 256, None)


def test_over_budget_source_is_a_k3_error(csrc_copy):
    src = csrc_copy / "qsgd.cu"
    src.write_text(src.read_text().replace(
        "  const int lane = threadIdx.x & 31;",
        "  __shared__ float spill[kWarps][kTile * 2];\n"
        "  const int lane = threadIdx.x & 31;", 1))
    out, meta = kl.lint_budget(csrc_copy, program="t")
    assert meta["kernels"]["qsgd_kernel"]["static_shared_bytes"] == \
        8 * 2048 * 4
    assert ids(out) == [("K3", "error")] and "49152" in out[0].message


def test_dynamic_shared_memory_is_a_k3_error(csrc_copy):
    src = csrc_copy / "sign_topk.cu"
    src.write_text(src.read_text().replace(
        "<<<grid, block, 0, (cudaStream_t)stream>>>",
        "<<<grid, block, 4096, (cudaStream_t)stream>>>"))
    out, _ = kl.lint_budget(csrc_copy, program="t")
    assert ids(out) == [("K3", "error")] and "4096" in out[0].message


def test_constant_expressions():
    consts = {"kWarps": 4, "kTile": 1024}
    assert kl._eval("kWarps * 32", consts) == 128
    assert kl._eval("(kTile / 128) * 4u", consts) == 32
    assert kl._eval("0xffffffffu", consts) == 2 ** 32 - 1
    with pytest.raises(ValueError):
        kl._eval("sizeof(float)", consts)


def test_probe_tile_counts():
    assert kl.tile_counts(528, 4) == [1, 3, 2113, 6341]
    assert kl.tile_counts(4224, 8) == [1, 7, 33793, 101381]
    assert kl.tile_counts(10, 1) == [1, 11, 35]


def test_cli_source_legs_on_the_cpu(tmp_path, capsys):
    out = tmp_path / "report.json"
    assert analysis_main(["--kernels", "--device", "cpu", "--out",
                          str(out)]) == 0
    text = capsys.readouterr().out
    assert "kernels/csrc: 0 error(s)" in text and "[analysis] OK" in text
    assert out.exists()
    for bad in ("results/x.json", "ANALYSIS.json"):
        with pytest.raises(SystemExit, match="reference"):
            analysis_main(["--kernels", "--device", "cpu", "--out", bad])


# ------------------------------------------------------------------ K4

def test_k4_tags_the_dense_gossip_of_the_committed_tree():
    out, meta = kl.lint_dense_gossip(program="t")
    assert meta["dense_sites"] == len(out) >= 2
    assert {f.rule_id for f in out} == {"K4"}
    assert {f.severity for f in out} == {"warning"}
    locs = [f.location for f in out]
    assert any("repro_torch/core/sparq.py:" in x for x in locs)
    assert any("repro_torch/dist/sparq_dist.py:" in x for x in locs)
    msgs = " ".join(f.message for f in out)
    assert "gossip_mix()" in msgs and "build_sparq()" in msgs
    assert "n=10000" in msgs and "0.4 GiB" in msgs


def test_k4_passes_a_gossip_free_tree(tmp_path):
    pkg = tmp_path / "repro_torch"
    (pkg / "dist").mkdir(parents=True)
    (pkg / "core").mkdir()
    for d in (pkg, pkg / "dist", pkg / "core"):
        (d / "__init__.py").write_text("")
    (pkg / "core" / "sparq.py").write_text(
        "import torch\n\n"
        "def ring_mix(x, c):\n"
        "    return c * (torch.roll(x, 1, 0) + torch.roll(x, -1, 0)) - x\n")
    (pkg / "dist" / "sparq_dist.py").write_text(
        "from repro_torch.core.sparq import ring_mix\n\n"
        "def build_sparq(plan):\n"
        "    def mix_term(x):\n"
        "        return ring_mix(x, 0.5)\n"
        "    return mix_term\n")
    # a product outside the gossip modules is model compute, not mixing
    (pkg / "core" / "model.py").write_text(
        "def layer(x, w):\n    return x @ w\n")
    out, meta = kl.lint_dense_gossip(pkg, program="t")
    assert out == [] and meta == {"dist_reachable": 3, "dense_sites": 0}
    # the same tree with a dense product in the mix is tagged
    (pkg / "core" / "sparq.py").write_text(
        "import torch\n\n"
        "def ring_mix(x, c):\n"
        "    return torch.tensordot(c, x, dims=1) - x\n")
    out, meta = kl.lint_dense_gossip(pkg, program="t")
    assert [f.location for f in out] == ["t:repro_torch/core/sparq.py:4"]


def test_cli_runs_k4(capsys):
    assert analysis_main(["--kernels", "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert "dist/dense_gossip: 0 error(s), 2 warning(s)" in text
    assert "[K4/WARNING]" in text


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
def test_k1_card_leg(cuda):
    before = (sign_topk_blocks.launches, qsgd_blocks.launches)
    out, meta = kl.lint_coverage_card(cuda, program="t")
    assert out == []
    assert set(meta) == {"sign_topk_f32", "sign_topk_bf16", "qsgd_f32",
                         "qsgd_bf16"}
    # probe launches bypass the wrappers: the paths' counts stay theirs
    assert (sign_topk_blocks.launches, qsgd_blocks.launches) == before


@pytest.mark.cuda
def test_k3_card_leg(cuda):
    out, meta = kl.lint_budget_card(program="t")
    assert [f for f in out if f.severity == "error"] == []
    for entry in ("sign_topk_f32", "sign_topk_bf16"):
        a = meta[entry]
        assert a["shared_bytes"] == 16_400 and a["num_regs"] <= 128
        assert a["blocks_per_sm"] >= 4
