"""The port's suite driver (``repro_torch.launch.run``) and roofline suite
(``repro_torch.launch.roofline``) on the CPU: the documents' header and
strict JSON, a failing suite, the static ``--check-artifacts`` rules
(``benchmarks/run.py:82``, read for the port's documents), and the refusal
of ``BENCH_*`` names."""
import json
import os
import subprocess

import pytest

torch = pytest.importorskip("torch")

from repro_torch.launch import dryrun, roofline  # noqa: E402
from repro_torch.launch import run as run_mod  # noqa: E402

HEADER = {"schema_version", "suite", "quick", "generated_unix", "elapsed_s",
          "error", "rows", "threefry_partitionable", "device"}
ORACLE = {"lo": 90.0, "hi": 110.0, "bits": 100.0}


def _doc(path, suite, device, rows, quick=True):
    run_mod.write_artifact(str(path), suite, quick, rows, 0.5, device)
    return path


@pytest.fixture
def one_thread():
    """The suite's CPU timings at one intra-op thread: the workers share
    the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_kernels_suite_on_the_cpu_writes_a_strict_document(tmp_path,
                                                           capsys,
                                                           one_thread):
    assert run_mod.main(["--suite", "kernels", "--device", "cpu",
                         "--out-dir", str(tmp_path)]) == 0
    files = os.listdir(tmp_path)
    assert files == ["suite_kernels.json"]
    with open(tmp_path / files[0]) as f:
        doc = json.load(f, parse_constant=pytest.fail)
    assert set(doc) == HEADER
    assert doc["schema_version"] == 3 and doc["suite"] == "kernels"
    assert doc["quick"] is True and doc["device"] == "cpu"
    assert doc["error"] == ""
    names = [r["name"] for r in doc["rows"]]
    assert names == ["kernel_sign_topk", "kernel_qsgd",
                     "kernel_fused_trigger"]
    for r in doc["rows"]:
        assert r["contract_status"] == "n/a" and r["bits_oracle"] is None
        assert r["device"] == "cpu" and r["peak_hbm_bytes"] is None
        assert r["bit_equal_oracle"] is True
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "name,us_per_call,derived"
    assert [ln.split(",")[0] for ln in out[1:]] == names
    # a CPU document holds no card leg: the kernels rule flags it
    assert run_mod.check_artifacts([str(tmp_path)]) == 1


def test_non_finite_floats_become_strings(tmp_path):
    rows = [{"name": "r", "us_per_call": 1.0, "bits_to_target": float("inf"),
             "x": [float("-inf"), float("nan")]}]
    path = _doc(tmp_path / "suite_convex.json", "convex", "cpu", rows)
    text = path.read_text()
    assert "Infinity" not in text and "NaN" not in text
    row = json.loads(text)["rows"][0]
    assert row["bits_to_target"] == "inf" and row["x"] == ["-inf", "nan"]


def test_a_failing_suite_fails_the_process_and_the_rest_still_run(
        tmp_path, monkeypatch):
    def fake(name):
        def fn(quick, device):
            if name == "convex":
                raise RuntimeError("boom")
            return [{"name": f"{name}_row", "us_per_call": 1.0,
                     "device": device}]
        return fn
    monkeypatch.setattr(run_mod, "suite_fn", fake)
    assert run_mod.main(["--device", "cpu", "--out-dir",
                         str(tmp_path)]) == 1
    files = sorted(os.listdir(tmp_path))
    assert files == sorted(f"suite_{s}.json" for s in run_mod.SUITES)
    with open(tmp_path / "suite_convex.json") as f:
        doc = json.load(f)
    assert doc["error"] == "RuntimeError: boom" and doc["rows"] == []
    with open(tmp_path / "suite_faults.json") as f:
        doc = json.load(f)
    assert doc["rows"] == [{"name": "faults_row", "us_per_call": 1.0,
                            "device": "cpu", "contract_status": "n/a",
                            "bits_oracle": None}]


def test_check_artifacts_flags_each_rule(tmp_path, capsys):
    good = {"name": "ok", "us_per_call": 1.0, "bits": 100.0,
            "bits_oracle": ORACLE, "contract_status": "ok",
            "peak_hbm_bytes": 1024, "device": "cuda:0"}
    rows = [good,
            {**good, "name": "edited", "bits": 120.0},
            {**good, "name": "r7", "contract_status": "error(R7)"},
            {**good, "name": "drift", "bit_equal_oracle": False},
            {**good, "name": "peak", "peak_hbm_bytes": 0},
            {**good, "name": "warn", "contract_status": "warn(R7)"}]
    _doc(tmp_path / "suite_convex.json", "convex", "cuda:0", rows)
    assert run_mod.check_artifacts([str(tmp_path)]) == 4
    out = capsys.readouterr().out
    for name in ("edited", "r7", "drift", "peak"):
        assert f"row {name!r}" in out
    assert "row 'warn'" not in out and "row 'ok'" not in out
    assert run_mod.main(["--check-artifacts", "--out-dir",
                         str(tmp_path)]) == 1


def test_check_artifacts_passes_a_cpu_document_without_peaks(tmp_path):
    rows = [{"name": "a", "us_per_call": 1.0, "bits": 100.0,
             "bits_oracle": ORACLE, "contract_status": "ok",
             "peak_hbm_bytes": None, "device": "cpu"},
            {"name": "vanilla", "us_per_call": 1.0, "bits": 5.0,
             "bits_oracle": None, "contract_status": "n/a",
             "peak_hbm_bytes": None, "device": "cpu"}]
    _doc(tmp_path / "suite_convex.json", "convex", "cpu", rows)
    assert run_mod.check_artifacts([str(tmp_path)]) == 0
    assert run_mod.main(["--check-artifacts", "--out-dir",
                         str(tmp_path)]) == 0


def test_kernels_rule_on_the_card(tmp_path):
    def row(name, us, ref):
        return {"name": name, "us_per_call": us, "ref_us": ref,
                "bit_equal_oracle": True, "peak_hbm_bytes": 4096,
                "device": "cuda:0"}
    slow = [row("kernel_sign_topk", 9.0, 5.0), row("kernel_qsgd", 1.0, 2.0),
            row("kernel_fused_trigger", 8.0, 5.0)]
    _doc(tmp_path / "suite_kernels.json", "kernels", "cuda:0", slow)
    assert run_mod.check_artifacts([str(tmp_path)]) == 1
    slow[2]["us_per_call"] = 4.0
    _doc(tmp_path / "suite_kernels.json", "kernels", "cuda:0", slow)
    assert run_mod.check_artifacts([str(tmp_path)]) == 0


def test_bench_names_are_refused(tmp_path):
    with pytest.raises(ValueError, match="BENCH_"):
        run_mod.write_artifact(str(tmp_path / "BENCH_x.json"), "convex",
                               True, [], 0.0, "cpu")
    assert not os.path.exists(tmp_path / "BENCH_x.json")
    with pytest.raises(SystemExit, match="BENCH_"):
        dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                     "--out", str(tmp_path / "BENCH_roofline.json")])


def test_roofline_reads_the_port_dry_run_rows(tmp_path, monkeypatch,
                                             capsys):
    monkeypatch.chdir(tmp_path)
    out = os.path.join(roofline.DRYRUN_DIR, "dryrun_x.json")
    assert dryrun.main(["--arch", "qwen1.5-0.5b", "--shape", "decode_32k",
                        "--out", out]) == 0
    monkeypatch.setattr(subprocess, "Popen", pytest.fail)
    rows = roofline.run_bench(quick=True, device="cpu")
    assert [r["name"] for r in rows] == \
        ["roofline_qwen1.5-0.5b_decode_32k_16x16"]
    r = rows[0]
    assert r["dominant"] == "memory_s" and not r["generated_here"]
    assert r["peak_hbm_bytes"] == r["memory"]["watermark_bytes"] > 0
    assert r["dot_flops_per_rank"] == 2_074_476_544
    text = roofline.table(roofline.load_rows())
    assert "| qwen1.5-0.5b | decode_32k | serve_step(decode) |" in text
    assert roofline.main([]) == 0
    assert "1 dry-run rows, 0 failures" in capsys.readouterr().out


def test_roofline_generates_its_rows_through_the_dry_run(tmp_path,
                                                        monkeypatch):
    monkeypatch.chdir(tmp_path)
    calls = []

    class FakeProc:
        def __init__(self, cmd, **kw):
            calls.append(cmd)
            with open(cmd[cmd.index("--out") + 1], "w") as f:
                json.dump([], f)

        def wait(self, timeout=None):
            return 0

        def poll(self):
            return 0
    os.makedirs(roofline.DRYRUN_DIR)
    monkeypatch.setattr(subprocess, "Popen", FakeProc)
    written = roofline.ensure_artifacts(quick=True, device="cpu")
    assert [os.path.basename(p) for p in written] == [
        "dryrun_ci_train_4k.json", "dryrun_ci_decode_32k.json"]
    for cmd, shape in zip(calls, roofline.CI_SHAPES):
        assert cmd[1:] == ["-m", "repro_torch.launch.dryrun", "--arch",
                           "qwen1.5-0.5b", "--shape", shape, "--lint",
                           "--device", "cpu", "--out",
                           os.path.join(roofline.DRYRUN_DIR,
                                        f"dryrun_ci_{shape}.json")]
    # rows present: nothing is generated again
    assert roofline.ensure_artifacts(quick=True, device="cpu") == []
    assert roofline.run_bench(device="cpu")[0]["name"] == \
        "roofline_no_artifacts"
