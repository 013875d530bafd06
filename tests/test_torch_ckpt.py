"""The port's full-state checkpoints (``repro_torch.checkpoint.ckpt``) and
the train CLI's ``--ckpt-dir``/``--ckpt-every``/``--resume`` on the CPU: the
counterpart of ``tests/test_train_resume.py``.

A resumed run equals the unbroken one bit for bit: the checkpoint carries
params, x_hat, the optimizer rows, t, the Kahan bit pair, sync_rounds and
triggers, and everything else a step draws (fault masks, the plan's round,
compressor keys) is a function of t and sync_rounds. Also: the directory
rules of the reference (``step_<N>``, temp directories ignored, replace on
save), the refusals of a restore into another state, the raw files' sizes,
and x^0 of the CLI against the reference engine's first loss.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro.data.synthetic import TokenPipeline as JPipe  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.dist.sparq_dist import DistSparqConfig as JDcfg  # noqa: E402
from repro.dist.sparq_dist import build_sparq as jbuild  # noqa: E402
from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.schedule import fixed  # noqa: E402
from repro_torch.core.triggers import zero  # noqa: E402
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.optim.sgd import adamw  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--reduced", "--nodes", "4", "--use-kernel", "--H", "3",
        "--seq-len", "32", "--batch-per-node", "1", "--log-every", "1",
        "--device", "cpu"]
FAULTY = ["--dynamic", "matchings", "--dynamic-rounds", "4",
          "--link-drop", "0.3", "--stragglers", "1"]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread while this module runs: the suite runs several
    workers at once, and their small multi-threaded torch operations slow
    each other down many times over."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def same_stream():
    with prng.threefry_partitionable(jax.config.jax_threefry_partitionable):
        yield


def _engine(**kw):
    cfg = dataclasses.replace(
        tget("qwen1.5-0.5b").reduced(n_layers=1, d_model=128, vocab=256),
        n_nodes=4)
    # momentum > 0, so the opt rows are real buffers
    dcfg = DistSparqConfig(**{**dict(H=2, variant="dense", frac=0.25,
                                     use_kernel=True, threshold=zero(),
                                     lr=fixed(0.05), gamma=0.3,
                                     momentum=0.9), **kw})
    init_fn, step, _ = build_sparq(cfg, dcfg, device="cpu")
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, cfg.vocab_size, (4, 2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    return init_fn, step, batch


def _leaves(state):
    return list(ckpt._leaves(state))


def _assert_same(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb, strict=True):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y), k
        else:
            assert type(x) is type(y) and x == y, k


@pytest.mark.parametrize("opt", ["momentum", "adamw"])
def test_full_state_roundtrip(tmp_path, opt):
    """Every leaf (params, x_hat, the optimizer's rows and count, t, bits,
    bits_c, sync_rounds, triggers) comes back exactly, into a zero state."""
    kw = {"momentum": 0.0, "optimizer": adamw()} if opt == "adamw" else {}
    init_fn, step, batch = _engine(**kw)
    state = init_fn()
    for _ in range(3):
        state, _ = step(state, batch)
    assert state["t"] == 3 and float(state["bits"]) > 0
    ckpt.save(str(tmp_path), 3, state, extra={"note": "three steps"})
    assert ckpt.latest_step(str(tmp_path)) == 3
    restored = ckpt.restore(str(tmp_path), 3, like=init_fn.zero_state())
    _assert_same(state, restored)
    assert restored["t"] == 3 and restored["sync_rounds"] == 1
    rows = [v for k, v in _leaves(restored["opt"])
            if isinstance(v, torch.Tensor)]
    assert rows and all(float(r.abs().sum()) > 0 for r in rows)
    man = ckpt._manifest(os.path.join(tmp_path, "step_3"))
    assert man["extra"] == {"note": "three steps"} and man["step"] == 3


def test_resumed_equals_unbroken_bit_for_bit(tmp_path):
    """Save at t = 2, run 2 more; restore and run the same 2: equal."""
    init_fn, step, batch = _engine()
    state = init_fn()
    for _ in range(2):
        state, _ = step(state, batch)
    ckpt.save(str(tmp_path), 2, state)
    for _ in range(2):
        state, _ = step(state, batch)
    resumed = ckpt.restore(str(tmp_path), 2, like=init_fn.zero_state())
    for _ in range(2):
        resumed, _ = step(resumed, batch)
    _assert_same(state, resumed)


def _train(argv, tmp_path, **kw):
    return train.run(TINY + argv + ["--ckpt-dir", str(tmp_path / "ck")],
                     **kw)


@pytest.mark.parametrize("flags", [["--momentum", "0.9"],
                                   ["--momentum", "0.9"] + FAULTY],
                         ids=["momentum", "faults_matchings"])
def test_cli_resume_equals_unbroken(tmp_path, flags):
    """The CLI: 6 steps saving at 4, then --resume from 4 across the sync of
    t = 6 (H = 3), against the unbroken run; the hook sees the saved and
    the restored state, equal to the file chunk by chunk."""
    events = []

    def seen(kind, path, step, state):
        diffs = []
        ckpt.compare(os.path.dirname(path), step, state,
                     lambda k, lo, hi, a, b: diffs.append(
                         not torch.equal(a, b)))
        events.append((kind, step, state["t"], any(diffs)))

    whole = _train(["--steps", "6", "--ckpt-every", "4"] + flags, tmp_path,
                   on_checkpoint=seen)
    assert [s["step"] for s in whole["saves"]] == [4]
    rest = _train(["--steps", "6", "--resume"] + flags, tmp_path,
                  on_checkpoint=seen)
    assert events == [("save", 4, 4, False), ("restore", 4, 4, False)]
    assert rest["start"] == 4 and rest["restore"]["step"] == 4
    assert rest["losses"] == whole["losses"][4:]
    assert rest["state"]["sync_rounds"] == 2
    _assert_same(whole["state"], rest["state"])
    if FAULTY[0] in flags:
        assert whole["train_step"].plan.R == 4


def test_steps_zero_and_complete_resume_run_nothing(tmp_path, capsys):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               OMP_NUM_THREADS="1")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.train"]
                       + TINY + ["--steps", "0"], env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert "DONE no steps run (start=0, steps=0)" in r.stdout
    _train(["--steps", "2", "--ckpt-every", "2"], tmp_path)
    capsys.readouterr()
    assert train.main(TINY + ["--steps", "2", "--resume", "--ckpt-dir",
                              str(tmp_path / "ck")]) == 0
    out = capsys.readouterr().out
    assert "resumed full train state from step 2 (t=2" in out
    assert "DONE no steps run (start=2, steps=2)" in out


def test_resume_without_checkpoint(tmp_path, capsys):
    with pytest.raises(SystemExit, match="--resume needs --ckpt-dir"):
        train.run(TINY + ["--steps", "1", "--resume"])
    out = _train(["--steps", "1", "--resume"], tmp_path)
    assert "starting fresh" in capsys.readouterr().out
    assert out["start"] == 0 and len(out["losses"]) == 1


def test_latest_step_and_replace(tmp_path):
    d = str(tmp_path)
    assert ckpt.latest_step(d) is None
    assert ckpt.latest_step(str(tmp_path / "missing")) is None
    os.makedirs(tmp_path / ".tmp_ckpt_abc")
    os.makedirs(tmp_path / "step_x")
    assert ckpt.latest_step(d) is None
    state = {"a": torch.arange(6.0), "t": 1}
    ckpt.save(d, 3, state)
    ckpt.save(d, 10, state)
    assert ckpt.latest_step(d) == 10
    ckpt.save(d, 3, {"a": torch.zeros(6), "t": 7})     # replaced
    back = ckpt.restore(d, 3, like={"a": torch.ones(6), "t": 0})
    assert back["t"] == 7 and not back["a"].any()
    assert not [p for p in os.listdir(d) if p.startswith(".tmp_ckpt_")
                and p != ".tmp_ckpt_abc"]


def test_restore_refuses_another_state(tmp_path):
    d = str(tmp_path)
    ckpt.save(d, 1, {"x": torch.zeros(4, 8), "t": 1})
    with pytest.raises(ValueError, match="shape|4, 8"):
        ckpt.restore(d, 1, like={"x": torch.zeros(4, 9), "t": 0})
    with pytest.raises(ValueError, match="float32"):
        ckpt.restore(d, 1, like={"x": torch.zeros(4, 8,
                                                  dtype=torch.bfloat16),
                                 "t": 0})
    with pytest.raises(ValueError, match="missing"):
        ckpt.restore(d, 1, like={"x": torch.zeros(4, 8), "y": 0, "t": 0})
    with pytest.raises(ValueError, match="unknown"):
        ckpt.restore(d, 1, like={"x": torch.zeros(4, 8)})
    with open(os.path.join(d, "step_1", "x.bin"), "r+b") as f:
        f.truncate(8)
    with pytest.raises(ValueError, match="bytes"):
        ckpt.restore(d, 1, like={"x": torch.zeros(4, 8), "t": 0})


def test_chunked_files_hold_raw_bytes(tmp_path, monkeypatch):
    """Chunks smaller than a row: each file is numel * itemsize raw
    little-endian bytes, and reads back equal (bfloat16 too)."""
    monkeypatch.setattr(ckpt, "CHUNK_BYTES", 96)
    g = torch.Generator().manual_seed(0)
    state = {"p": torch.randn((3, 101), generator=g),
             "h": torch.randn((3, 101), generator=g).to(torch.bfloat16),
             "opt": (torch.randn(5, generator=g), 4), "s": torch.tensor(2.5),
             "n": torch.tensor(9, dtype=torch.int32), "t": 12}
    path = ckpt.save(str(tmp_path), 12, state)
    sizes = {"p.bin": 3 * 101 * 4, "h.bin": 3 * 101 * 2, "opt.0.bin": 20,
             "opt.1.bin": 8, "s.bin": 4, "n.bin": 4, "t.bin": 8}
    for name, size in sizes.items():
        assert os.path.getsize(os.path.join(path, name)) == size, name
    raw = np.fromfile(os.path.join(path, "p.bin"), dtype="<f4")
    np.testing.assert_array_equal(raw.reshape(3, 101), state["p"].numpy())
    assert ckpt.nbytes(state) == sum(sizes.values())
    like = {"p": torch.zeros(3, 101), "h": torch.zeros(3, 101,
                                                      dtype=torch.bfloat16),
            "opt": (torch.zeros(5), 0), "s": torch.tensor(0.0),
            "n": torch.tensor(0, dtype=torch.int32), "t": 0}
    _assert_same(state, ckpt.restore(str(tmp_path), 12, like=like))


def test_cli_x0_first_loss_equals_reference_engine():
    """The port's CLI from PRNGKey(0) and the reference engine from the
    reference's own PRNGKey(0) init on the same batch: the first loss agrees
    within the model's bfloat16 tolerance (1e-4 relative, ROADMAP C.3)."""
    out = train.run(TINY + ["--steps", "1"])
    jc = dataclasses.replace(jget("qwen1.5-0.5b").reduced(), n_nodes=4)
    mesh = jsh.train_mesh(jax.make_mesh((1, 1), ("data", "model")), jc)
    init_fn, step, _, _ = jbuild(jc, mesh, JDcfg(
        H=3, frac=0.1, lr=jsched.decaying(0.5, 100.0),
        threshold=jtrig.constant(2.0), variant="ring", use_kernel=True))
    pipe = JPipe(vocab_size=jc.vocab_size, seq_len=32, batch_per_node=1,
                 n_nodes=4, seed=0)
    _, m = jax.jit(step)(init_fn(jax.random.PRNGKey(0)),
                         pipe.global_batch(0))
    assert out["losses"][0] == pytest.approx(float(m["loss"]), rel=1e-4)
