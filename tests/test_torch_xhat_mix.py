"""The sync's one-pass x_hat update and mixing (``repro_torch.kernels.
xhat_mix``): its plain version against the engine's eager expressions, the
engine's choice of it, its charge on ``meta`` and its counter on the CPU;
the kernel against the plain version, and its K1 and K3 audits, on the card
under the ``cuda`` marker (skipped without a card), run there with

    PYTHONPATH=src python -m pytest -m cuda -q tests/test_torch_xhat_mix.py

Tolerances: roll mode and the x_hat update are bit for bit (the kernel
keeps the eager order and rounding); dense mode is within
``parity.xhat_mix_tolerance``, because the kernel sums over the nodes in
another order than ``tensordot``'s GEMM (a few float32 roundings of the
consensus term's magnitude, scaled by gamma, plus a spacing of x)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import spans  # noqa: E402
from repro_torch.analysis import kernel_lint as kl  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import schedule, triggers  # noqa: E402
from repro_torch.core.sparq import gossip_mix  # noqa: E402
from repro_torch.dist import sparq_dist  # noqa: E402
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq  # noqa: E402
from repro_torch.kernels import parity, xhat_mix  # noqa: E402
from repro_torch.launch import op_walk  # noqa: E402
from repro_torch.launch.dryrun import CountingNodeComm  # noqa: E402

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
PROBE = next(p for p in kl.PROBES if p.source == "xhat_mix")


def eager(x_hat, x, q, trig, gamma, w, roll, chunk):
    """The engine's x_hat update and mixing as one rank ran them before
    the one-pass version: column chunk by column chunk, the rows rolled
    with ``torch.roll`` or mixed by ``gossip_mix``."""
    trigf = trig.to(torch.float32)[:, None]
    for lo in range(0, x_hat.shape[1], chunk):
        c = slice(lo, min(x_hat.shape[1], lo + chunk))
        xe_new = (x_hat[:, c].to(torch.float32)
                  + q[:, c] * trigf).to(x_hat.dtype)
        x_hat[:, c] = xe_new
        xf = xe_new.to(torch.float32)
        if roll is not None:
            c0, terms = roll
            rolled = [torch.roll(xe_new, -s, dims=0) for s, _ in terms]
            acc = (float(c0) - 1.0) * xf
            for (_, c_s), x_s in zip(terms, rolled):
                acc = acc + c_s * x_s.to(torch.float32)
        else:
            acc = gossip_mix(w, xf)
        x[:, c] += gamma * acc


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize("n", parity.XHAT_MIX_NODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["roll", "dense"])
def test_plain_version_is_the_eager_path_bit_for_bit(mode, dtype, n,
                                                     monkeypatch):
    """Five tiles a row in chunks of three: the last chunk is partial."""
    chunk = 3 * xhat_mix.BLOCK
    monkeypatch.setattr(xhat_mix, "COLUMN_CHUNK", chunk)
    x_hat, x, q, trig, w, roll = parity.make_xhat_mix_case(
        mode, n, 5 * xhat_mix.BLOCK, DTYPES[dtype], torch.device("cpu"))
    assert trig[1] == 0.0
    want = [t.clone() for t in (x_hat, x)]
    eager(*want, q, trig, 0.3, w, roll, chunk)
    before = x_hat.clone()
    xhat_mix.xhat_mix(x_hat, x, q, trig, 0.3, w=w, roll=roll)
    assert torch.equal(x_hat, want[0]) and torch.equal(x, want[1])
    # the untriggered row keeps its x_hat; the triggered ones move
    assert torch.equal(x_hat[1], before[1])
    assert not torch.equal(x_hat[0], before[0])


def test_cpu_tensors_launch_nothing():
    before = xhat_mix.xhat_mix.launches
    parity.check_xhat_mix("roll", 4, xhat_mix.BLOCK, torch.float32,
                          torch.device("cpu"))
    assert xhat_mix.xhat_mix.launches == before


def _meta_rows(n=4, width=2048, dtype=torch.float32):
    m = torch.device("meta")
    return (torch.empty((n, width), dtype=dtype, device=m),
            torch.empty((n, width), device=m),
            torch.empty((n, width), device=m), torch.empty((n,), device=m))


@pytest.mark.parametrize("mode", ["roll", "dense"])
def test_meta_charges_work_bytes_and_launches_nothing(mode):
    x_hat, x, q, trig = _meta_rows(dtype=torch.bfloat16)
    w = torch.empty((4, 4), device="meta") if mode == "dense" else None
    roll = (0.5, ((1, 0.25), (3, 0.25))) if mode == "roll" else None
    before = xhat_mix.xhat_mix.launches
    with op_walk.OpWalk("meta") as walk:
        xhat_mix.xhat_mix(x_hat, x, q, trig, 0.3, w=w, roll=roll)
    assert walk.kernels == {"xhat_mix": {
        "launches": 1,
        "bytes": xhat_mix.work_bytes(4, 2048, torch.bfloat16,
                                     mode == "dense")}}
    assert xhat_mix.xhat_mix.launches == before


def test_work_bytes_is_20_bytes_a_float32_coordinate():
    # the MoE cells' rows: 87.3 GB, 26.06 ms at 3.35 TB/s
    got = xhat_mix.work_bytes(4, 1_091_315_712, torch.float32, False)
    assert got == 20 * 4 * 1_091_315_712 + 16
    assert got / 3.35e12 * 1e3 == pytest.approx(26.06, abs=0.01)
    assert xhat_mix.work_bytes(2, 1024, torch.bfloat16, True) == \
        16 * 2 * 1024 + 8 + 16


@pytest.mark.parametrize("bad", ["ragged", "one_row", "seventeen", "half",
                                 "both", "neither", "shift"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    n, width, dtype = 4, 2048, torch.float32
    if bad == "ragged":
        width = 1000
    elif bad == "one_row":
        n = 1
    elif bad == "seventeen":
        n = 17
    elif bad == "half":
        dtype = torch.float16
    x_hat, x, q, trig = _meta_rows(n, width, dtype)
    w = torch.empty((n, n), device="meta")
    roll = (0.5, ((1, 0.5),))
    kw = {"both": dict(w=w, roll=roll), "neither": {},
          "shift": dict(roll=(0.5, ((4, 0.5),)))}.get(bad, dict(roll=roll))
    with pytest.raises((ValueError, TypeError)):
        xhat_mix.xhat_mix(x_hat, x, q, trig, 0.3, **kw)


def _cfg(n):
    return dataclasses.replace(
        get_config("qwen1.5-0.5b").reduced(n_layers=1, d_model=64,
                                           vocab=128),
        n_nodes=n, compute_dtype="float32")


def _dcfg(variant="ring", **kw):
    return DistSparqConfig(H=1, variant=variant, frac=0.25, use_kernel=True,
                           lr=schedule.fixed(0.05), threshold=triggers.zero(),
                           gamma=0.3, **kw)


def _batch(n, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, 128, (n, 2, 8)))
            for k in ("tokens", "labels")}


@pytest.mark.parametrize("n,variant,mode", [(4, "ring", "roll"),
                                            (2, "ring", "dense"),
                                            (4, "dense", "dense")])
def test_one_rank_mixes_in_one_pass_each_sync(n, variant, mode,
                                              monkeypatch):
    """One rank on the CPU: the wrapper once a sync, in the plan's mode,
    on the plain version (no launch)."""
    calls = []
    real = sparq_dist.xhat_mix

    def spy(x_hat, x, q, trig, gamma, *, w=None, roll=None):
        calls.append("roll" if roll is not None else "dense")
        return real(x_hat, x, q, trig, gamma, w=w, roll=roll)
    monkeypatch.setattr(sparq_dist, "xhat_mix", spy)
    init_fn, step, _ = build_sparq(_cfg(n), _dcfg(variant), device="cpu")
    state = init_fn()
    before = xhat_mix.xhat_mix.launches
    for s in range(2):
        state, _ = step(state, _batch(n, s))
    assert calls == [mode] * 2
    assert xhat_mix.xhat_mix.launches == before


@pytest.mark.parametrize("node,charged", [(1, 1), (2, 0)])
def test_only_a_rank_holding_every_row_takes_the_one_pass(node, charged):
    """On meta, the dry run's stand-in comm: one rank charges the kernel
    once a sync; a rank of a node-2 mesh mixes chunk by chunk and fetches
    the rows it lacks."""
    walk = op_walk.OpWalk("meta")
    comm = CountingNodeComm(walk, (node, 1, 1))
    init_fn, step, _ = build_sparq(_cfg(4), _dcfg(), device="meta",
                                   comm=comm)
    state = init_fn.zero_state()
    lo, hi = step.rows
    batch = {k: torch.zeros((hi - lo, 2, 8), dtype=torch.int64)
             for k in ("tokens", "labels")}
    with walk:
        step(state, batch)
    got = walk.kernels.get("xhat_mix", {"launches": 0})["launches"]
    assert got == charged
    assert ("collective-permute" in walk.collectives) == (node > 1)


@pytest.mark.parametrize("n", [2, 4])
def test_rows_mixed_kernel_counts_the_rows_of_every_sync(n):
    init_fn, step, _ = build_sparq(_cfg(n), _dcfg(), device="cpu")
    state = init_fn()
    with spans.enabled():
        for s in range(3):
            state, _ = step(state, _batch(n, s))
        counts = spans.counters()
    assert counts["sparq.rows_mixed_kernel"] == 3 * n == \
        counts["sparq.rows_compressed"]


def test_a_mesh_rank_counts_no_kernel_rows(monkeypatch):
    seen = []
    monkeypatch.setattr(spans, "count",
                        lambda name, value: seen.append(name))
    walk = op_walk.OpWalk("meta")
    init_fn, step, _ = build_sparq(_cfg(4), _dcfg(), device="meta",
                                   comm=CountingNodeComm(walk, (2, 1, 1)))
    batch = {k: torch.zeros((2, 2, 8), dtype=torch.int64)
             for k in ("tokens", "labels")}
    with spans.enabled(), walk:
        step(init_fn.zero_state(), batch)
    assert "sparq.rows_compressed" in seen
    assert "sparq.rows_mixed_kernel" not in seen


def test_k1_source_leg_and_k3_closed_form_hold_the_new_kernel():
    out, meta = kl.lint_registry(program="t")
    assert out == []
    src = meta["sources"]["xhat_mix"]
    assert src["kernels"] == ["xhat_mix_kernel"]
    assert src["entries"] == sorted(
        e + extra for e in xhat_mix.ENTRIES.values()
        for extra in ("", "_attributes", "_launch_config"))
    out, meta = kl.lint_budget(program="t")
    assert out == []
    assert meta["kernels"]["xhat_mix_kernel"] == {
        "static_shared_bytes": 0, "dynamic_shared_bytes": 0,
        "threads": 256, "min_blocks": 2, "max_registers": 128}


# -------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("n", parity.XHAT_MIX_NODES)
@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("mode", ["roll", "dense"])
def test_kernel_matches_plain(cuda, mode, dtype, n):
    """Roll mode bit for bit, dense mode within the stated tolerance, over
    more tiles than the grid walks in one stride."""
    before = xhat_mix.xhat_mix.launches
    grid, block = xhat_mix.launch_config((mode, DTYPES[dtype]), 1 << 40)
    tiles = grid * block // 32 + 3
    parity.check_xhat_mix(mode, n, tiles * xhat_mix.BLOCK, DTYPES[dtype],
                          cuda, seed=n)
    torch.cuda.synchronize()
    assert xhat_mix.xhat_mix.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n,variant", [(4, "ring"), (2, "ring"),
                                       (4, "dense")])
def test_engine_launches_once_a_sync_and_matches_the_cpu(cuda, n, variant):
    p0 = None
    out = {}
    for where in ("cuda", "cpu"):
        init_fn, step, _ = build_sparq(_cfg(n), _dcfg(variant),
                                       device=where)
        state = init_fn() if p0 is None else init_fn(params=p0)
        if p0 is None:
            p0 = step.unravel(state["params"][0].cpu())
        before = xhat_mix.xhat_mix.launches
        for s in range(3):
            state, _ = step(state, _batch(n, s))
        out[where] = state, xhat_mix.xhat_mix.launches - before
    (a, la), (b, lb) = out["cuda"], out["cpu"]
    assert (la, lb) == (3, 0)
    assert float((a["params"].cpu() - b["params"]).abs().max()) < 5e-4
    assert int(a["triggers"]) == int(b["triggers"])


@pytest.mark.cuda
def test_k1_card_leg_covers_the_new_kernel(cuda):
    out, meta = kl.lint_coverage_card(cuda, (PROBE,), program="t")
    assert out == []
    assert set(meta) == set(xhat_mix.ENTRIES.values())


@pytest.mark.cuda
def test_k3_card_leg_holds_the_new_kernel(cuda):
    out, meta = kl.lint_budget_card(probes=(PROBE,), program="t")
    assert [f for f in out if f.severity == "error"] == []
    for entry in xhat_mix.ENTRIES.values():
        a = meta[entry]
        assert a["shared_bytes"] == 0 and a["num_regs"] <= 128
        assert a["blocks_per_sm"] >= 2

