"""The port's dry run (``repro_torch.launch.dryrun``) and cost walk
(``repro_torch.launch.op_walk``) against the reference's
(``repro.launch.dryrun``, ``repro.launch.hlo_walk``).

* ``param_count``, ``active_param_count`` and ``model_flops`` of all ten
  configs: exactly the reference's (integers, and the float of the same
  integer product), and the values of the reference's table.
* Dot FLOPs: a Python loop of 8 products gives ``tests/test_hlo_walk.py``'s
  figure exactly; the reduced qwen1.5-0.5b prefill forward on ``meta``
  counts exactly what ``hlo_walk.analyse_hlo`` counts on the reference's
  compiled CPU module (no operation accounts for a difference: both count
  the projections, the chunked attention's score and value products over
  every chunk pair, and the LM head; tolerance 0).
* The kernels on ``meta`` are charged their closed form and run nothing of
  their plain version.
* The dry run of qwen1.5-0.5b at ``train_4k`` and ``decode_32k`` on the
  reference's ``16x16`` grid gives ``ok`` rows with positive terms.

Importing ``repro.launch.dryrun`` sets ``XLA_FLAGS`` in the environment
(``src/repro/launch/dryrun.py:1-2``), which would reach every subprocess a
later test on the same worker spawns: the fixture restores it.
"""
import functools
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import registry as jreg  # noqa: E402
from repro.launch.hlo_walk import analyse_hlo  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro.models.config import INPUT_SHAPES as J_SHAPES  # noqa: E402
from repro_torch.configs.registry import ARCH_IDS, get_config  # noqa: E402
from repro_torch.dist import serve  # noqa: E402
from repro_torch.kernels import qsgd, sign_topk  # noqa: E402
from repro_torch.launch import dryrun, op_walk  # noqa: E402
from repro_torch.models.config import INPUT_SHAPES, InputShape  # noqa: E402

SHAPES = ("train_4k", "prefill_32k", "decode_32k")
# (params, active params), the reference's dry run on the CPU
TABLE = {
    "qwen1.5-0.5b": (619_570_176, 619_570_176),
    "mamba2-370m": (419_825_152, 419_825_152),
    "musicgen-large": (2_424_705_024, 2_424_705_024),
    "chameleon-34b": (34_293_424_128, 34_293_424_128),
    "minitron-4b": (4_190_509_056, 4_190_509_056),
    "deepseek-moe-16b": (16_375_728_128, 2_828_650_496),
    "deepseek-v3-671b": (671_712_528_384, 38_238_406_656),
    "zamba2-7b": (6_751_130_832, 6_751_130_832),
    "stablelm-1.6b": (1_644_367_872, 1_644_367_872),
    "qwen1.5-32b": (35_197_096_960, 35_197_096_960),
}
# the reference's model FLOPs at train_4k, 4 significant digits
TRAIN_4K_FLOPS = {"qwen1.5-0.5b": 3.8980e15, "deepseek-v3-671b": 2.4058e17,
                  "deepseek-moe-16b": 1.7796e16, "zamba2-7b": 4.2474e16}


@pytest.fixture(scope="module")
def jdryrun():
    """The reference's dry run, imported with ``XLA_FLAGS`` restored; its
    ``param_count`` (an ``eval_shape`` of ``init_params``, which
    ``active_param_count`` and ``model_flops`` call again) memoized per
    config for the module."""
    saved = os.environ.get("XLA_FLAGS")
    import repro.launch.dryrun as mod
    if saved is None:
        os.environ.pop("XLA_FLAGS", None)
    else:
        os.environ["XLA_FLAGS"] = saved
    count = mod.param_count
    mod.param_count = functools.lru_cache(maxsize=None)(count)
    yield mod
    mod.param_count = count


@pytest.mark.parametrize("arch", list(TABLE))
def test_counts_equal_the_reference_table(arch):
    cfg = get_config(arch)
    assert (dryrun.param_count(cfg), dryrun.active_param_count(cfg)) == \
        TABLE[arch]
    for name in SHAPES:
        shape = INPUT_SHAPES[name]
        tokens = shape.global_batch * (1 if shape.is_decode
                                       else shape.seq_len)
        factor = 6 if shape.kind == "train" else 2
        assert dryrun.model_flops(cfg, shape) == \
            float(factor * TABLE[arch][1] * tokens)
    if arch in TRAIN_4K_FLOPS:
        got = dryrun.model_flops(cfg, INPUT_SHAPES["train_4k"])
        assert abs(got / TRAIN_4K_FLOPS[arch] - 1) < 5e-5


@pytest.mark.parametrize("arch", list(TABLE))
def test_counts_equal_the_reference(jdryrun, arch):
    assert tuple(ARCH_IDS) == tuple(jreg.ARCH_IDS) == tuple(TABLE)
    cfg, jcfg = get_config(arch), jreg.get_config(arch)
    assert dryrun.param_count(cfg) == jdryrun.param_count(jcfg)
    assert dryrun.active_param_count(cfg) == jdryrun.active_param_count(jcfg)
    for name in SHAPES:
        assert dryrun.model_flops(cfg, INPUT_SHAPES[name]) == \
            jdryrun.model_flops(jcfg, J_SHAPES[name]), name


@pytest.mark.parametrize("device", ["meta", "cpu"])
def test_loop_of_products_counts_every_trip(device):
    x = torch.zeros((128, 256), device=device)
    ws = torch.zeros((8, 256, 256), device=device)

    def loop():
        y = x
        for i in range(8):
            y = torch.tanh(y @ ws[i])
        return y
    with op_walk.OpWalk(device) as w:
        loop()
    res = w.result()
    assert res["dot_flops"] == 2 * 128 * 256 * 256 * 8
    assert res["dot_flops_by_op"] == {"mm": 2 * 128 * 256 * 256 * 8}
    # 8 products and 8 tanh, each reading its inputs and writing its output
    act, w = 128 * 256 * 4, 256 * 256 * 4
    assert res["hbm_bytes"] == 8 * (act + w + act) + 8 * 2 * act


def test_host_operations_are_not_charged():
    with op_walk.OpWalk("meta") as w:
        torch.ones(64) * 2.0
    assert w.ops == 0 and w.hbm_bytes == 0


def test_bytes_and_live_set_of_in_place_and_fresh_outputs():
    """copy_ reads its source and writes its destination, and its output
    (the destination) is no new allocation; x + y reads both and writes a
    fresh tensor, live while referenced."""
    x = torch.empty(1024, device="meta")
    y = torch.empty(1024, device="meta")
    with op_walk.OpWalk("meta") as w:
        for _ in range(4):
            x.copy_(y)
        z = x + y
    assert w.hbm_bytes == 4 * 2 * 4096 + 3 * 4096
    assert w.peak_live_bytes == 4096 and z.shape == x.shape


def test_reduced_prefill_dot_flops_equal_hlo_walk():
    B, S = 1, 4096
    jcfg = jreg.get_config("qwen1.5-0.5b").reduced()
    pshape = jax.eval_shape(lambda k: jtf.init_params(jcfg, k),
                            jax.random.PRNGKey(0))
    tok = jax.ShapeDtypeStruct((B, S), jnp.int32)
    hlo = jax.jit(lambda p, t: jtf.forward(jcfg, p, t)[0]).lower(
        pshape, tok).compile().as_text()
    want = analyse_hlo(hlo)["dot_flops"]
    cfg = get_config("qwen1.5-0.5b").reduced()
    params, _, tokens, _, _ = serve.serve_shapes(
        cfg, InputShape("prefill_4k", S, B, "prefill"), S)
    prefill, _ = serve.build_prefill(cfg, "meta")
    with op_walk.OpWalk("meta") as w:
        logits = prefill(params, tokens, None)
    assert logits.device.type == "meta"
    assert logits.shape == (B, S, cfg.vocab_size)
    assert w.dot_flops == want


def test_sign_topk_on_meta_is_charged_its_closed_form(monkeypatch):
    def boom(*a, **k):
        raise AssertionError("the plain version ran on meta")
    monkeypatch.setattr(sign_topk, "_block_compress", boom)
    monkeypatch.setattr(qsgd, "qsgd_rows", boom)
    n = 2_420_196
    x = torch.empty((n, 1024), device="meta")
    before = sign_topk.sign_topk_blocks.launches
    with op_walk.OpWalk("meta") as w:
        q, xn, scale = sign_topk.sign_topk_blocks(x, None, 1.0, 103)
        q2, xn2, _ = sign_topk.sign_topk_blocks(x, torch.empty_like(x), 0.0,
                                                103)
        out = qsgd.qsgd_blocks(x, torch.empty_like(x), 16)
    assert sign_topk.sign_topk_blocks.launches == before
    assert q.shape == x.shape and xn is None and scale.shape == (n,)
    assert xn2.shape == x.shape and out.shape == x.shape
    ensemble = n * 1024 * 8 + n * 4
    assert sign_topk.work_bytes(n, torch.float32, False) == ensemble
    assert qsgd.work_bytes(n, torch.float32) == n * 1024 * 12
    assert w.kernels == {
        "sign_topk": {"launches": 2,
                      "bytes": ensemble + n * 1024 * 16 + n * 4},
        "qsgd": {"launches": 1, "bytes": n * 1024 * 12}}
    # the kernels' outputs are allocations; every charged byte is theirs,
    # except the empty_like x_hat and noise, which move nothing either
    assert w.hbm_bytes == sum(k["bytes"] for k in w.kernels.values())
    assert w.dot_flops == 0


def test_meta_step_counts_like_the_cpu_step_but_for_the_kernel():
    """The reduced main path on meta and on the CPU: the same products;
    on the CPU the compression is the plain version's operations, on meta
    one charge of the kernel's closed form."""
    from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq
    cfg = get_config("qwen1.5-0.5b").reduced(n_layers=1, d_model=128,
                                              vocab=256)
    dcfg = DistSparqConfig(H=1, use_kernel=True, frac=0.1, variant="ring")
    batch = {k: torch.zeros((4, 2, 16), dtype=torch.int32)
             for k in ("tokens", "labels")}
    got = {}
    for dev in ("meta", "cpu"):
        init_fn, step, _ = build_sparq(cfg, dcfg, device=dev)
        state = init_fn.zero_state()
        with op_walk.OpWalk(dev) as w:
            step(state, batch)
        got[dev] = w.result()
    assert got["meta"]["dot_flops"] == got["cpu"]["dot_flops"] > 0
    tiles = 4 * step.d_pad // 1024
    assert got["meta"]["kernels"] == {"sign_topk": {
        "launches": 1,
        "bytes": sign_topk.work_bytes(tiles, torch.float32, False)}}
    assert got["cpu"]["kernels"] == {}


def test_opts_are_checked():
    assert dryrun._opts("micro2,xhat_bf16,causal4,route2") == [
        "micro2", "xhat_bf16", "causal4", "route2"]
    with pytest.raises(ValueError, match="unknown opt"):
        dryrun._opts("micro2,fast")
    row = dryrun.run_one("qwen1.5-0.5b", "decode_32k", False, "dense",
                         "nosuch")
    assert not row["ok"] and "unknown opt" in row["error"]
    assert "traceback" in row


@pytest.mark.parametrize("shape", ["train_4k", "decode_32k"])
def test_dryrun_rows_on_the_reference_grid(shape):
    row = dryrun.run_one("qwen1.5-0.5b", shape, False, "dense")
    assert row["ok"], row.get("traceback")
    assert row["mesh"] == "16x16" and row["n_ranks"] == 256
    for k in ("compute_s", "memory_s", "collective_s"):
        assert row[k] > 0 and np.isfinite(row[k])
    assert row["dominant"] in ("compute_s", "memory_s", "collective_s")
    assert row["memory"]["watermark_bytes"] > row["memory"]["state_bytes"]
    if shape == "train_4k":
        # (node 16, fsdp 1, model 16): one row per rank, the kernel once
        assert row["train_mesh"] == {"node": 16, "fsdp": 1, "model": 16}
        assert row["rows_per_rank"] == 1
        assert row["kernels"]["sign_topk"]["launches"] == 1
        assert set(row["collectives"]) == {"all-gather"}
    else:
        assert row["serve_mesh"] == {"data": 16, "model": 16}
        # the reference's committed roofline row (BENCH_roofline.json,
        # hlo_flops_per_device at decode_32k): the same rank's products
        assert row["dot_flops_per_rank"] == 2_074_476_544
