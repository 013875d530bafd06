"""Port parity, the sharded flat-buffer engine: 2 and 4 gloo ranks on the
CPU (``repro_torch.dist.comm.spawn``: one process per rank, a FileStore
under a temporary directory, one thread each, a deadline on the group and
the join) against the port's one-process run of the same config, and one
case against the reference's one-device ``build_sparq``.

Each rank returns its rows of the final ``params`` and ``x_hat`` and its
per-step channels; the one-process runs here use one thread too (the CPU's
float32 sums follow the thread count).

Tolerances:
* bits, triggers and sync rounds: exactly, in every case;
* ``fsdp = 1`` (rows on the node axis, model replicas): losses and every
  row bit for bit, for the shift plan fetching rows from one or two ranks,
  dense mixing, faults with a time-varying plan, the generic path and
  momentum, and a MoE of deepseek-moe-16b's pattern (one dense and six MoE
  layers, tiny widths) with one node a rank;
* ``fsdp = 2``: the per-node batch is split and its gradient summed over
  the group, so the float32 sums run in another order: losses within
  ``1e-4`` relative, x_hat beyond ``5e-4`` on at most 8 entries of a tile
  in at most 1 % of the tiles (selection-boundary flips), and params
  within ``5e-4`` outside the flipped columns;
* a checkpoint saved at 2 ranks and restored at 1 and at 4: bit for bit
  equal to the unbroken run;
* against the reference (float32 compute and scores): losses within
  ``1e-4`` relative, bits within ``1e-6`` relative, params within
  ``5e-4`` (``tests/test_dist_equivalence.py``'s).

The data-sharded serve over two ranks is ``tests/test_torch_serve.py``'s.
"""
import dataclasses
import functools
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import ckpt  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.faults import DropoutWindow, FaultPlan  # noqa: E402
from repro_torch.core.schedule import decaying  # noqa: E402
from repro_torch.core.triggers import constant  # noqa: E402
from repro_torch.data.synthetic import TokenPipeline  # noqa: E402
from repro_torch.dist import comm, serve, sharding  # noqa: E402
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq  # noqa
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import transformer  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(n_layers=1, d_model=64, vocab=128)
SEQ, PER, STEPS, SAVE_AT = 16, 2, 6, 4
TIMEOUT_S = 240.0
FAULTS = FaultPlan(link_drop=0.3, stragglers=(1,), straggler_frac=0.5,
                   dropout=(DropoutWindow(2, 1, 4),), seed=4)
CASES = {
    "ring": {},
    "dense": {"variant": "dense"},
    "faults": {"dynamic": "matchings", "rounds": 4, "faults": FAULTS},
    "generic": {"use_kernel": False},
    "momentum": {"momentum": 0.9},
}
F32_SCORES = functools.partial(tattn.chunked_attention,
                               score_dtype=torch.float32)


def _cfg(n):
    return dataclasses.replace(get_config("qwen1.5-0.5b").reduced(**SMALL),
                               n_nodes=n, compute_dtype="float32")


def _moe7(n):
    """deepseek-moe-16b's pattern at depth 7: one dense and six MoE layers,
    tiny widths."""
    return dataclasses.replace(
        get_config("deepseek-moe-16b").reduced(n_layers=7, d_model=64,
                                               vocab=128),
        n_nodes=n, compute_dtype="float32")


def _dcfg(case):
    return DistSparqConfig(**{**dict(
        H=3, frac=0.1, use_kernel=True, variant="ring",
        lr=decaying(0.5, 100.0), threshold=constant(2.0)), **CASES[case]})


def _trajectory(n, case, mesh=None, steps=STEPS, start=0, save=None,
                restore=None, rows_of=None, cfg=_cfg):
    """``steps`` steps of ``case`` at ensemble ``n`` from x^0 (or from the
    checkpoint ``restore`` at step ``start``) through the CLI's loop,
    saving at ``SAVE_AT`` to ``save``; returns the per-step channels and
    the rank's final rows."""
    init_fn, step, _ = build_sparq(cfg(n), _dcfg(case), device="cpu",
                                   mesh=mesh)
    rows = rows_of(step) if rows_of else None
    if restore is None:
        state = init_fn(key=prng.PRNGKey(0))
    else:
        state = ckpt.restore(restore, start, like=init_fn.zero_state(),
                             rows=rows)
    pipe = TokenPipeline(vocab_size=128, seq_len=SEQ, batch_per_node=PER,
                         n_nodes=n, seed=0)

    def save_at(i, state, metrics):
        if save is not None and i + 1 == SAVE_AT:
            ckpt.save(save, SAVE_AT, state, rows=rows)
    state, _, out = train.train_steps(step, state, pipe, start, steps,
                                      save_at)
    out.update(params=state["params"].clone(), x_hat=state["x_hat"].clone(),
               sync_rounds=state["sync_rounds"], n=step.n_nodes,
               rows=step.rows, exchange_s=list(step.exchange_s))
    return out


def _mesh(n, model=1):
    return sharding.train_mesh(make_production_mesh(model=model,
                                                    device_type="cpu"),
                               _cfg(n))


def _two_ranks(rank, ckpt_dir):
    """Two ranks: every engine case at n = 4 over (node 2), two rows per
    rank; the momentum case saves at step 4."""
    out = {c: _trajectory(4, c, _mesh(4)) for c in CASES if c != "momentum"}
    out["momentum"] = _trajectory(4, "momentum", _mesh(4), save=ckpt_dir,
                                  rows_of=ckpt.Rows.of)
    return out


def serve_ranks(rank, cfg, toks, steps):
    """One of two ranks of ``tests/test_torch_serve.py``'s data-2 serve:
    prefill and ``steps`` decode steps over (data 2, model 1), the cache
    cut from a global one by ``shardings_fn``; and the prefill over a
    (data 1, model 2) mesh on the rank's parameter blocks."""
    prod = make_production_mesh(device_type="cpu")
    smesh = sharding.serve_mesh(prod)
    params = transformer.init_params(cfg, prng.PRNGKey(0))
    prefill, _ = serve.build_prefill(cfg, smesh)
    decode, shardings = serve.build_decode(cfg, smesh)
    glob = transformer.init_cache(cfg, toks.shape[0], steps, device="cpu")
    _, cs, ts, _, ps = shardings(transformer.param_shapes(cfg), glob,
                                 toks[:, :1], None)
    cache = serve.local_shard(glob, cs, smesh)
    logits = [prefill(params, toks)]
    for t in range(steps):
        lg, cache = decode(params, cache, toks[:, t:t + 1], None, t)
        logits.append(lg)
    tmesh = sharding.serve_mesh(make_production_mesh(model=2,
                                                     device_type="cpu"))
    tp_step, tp_shardings = serve.build_prefill(cfg, tmesh)
    blocks, _, _ = tp_shardings(params, toks, None)
    tp_logits = tp_step(serve.local_shard(params, blocks, tmesh), toks)
    return {"logits": logits, "cache": cache, "tp_logits": tp_logits,
            "coords": sharding.coordinates(smesh), "tok_spec": ts.spec,
            "pos_spec": ps.spec, "placements": list(ts.placements())}


def _four_ranks(rank, ckpt_dir):
    """Four ranks: the ring at n = 4 over (node 4), one row per rank, with
    float32 scores for the reference's comparison, and the MoE of depth 7;
    fsdp 2 and model-2 replicas; the 2-rank checkpoint restored over
    (node 4)."""
    out = {}
    tattn.chunked_attention = F32_SCORES
    out["ring_f32"] = _trajectory(4, "ring", _mesh(4))
    tattn.chunked_attention = F32_SCORES.func
    out["moe7"] = _trajectory(4, "ring", _mesh(4), cfg=_moe7)
    out["faults"] = _trajectory(4, "faults", _mesh(4))
    out["fsdp"] = _trajectory(2, "ring", _mesh(2))
    out["fsdp"]["coords"] = sharding.coordinates(_mesh(2))
    replicas = _mesh(4, model=2)
    out["model2"] = _trajectory(4, "momentum", replicas)
    out["model2"]["mesh"] = sharding.axis_sizes(replicas)
    out["restored"] = _trajectory(4, "momentum", _mesh(4), start=SAVE_AT,
                                  restore=ckpt_dir, rows_of=ckpt.Rows.of)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ckpt"))


@pytest.fixture(scope="module")
def two(ckpt_dir):
    return comm.spawn(_two_ranks, 2, (ckpt_dir,), timeout_s=TIMEOUT_S,
                      deadline_s=TIMEOUT_S)


@pytest.fixture(scope="module")
def four(two, ckpt_dir):
    return comm.spawn(_four_ranks, 4, (ckpt_dir,), timeout_s=TIMEOUT_S,
                      deadline_s=TIMEOUT_S)


@functools.lru_cache(maxsize=None)
def _one(n, case, f32=False):
    """The one-process run of a case (memoized for the module)."""
    if f32:
        saved, tattn.chunked_attention = tattn.chunked_attention, F32_SCORES
    try:
        return _trajectory(n, case)
    finally:
        if f32:
            tattn.chunked_attention = saved


def _stacked(ranks, key, pick=lambda r: True):
    parts = sorted((r for r in ranks if pick(r)), key=lambda r: r["rows"])
    return torch.cat([r[key] for r in parts])


def _assert_exact(ranks, want):
    for r in ranks:
        for key in ("losses", "bits", "triggers", "sync_rounds"):
            assert r[key] == want[key], key
        lo, hi = r["rows"]
        for key in ("params", "x_hat"):
            assert torch.equal(r[key], want[key][lo:hi]), (key, lo, hi)


@pytest.mark.parametrize("case", list(CASES))
def test_two_ranks_equal_one_process(two, case):
    ranks = [r[case] for r in two]
    assert [r["rows"] for r in ranks] == [(0, 2), (2, 4)]
    _assert_exact(ranks, _one(4, case))
    assert ranks[0]["sync_rounds"] == 2


def test_shift_plan_fetches_from_two_ranks(two):
    """With two rows per rank, each shift's rows come from two ranks, and
    the exchange's time is kept per sync."""
    ring = [r["ring"] for r in two]
    assert all(len(r["exchange_s"]) == 2 for r in ring)
    assert all(s >= 0.0 for r in ring for s in r["exchange_s"])
    assert torch.equal(_stacked(ring, "x_hat"), _one(4, "ring")["x_hat"])


def test_four_ranks_equal_one_process(four):
    _assert_exact([r["faults"] for r in four], _one(4, "faults"))
    _assert_exact([r["ring_f32"] for r in four], _one(4, "ring", True))
    assert [r["ring_f32"]["rows"] for r in four] == \
        [(0, 1), (1, 2), (2, 3), (3, 4)]


def test_moe_of_depth_seven_one_node_a_rank_equals_one_process(four):
    """One dense and six MoE layers, one node on each of four ranks: every
    row, loss, bit count and trigger count as one process gives them."""
    ranks = [r["moe7"] for r in four]
    assert [r["rows"] for r in ranks] == [(0, 1), (1, 2), (2, 3), (3, 4)]
    want = _trajectory(4, "ring", cfg=_moe7)
    assert want["triggers"][-1] > 0
    _assert_exact(ranks, want)


def test_model_axis_replicas_equal_one_process(four):
    ranks = [r["model2"] for r in four]
    assert ranks[0]["mesh"] == {"node": 2, "fsdp": 1, "model": 2}
    assert [r["rows"] for r in ranks] == [(0, 2), (0, 2), (2, 4), (2, 4)]
    _assert_exact(ranks, _one(4, "momentum"))


def _flips_only(got, want, atol=5e-4, per_tile=8, tile_share=0.01):
    dx = (got["x_hat"] - want["x_hat"]).abs()
    far = (dx > atol).view(dx.shape[0], -1, 1024).sum(-1)
    assert int(far.max()) <= per_tile
    assert int((far > 0).sum()) <= tile_share * far.numel()
    cols = (dx > 1e-6).any(0)
    rest = (got["params"] - want["params"]).abs()[:, ~cols]
    assert rest.numel() == 0 or float(rest.max()) <= atol


def test_fsdp_two_within_flips(four):
    """(node 2, fsdp 2): each rank of a node computes on half of the
    node's batch and the gradients are summed over the pair."""
    ranks = [r["fsdp"] for r in four]
    assert [r["coords"]["fsdp"] for r in ranks] == [0, 1, 0, 1]
    want = _one(2, "ring")
    for r in ranks:
        assert r["bits"] == want["bits"] and r["triggers"] == want["triggers"]
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=1e-4)
    # the fsdp pair of a node holds the same rows
    assert torch.equal(ranks[0]["params"], ranks[1]["params"])
    got = {k: _stacked(ranks, k, lambda r: r["coords"]["fsdp"] == 0)
           for k in ("params", "x_hat")}
    _flips_only(got, want)


def test_checkpoint_across_world_sizes(two, four, ckpt_dir):
    """Saved at step 4 by 2 ranks (two rows each); restored at 4 ranks
    (one row each) and in one process, both run on to step 6: equal to
    the unbroken run bit for bit."""
    want = _one(4, "momentum")
    restored = [r["restored"] for r in four]
    for r in restored:
        assert r["losses"] == want["losses"][SAVE_AT:]
        assert r["bits"] == want["bits"][SAVE_AT:]
    assert torch.equal(_stacked(restored, "params"), want["params"])
    assert torch.equal(_stacked(restored, "x_hat"), want["x_hat"])
    one = _trajectory(4, "momentum", start=SAVE_AT, restore=ckpt_dir)
    assert one["losses"] == want["losses"][SAVE_AT:]
    for key in ("params", "x_hat"):
        assert torch.equal(one[key], want[key])
    man = ckpt._manifest(os.path.join(ckpt_dir, f"step_{SAVE_AT}"))
    assert man["leaves"]["params"]["shape"][0] == 4


def test_sharded_run_equals_reference(four):
    """The 4-rank ring run with float32 compute and scores against the
    reference's one-device build_sparq on the same batches."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jget
    from repro.core.schedule import decaying as jdecaying
    from repro.core.triggers import constant as jconstant
    from repro.dist import sharding as jsh
    from repro.dist.sparq_dist import DistSparqConfig as JDcfg
    from repro.dist.sparq_dist import build_sparq as jbuild
    from repro.models import attention as jattn
    jc = dataclasses.replace(jget("qwen1.5-0.5b").reduced(**SMALL),
                             n_nodes=4, compute_dtype="float32")
    mesh = jsh.train_mesh(jax.make_mesh((1, 1), ("data", "model")), jc)
    saved = jattn.chunked_attention
    jattn.chunked_attention = functools.partial(saved,
                                                score_dtype=jnp.float32)
    try:
        jinit, jstep, _, _ = jbuild(jc, mesh, JDcfg(
            H=3, frac=0.1, use_kernel=True, variant="ring",
            lr=jdecaying(0.5, 100.0), threshold=jconstant(2.0)))
        state = jinit(jax.random.PRNGKey(0))
        pipe = TokenPipeline(vocab_size=128, seq_len=SEQ,
                             batch_per_node=PER, n_nodes=4, seed=0)
        step = jax.jit(jstep)
        losses, bits, trig = [], [], []
        for i in range(STEPS):
            state, m = step(state, pipe.global_batch(i))
            losses.append(float(m["loss"]))
            bits.append(float(m["bits"]))
            trig.append(int(m["triggers"]))
    finally:
        jattn.chunked_attention = saved
    ranks = [r["ring_f32"] for r in four]
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=1e-4)
    np.testing.assert_allclose(ranks[0]["bits"], bits, rtol=1e-6)
    assert ranks[0]["triggers"] == trig
    np.testing.assert_allclose(_stacked(ranks, "params").numpy(),
                               np.asarray(state["params"]), atol=5e-4)


def test_cli_mesh_line_equals_reference(capfd):
    """``launch.train --devices 2 --device cpu --reduced`` prints the
    reference CLI's mesh line (the port adds its backend, ranks per card
    and transport after it)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.join(ROOT, "src"))
    ref = subprocess.run(
        [sys.executable, "-m", "repro.launch.train", "--devices", "2",
         "--reduced", "--steps", "0"], capture_output=True, text=True,
        env=env, cwd=ROOT, timeout=120, check=True).stdout
    want = next(ln for ln in ref.splitlines()
                if ln.startswith("[train] mesh"))
    out = train.run(["--devices", "2", "--reduced", "--steps", "0",
                     "--device", "cpu"])
    got = next(ln for ln in capfd.readouterr().out.splitlines()
               if ln.startswith("[train] mesh"))
    assert got.startswith(want + "; backend gloo, 2 rank(s) on the CPU, "
                                 "transport host"), (got, want)
    assert out["mesh"] == {"node": 2, "fsdp": 1, "model": 1}
    assert out["cfg"].n_nodes == 2
