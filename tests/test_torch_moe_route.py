"""MoE routing's queue positions and slot tables in one pass
(``repro_torch.kernels.moe_route``): its plain version against the chain
``route`` ran before it, ``route`` against that whole former routing, its
charge on ``meta``, its refusals and its counters on the CPU; the kernel
against the plain version, and its K1 and K3 audits, on the card under the
``cuda`` marker (skipped without a card), run there with

    PYTHONPATH=src python -m pytest -m cuda -q tests/test_torch_moe_route.py

The tables are integers and the aux's f_e is each expert's count over T as
``one_hot(...).mean(0)`` rounds it on the device, so every comparison is bit
for bit."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402

from repro_torch import spans  # noqa: E402
from repro_torch.analysis import kernel_lint as kl  # noqa: E402
from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.kernels import moe_route as mr  # noqa: E402
from repro_torch.kernels import parity  # noqa: E402
from repro_torch.launch import op_walk  # noqa: E402
from repro_torch.models import moe  # noqa: E402

PROBE = next(p for p in kl.PROBES if p.source == "moe_route")
CASES = {spec[0]: spec for spec in parity.MOE_ROUTE_CASES}


def former_tables(expert_idx, e, cap, before=0):
    """The integer chain of ``route`` before the one-pass version:
    ``(slot, token_for_slot[:-1], counts)``."""
    t_count, k = expert_idx.shape
    flat_expert = expert_idx.reshape(-1)
    choices = F.one_hot(flat_expert, e)
    pos = torch.cumsum(choices, dim=0) - 1 + before
    pos_in_e = torch.gather(pos, 1, flat_expert[:, None])[:, 0]
    slot = torch.where(pos_in_e < cap, flat_expert * cap + pos_in_e, e * cap)
    token_ids = torch.arange(t_count, dtype=torch.int32,
                             device=expert_idx.device).repeat_interleave(k)
    token_for_slot = torch.full((e * cap + 1,), t_count, dtype=torch.int32,
                                device=expert_idx.device).index_put(
                                    (slot,), token_ids)
    return slot.view(t_count, k), token_for_slot[:-1], choices.sum(0)


def former_route(cfg, router_w, x):
    """``moe.route`` without a group, as it was before the one-pass
    version."""
    t_count = x.shape[0]
    e, k = cfg.n_experts, cfg.moe_top_k
    logits = x.to(torch.float32) @ router_w.to(torch.float32)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals, expert_idx = top.values[:, :k], top.indices[:, :k]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    cap = moe.capacity(cfg, t_count)
    onehot = F.one_hot(expert_idx, e).to(torch.float32).sum(1)
    aux = e * torch.sum(onehot.mean(0) * probs.mean(0))
    slot, token_for_slot, _ = former_tables(expert_idx, e, cap)
    gate_for_slot = torch.zeros((e * cap + 1,), dtype=torch.float32,
                                device=x.device).index_put(
                                    (slot.reshape(-1),), gate_vals.reshape(-1))
    return token_for_slot, gate_for_slot[:-1], aux, cap, slot


def _cfg(n_experts=64, top_k=6, cf=1.25):
    return dataclasses.replace(
        get_config("deepseek-moe-16b").reduced(n_layers=2, d_model=64,
                                               vocab=128),
        n_experts=n_experts, moe_top_k=top_k, capacity_factor=cf,
        compute_dtype="float32")


def _router(cfg, tokens, seed, dev):
    """Router weights and tokens on a grid of 1/8 and 1/4, so that every
    logit is exact whatever order a product sums in (a batch routes as its
    halves do)."""
    rng = np.random.default_rng(seed)
    w = torch.from_numpy((rng.integers(-4, 5, (cfg.d_model, cfg.n_experts))
                          / 8).astype(np.float32)).to(dev)
    x = torch.from_numpy((rng.integers(-4, 5, (tokens, cfg.d_model))
                          / 4).astype(np.float32)).to(dev)
    return w, x


def _assert_same_routing(got, want):
    for name, a, b in zip(("token_for_slot", "gate_for_slot", "aux", "cap",
                           "slot"), got, want):
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), name
        else:
            assert a == b, name


class _Mirror:
    """Rank ``rank`` of an fsdp pair in one process whose peer holds the
    same tokens: a gather repeats this rank's tensor, a sum doubles it."""

    size = 2

    def __init__(self, rank):
        self.rank = rank

    def all_gather(self, t, dim):
        return torch.cat([t, t], dim)

    def all_reduce(self, t, op="sum"):
        return 2 * t


def _check_pair(cfg, w, x):
    """Each rank's tables of a mirrored pair are its rows of the whole
    batch's, the peer's tokens after its own."""
    t = x.shape[0]
    whole = moe.route(cfg, w, torch.cat([x, x]))
    for rank in (0, 1):
        tfs, gfs, aux, cap, slot = moe.route(cfg, w, x, group=_Mirror(rank))
        assert cap == whole[3]
        own = tfs < t
        assert torch.equal(torch.where(own, tfs + rank * t, 2 * t),
                           torch.where((whole[0] >= rank * t)
                                       & (whole[0] < (rank + 1) * t),
                                       whole[0], 2 * t))
        assert torch.equal(slot, whole[4][rank * t:(rank + 1) * t])
        # the gates and the aux are the same float32 sums of one row, or
        # of the group's rows in another order
        torch.testing.assert_close(gfs[own], whole[1][own], rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(aux, whole[2], rtol=1e-6, atol=0)


# ------------------------------------------------------------------- CPU

@pytest.mark.parametrize("name", list(CASES))
def test_plain_version_gives_the_former_tables(name):
    spec = CASES[name]
    ids, before = parity.make_moe_route_case(spec, torch.device("cpu"))
    e, cap = spec[4], spec[5]
    slot, tfs, counts = mr.moe_route(ids, e, cap, before)
    groups = ids if ids.dim() == 3 else ids[None]
    for g in range(groups.shape[0]):
        off = 0 if before is None else (before if ids.dim() == 2
                                        else before[g])
        want = former_tables(groups[g], e, cap, off)
        got = [t if ids.dim() == 2 else t[g] for t in (slot, tfs, counts)]
        assert torch.equal(got[0], want[0])
        assert torch.equal(got[1][:-1], want[1])
        assert int(got[1][-1]) == groups.shape[1]     # the overflow bin
        assert got[2].dtype == torch.int32
        assert torch.equal(got[2].long(), want[2])


@pytest.mark.parametrize("n_experts,top_k,tokens,cf", [
    (64, 6, 512, 1.25), (64, 6, 333, 0.5), (256, 8, 128, 1.0),
    (16, 2, 1, 1.25)])
def test_route_equals_the_former_route(n_experts, top_k, tokens, cf):
    cfg = _cfg(n_experts, top_k, cf)
    w, x = _router(cfg, tokens, tokens, torch.device("cpu"))
    _assert_same_routing(moe.route(cfg, w, x), former_route(cfg, w, x))


def test_mirrored_fsdp_pair_routes_as_the_whole_batch():
    cfg = _cfg(cf=0.5)
    _check_pair(cfg, *_router(cfg, 96, 3, torch.device("cpu")))


def test_choice_share_is_the_one_hot_mean_on_the_cpu():
    rng = np.random.default_rng(0)
    for t in (1, 7, 333, 4096, 4097):
        ids = torch.from_numpy(rng.integers(0, 64, (t, 6)))
        counts = mr.moe_route_counts(ids, 64)
        want = F.one_hot(ids, 64).to(torch.float32).sum(1).mean(0)
        assert torch.equal(mr.choice_share(counts, t), want)


def test_cpu_tensors_launch_nothing():
    before = mr.moe_route.launches
    for spec in parity.MOE_ROUTE_CASES[:3]:
        parity.check_moe_route(spec, torch.device("cpu"))
    assert mr.moe_route.launches == before


def test_meta_charges_work_bytes_and_launches_nothing():
    ids = torch.empty((4096, 64), dtype=torch.int64, device="meta")[:, :6]
    before_t = torch.empty((64,), dtype=torch.int64, device="meta")
    launches = mr.moe_route.launches
    with op_walk.OpWalk("meta") as walk:
        slot, tfs, counts = mr.moe_route(ids, 64, 480)
        mr.moe_route(ids, 64, 480, before_t)
        c = mr.moe_route_counts(ids, 64)
    assert (slot.shape, tfs.shape, counts.shape, c.shape) == (
        (4096, 6), (64 * 480 + 1,), (64,), (64,))
    assert (slot.dtype, tfs.dtype, counts.dtype) == (
        torch.int64, torch.int32, torch.int32)
    assert walk.kernels == {"moe_route": {
        "launches": 3,
        "bytes": 2 * mr.work_bytes(4096, 6, 64, 480) + 8 * 64
        + mr.work_bytes(4096, 6, 64, None)}}
    assert mr.moe_route.launches == launches


def test_work_bytes_at_the_cells_routing():
    # 24,576 choices in and out at 8 B, 30,721 owners, 64 counts
    assert mr.work_bytes(4096, 6, 64, 480) == 516_356
    assert mr.work_bytes(4096, 6, 64, 480) / 3.35e12 * 1e6 == \
        pytest.approx(0.154, abs=1e-3)
    assert mr.work_bytes(2048, 6, 64, 240, groups=3, before=True) == \
        3 * (16 * 12288 + 4 * 15361 + 4 * 64 + 8 * 64)
    assert mr.blocks(1) == 1 and mr.blocks(mr.CHUNK) == 1
    assert mr.blocks(mr.CHUNK + 1) == 2


@pytest.mark.parametrize("bad", ["experts", "top_k", "int32", "float",
                                 "choice_stride", "before_shape",
                                 "before_dtype", "mixed"])
def test_wrapper_refuses_what_the_kernel_does_not_take(bad):
    m = torch.device("meta")
    e, k, dtype = 64, 6, torch.int64
    if bad == "experts":
        e = 257
    elif bad == "top_k":
        k = 9
    elif bad == "int32":
        dtype = torch.int32
    elif bad == "float":
        dtype = torch.float32
    ids = torch.empty((128, k), dtype=dtype, device=m)
    before = None
    if bad == "choice_stride":
        ids = torch.empty((128, 2 * k), dtype=dtype, device=m)[:, ::2]
    elif bad == "before_shape":
        before = torch.empty((e + 1,), dtype=torch.int64, device=m)
    elif bad == "before_dtype":
        before = torch.empty((e,), dtype=torch.int32, device=m)
    elif bad == "mixed":
        before = torch.zeros((e,), dtype=torch.int64)
    with pytest.raises(ValueError):
        mr.moe_route(ids, e, 480, before)


def test_routed_kernel_counts_nothing_on_the_cpu():
    cfg = _cfg()
    p = _params(cfg)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    with spans.enabled():
        moe.moe_forward(cfg, p, x)
        counts = spans.counters()
    assert counts["moe.choices"] == 32 * cfg.moe_top_k
    assert counts["moe.routed_kernel"] == 0


def _params(cfg, dev="cpu"):
    from repro_torch.core import prng
    from repro_torch.models import transformer
    params = transformer.init_params(cfg, prng.PRNGKey(0))
    return {k: v[0].to(dev) for k, v in params["seg1"]["moe"].items()}


def test_k1_source_leg_and_k3_closed_form_hold_the_new_kernel():
    out, meta = kl.lint_registry(program="t")
    assert out == []
    src = meta["sources"]["moe_route"]
    assert src["kernels"] == ["moe_route_kernel"]
    assert src["entries"] == sorted(
        e + extra for e in mr.ENTRIES.values()
        for extra in ("", "_attributes", "_launch_config"))
    out, meta = kl.lint_budget(program="t")
    assert out == []
    # 32 warps' counts of 256 experts, and 256 totals and starts
    assert meta["kernels"]["moe_route_kernel"] == {
        "static_shared_bytes": 4 * (32 * 256 + 2 * 256),
        "dynamic_shared_bytes": 0, "threads": 1024, "min_blocks": 1,
        "max_registers": 64}


# -------------------------------------------------------------- the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda", torch.cuda.current_device())


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain(cuda, name):
    """slot, token_for_slot and counts bit for bit; one launch a routing up
    to a block's chunk a group, and the counting pass's own."""
    before = mr.moe_route.launches
    parity.check_moe_route(CASES[name], cuda, seed=11)
    torch.cuda.synchronize()
    spec = CASES[name]
    per = 2 if mr.blocks(spec[2] * spec[3]) > 1 else 1
    assert mr.moe_route.launches == before + per + 1


@pytest.mark.cuda
@pytest.mark.parametrize("n_experts,top_k,tokens,cf", [
    (64, 6, 4096, 1.25), (64, 6, 2048, 1.25), (256, 8, 1024, 1.0),
    (64, 6, 1, 1.25), (64, 7, 1001, 0.5)])
def test_route_equals_the_former_route_on_the_card(cuda, n_experts, top_k,
                                                   tokens, cf):
    """Every output of ``route`` through the kernel, the aux's f_e from
    the counts included, bit for bit as the former chain gives it on the
    card."""
    cfg = _cfg(n_experts, top_k, cf)
    w, x = _router(cfg, tokens, tokens, cuda)
    before = mr.moe_route.launches
    got = moe.route(cfg, w, x)
    assert mr.moe_route.launches == before + 1
    _assert_same_routing(got, former_route(cfg, w, x))


@pytest.mark.cuda
def test_mirrored_fsdp_pair_routes_as_the_whole_batch_on_the_card(cuda):
    cfg = _cfg(cf=0.5)
    before = mr.moe_route.launches
    _check_pair(cfg, *_router(cfg, 1500, 3, cuda))
    # the whole batch once; each rank its counting pass and its ranking
    assert mr.moe_route.launches == before + 5


@pytest.mark.cuda
def test_router_gradient_equals_the_plain_paths(cuda, monkeypatch):
    cfg = _cfg()
    w0, x0 = _router(cfg, 4096, 5, cuda)
    weight = torch.randn((cfg.n_experts * moe.capacity(cfg, 4096),),
                         generator=torch.Generator(cuda).manual_seed(0),
                         device=cuda)
    grads = []
    for plain in (False, True):
        if plain:
            monkeypatch.setattr(moe, "moe_route", mr.moe_route_plain)
        w, x = w0.clone().requires_grad_(), x0.clone().requires_grad_()
        _, gfs, aux, _, _ = moe.route(cfg, w, x)
        ((gfs * weight).sum() + aux).backward()
        grads.append((w.grad, x.grad))
    for a, b in zip(*grads):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_routed_kernel_counts_every_choice_on_the_card(cuda):
    cfg = _cfg()
    p = _params(cfg, cuda)
    x = torch.randn((2, 64, cfg.d_model), device=cuda)
    with spans.enabled():
        moe.moe_forward(cfg, p, x)
        counts = spans.counters()
    assert counts["moe.routed_kernel"] == counts["moe.choices"] == \
        128 * cfg.moe_top_k


@pytest.mark.cuda
def test_k1_card_leg_covers_the_new_kernel(cuda):
    before = mr.moe_route.launches
    out, meta = kl.lint_coverage_card(cuda, (PROBE,), program="t")
    assert out == []
    assert set(meta) == set(mr.ENTRIES.values())
    assert mr.moe_route.launches == before


@pytest.mark.cuda
def test_k3_card_leg_holds_the_new_kernel(cuda):
    out, meta = kl.lint_budget_card(probes=(PROBE,), program="t")
    assert [f for f in out if f.severity == "error"] == []
    for entry in mr.ENTRIES.values():
        a = meta[entry]
        assert a["shared_bytes"] == 4 * (32 * 256 + 2 * 256)
        assert a["num_regs"] <= 64 and a["blocks_per_sm"] >= 1
