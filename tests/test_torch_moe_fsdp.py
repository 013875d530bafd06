"""Port parity, MoE routing under fsdp (ROADMAP C.1): reduced
deepseek-moe-16b and deepseek-v3-671b (MLA, MTP) trained over a
``(node 1, fsdp 2)`` mesh of two gloo ranks on the CPU, with 1 and 2
microbatches, against the reference's one-device ``build_sparq``.

Each rank holds one half of every microbatch of the node's batch; every
MoE layer routes the whole microbatch over the pair
(``repro_torch.models.moe.route`` with the fsdp group), as the reference
routes it in one call. The ranks are spawned once for the module and loop
over the cases; the reference's routing tables are read through
``jax.debug.callback`` around ``repro.models.moe.route``.

Tolerances (float32 compute and scores):
* every MoE call's routing table (the ranks' own tokens at their global
  slots, joined), its capacity and its drops: exactly;
* losses: within ``1e-5`` relative, every step;
* the fsdp mean of the ranks' gradients of ``lm_loss`` at a large aux
  coefficient against one process on the whole batch: within ``1e-5`` of
  the largest entry;
* blocked routing (``moe_route_blocks`` 4): each rank's rows of the MoE
  output exactly, the aux within ``1e-5``.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs.registry import get_config  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.schedule import decaying  # noqa: E402
from repro_torch.core.triggers import constant  # noqa: E402
from repro_torch.data.synthetic import TokenPipeline  # noqa: E402
from repro_torch.dist import comm, sharding  # noqa: E402
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq  # noqa
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import make_production_mesh  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import moe, transformer  # noqa: E402

ARCHS = ("deepseek-moe-16b", "deepseek-v3-671b")
# (arch, microbatches, capacity factor: None keeps the config's); at their
# own factor the reduced configs may drop no choice on these batches
# (whether they do depends on x^0's threefry layout), so one case per arch
# halves it: 64 slots for the 128 choices of a 64-token microbatch
CASES = [(arch, mbs, None) for arch in ARCHS for mbs in (1, 2)] + \
    [(arch, 1, 0.5) for arch in ARCHS]
SEQ, PER, STEPS = 16, 4, 3
RTOL = 1e-5
TIMEOUT_S = 300.0
F32_SCORES = functools.partial(tattn.chunked_attention,
                               score_dtype=torch.float32)


def _cfg(arch, cf=None, **kw):
    if cf is not None:
        kw["capacity_factor"] = cf
    return dataclasses.replace(get_config(arch).reduced(), n_nodes=1,
                               compute_dtype="float32", **kw)


def _dcfg(mbs, dist_cls=DistSparqConfig, lr=decaying, thr=constant):
    return dist_cls(H=2, frac=0.1, use_kernel=True, variant="ring",
                    microbatches=mbs, lr=lr(0.5, 100.0), threshold=thr(2.0))


class _Routes:
    """Every ``moe.route`` call while installed: the slot table, the
    capacity, the token count and the caller's rank in its group."""

    def __enter__(self):
        self.calls, self.real = [], moe.route

        def route(cfg, w, x, group=None):
            out = self.real(cfg, w, x, group)
            self.calls.append((out[0].clone(), out[3], x.shape[0],
                               None if group is None else group.rank))
            return out
        moe.route = route
        return self

    def __exit__(self, *exc):
        moe.route = self.real


def _trajectory(arch, mbs, cf, mesh):
    """``STEPS`` steps through the CLI's loop; the first step's routes."""
    cfg = _cfg(arch, cf)
    init_fn, step, _ = build_sparq(cfg, _dcfg(mbs), device="cpu", mesh=mesh)
    state = init_fn(key=prng.PRNGKey(0))
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         batch_per_node=PER, n_nodes=step.n_nodes, seed=0)
    with _Routes() as log:
        state, _, first = train.train_steps(step, state, pipe, 0, 1,
                                            lambda *a: None)
    state, _, rest = train.train_steps(step, state, pipe, 1, STEPS,
                                       lambda *a: None)
    return {"losses": first["losses"] + rest["losses"],
            "bits": first["bits"] + rest["bits"], "routes": log.calls,
            "rows": step.rows}


def _aux_grads(group):
    """The gradient of ``lm_loss`` (aux coefficient 1) on the rank's half
    of a 4-row batch, or on all of it without a group, at x^0."""
    cfg = _cfg("deepseek-moe-16b", router_aux_coef=1.0)
    params = transformer.init_params(cfg, prng.PRNGKey(0))
    leaves = [v for _, v in transformer._tree_items(params)]
    for v in leaves:
        v.requires_grad_(True)
    b = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                      batch_per_node=PER, n_nodes=1).batch(0, 0)
    rows = slice(None) if group is None else \
        slice(2 * group.rank, 2 * group.rank + 2)
    batch = {k: torch.as_tensor(v[rows]).long() for k, v in b.items()}
    loss, metrics = transformer.lm_loss(cfg, params, batch, group)
    loss.backward()
    return {"loss": float(loss.detach()),
            "aux": float(metrics["aux"].detach()),
            "grad": torch.cat([v.grad.reshape(-1) for v in leaves])}


def _blocked(group):
    """Blocked routing (``moe_route_blocks`` 4) of one MoE layer on a 4 x 16
    batch of hidden states: the rank's half with the fsdp group, or the
    whole without. Returns (y, aux)."""
    cfg = _cfg("deepseek-moe-16b", moe_route_blocks=4)
    params = transformer.init_params(cfg, prng.PRNGKey(0))
    layer = {k: v[0] for k, v in params["seg1"]["moe"].items()}
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (PER, SEQ, cfg.d_model)).astype(np.float32))
    if group is not None:
        x = x[2 * group.rank:2 * group.rank + 2]
    y, aux = moe.moe_forward(cfg, layer, x, group)
    return y, float(aux)


def _ranks(rank):
    """One of two ranks over (node 1, fsdp 2): every case, the aux
    gradient and a batch whose microbatch does not split."""
    tattn.chunked_attention = F32_SCORES
    out = {}
    for arch, mbs, cf in CASES:
        cfg = _cfg(arch, cf)
        mesh = sharding.train_mesh(make_production_mesh(device_type="cpu"),
                                   cfg)
        out[(arch, mbs, cf)] = _trajectory(arch, mbs, cf, mesh)
    out["coords"] = sharding.coordinates(mesh)
    group = comm.GroupComm(mesh.get_group("fsdp"), torch.device("cpu"))
    out["aux"] = _aux_grads(group)
    out["blocked"] = _blocked(group)
    init_fn, step, _ = build_sparq(cfg, _dcfg(2), device="cpu", mesh=mesh)
    pipe = TokenPipeline(vocab_size=cfg.vocab_size, seq_len=SEQ,
                         batch_per_node=2, n_nodes=1)
    try:
        step(init_fn(), pipe.global_batch(0))
        out["unsplit"] = None
    except ValueError as e:
        out["unsplit"] = str(e)
    return out


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def two():
    return comm.spawn(_ranks, 2, (), timeout_s=TIMEOUT_S,
                      deadline_s=TIMEOUT_S)


def _reference(arch, mbs, cf):
    """The reference's ``build_sparq`` on one device: per-step losses and
    bits, and the first step's routing tables (read through
    ``jax.debug.callback``, in call order: microbatch, then layer)."""
    import jax
    import jax.numpy as jnp
    from repro.configs.registry import get_config as jget
    from repro.core.schedule import decaying as jdecaying
    from repro.core.triggers import constant as jconstant
    from repro.dist import sharding as jsh
    from repro.dist.sparq_dist import DistSparqConfig as JDcfg
    from repro.dist.sparq_dist import build_sparq as jbuild
    from repro.models import attention as jattn
    from repro.models import moe as jmoe
    jc = dataclasses.replace(jget(arch).reduced(), n_nodes=1,
                             compute_dtype="float32")
    if cf is not None:
        jc = dataclasses.replace(jc, capacity_factor=cf)
    mesh = jsh.train_mesh(jax.make_mesh((1, 1), ("data", "model")), jc)
    calls, record = [], [True]
    real_route, real_attn = jmoe.route, jattn.chunked_attention

    def route(cfg, w, x):
        out = real_route(cfg, w, x)

        def keep(tfs, t=x.shape[0], cap=out[3]):
            if record[0]:
                calls.append((np.asarray(tfs), cap, t))
        jax.debug.callback(keep, out[0])
        return out
    jmoe.route = route
    jattn.chunked_attention = functools.partial(real_attn,
                                                score_dtype=jnp.float32)
    try:
        jinit, jstep, _, _ = jbuild(jc, mesh, _dcfg(mbs, JDcfg, jdecaying,
                                                    jconstant))
        state = jinit(jax.random.PRNGKey(0))
        pipe = TokenPipeline(vocab_size=jc.vocab_size, seq_len=SEQ,
                             batch_per_node=PER, n_nodes=1, seed=0)
        step = jax.jit(jstep)
        losses, bits = [], []
        for i in range(STEPS):
            state, m = step(state, pipe.global_batch(i))
            losses.append(float(m["loss"]))
            bits.append(float(m["bits"]))
            record[0] = False
    finally:
        jmoe.route, jattn.chunked_attention = real_route, real_attn
    return {"losses": losses, "bits": bits, "routes": calls}


def _joined(calls):
    """The ranks' tables of one route call joined into the whole batch's:
    rank f's token t is token ``f * T_f + t``; each slot is held by at most
    one rank. Returns (table, cap, tokens)."""
    t_all = sum(c[2] for c in calls)
    cap = {c[1] for c in calls}
    assert len(cap) == 1
    table = torch.full_like(calls[0][0], t_all)
    base = 0
    for tfs, _, t, rank in sorted(calls, key=lambda c: c[3]):
        own = tfs < t
        assert not bool((own & (table < t_all)).any()), "a slot held twice"
        table = torch.where(own, tfs + base, table)
        base += t
    return table, cap.pop(), t_all


@pytest.mark.parametrize("arch,mbs,cf", CASES)
def test_fsdp_moe_routing_equals_reference(two, arch, mbs, cf):
    """Every MoE call of the first step: the ranks' joined table equals
    the reference's whole-microbatch table (capacity and drops with it);
    every step's loss within 1e-5 and its bits equal."""
    want = _reference(arch, mbs, cf)
    ranks = [r[(arch, mbs, cf)] for r in two]
    assert [r["coords"]["fsdp"] for r in two] == [0, 1]
    assert all(r["rows"] == (0, 1) for r in ranks)
    cfg = get_config(arch).reduced()
    n_calls = mbs * (cfg.n_layers - cfg.first_k_dense)
    assert len(want["routes"]) == n_calls
    for r in ranks:
        assert len(r["routes"]) == n_calls
    for i, (w_tfs, w_cap, w_t) in enumerate(want["routes"]):
        table, cap, t_all = _joined([r["routes"][i] for r in ranks])
        assert (cap, t_all) == (w_cap, w_t), i
        np.testing.assert_array_equal(table.numpy(), w_tfs)
        # the drops: choices that found no slot
        assert int((table < t_all).sum()) == int((w_tfs < w_t).sum())
    for r in ranks:
        np.testing.assert_allclose(r["losses"], want["losses"], rtol=RTOL)
        np.testing.assert_allclose(r["bits"], want["bits"], rtol=1e-6)


def test_fsdp_moe_routing_drops_choices(two):
    """Each arch's calls route past capacity somewhere (the halved
    capacity leaves fewer slots than choices): choices are dropped, so the
    drops are part of what is held."""
    for arch in ARCHS:
        k = get_config(arch).reduced().moe_top_k
        dropped = 0
        for case in (c for c in CASES if c[0] == arch):
            routes = [r[case]["routes"] for r in two]
            for calls in zip(*routes, strict=True):
                table, _, t_all = _joined(calls)
                dropped += t_all * k - int((table < t_all).sum())
        assert dropped > 0, arch


def test_fsdp_aux_gradient_is_the_whole_batch_one(two):
    """With the aux coefficient at 1, the mean over the pair of the ranks'
    losses and gradients equals one process's on the whole batch."""
    tattn.chunked_attention, saved = F32_SCORES, tattn.chunked_attention
    try:
        want = _aux_grads(None)
    finally:
        tattn.chunked_attention = saved
    got = [r["aux"] for r in two]
    assert got[0]["aux"] == got[1]["aux"]
    np.testing.assert_allclose(got[0]["aux"], want["aux"], rtol=RTOL)
    np.testing.assert_allclose(np.mean([g["loss"] for g in got]),
                               want["loss"], rtol=RTOL)
    mean = (got[0]["grad"] + got[1]["grad"]) / 2
    err = float((mean - want["grad"]).abs().max())
    assert err <= RTOL * float(want["grad"].abs().max()), err


def test_fsdp_blocked_routing_keeps_the_blocks(two):
    """With ``moe_route_blocks`` 4 each rank routes its two of the batch's
    four blocks on their own, as one process routes them: its rows of the
    output equal, and the aux is the mean over all four blocks."""
    y, aux = _blocked(None)
    for r in two:
        f = r["coords"]["fsdp"]
        got_y, got_aux = r["blocked"]
        assert torch.equal(got_y, y[2 * f:2 * f + 2])
        np.testing.assert_allclose(got_aux, aux, rtol=RTOL)


def test_unsplit_microbatch_raises(two):
    """A microbatch of 1 row (batch_per_node 2, microbatches 2) over fsdp
    2 is refused with the shapes named, not laid out some other way."""
    for r in two:
        assert "microbatch of 1 rows" in r["unsplit"]
        assert "fsdp 2" in r["unsplit"]
