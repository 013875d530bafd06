"""Port parity, the slice as a whole: the port's flat-buffer engine
(``repro_torch.dist.sparq_dist.build_sparq``) against the reference's on the
same weights and batches, for 5 steps: the kernel path, the generic path
(global TopFrac, and the stochastic QSGD with the reference's keys), fault
injection and the time-varying plans.

The selection is a discontinuous function of the iterate: where two entries
of a tile lie closer than the packages' float32 rounding differences, each
package may keep a different one, and the iterates then differ by a whole
scale. The reference's default model keeps attention scores in bfloat16,
which XLA and PyTorch round at different points, so the engines are compared
with float32 compute and float32 scores in both packages; the model's own
parity in its default numerics is ``test_torch_model.py``'s.

Tolerances, those of ``tests/test_dist_equivalence.py``: params and x_hat
within ``atol = 5e-4``; ``triggers`` and ``sync_rounds`` exact; ``bits``
within ``rtol = 1e-6`` (float32 sums of per-node messages in another order).
The lr = 0 sync starts both from the same carried state, so both see the
same diff and the selected supports must be equal exactly.
"""
import collections
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.registry import get_config as jget  # noqa: E402
from repro.core import compression as jcomp  # noqa: E402
from repro.core import faults as jfaults  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.core import topology as jtopo  # noqa: E402
from repro.core import triggers as jtrig  # noqa: E402
from repro.dist import sharding as jsh  # noqa: E402
from repro.dist.sparq_dist import DistSparqConfig as JDcfg  # noqa: E402
from repro.dist.sparq_dist import build_sparq as jbuild  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import transformer as jtf  # noqa: E402
from repro_torch.configs.registry import get_config as tget  # noqa: E402
from repro_torch.core import compression as tcomp  # noqa: E402
from repro_torch.core import faults as tfaults  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.core import topology as ttopo  # noqa: E402
from repro_torch.core import triggers as ttrig  # noqa: E402
from repro_torch.dist.sparq_dist import DistSparqConfig, build_sparq  # noqa: E402
from repro_torch.kernels.sign_topk import sign_topk_blocks  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models.transformer import params_from_jax  # noqa: E402

N, T = 4, 5
# a knob whose value is an object of each package: (reference's, port's)
Pair = collections.namedtuple("Pair", "j t")


@pytest.fixture(autouse=True)
def same_stream():
    """The port draws from the threefry stream JAX is set to."""
    with prng.threefry_partitionable(jax.config.jax_threefry_partitionable):
        yield


@pytest.fixture
def float32_scores(monkeypatch):
    monkeypatch.setattr(jattn, "chunked_attention", functools.partial(
        jattn.chunked_attention, score_dtype=jnp.float32))
    monkeypatch.setattr(tattn, "chunked_attention", functools.partial(
        tattn.chunked_attention, score_dtype=torch.float32))


def _setup():
    kw = dict(n_nodes=N, compute_dtype="float32")
    small = dict(n_layers=1, d_model=128, vocab=256)
    jc = dataclasses.replace(jget("qwen1.5-0.5b").reduced(**small), **kw)
    tc = dataclasses.replace(tget("qwen1.5-0.5b").reduced(**small), **kw)
    rng = np.random.default_rng(0)
    batch = {k: rng.integers(0, jc.vocab_size, (N, 2, 16)).astype(np.int32)
             for k in ("tokens", "labels")}
    p0 = jtf.init_params(jc, jax.random.PRNGKey(0))
    return jc, tc, batch, p0


def _engines(jc, tc, thr, H, beta, variant, lr=0.05, extra=None):
    """Both engines with the same knobs; schedules named by factory so each
    package builds its own, and a ``Pair`` knob gives each its object."""
    common = {**dict(H=H, variant=variant, frac=0.25, use_kernel=True,
                     gamma=0.3, momentum=beta), **(extra or {})}

    def side(which):
        return {k: getattr(v, which) if isinstance(v, Pair) else v
                for k, v in common.items()}
    mesh = jsh.train_mesh(jax.make_mesh((1, 1), ("data", "model")), jc)
    jinit, jstep, _, _ = jbuild(jc, mesh, JDcfg(
        threshold=thr(jtrig), lr=jsched.fixed(lr), **side("j")))
    tinit, tstep, _ = build_sparq(tc, DistSparqConfig(
        threshold=thr(ttrig), lr=tsched.fixed(lr), **side("t")),
        device="cpu")
    return (jinit, jax.jit(jstep)), (tinit, tstep)


def _always(m):
    return m.zero()


def _never(m):
    return m.constant(1e12)


def _faults(mod):
    """30 % link drop, node 1 straggling half its steps, node 2 offline
    across the first sync (the reference's own fault case)."""
    return mod.FaultPlan(link_drop=0.3, stragglers=(1,), straggler_frac=0.5,
                         dropout=(mod.DropoutWindow(2, 1, 3),), seed=5)


FAULTS = {"faults": Pair(_faults(jfaults), _faults(tfaults))}
GENERIC = {"use_kernel": False}
CASES = [("always-dense", _always, 2, 0.0, "dense", None),
         ("never-dense", _never, 3, 0.0, "dense", None),
         ("momentum-dense", _always, 2, 0.9, "dense", None),
         ("always-ring", _always, 3, 0.0, "ring", None),
         ("momentum-ring", _always, 2, 0.9, "ring", None),
         ("never-ring", _never, 2, 0.0, "ring", None),
         ("nesterov-torus", _always, 2, 0.9, "dense",
          {"topology": "torus2d", "nesterov": True}),
         ("bf16-xhat-microbatches", _always, 2, 0.0, "ring",
          {"xhat_dtype": "bfloat16", "microbatches": 2}),
         # faults: the ring variant falls back to the dense product
         ("faults-sgd-ring", _always, 2, 0.0, "ring", FAULTS),
         ("faults-momentum-dense", _always, 2, 0.9, "dense", FAULTS),
         # time-varying plans, one per family
         ("matchings", _always, 2, 0.0, "ring",
          {"dynamic": "matchings", "rounds": 3, "topo_seed": 2}),
         ("edges", _always, 2, 0.0, "dense",
          {"topology": "complete", "dynamic": "edges", "rounds": 3,
           "edge_frac": 0.6, "topo_seed": 1}),
         ("cycle", _always, 2, 0.0, "dense",
          {"topology": "expander", "deg": 2, "dynamic": "cycle",
           "rounds": 2, "topo_seed": 1}),
         # the generic path: global TopFrac, and a stochastic operator
         ("generic-topfrac", _always, 2, 0.0, "ring", GENERIC),
         ("generic-qsgd", _always, 2, 0.0, "dense",
          dict(GENERIC, compressor=Pair(jcomp.QSGD(s=16), tcomp.QSGD(s=16)),
               seed=3)),
         ("generic-faults-matchings", _always, 2, 0.9, "dense",
          dict(GENERIC, dynamic="matchings", rounds=3, **FAULTS))]


@pytest.mark.parametrize("name,thr,H,beta,variant,extra", CASES,
                         ids=[c[0] for c in CASES])
def test_engine_matches_reference(float32_scores, name, thr, H, beta,
                                  variant, extra):
    jc, tc, batch, p0 = _setup()
    (jinit, jstep), (tinit, tstep) = _engines(jc, tc, thr, H, beta, variant,
                                              extra=extra)
    assert tstep.payload_bits == jstep.payload_bits
    assert tstep.gamma == jstep.gamma and tstep.n_nodes == jstep.n_nodes
    js = jinit(jax.random.PRNGKey(0))
    ts = tinit(params=params_from_jax(tc, jax.tree.map(np.asarray, p0)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(T):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
    np.testing.assert_allclose(ts["params"].numpy(), np.asarray(js["params"]),
                               atol=5e-4, rtol=0)
    assert str(ts["x_hat"].dtype).endswith(str(js["x_hat"].dtype))
    np.testing.assert_allclose(ts["x_hat"].float().numpy(),
                               np.asarray(js["x_hat"].astype(jnp.float32)),
                               atol=5e-4, rtol=0)
    assert int(ts["triggers"]) == int(js["triggers"])
    assert ts["sync_rounds"] == int(js["sync_rounds"])
    assert ts["t"] == int(js["t"]) == T
    np.testing.assert_allclose(float(ts["bits"]), float(js["bits"]),
                               rtol=1e-6)
    D = tstep.d_model_total
    assert not ts["params"][:, D:].any() and not ts["x_hat"][:, D:].any()
    if name.startswith("never"):
        assert int(ts["triggers"]) == 0 and not ts["x_hat"].any()


def test_sync_at_zero_lr_selects_the_reference_support(float32_scores):
    """Carry the reference's state over 3 steps (one sync), hand it to the
    port, and take one more sync step at lr = 0 in both: x^{t+1/2} is the
    carried iterate exactly, so both see the same diff, and the supports of
    q (where x_hat moved) must be equal exactly."""
    jc, tc, batch, p0 = _setup()
    (jinit, jstep), _ = _engines(jc, tc, _always, 2, 0.0, "dense")
    js = jinit(jax.random.PRNGKey(0))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(3):
        js, _ = jstep(js, jb)
    (_, jstep0), (tinit, tstep0) = _engines(jc, tc, _always, 2, 0.0,
                                            "dense", lr=0.0)
    ts = tinit(params=params_from_jax(tc, jax.tree.map(np.asarray, p0)))
    ts["params"].copy_(torch.tensor(np.asarray(js["params"])))
    ts["x_hat"].copy_(torch.tensor(np.asarray(js["x_hat"])))
    ts["t"], ts["sync_rounds"] = int(js["t"]), int(js["sync_rounds"])
    ts["triggers"].fill_(int(js["triggers"]))
    ts["bits"].fill_(float(js["bits"]))
    ts["bits_c"].fill_(float(js["bits_c"]))
    xe0 = np.asarray(js["x_hat"])
    js1, _ = jstep0(js, jb)
    launches = sign_topk_blocks.launches
    ts1, _ = tstep0(ts, batch)
    assert sign_topk_blocks.launches == launches   # CPU: plain version
    moved_j = np.asarray(js1["x_hat"]) != xe0
    moved_t = ts1["x_hat"].numpy() != xe0
    assert moved_j.sum() > 0
    np.testing.assert_array_equal(moved_t, moved_j)
    assert int(ts1["triggers"]) == int(js1["triggers"])
    assert float(ts1["bits"]) == pytest.approx(float(js1["bits"]), rel=1e-6)


def test_unported_options_raise():
    """What the engine still refuses, as the reference refuses it: an
    unknown mixing variant, a custom compressor on the kernel path (which
    hard-wires BlockTopFrac), a time-varying family on an explicit
    Topology, and gamma* of a custom compressor without the dimension."""
    _, tc, _, _ = _setup()
    base = dict(use_kernel=True, frac=0.25)
    with pytest.raises(ValueError, match="variant"):
        build_sparq(tc, DistSparqConfig(variant="nope", **base),
                    device="cpu")
    with pytest.raises(ValueError, match="compressor"):
        build_sparq(tc, DistSparqConfig(compressor=tcomp.QSGD(), **base),
                    device="cpu")
    ring = ttopo.make_topology("ring", N)
    with pytest.raises(ValueError, match="ambiguous"):
        build_sparq(tc, DistSparqConfig(topology=ring, dynamic="matchings",
                                        **base), device="cpu")
    for cfg, comp, topo in ((DistSparqConfig, tcomp, ttopo),
                            (JDcfg, jcomp, jtopo)):
        with pytest.raises(ValueError, match="compressor"):
            cfg(compressor=comp.QSGD(), **base).resolved_compressor()
        with pytest.raises(ValueError, match="dimension"):
            cfg(compressor=comp.QSGD()).resolved_gamma(
                topo.make_topology("ring", N))


def test_engine_takes_frontend_embeds_like_the_reference(float32_scores):
    """The audio config's batch of frontend embeds (float32, with labels),
    as the reference's dry run hands it to its engine: the port's engine
    keeps the embeds' float dtype and matches the reference's losses."""
    kw = dict(n_nodes=N, compute_dtype="float32")
    small = dict(n_layers=1, d_model=128, vocab=256)
    jc = dataclasses.replace(jget("musicgen-large").reduced(**small), **kw)
    tc = dataclasses.replace(tget("musicgen-large").reduced(**small), **kw)
    rng = np.random.default_rng(1)
    batch = {"labels": rng.integers(0, jc.vocab_size,
                                    (N, 2, 16)).astype(np.int32),
             "embeds": rng.standard_normal((N, 2, 16, jc.d_model)
                                           ).astype(np.float32)}
    p0 = jtf.init_params(jc, jax.random.PRNGKey(0))
    (jinit, jstep), (tinit, tstep) = _engines(jc, tc, _always, 2, 0.0,
                                              "ring")
    js = jinit(jax.random.PRNGKey(0))
    ts = tinit(params=params_from_jax(tc, jax.tree.map(np.asarray, p0)))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(2):
        js, jm = jstep(js, jb)
        ts, tm = tstep(ts, batch)
        assert float(tm["loss"]) == pytest.approx(float(jm["loss"]),
                                                  rel=1e-5)
    np.testing.assert_allclose(ts["params"].numpy(), np.asarray(js["params"]),
                               atol=5e-4, rtol=0)
