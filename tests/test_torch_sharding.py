"""Port parity, sharding rules: ``repro_torch.dist.sharding`` against
``repro.dist.sharding`` at the reference's own abstract meshes, with no
devices, and the mesh factoring of ``train_mesh``, ``serve_mesh`` and the
train CLI against the reference's.

Every comparison is exact: a spec is the same axis name or None per
dimension (the reference's ``PartitionSpec`` padded with None to the
leaf's rank), and a factoring is the same sizes.

Both sides read the same shape trees: the port's ``param_shapes`` and its
meta ``init_cache`` as ``ShapeDtypeStruct`` trees for the reference (the
trees themselves are held against the reference's in
``tests/test_torch_serve.py``).
"""
import dataclasses
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.dist import sharding as jsh  # noqa: E402
from repro_torch.configs import registry as treg  # noqa: E402
from repro_torch.dist import comm, sharding as tsh  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.models.transformer import init_cache, param_shapes  # noqa

TRAIN_SIZES = {"node": 16, "fsdp": 16, "model": 2}
SERVE_SIZES = {"data": 16, "model": 16}
JDTYPE = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
          torch.int32: jnp.int32}


def _amesh(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _sds(tree):
    """The port's shape tree (tuples or meta tensors) as ShapeDtypeStructs."""
    if isinstance(tree, dict):
        return {k: _sds(v) for k, v in tree.items()}
    if isinstance(tree, tuple):
        return jax.ShapeDtypeStruct(tree, jnp.float32)
    return jax.ShapeDtypeStruct(tuple(tree.shape), JDTYPE[tree.dtype])


def _walk(tree, path=()):
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _walk(tree[k], path + (k,))
        else:
            yield path + (k,), tree[k]


def _padded(spec, ndim):
    spec = tuple(spec)
    return spec + (None,) * (ndim - len(spec))


def _same_specs(got, want, shapes, extra=0):
    g, w, s = dict(_walk(got)), dict(_walk(want)), dict(_walk(shapes))
    assert g.keys() == w.keys()
    for path in w:
        ndim = len(tsh.leaf_shape(s[path])) + extra
        assert tuple(g[path]) == _padded(w[path], ndim), path


@pytest.mark.parametrize("node_dim", [False, True])
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_param_specs_equal_reference(arch, node_dim):
    pshape = param_shapes(treg.get_config(arch))
    want = jsh.param_specs(_sds(pshape), _amesh(TRAIN_SIZES),
                           node_dim=node_dim)
    got = tsh.param_specs(pshape, TRAIN_SIZES, node_dim=node_dim)
    _same_specs(got, want, pshape, extra=int(node_dim))
    # and on the serve view, where there is no fsdp axis
    _same_specs(tsh.param_specs(pshape, SERVE_SIZES),
                jsh.param_specs(_sds(pshape), _amesh(SERVE_SIZES)), pshape)


@pytest.mark.parametrize("cache_mode", ["auto", "inner", "seq"])
@pytest.mark.parametrize("arch", treg.ARCH_IDS)
def test_cache_specs_equal_reference(arch, cache_mode):
    cfg = treg.get_config(arch)
    for batch, clen in ((128, 1024), (8, 1000)):
        cshape = init_cache(cfg, batch, clen, device="meta")
        want = jsh.cache_specs(_sds(cshape), _amesh(SERVE_SIZES),
                               cache_mode=cache_mode)
        got = tsh.cache_specs(cshape, SERVE_SIZES, cache_mode=cache_mode)
        _same_specs(got, want, cshape)
    with pytest.raises(ValueError, match="cache_mode"):
        tsh.cache_specs(cshape, SERVE_SIZES, cache_mode="rows")


@pytest.mark.parametrize("shape", [(16, 16, 4096), (16, 3, 4096),
                                   (16, 32, 128), (16, 2), (4, 1, 8, 8)])
def test_train_batch_specs_equal_reference(shape):
    for sizes in (TRAIN_SIZES, {"node": 4, "fsdp": 1, "model": 2},
                  {"node": 2, "fsdp": 2, "model": 1}):
        bshape = {"tokens": shape, "labels": shape}
        want = jsh.train_batch_specs(
            {k: jax.ShapeDtypeStruct(v, jnp.int32)
             for k, v in bshape.items()}, _amesh(sizes))
        got = tsh.train_batch_specs(bshape, sizes)
        for k in bshape:
            assert got[k] == tuple(want[k]), (sizes, k)
        # the engine splits the per-node batch where the spec puts fsdp
        # (the reference names the axis at size 1 too)
        per = shape[1] if len(shape) > 1 else 0
        split = tsh.fsdp_split(per, sizes["fsdp"])
        assert (split > 1) == (sizes["fsdp"] > 1
                               and got["tokens"][1] == "fsdp")


# ----------------------------------- the cases of tests/test_sharding_specs.py

@pytest.mark.parametrize("arch", ["qwen1.5-0.5b", "deepseek-v3-671b",
                                  "mamba2-370m", "zamba2-7b"])
def test_every_leaf_gets_a_divisible_spec(arch):
    pshape = param_shapes(treg.get_config(arch))
    specs = tsh.param_specs(pshape, TRAIN_SIZES, node_dim=True)
    for path, shape in _walk(pshape):
        spec = dict(_walk(specs))[path]
        assert len(spec) == len(shape) + 1
        for dim, ax in zip((16,) + shape, spec, strict=True):
            if ax is not None:
                assert dim % TRAIN_SIZES[ax] == 0, (path, spec)


def test_embedding_vocab_not_divisible_is_replicated():
    pshape = param_shapes(treg.get_config("mamba2-370m"))  # vocab 50280
    specs = tsh.param_specs(pshape, {"node": 4, "fsdp": 1, "model": 16})
    assert specs["embed"]["embedding"][0] is None


def test_moe_experts_sharded_over_model():
    pshape = param_shapes(treg.get_config("deepseek-v3-671b"))
    specs = tsh.param_specs(pshape, TRAIN_SIZES)
    assert specs["seg1"]["moe"]["w_gate"][1] == "model"   # (L, E, D, F)


def test_cache_specs_decode():
    cshape = init_cache(treg.get_config("qwen1.5-32b"), 128, 1024,
                        device="meta")
    specs = tsh.cache_specs(cshape, SERVE_SIZES)
    k_spec = specs["kv"]["k"]                              # (L, B, C, H, hd)
    assert k_spec[1] == "data" and "model" in k_spec
    assert all(a is None for a in specs["kv"]["pos"])


def test_train_batch_specs():
    assert tsh.train_batch_specs({"tokens": (16, 16, 4096)},
                                 TRAIN_SIZES)["tokens"] == \
        ("node", "fsdp", None)
    assert tsh.train_batch_specs({"tokens": (16, 3, 4096)},
                                 TRAIN_SIZES)["tokens"] == \
        ("node", None, None)


def test_train_mesh_reshape_properties():
    """The logical view is a pure reshape of the production ranks."""
    shape = tsh.train_mesh_shape((16, 16), 16)
    assert shape == (16, 1, 16)
    ranks = np.arange(256).reshape(16, 16)
    assert np.array_equal(ranks.reshape(shape).reshape(16, 16), ranks)
    cfg = treg.get_config("deepseek-v3-671b")
    node, fsdp, model = tsh.train_mesh_shape((2, 16, 16), cfg.n_nodes,
                                             cfg.pod_axis_to)
    assert node * fsdp * model == 512 and model == 16


# ------------------------------------------------------------ mesh factoring

class _FakeProd:
    def __init__(self, shape):
        self.devices = np.arange(math.prod(shape)).reshape(shape)


@pytest.fixture
def ref_views(monkeypatch):
    """The reference's ``train_mesh``/``serve_mesh`` with its ``Mesh``
    recorded as (shape, axis names): its factoring with no devices."""
    monkeypatch.setattr(jsh, "Mesh", lambda devs, names: (devs.shape,
                                                          tuple(names)))
    return jsh


PROD_SHAPES = [(1, 1), (2, 1), (4, 1), (4, 2), (8, 1), (6, 2), (12, 1),
               (16, 16), (3, 4), (2, 4, 2), (2, 16, 16), (2, 3, 1)]


@pytest.mark.parametrize("prod", PROD_SHAPES, ids=str)
def test_train_and_serve_mesh_equal_reference(ref_views, prod):
    for n_nodes in (1, 2, 3, 4, 6, 16, 24):
        for pod_axis_to in ("node", "fsdp"):
            cfg = dataclasses.replace(treg.get_config("qwen1.5-0.5b"),
                                      n_nodes=n_nodes,
                                      pod_axis_to=pod_axis_to)
            shape, names = ref_views.train_mesh(_FakeProd(prod), cfg)
            assert names == tsh.TRAIN_AXES
            assert tsh.train_mesh_shape(prod, n_nodes, pod_axis_to) == \
                tuple(shape), (n_nodes, pod_axis_to)
    shape, names = ref_views.serve_mesh(_FakeProd(prod))
    assert names == tsh.SERVE_AXES
    assert tsh.serve_mesh_shape(prod) == tuple(shape)


def _ref_cli_factoring(ndev, n_nodes):
    """``repro/launch/train.py:125-140`` as it stands there (the CLI's
    body, not a function)."""
    n_nodes = min(n_nodes, ndev)
    while ndev % n_nodes:
        n_nodes -= 1
    rest = ndev // n_nodes
    model_par = 1
    for m in (16, 8, 4, 2, 1):
        if rest % m == 0:
            model_par = m
            break
    return n_nodes, model_par


@pytest.mark.parametrize("ndev", [1, 2, 3, 4, 6, 8, 12, 16, 32, 48, 256])
def test_cli_factoring_equals_reference(ref_views, ndev):
    for n_nodes in (1, 2, 3, 4, 5, 8, 16, 24):
        want = _ref_cli_factoring(ndev, n_nodes)
        assert tsh.cli_factoring(ndev, n_nodes) == want
        # the train view the CLI then builds on the production grid
        nodes, model_par = want
        cfg = dataclasses.replace(treg.get_config("qwen1.5-0.5b"),
                                  n_nodes=nodes)
        prod = (ndev // model_par, model_par)
        shape, _ = ref_views.train_mesh(_FakeProd(prod), cfg)
        assert tsh.train_mesh_shape(prod, nodes) == tuple(shape)


# ----------------------------------------------- on a DeviceMesh of one rank

def test_meshes_and_placements_on_one_rank():
    """``make_production_mesh`` and the two views over a gloo group of this
    one process, and the DTensor placements of a few specs."""
    from torch.distributed.tensor import Replicate, Shard
    cfg = treg.get_config("qwen1.5-0.5b").reduced()
    with comm.single_rank_group("gloo", torch.device("cpu"), timeout_s=60):
        prod = tmesh.make_production_mesh(device_type="cpu")
        assert prod.mesh_dim_names == ("data", "model")
        assert tuple(prod.shape) == (1, 1)
        tm = tsh.train_mesh(prod, cfg)
        assert tsh.axis_sizes(tm) == {"node": 1, "fsdp": 1, "model": 1}
        assert tsh.coordinates(tm) == {"node": 0, "fsdp": 0, "model": 0}
        sm = tsh.serve_mesh(prod)
        assert tsh.axis_sizes(sm) == {"data": 1, "model": 1}
        assert tsh.placements(("node", None, "model"), tm) == (
            Shard(0), Replicate(), Shard(2))
        assert tsh.placements((None, None), sm) == (Replicate(), Replicate())
    with pytest.raises(ValueError, match="factor"):
        with comm.single_rank_group("gloo", torch.device("cpu"),
                                    timeout_s=60):
            tmesh.make_production_mesh(model=2, device_type="cpu")


def _paced_ranks(rank, rounds, pause_s):
    """``rounds`` all-reduces, ``pause_s`` apart on every rank: the run
    outlasts its group's timeout while no collective waits long."""
    import torch.distributed as dist
    total = torch.zeros(1)
    for _ in range(rounds):
        time.sleep(pause_s)
        one = torch.ones(1)
        dist.all_reduce(one)
        total += one
    return float(total)


def test_spawn_outlives_its_group_timeout():
    """Without a join deadline (as the train CLI starts its ranks), a run
    longer than its group's per-collective timeout finishes; with one,
    ``spawn`` stops the ranks and raises."""
    t0 = time.monotonic()
    out = comm.spawn(_paced_ranks, 2, (12, 0.5), timeout_s=5.0)
    assert time.monotonic() - t0 > 6.0
    assert out == [24.0, 24.0]
    with pytest.raises(TimeoutError, match="not done within 2 s"):
        comm.spawn(_paced_ranks, 2, (120, 0.5), timeout_s=5.0,
                   deadline_s=2.0)


def test_local_index_cuts_each_rank_block():
    x = torch.arange(4 * 6 * 3).reshape(4, 6, 3)
    sizes = {"data": 2, "model": 3}
    blocks = {}
    for d in range(2):
        for m in range(3):
            ix = tsh.local_index(("data", "model"), tuple(x.shape), sizes,
                                 {"data": d, "model": m})
            blocks[d, m] = x[ix]
            assert blocks[d, m].shape == (2, 2, 3)
    rows = [torch.cat([blocks[d, m] for m in range(3)], dim=1)
            for d in range(2)]
    assert torch.equal(torch.cat(rows, dim=0), x)


def test_h100_constants_are_the_data_sheet():
    assert tmesh.PEAK_FLOPS_BF16 == 989.4e12
    assert tmesh.HBM_BW == 3.35e12
    assert tmesh.NVLINK_BW == 900e9
