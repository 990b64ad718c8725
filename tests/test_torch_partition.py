"""The port's partitioning rules (``repro_torch.distributed.partition``),
mesh context (``models.shardctx``) and elastic mesh shapes
(``distributed.elastic.choose_mesh_shape``) against the JAX package's.

Both packages' spec functions read only a mesh's axis names and sizes,
so stand-in mesh objects serve on both sides (``axis_names`` and
``devices.shape`` for the reference, ``mesh_dim_names`` and ``shape``
for the port) and every config is held at full size: the reference's
parameters and caches as ``jax.eval_shape`` structs, the port's as
shapes without data (``FakeTensorMode``, ``meta``). Every spec must be
equal, leaf for leaf.
"""

import functools
import types

import jax
import jax.numpy as jnp
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro.configs import base as ref_configs
from repro.distributed import elastic as ref_elastic
from repro.distributed import partition as ref_partition
from repro.models import layers as ref_L
from repro.models import shardctx as ref_shardctx
from repro.models import transformer as ref_T
from repro_torch.configs import base as configs
from repro_torch.distributed import elastic, partition
from repro_torch.models import layers as L
from repro_torch.models import shardctx
from repro_torch.models import transformer as T

# the reference's configs: each is compared with its counterpart there
ARCHS = ref_configs.all_names()
MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "1x1": ((1, 1), ("data", "model"))}
CACHE_SHAPE = (4, 64)  # batch, positions of the caches held here


def _ref_mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(axis_names=axes,
                                 devices=types.SimpleNamespace(shape=shape))


def _mesh(name):
    shape, axes = MESHES[name]
    return types.SimpleNamespace(mesh_dim_names=axes, shape=shape)


def _ref_flat(tree, is_leaf=None):
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            tree, is_leaf=is_leaf)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        out[key] = leaf
    return out


def _flat(tree):
    out = {}
    partition.map_with_path(
        lambda path, leaf: out.__setitem__("/".join(path), leaf), tree)
    return out


def _is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


@functools.cache
def _ref_shapes(arch):
    cfg = ref_configs.get(arch)
    params = jax.eval_shape(
        lambda k: ref_T.init_params(k, cfg, ref_L.FP32),
        jax.ShapeDtypeStruct((2,), jnp.uint32))
    cache = jax.eval_shape(
        lambda: ref_T.init_cache(cfg, *CACHE_SHAPE, ref_L.FP32))
    return params, cache


@functools.cache
def _shapes(arch):
    cfg = configs.get(arch)
    with FakeTensorMode():
        params = T.init_params(torch.Generator(), cfg, L.FP32, device="cpu")
    params = partition.map_with_path(
        lambda _, x: torch.empty(x.shape, dtype=x.dtype, device="meta"),
        params)
    cache = T._cache(cfg, *CACHE_SHAPE, L.FP32, torch.device("meta"))
    return params, cache


def _same(got, want):
    """Two flat spec dicts hold the same keys and the same entries."""
    assert sorted(got) == sorted(want)
    for k in want:
        assert tuple(got[k]) == tuple(want[k]), k


@pytest.mark.parametrize("arch", ARCHS)
def test_param_and_opt_specs_match_reference(arch):
    ref_params, _ = _ref_shapes(arch)
    params, _ = _shapes(arch)
    want = ref_partition.param_specs(ref_params)
    got = partition.param_specs(params)
    _same(_flat(got), _ref_flat(want, _is_spec))
    ref_opt = ref_partition.opt_specs(ref_params)
    opt = partition.opt_specs(params)
    _same(_flat(opt), _ref_flat(ref_opt, _is_spec))
    for name in MESHES:
        _same(_flat(partition.validate_divisibility(got, params,
                                                    _mesh(name))),
              _ref_flat(ref_partition.validate_divisibility(
                  want, ref_params, _ref_mesh(name)), _is_spec))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("long_context", [False, True])
def test_cache_specs_match_reference(arch, long_context):
    _, ref_cache = _ref_shapes(arch)
    _, cache = _shapes(arch)
    for name in MESHES:
        want = ref_partition.cache_specs(ref_cache, _ref_mesh(name),
                                         long_context=long_context)
        got = partition.cache_specs(cache, _mesh(name),
                                    long_context=long_context)
        _same(_flat(got), _ref_flat(want, _is_spec))
        _same(_flat(partition.validate_divisibility(got, cache,
                                                    _mesh(name))),
              _ref_flat(ref_partition.validate_divisibility(
                  want, ref_cache, _ref_mesh(name)), _is_spec))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("long_context", [False, True])
def test_batch_spec_matches_reference(mesh, long_context):
    want = ref_partition.batch_spec(_ref_mesh(mesh),
                                    long_context=long_context)
    got = partition.batch_spec(_mesh(mesh), long_context=long_context)
    _same(_flat(got), _ref_flat(want, _is_spec))


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mesh = _mesh("2x16x16")
    assert partition.placements_of(partition.P(("pod", "data"), None),
                                   mesh) == (Shard(0), Shard(0), Replicate())
    assert partition.placements_of(partition.P("model", "data"), mesh) == (
        Replicate(), Shard(1), Shard(0))
    assert partition.placements_of(partition.P(), mesh) == (Replicate(),) * 3


@pytest.mark.parametrize("mesh", list(MESHES))
def test_attn_spec_and_axis_size_match_reference(mesh):
    cases = [(h, b) for h in (1, 4, 8, 32, 40, 64) for b in (1, 4, 16, 256)]
    try:
        ref_shardctx.set_mesh_ctx(_ref_mesh(mesh), ("data",))
        shardctx.set_mesh_ctx(_mesh(mesh), ("data",))
        for h, b in cases:
            assert shardctx.attn_spec(h, b) == ref_shardctx.attn_spec(h, b)
        for ax in ("data", "model", "pod", ("data", "model"),
                   ("pod", "data")):
            assert shardctx.axis_size(ax) == ref_shardctx.axis_size(ax)
    finally:
        ref_shardctx.clear_mesh_ctx()
        shardctx.clear_mesh_ctx()
    assert shardctx.attn_spec(8, 4) is None and shardctx.axis_size("data") == 1


def test_choose_mesh_shape_matches_reference():
    for n in range(1, 513):
        for prefer in (16, 8, 4, 2, 1):
            assert (elastic.choose_mesh_shape(n, prefer_model=prefer)
                    == ref_elastic.choose_mesh_shape(n, prefer_model=prefer))


def test_constrain_passes_plain_tensors_through():
    x = torch.ones(4, 8)
    shardctx.set_mesh_ctx(_mesh("2x4"))
    try:
        assert shardctx.constrain(x, ("data",), "model") is x
    finally:
        shardctx.clear_mesh_ctx()
    assert shardctx.constrain(x, "data", None) is x


@pytest.mark.parametrize("h,hk,off,hl", [(40, 8, 10, 10), (32, 8, 4, 2),
                                         (12, 4, 3, 6), (8, 8, 4, 4)])
def test_flash_local_with_a_head_offset_matches_the_whole_call(h, hk, off,
                                                               hl):
    """The GQA trap: a rank's query heads ``[off, off + hl)`` (q's heads
    sharded, k's not) must meet their global kv heads, not ``h_local //
    rep``: ``flash_mha_local`` with the global offset against the same
    heads of the whole call, bit for bit (the plain version computes each
    head alone)."""
    from repro_torch.models import flash
    b, s, d = 2, 32, 8
    g = torch.Generator().manual_seed(h + off)
    q, k, v = (torch.randn(b, s, n, d, generator=g) for n in (h, hk, hk))
    want = flash.flash_mha(q, k, v, causal=True, q_block=16,
                           kv_block=16)[:, :, off:off + hl]
    got = flash.flash_mha_local(q[:, :, off:off + hl], k, v, rep=h // hk,
                                q_head_offset=off, causal=True, q_block=16,
                                kv_block=16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
