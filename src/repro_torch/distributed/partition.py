"""Partitioning rules: parameter, optimizer, batch and cache specs, and
their DTensor placements.

The port of ``src/repro/distributed/partition.py``. The strategy is the
reference's (single pod mesh ``("data", "model")`` = (16, 16); multi-pod
adds a leading ``"pod"`` axis used for data parallelism only):

  * 2D weight sharding: every large matrix is sharded on both axes,
    row-wise over ``"data"`` (FSDP: the weight is all-gathered before use
    and its gradient reduce-scattered) and column-wise over ``"model"``
    (tensor parallelism over heads, FFN, vocab and experts);
  * MoE experts: the expert dim over ``"model"``, the contracting dim
    over ``"data"``;
  * optimizer moments: their parameter's spec (float32, fully sharded);
  * activations: batch over data, sequence over model at the layer
    boundaries (``transformer.set_activation_sharding``);
  * decode caches: batch over data, kv heads over ``"model"``; a
    long-context (batch 1) cache shards the sequence over ``"data"``;
  * params are replicated across pods; the pod axis only reduces the
    gradients.

A spec is a ``P``: a tuple with one entry per tensor dim, each ``None``,
a mesh axis name, or a tuple of names (one tensor dim sharded over
several mesh dims, the first name outermost). The spec functions read
only the mesh's axis names and sizes (``mesh.mesh_dim_names`` and
``mesh.shape``, as a ``DeviceMesh`` has them), so a stand-in object with
those two attributes serves where no process group exists. They walk the
port's nested dicts (and the caches' tuples), whose keys are the
reference's; layer stacks carry a leading layer axis, as there.

``shardings_of`` turns specs into ``Sharding``s, a mesh with one DTensor
placement per mesh dim (``Shard(d)`` for the tensor dim whose entry names
that mesh dim, else ``Replicate()``), and ``distribute`` builds the
DTensors.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard


class P(tuple):
    """A partition spec: one entry per tensor dim (the reference's
    ``jax.sharding.PartitionSpec``, as a plain tuple). As there, an entry
    of one axis name in a tuple is that name."""

    def __new__(cls, *entries):
        return super().__new__(cls, (e[0] if isinstance(e, tuple)
                                     and len(e) == 1 else e
                                     for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


class Sharding(NamedTuple):
    """A mesh and one DTensor placement per mesh dim (the reference's
    ``NamedSharding``)."""
    mesh: object
    placements: tuple


# name -> spec for the TRAILING dims (leading stacked dims get None)
_RULES: dict[str, tuple] = {
    "embed": ("model", "data"),
    "lm_head": ("data", "model"),
    "final_norm": (None,),
    "enc_norm": (None,),
    # attention
    "wq": ("data", "model"),
    "wk": ("data", "model"),
    "wv": ("data", "model"),
    "wo": ("model", "data"),
    "q_norm": (None,),
    "k_norm": (None,),
    # MLA
    "wq_a": ("data", None),
    "wq_b": (None, "model"),
    "wkv_a": ("data", None),
    "wkv_b": (None, "model"),
    "q_a_norm": (None,),
    "kv_a_norm": (None,),
    # MLP
    "w_in": ("data", "model"),
    "w_gate": ("data", "model"),
    "w_out": ("model", "data"),
    # MoE (expert-stacked weights override by rank below)
    "router": ("data", None),
    # SSM
    "conv_w": (None, "model"),
    "conv_b": ("model",),
    "a_log": ("model",),
    "w_bc": ("data", None),
    "w_dt": ("data", "model"),
    "dt_bias": ("model",),
    "d_skip": ("model",),
    "norm_scale": ("model",),
    # norms
    "attn_norm": (None,),
    "mlp_norm": (None,),
    "cross_norm": (None,),
}

# MoE expert weights: (E, d, ff)-shaped -> EP over model, FSDP over data
_MOE_RULES = {
    "w_in": ("model", "data", None),
    "w_gate": ("model", "data", None),
    "w_out": ("model", None, "data"),
}


def map_with_path(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists, ``path``
    the keys (a tuple or list's indices as strings, as JAX names them)
    from the root; the tree's structure is kept."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, path + (str(k),))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        return type(tree)(map_with_path(fn, v, path + (str(i),))
                          for i, v in enumerate(tree))
    return fn(path, tree)


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of specs and trees of its
    structure."""
    return map_with_path(
        lambda path, s: fn(s, *(_at(t, path) for t in trees)), specs)


def _at(tree, path):
    for k in path:
        tree = tree[int(k)] if isinstance(tree, (tuple, list)) else tree[k]
    return tree


def axis_sizes(mesh) -> dict:
    """``{axis name: size}`` of ``mesh``."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def param_spec(path, leaf) -> P:
    names = [str(p) for p in path]
    key = names[-1]
    moe = any(n in ("moe",) for n in names)
    if moe and key in _MOE_RULES:
        trailing = _MOE_RULES[key]
    elif key in _RULES:
        trailing = _RULES[key]
    else:
        trailing = tuple([None] * leaf.ndim)
    pad = leaf.ndim - len(trailing)
    spec = (None,) * pad + tuple(trailing)
    return P(*spec[: leaf.ndim])


def param_specs(params):
    return map_with_path(param_spec, params)


def opt_specs(params):
    """Optimizer moments share their parameter's spec; step is replicated."""
    ps = param_specs(params)
    return {"m": ps, "v": ps, "step": P()}


def _dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def batch_spec(mesh, *, long_context: bool = False) -> dict:
    dp = _dp_axes(mesh)
    if long_context:  # batch=1: shard the sequence instead (SP)
        return {"tokens": P(None, "data"), "targets": P(None, "data")}
    return {"tokens": P(dp, None), "targets": P(dp, None)}


def cache_spec(path, leaf, mesh, *, long_context: bool = False) -> P:
    """Decode-cache specs: (stack, B, S, heads, hd)-style trees.

    The model axis lands on the kv-head dim when divisible, else on the
    head_dim, else on the sequence (the reference's fallback, which keeps
    caches with few kv heads from being replicated over the model
    axis)."""
    dp = _dp_axes(mesh)
    msize = axis_sizes(mesh).get("model", 1)
    names = [str(p) for p in path]
    nd = leaf.ndim
    if "ssm" in names:
        if "conv" in names:
            # (L, B, K-1, di)
            return P(None, dp, None, "model") if nd == 4 else P(*((None,) * nd))
        # h: (L, B, di, n) or (L, B, nh, hd, n)
        if nd == 4:
            return P(None, dp, "model", None)
        if nd == 5:
            return P(None, dp, "model", None, None)
    if nd == 5:  # (L, B, S, kv, hd)
        batch_ax = None if long_context else dp
        seq_ax = "data" if long_context else None
        if leaf.shape[3] % msize == 0:
            return P(None, batch_ax, seq_ax, "model", None)
        if leaf.shape[4] % msize == 0:
            return P(None, batch_ax, seq_ax, None, "model")
        if long_context:
            return P(None, None, ("data", "model"), None, None)
        return P(None, dp, "model", None, None)
    if nd == 4:  # mla: (L, B, S, r)
        seq_ax = "data" if long_context else None
        batch_ax = None if long_context else dp
        if leaf.shape[3] % msize == 0:
            return P(None, batch_ax, seq_ax, "model")
        return P(None, batch_ax, seq_ax, None)
    return P(*((None,) * nd))


def cache_specs(cache, mesh, *, long_context: bool = False):
    return map_with_path(
        lambda p, l: cache_spec(p, l, mesh, long_context=long_context), cache
    )


def placements_of(spec, mesh) -> tuple:
    """One placement per mesh dim: ``Shard(d)`` for the tensor dim ``d``
    whose entry names the mesh dim, else ``Replicate()``."""
    out = []
    for name in mesh.mesh_dim_names:
        dims = [d for d, ax in enumerate(spec)
                if ax == name or (isinstance(ax, tuple) and name in ax)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return tuple(out)


def shard_range(size: int, mesh, placements, dim: int) -> tuple[int, int]:
    """``(offset, length)`` of this rank's part of tensor dim ``dim`` (of
    global ``size``) under ``placements``, mesh dims in order, each split
    as ``torch.chunk`` splits (DTensor's layout)."""
    coord = mesh.get_coordinate()
    off = 0
    for i, pl in enumerate(placements):
        if isinstance(pl, Shard) and pl.dim == dim:
            n = mesh.size(i)
            chunk = -(-size // n)
            start = min(coord[i] * chunk, size)
            off += start
            size = max(min(chunk, size - start), 0)
    return off, size


def zeros(shape, spec, mesh, dtype, device):
    """A DTensor of zeros of global ``shape`` under ``spec``, each rank
    allocating only its own shard."""
    pl = placements_of(spec, mesh)
    local = [shard_range(n, mesh, pl, d)[1] for d, n in enumerate(shape)]
    return DTensor.from_local(
        torch.zeros(local, dtype=dtype, device=device), mesh, pl,
        run_check=False, shape=torch.Size(shape),
        stride=contiguous_stride(shape))


def contiguous_stride(shape) -> tuple:
    """The strides of a contiguous tensor of ``shape``, computed (making
    a tensor for them would count as an allocation in the account)."""
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= size
    return tuple(reversed(stride))


def shardings_of(specs, mesh):
    return map_specs(lambda s: Sharding(mesh, placements_of(s, mesh)), specs)


def validate_divisibility(specs, tree, mesh):
    """Replace specs whose sharded dims don't divide the mesh axis —
    keeps small/reduced configs distributable on the production mesh."""
    sizes = axis_sizes(mesh)

    def fix(spec, leaf):
        out = []
        for dim, ax in enumerate(spec):
            if ax is None:
                out.append(None)
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            need = math.prod(sizes[a] for a in axes)
            out.append(ax if leaf.shape[dim] % need == 0 else None)
        return P(*out)

    return map_specs(fix, specs, tree)


def distribute(tree, specs, mesh):
    """The tree's tensors (or arrays) as DTensors on ``mesh`` under
    ``specs``. Every rank must pass the same values: each keeps its own
    shard of its own copy, with no communication (a view where the shard
    is the whole tensor or a contiguous part of it)."""
    return map_specs(
        lambda s, leaf: place(leaf, Sharding(mesh, placements_of(s, mesh))),
        specs, tree)


def place(leaf, sharding: Sharding):
    """A host array or tensor (the same on every rank; or a DTensor,
    resharded) as a DTensor under ``sharding``."""
    if isinstance(leaf, DTensor):
        return leaf.redistribute(sharding.mesh, sharding.placements)
    t = torch.as_tensor(leaf)
    mesh, pl = sharding.mesh, tuple(sharding.placements)
    local = t
    for d, n in enumerate(t.shape):
        off, size = shard_range(n, mesh, pl, d)
        if size != n:
            local = local.narrow(d, off, size)
    return DTensor.from_local(local.contiguous(), mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())
