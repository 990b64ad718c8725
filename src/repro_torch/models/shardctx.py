"""Mesh context for model-internal sharding constraints, and the local
regions where kernels run on shards.

The port of ``src/repro/models/shardctx.py``. The model code stays
mesh-agnostic; launchers call ``set_mesh_ctx`` and layers apply
``constrain`` hints. Dims that don't divide their mesh axes are
auto-dropped, so reduced configs and the production ones share one code
path. ``constrain`` is ``DTensor.redistribute`` to the spec's placements;
a plain tensor, or no mesh, passes through unchanged.

The kernels (K6-K9) launch through ``ctypes`` and take no DTensor. Where
a kernel's call site receives DTensors it runs the kernel (its plain
version on the CPU) on the local shards of a layout that makes the
shards independent, and wraps the result back into a DTensor:
``local`` (``redistribute`` then ``to_local``) and ``wrap``
(``DTensor.from_local``), both differentiable. An input the local call
reads whole on every rank of a mesh dim along which the computation
differs (a weight against batch shards, keys against head shards) gets a
``Partial`` gradient on that mesh dim: each rank's part of it is summed.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distributed.partition import (contiguous_stride,
                                               placements_of, shard_range)

_MESH = None
_DP: tuple = ("data",)


def set_mesh_ctx(mesh, dp_axes=("data",)):
    global _MESH, _DP
    _MESH = mesh
    _DP = tuple(dp_axes)


def clear_mesh_ctx():
    set_mesh_ctx(None)


def mesh():
    return _MESH


def dp_axes() -> tuple:
    return _DP


def axis_size(name) -> int:
    if _MESH is None:
        return 1
    sizes = dict(zip(_MESH.mesh_dim_names, tuple(_MESH.shape)))
    names = name if isinstance(name, tuple) else (name,)
    return math.prod(sizes.get(n, 1) for n in names)


def constrain(x, *spec):
    """``x`` redistributed to ``spec``'s placements, each sharded dim
    dropped where its mesh axes do not divide it (or have size 1)."""
    if _MESH is None or not isinstance(x, DTensor):
        return x
    fixed = []
    for dim, ax in enumerate(spec):
        if ax is None:
            fixed.append(None)
            continue
        need = axis_size(ax)
        fixed.append(ax if need > 1 and x.shape[dim] % need == 0 else None)
    if all(a is None for a in fixed):
        return x
    return x.redistribute(_MESH, placements_of(fixed, _MESH))


def replicating():
    """With a mesh set, a context in which plain tensors meeting DTensors
    count as replicated (``implicit_replication``); else a no-op."""
    return (implicit_replication() if _MESH is not None
            else contextlib.nullcontext())


def attn_spec(n_heads: int, batch: int):
    """Best sharding for (B, S, H, D) attention activations: heads over
    model when divisible, else fold model into the batch dim, else
    batch-only."""
    if _MESH is None:
        return None
    m = axis_size("model")
    dp = axis_size(_DP)
    if n_heads % m == 0:
        return (_DP, None, "model", None)
    if batch % (dp * m) == 0:
        return (tuple(_DP) + ("model",), None, None, None)
    # fallback: batch-only sharding. Attention compute replicates across
    # the model axis (visible in the compute term), but the flash loops
    # stay collective-free.
    return (_DP, None, None, None)


# ---------------------------------------------------------------------------
# local regions
# ---------------------------------------------------------------------------


def reshape(x, *shape):
    """``x.reshape(shape)``; for a DTensor whose shards the reshape cannot
    keep (a dim split into parts the mesh does not divide, as 40 heads
    over a model axis of 16), every shard but the batch dim's is gathered
    first, in the forward and in the backward alike."""
    if not isinstance(x, DTensor):
        return x.reshape(shape)
    return _Reshape.apply(x, shape)


def _reshape(x, shape):
    try:
        return x.reshape(shape)
    except RuntimeError:  # DTensor's view propagation refused the shards
        return x.redistribute(x.device_mesh,
                              keep(x.placements, (0,))).reshape(shape)


class _Reshape(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, shape):
        ctx.in_shape = tuple(x.shape)
        return _reshape(x, shape)

    @staticmethod
    def backward(ctx, g):
        return _reshape(g, ctx.in_shape), None


def gather_fsdp(w):
    """A weight with its shards over the data axes (``dp_axes``, the FSDP
    shards) gathered before use, its other shards (tensor parallelism)
    kept; its gradient, partial over those axes, is reduce-scattered back
    by the redistribute's backward. A plain tensor as it is."""
    if not isinstance(w, DTensor):
        return w
    m = w.device_mesh
    pl = tuple(Replicate() if n in _DP and isinstance(p, Shard)
               and m.size(i) > 1 else p
               for i, (n, p) in enumerate(zip(m.mesh_dim_names, w.placements)))
    return w if pl == tuple(w.placements) else w.redistribute(
        w.device_mesh, pl)


def gather_seq(x):
    """``x`` (B, S, ...) with any shard of its sequence dim gathered:
    where a norm ends and the projections begin under sequence
    parallelism (the all-gather XLA inserts for the reference)."""
    if not isinstance(x, DTensor) or Shard(1) not in x.placements:
        return x
    return x.redistribute(x.device_mesh, tuple(
        Replicate() if pl == Shard(1) else pl for pl in x.placements))


def gather_seq_grad(y):
    """``y`` as it is, its gradient with any sequence shard gathered: the
    layer's branch output (B, S, d) added to a residual stream that the
    layer boundary shards over the sequence, so that the products behind
    it see their gradient whole along S (some torch releases cannot
    flatten (B, S) with S sharded)."""
    if not isinstance(y, DTensor):
        return y
    return _GatherSeqGrad.apply(y)


class _GatherSeqGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, g):
        return gather_seq(g)


def settle(x):
    """A DTensor with its partial sums reduced (shards kept); anything
    else as it is. Some of DTensor's partial placements (a gather from a
    sharded dim) cannot follow a later index."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, keep(x.placements, range(x.ndim)))


def any_dtensor(*xs) -> bool:
    return any(isinstance(x, DTensor) for x in xs)


def mesh_of(*xs):
    return next(x.device_mesh for x in xs if isinstance(x, DTensor))


def local(x, mesh, placements, grads=None):
    """The local shard of ``x`` (a DTensor, or a plain tensor taken as
    replicated) redistributed to ``placements``; its gradient is read as
    a DTensor of ``grads`` (default ``placements``)."""
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    x = x.redistribute(mesh, tuple(placements))
    return x.to_local(grad_placements=None if grads is None
                      else tuple(grads))


def wrap(y, mesh, placements, shape):
    """The local result ``y`` as a DTensor of global ``shape``."""
    return DTensor.from_local(y, mesh, tuple(placements), run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


def keep(placements, dims) -> tuple:
    """``placements`` with every ``Shard`` of a tensor dim outside
    ``dims`` (and every ``Partial``) replaced by ``Replicate()``."""
    return tuple(pl if isinstance(pl, Shard) and pl.dim in dims
                 else Replicate() for pl in placements)


def follow(placements, mapping, otherwise=Replicate()) -> tuple:
    """Per mesh dim: ``mapping[d]`` where ``placements`` has ``Shard(d)``
    for a ``d`` in ``mapping``, else ``otherwise``."""
    return tuple(mapping.get(pl.dim, otherwise) if isinstance(pl, Shard)
                 else otherwise for pl in placements)


def write_row(cache, row, at) -> None:
    """``cache[b, at[b]] = row[b]`` in place, for a DTensor ``cache``
    ``(B, C, ...)``, ``row`` ``(B, ...)`` and positions ``at`` ``(B,)``
    in ``[0, C)``, on each rank's shard of the cache, whatever dims it is
    sharded on: a row outside the local positions writes nothing."""
    m = cache.device_mesh
    rep = [REPLICATE] * m.ndim
    cp = cache.placements
    vals, pos = local(row, m, rep), local(at, m, rep)
    (ob, lb), (os_, ls) = (shard_range(cache.shape[d], m, cp, d)
                           for d in (0, 1))
    vals, pos = vals[ob:ob + lb], pos[ob:ob + lb].long() - os_
    for d in range(2, cache.ndim):
        off, n = shard_range(cache.shape[d], m, cp, d)
        vals = vals.narrow(d - 1, off, n)
    loc = cache.to_local()
    inside = ((pos >= 0) & (pos < ls)).reshape((lb,) + (1,) * (vals.ndim - 1))
    pos = torch.clamp(pos, 0, ls - 1)
    bi = torch.arange(lb, device=loc.device)
    loc[bi, pos] = torch.where(inside, vals.to(loc.dtype), loc[bi, pos])


PARTIAL = Partial()
REPLICATE = Replicate()
