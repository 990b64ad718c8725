"""Per-device cost account of the ops that run: FLOPs, bytes, collectives.

The counterpart of ``src/repro/launch/hlo_cost.py``. The reference
parses XLA's optimized HLO, whose ``cost_analysis`` counts a while-loop
body once (so a scan over layers is under-counted by its trip count),
and multiplies loop bodies by their trip counts. The port runs eagerly:
``CostMode`` is a ``TorchDispatchMode`` that sees every op as it
executes, so every layer and every block of every loop is counted as it
runs, and nothing needs multiplying.

Under DTensors the mode lets DTensor's dispatch run first (it returns
``NotImplemented`` for a DTensor argument, as ``CommDebugMode`` does), so
it sees the ops on the local shards and the collectives DTensor launches
(``_c10d_functional``): every count is per device. Ops on ``FakeTensor``s
are not counted: DTensor's sharding propagation runs each new op
signature once on them to learn its output's shape. On ``meta`` tensors
nothing is allocated or computed; the dry run runs it so.

It records, per device:

  * ``flops``: dot FLOPs, ``2 · prod(out) · K`` for ``mm``, ``bmm``,
    ``addmm`` and ``baddbmm`` (every einsum and matmul reaches one);
  * ``flops_elementwise``: the output elements of each pointwise op and
    the input elements of each reduction (HLO's convention for
    ``reduce``);
  * ``bytes``: every op's tensor operands plus its outputs, views and
    metadata ops excluded (the reference's kernel-level traffic model,
    ``hlo_cost.py:12-13``). Eager execution fuses nothing, so this is
    more than XLA's fused count;
  * collective bytes by kind under the reference's ring conventions
    (``_COLLECTIVE_FACTORS``, ``hlo_cost.py:53-59``), from each
    collective's local output and its group's size.

Kernels under the account: a wrapper given a ``meta`` tensor (or a CPU
tensor) runs its plain version, so the account counts the plain
version's products, not the kernel's work. K6's plain loop
(``kernels/attention/ref.flash_gqa_ref``) computes every (512 × 512)
block pair, where the card kernel skips the blocks the causal mask (or
the window) hides: a causal prefill of n blocks counts n² block pairs
against the kernel's n(n+1)/2. K8's plain scan and K7's plain decode do
the kernel's arithmetic. A CUDA tensor never takes the plain version.
"""

from __future__ import annotations

import weakref

import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.launch import analysis

aten = torch.ops.aten

# c10d functional op name -> (kind, index of its group-name argument)
_COLLECTIVES = {
    "all_gather_into_tensor": ("all-gather", 2),
    "all_gather_into_tensor_coalesced": ("all-gather", 2),
    "all_reduce": ("all-reduce", 2),
    "all_reduce_coalesced": ("all-reduce", 2),
    "reduce_scatter_tensor": ("reduce-scatter", 3),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 3),
    "all_to_all_single": ("all-to-all", 3),
}

_DOTS = {aten.mm.default, aten.bmm.default, aten.addmm.default,
         aten.baddbmm.default}

_REDUCTIONS = {"sum", "mean", "amax", "amin", "max", "min", "prod",
               "logsumexp", "cumsum", "cumprod", "var", "std", "norm",
               "_log_softmax", "_softmax", "topk", "sort", "argmax",
               "argmin", "any", "all"}

# ops that move no data: views, metadata, scalars
_FREE = {"view", "_unsafe_view", "reshape", "expand", "permute", "t",
         "transpose", "squeeze", "unsqueeze", "select", "slice", "alias",
         "as_strided", "detach", "split", "split_with_sizes", "unbind",
         "chunk", "narrow", "diagonal", "unfold", "view_as", "_to_copy_meta",
         "lift_fresh", "empty", "empty_strided", "empty_like", "sym_size",
         "sym_stride", "sym_numel", "is_same_size", "_local_scalar_dense",
         "wait_tensor", "new_empty", "new_empty_strided", "set_"}


def _tensors(*trees) -> list:
    """The tensors among an op's arguments or results (flat, or in lists,
    tuples and dicts)."""
    out = []
    for x in trees:
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            out.extend(_tensors(*x))
        elif isinstance(x, dict):
            out.extend(_tensors(*x.values()))
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _shape_inference(types, out) -> bool:
    """Whether an op ran on ``FakeTensor``s: DTensor's sharding
    propagation runs each new op signature once on fake tensors to learn
    its output's shape. That is no op of the step, and no device runs it;
    the account's own shards are ``meta`` tensors, not fake ones."""
    return (any(issubclass(t, FakeTensor) for t in types)
            or any(isinstance(t, FakeTensor) for t in _tensors(out)))


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group
    return _resolve_process_group(name).size()


class CostMode(TorchDispatchMode):
    """Counts the ops run under it (see the module docstring); read
    ``total()``."""

    def __init__(self):
        super().__init__()
        self.dot = 0.0
        self.elem = 0.0
        self.bytes = 0.0
        self.collectives: list = []  # (kind, local output bytes, group)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented  # let DTensor desugar to local ops
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not _shape_inference(types, out):
            self._count(func, args, kwargs, out)
        return out

    def _count(self, func, args, kwargs, out):
        name = func._opname
        ns = func.namespace
        ins, outs = _tensors(args, kwargs), _tensors(out)
        if ns == "_c10d_functional" and name in _COLLECTIVES:
            kind, gi = _COLLECTIVES[name]
            g = _group_size(args[gi]) if len(args) > gi else 1
            ob = sum(map(_nbytes, outs))
            self.collectives.append((kind, ob, g))
            self.bytes += ob + sum(map(_nbytes, ins))
            return
        if name in _FREE or ns == "_c10d_functional":
            return
        self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if func in _DOTS:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            self.dot += 2.0 * outs[0].numel() * a.shape[-1]
        elif name in _REDUCTIONS:
            self.elem += float(ins[0].numel()) if ins else 0.0
        elif torch.Tag.pointwise in func.tags:
            self.elem += float(sum(t.numel() for t in outs))

    def total(self) -> dict:
        """The reference's ``HloCost.total()`` keys: ``flops`` (dot),
        ``flops_elementwise``, ``bytes``, ``collective_bytes`` and
        ``collective_per_op``; plus ``collective_counts``."""
        coll = analysis.collective_bytes(self.collectives)
        return {
            "flops": self.dot,
            "flops_elementwise": self.elem,
            "bytes": self.bytes,
            "collective_bytes": coll["total_bytes"],
            "collective_per_op": coll["per_op"],
            "collective_counts": coll["counts"],
        }


class MemoryMode(TorchDispatchMode):
    """Live and peak bytes of the storages that ops create under it (one
    device's, the local shards under DTensors), each storage counted once
    from its first output until it is freed. ``state_bytes`` are storages
    counted up front (``hold``): the arguments."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.state_bytes = 0
        self._seen: dict[int, int] = {}

    def hold(self, tree) -> None:
        """Count the storages of ``tree``'s tensors (DTensors by their
        local shards) as live from now on."""
        for t in _tensors(tree):
            if isinstance(t, DTensor):
                t = t.to_local()
            self._track(t, state=True)

    def _track(self, t, state=False):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen[key] = n
        self.live += n
        if state:
            self.state_bytes += n
        self.peak = max(self.peak, self.live)

        def free(key=key, n=n):
            if self._seen.pop(key, None) is not None:
                self.live -= n
        weakref.finalize(st, free)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if not _shape_inference(types, out):
            for t in _tensors(out):
                self._track(t)
        return out

    def report(self) -> dict:
        return {"argument_bytes": self.state_bytes, "peak_bytes": self.peak,
                "live_bytes": self.live}
