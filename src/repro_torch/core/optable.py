"""Reusable per-op compute tables: store bodies factored out of the oracle.

The sequential oracle (``loopir.interpret``) evaluates every store's
value/guard expression scalar-by-scalar while walking the program. A
hardware backend (``kernels/wave_exec``) cannot call back into the
oracle — it must *compute* store values itself from the load values its
own gathers produced. This module compiles each store into exactly that
shape, mirroring the paper's decoupled access/execute split:

  * everything the CU/AGU side can produce without touching protected
    memory — loop variables, ivars, locals, reads of index arrays —
    is **partially evaluated away**: every maximal ``LoadVal``-free
    subtree of the value/guard expression becomes an *environment
    slot*, a per-request operand stream captured once during the trace
    walk (``loopir.interpret``'s ``aux_exprs`` hook),
  * everything downstream of a protected ``LoadVal`` stays symbolic: a
    small closed closure over (dep load streams, env slots, frozen
    read-only arrays) that the backend evaluates *vectorized per wave*,
    with numpy (bit-exact vs the oracle — same elementwise ops in the
    same order) or torch (``lib="torch"``; float64 on a given device,
    bit-exact on ``+ - * min max`` and the compares, held to a tolerance
    on ``tanh``/``exp``/``//``/``%``).

The closure node set is tiny (Const / DepRef / EnvRef / Gather / Bin /
Un) because the IR's expression language is; ``compile_store_tables``
rejects the one genuinely unsupported case — a ``Read`` whose index
depends on a ``LoadVal`` *and* whose array is also a store target (the
closure would need a coherent snapshot mid-execution; Table-1 and the
speculative kernels only gather frozen index/weight arrays this way).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Union

import numpy as np

from repro_torch.core import loopir as ir


class OpTableError(Exception):
    """A store body the op-table compiler cannot factor (module doc)."""


# ---------------------------------------------------------------------------
# Closure IR (the residue after partial evaluation)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CConst:
    v: float


@dataclasses.dataclass(frozen=True)
class CDep:
    """Value stream of a protected load (aligned via WavePlan dep maps)."""

    load_id: str


@dataclasses.dataclass(frozen=True)
class CEnv:
    """Captured environment slot (LoadVal-free subtree), by slot index."""

    slot: int


@dataclasses.dataclass(frozen=True)
class CGather:
    """Gather from a *frozen* read-only array at a load-dependent index."""

    array: str
    index: "CNode"


@dataclasses.dataclass(frozen=True)
class CBin:
    op: str
    a: "CNode"
    b: "CNode"


@dataclasses.dataclass(frozen=True)
class CUn:
    op: str
    a: "CNode"


CNode = Union[CConst, CDep, CEnv, CGather, CBin, CUn]

# The numpy path reuses the oracle's own op tables (ir.NP_BINOPS /
# ir.NP_UN_FNS) — one source, bit-exactness by construction. The torch
# counterparts below are the only duplicates; built on first use so the
# module imports without touching torch, and key-checked against the
# oracle tables so a new IR op that was only added in loopir fails
# loudly here instead of surfacing as a KeyError mid-step.


@functools.cache
def _torch_tables() -> tuple[dict, dict]:
    import torch

    binops = {
        "+": torch.add, "-": torch.sub, "*": torch.mul,
        "//": torch.floor_divide, "%": torch.remainder,
        "min": torch.minimum, "max": torch.maximum,
        "<": torch.lt, "<=": torch.le,
        ">": torch.gt, ">=": torch.ge,
        "==": torch.eq, "!=": torch.ne,
    }
    unfns = {
        "tanh": torch.tanh, "relu": lambda x: torch.clamp(x, min=0),
        "neg": torch.neg, "abs": torch.abs, "sign": torch.sign,
        "exp": torch.exp,
    }
    assert set(binops) == set(ir.NP_BINOPS), (
        "torch binop table out of sync with loopir.NP_BINOPS: "
        f"{set(binops) ^ set(ir.NP_BINOPS)}"
    )
    assert set(unfns) == set(ir.NP_UN_FNS), (
        "torch unary table out of sync with loopir.NP_UN_FNS: "
        f"{set(unfns) ^ set(ir.NP_UN_FNS)}"
    )
    return binops, unfns


@dataclasses.dataclass
class StoreTable:
    """Compute body of one store op, in backend-executable form.

    ``deps`` are the load ops whose values feed the body; the backend
    supplies one aligned stream per dep (see ``WavePlan.dep_maps``).
    ``env_exprs`` are the captured slots in slot order — the plan
    builder evaluates them through the ``aux_exprs`` interpreter hook
    into ``WavePlan.env`` streams. ``value``/``guard`` are closure
    trees over those two input kinds plus ``frozen_reads`` gathers.
    """

    op_id: str
    array: str
    deps: tuple[str, ...]
    env_exprs: tuple[ir.Expr, ...]
    value: CNode
    guard: Optional[CNode]
    frozen_reads: tuple[str, ...]

    def eval_value(self, deps, env, arrays, n, lib="np", device=None):
        """Vectorized store values for ``n`` requests; ``deps``/``env``
        map to per-request operand arrays already sliced and aligned to
        the same request subset. ``lib="np"`` is the bit-exact path;
        ``lib="torch"`` computes in float64 on ``device`` and returns a
        numpy array."""
        v = _eval_closure(self.value, deps, env, arrays, lib, device)
        return _to_host(_bcast(v, n, lib, device))

    def eval_guard(self, deps, env, arrays, n, lib="np", device=None):
        """Vectorized §6 valid mask (all-True when unguarded)."""
        if self.guard is None:
            return np.ones(n, dtype=bool)
        m = _eval_closure(self.guard, deps, env, arrays, lib, device)
        return _to_host(_bcast(m, n, lib, device)).astype(bool)


def _to_host(v) -> np.ndarray:
    if isinstance(v, np.ndarray):
        return v
    if hasattr(v, "cpu"):  # a torch tensor
        return v.cpu().numpy()
    return np.asarray(v)


def _bcast(v, n: int, lib: str, device):
    """Constant-valued bodies evaluate to scalars; stretch to n rows."""
    if (v.ndim if hasattr(v, "ndim") else np.ndim(v)) == 0:
        if lib == "np":
            return np.full(n, v, dtype=np.float64)
        import torch

        return torch.as_tensor(v, device=device).expand(n)
    return v


def _eval_closure(node: CNode, deps, env, arrays, lib, device=None):
    if lib == "np":
        binops, unfns, leaf = ir.NP_BINOPS, ir.NP_UN_FNS, np.asarray
    elif lib == "torch":
        import torch

        binops, unfns = _torch_tables()

        def leaf(x):
            # float operands compute in float64; integer and bool
            # operands keep their type, as they do under numpy
            t = torch.as_tensor(np.asarray(x), device=device)
            return t.double() if t.is_floating_point() else t
    else:
        raise ValueError(f"unknown closure lib {lib!r}")

    def ev(n):
        if isinstance(n, CConst):
            return leaf(n.v) if lib == "torch" else n.v
        if isinstance(n, CDep):
            return leaf(deps[n.load_id])
        if isinstance(n, CEnv):
            return leaf(env[n.slot])
        if isinstance(n, CGather):
            idx = ev(n.index)
            arr = leaf(arrays[n.array])
            # clip: mis-speculated (§6 guard-false) rows may hold garbage
            # indices; their results are masked out by the valid bit
            if lib == "np":
                i = np.clip(np.asarray(idx).astype(np.int64), 0, len(arr) - 1)
                return arr[i]
            return arr[idx.long().clamp(0, len(arr) - 1)]
        if isinstance(n, CBin):
            return binops[n.op](ev(n.a), ev(n.b))
        if isinstance(n, CUn):
            return unfns[n.op](ev(n.a))
        raise TypeError(f"cannot eval closure node {n!r}")

    with np.errstate(all="ignore"):
        return ev(node)


# ---------------------------------------------------------------------------
# Compilation: partial evaluation of store bodies
# ---------------------------------------------------------------------------


def _has_loadval(e: ir.Expr) -> bool:
    if isinstance(e, ir.LoadVal):
        return True
    if isinstance(e, ir.Bin):
        return _has_loadval(e.a) or _has_loadval(e.b)
    if isinstance(e, ir.Un):
        return _has_loadval(e.a)
    if isinstance(e, ir.Read):
        return _has_loadval(e.index)
    return False


def _has_streamed(e: ir.Expr, streamed: dict) -> bool:
    """Does ``e`` reference a cross-PE streamed local (FIFO pop value)?"""
    if isinstance(e, ir.Local):
        return e.name in streamed
    if isinstance(e, ir.Bin):
        return _has_streamed(e.a, streamed) or _has_streamed(e.b, streamed)
    if isinstance(e, ir.Un):
        return _has_streamed(e.a, streamed)
    if isinstance(e, ir.Read):
        return _has_streamed(e.index, streamed)
    return False


def compile_store_tables(
    program: ir.Program,
    stream_deps: Optional[dict[str, dict[str, str]]] = None,
) -> dict[str, StoreTable]:
    """One ``StoreTable`` per store op of ``program`` (keyed by op id).

    Partial evaluation rule: a maximal ``LoadVal``-free subtree becomes
    an env slot (deduplicated structurally); ``Const`` leaves inline;
    everything containing a ``LoadVal`` compiles to closure nodes.
    Raises ``OpTableError`` for a load-dependent ``Read`` of an array
    the program also stores to (no frozen snapshot exists).

    ``stream_deps`` maps a store op id to ``{local name: pop op id}``
    for cross-PE streamed locals (DESIGN.md §11): a ``Local`` in that
    map is *dynamic* — it compiles to a ``CDep`` on the pseudo pop op
    instead of an env slot, so the store's value flows through the
    FIFO slot in memory and the wave plan orders the store after the
    pop (the producer-before-consumer dep edge ``validate_plan``
    asserts per edge).
    """
    stream_deps = stream_deps or {}
    stored_arrays = {
        op.array for op, _ in program.mem_ops() if op.is_store
    }
    tables: dict[str, StoreTable] = {}
    for op, _path in program.mem_ops():
        if not op.is_store:
            continue
        env_exprs: list[ir.Expr] = []
        env_index: dict[ir.Expr, int] = {}
        deps: list[str] = []
        frozen: list[str] = []
        streamed = stream_deps.get(op.id, {})

        def slot(e: ir.Expr) -> CNode:
            if isinstance(e, ir.Const):
                return CConst(e.v)
            k = env_index.get(e)
            if k is None:
                k = len(env_exprs)
                env_index[e] = k
                env_exprs.append(e)
            return CEnv(k)

        def comp(e: ir.Expr) -> CNode:
            if not (_has_loadval(e) or _has_streamed(e, streamed)):
                return slot(e)
            if isinstance(e, ir.LoadVal):
                if e.load_id not in deps:
                    deps.append(e.load_id)
                return CDep(e.load_id)
            if isinstance(e, ir.Local):
                pop_op = streamed[e.name]
                if pop_op not in deps:
                    deps.append(pop_op)
                return CDep(pop_op)
            if isinstance(e, ir.Bin):
                return CBin(e.op, comp(e.a), comp(e.b))
            if isinstance(e, ir.Un):
                return CUn(e.op, comp(e.a))
            if isinstance(e, ir.Read):
                # index depends on a load value: the gather must run in
                # the backend, against a frozen array
                if e.array in stored_arrays:
                    raise OpTableError(
                        f"store '{op.id}': Read('{e.array}') has a "
                        f"load-dependent index but '{e.array}' is also a "
                        f"store target — no frozen snapshot to gather from"
                    )
                if e.array not in frozen:
                    frozen.append(e.array)
                return CGather(e.array, comp(e.index))
            raise TypeError(f"cannot compile {e!r}")  # pragma: no cover

        value = comp(op.value)
        guard = comp(op.guard) if op.guard is not None else None
        tables[op.id] = StoreTable(
            op_id=op.id,
            array=op.array,
            deps=tuple(deps),
            env_exprs=tuple(env_exprs),
            value=value,
            guard=guard,
            frozen_reads=tuple(frozen),
        )
    return tables
