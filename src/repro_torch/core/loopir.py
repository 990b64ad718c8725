"""LoopIR: a small loop-forest IR for irregular streaming programs.

This is the input language of the dynamic-loop-fusion compiler (the
paper's benchmarks in §7.2 are all expressible in it). Design mirrors
what the paper's passes see in LLVM IR:

  * a *forest* of loop nests executed in program (topological) order,
  * explicit induction variables (``IVar``) whose add/mul updates are
    exactly what SCEV turns into chains of recurrences,
  * memory operations (``Load``/``Store``) against named arrays; arrays
    read through ``Read`` expressions are *unprotected* read-only data
    (index arrays such as CSR ``row_ptr`` — the paper protects one base
    pointer per DU, read-only inputs need no protection),
  * optional ``guard`` predicates on stores (the §6 control-flow /
    speculation case),
  * user monotonicity assertions for data-dependent addresses (§3.3).

The module also provides the **sequential oracle**: a reference
interpreter whose final memory state defines correctness for every
executor (the wave executor and its CUDA backend in this package).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Union

import numpy as np

from repro_torch.core import cr as crlib

# ---------------------------------------------------------------------------
# Expressions
# ---------------------------------------------------------------------------


class Expr:
    def __add__(self, o):
        return Bin("+", self, wrap(o))

    def __radd__(self, o):
        return Bin("+", wrap(o), self)

    def __sub__(self, o):
        return Bin("-", self, wrap(o))

    def __rsub__(self, o):
        return Bin("-", wrap(o), self)

    def __mul__(self, o):
        return Bin("*", self, wrap(o))

    def __rmul__(self, o):
        return Bin("*", wrap(o), self)

    def __floordiv__(self, o):
        return Bin("//", self, wrap(o))

    def __mod__(self, o):
        return Bin("%", self, wrap(o))

    def __lt__(self, o):
        return Bin("<", self, wrap(o))

    def __le__(self, o):
        return Bin("<=", self, wrap(o))

    def __gt__(self, o):
        return Bin(">", self, wrap(o))

    def __ge__(self, o):
        return Bin(">=", self, wrap(o))

    def eq(self, o):
        return Bin("==", self, wrap(o))

    def ne(self, o):
        return Bin("!=", self, wrap(o))


@dataclasses.dataclass(frozen=True)
class Const(Expr):
    v: float


@dataclasses.dataclass(frozen=True)
class Param(Expr):
    """Runtime scalar parameter, with a conservative range for analysis."""

    name: str
    lo: int = 0
    hi: int = crlib.INF


@dataclasses.dataclass(frozen=True)
class Var(Expr):
    """Induction variable of an enclosing loop (the canonical 0,1,2,...
    counter) or a declared auxiliary IVar."""

    name: str


@dataclasses.dataclass(frozen=True)
class Local(Expr):
    """A loop-carried scalar local (defined by SetLocal)."""

    name: str


@dataclasses.dataclass(frozen=True)
class Read(Expr):
    """Read-only (unprotected) array read, e.g. CSR row_ptr/col_idx."""

    array: str
    index: Expr
    # optional user range assertion for the values read (helps analysis)
    lo: int = -crlib.INF
    hi: int = crlib.INF


@dataclasses.dataclass(frozen=True)
class LoadVal(Expr):
    """Value of the protected Load statement with the given id, in the
    current iteration."""

    load_id: str


@dataclasses.dataclass(frozen=True)
class Bin(Expr):
    op: str
    a: Expr
    b: Expr


@dataclasses.dataclass(frozen=True)
class Un(Expr):
    op: str  # tanh | relu | neg | abs | sign | exp
    a: Expr


def wrap(v: Union[int, float, Expr]) -> Expr:
    return v if isinstance(v, Expr) else Const(v)


_UN_FNS: dict[str, Callable] = {
    "tanh": np.tanh,
    "relu": lambda x: np.maximum(x, 0),
    "neg": lambda x: -x,
    "abs": np.abs,
    "sign": np.sign,
    "exp": np.exp,
}

# public alias: the numpy ufuncs above are already elementwise, so the
# oracle's scalar table IS the vectorized table (core/optable's
# closures use it directly — one source, nothing to keep in sync)
NP_UN_FNS: dict[str, Callable] = _UN_FNS


# vectorized counterparts of _binop, used by the affine trace compiler
# (core/affine.py); numpy's //, % match Python's semantics on ints and
# floats, min/max become elementwise minimum/maximum. Keep the two
# tables in sync: every op here must behave elementwise exactly like
# _binop does on scalars.
NP_BINOPS: dict[str, Callable] = {
    "+": np.add,
    "-": np.subtract,
    "*": np.multiply,
    "//": np.floor_divide,
    "%": np.mod,
    "min": np.minimum,
    "max": np.maximum,
    "<": np.less,
    "<=": np.less_equal,
    ">": np.greater,
    ">=": np.greater_equal,
    "==": np.equal,
    "!=": np.not_equal,
}


def _binop(op: str, a, b):
    if op == "+":
        return a + b
    if op == "-":
        return a - b
    if op == "*":
        return a * b
    if op == "//":
        return a // b
    if op == "%":
        return a % b
    if op == "min":
        return min(a, b)
    if op == "max":
        return max(a, b)
    if op == "<":
        return a < b
    if op == "<=":
        return a <= b
    if op == ">":
        return a > b
    if op == ">=":
        return a >= b
    if op == "==":
        return a == b
    if op == "!=":
        return a != b
    raise ValueError(f"unknown binop {op}")


# ---------------------------------------------------------------------------
# Statements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MonotonicHint:
    """User assertion (§3.3): the address is monotonically non-decreasing
    in the innermost loop. ``non_monotonic_outer`` lists 1-indexed outer
    depths that reset the address (None = assume *all* outer depths are
    non-monotonic — maximally conservative)."""

    innermost_monotonic: bool = True
    non_monotonic_outer: Optional[frozenset[int]] = None


@dataclasses.dataclass(frozen=True)
class Load:
    id: str
    array: str
    addr: Expr
    hint: Optional[MonotonicHint] = None

    @property
    def is_store(self) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class Store:
    id: str
    array: str
    addr: Expr
    value: Expr
    guard: Optional[Expr] = None  # §6: store under an if-condition
    hint: Optional[MonotonicHint] = None

    @property
    def is_store(self) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class IVar:
    """Auxiliary induction variable of a loop: ``name = init`` before the
    loop, ``name = name (op) step`` at the end of each iteration. This is
    the source-level origin of non-affine CRs, e.g. FFT's stride *= 2
    gives the paper's {2, ×, 2} recurrence."""

    name: str
    init: Expr
    op: str  # '+' or '*'
    step: Expr


@dataclasses.dataclass(frozen=True)
class SetLocal:
    """Assign a loop-carried scalar local (reduction accumulators etc.)."""

    name: str
    value: Expr


@dataclasses.dataclass(frozen=True)
class Loop:
    var: str
    trip: Expr
    body: tuple  # of Load | Store | SetLocal | Loop
    ivars: tuple[IVar, ...] = ()
    # False models loops whose exit predicate cannot be computed one
    # iteration in advance (paper §4.2(3): lastIter hint degrades to 0).
    predictable: bool = True

    def __post_init__(self):
        object.__setattr__(self, "body", tuple(self.body))
        object.__setattr__(self, "ivars", tuple(self.ivars))


Stmt = Union[Load, Store, SetLocal, Loop]


@dataclasses.dataclass(frozen=True)
class Program:
    name: str
    loops: tuple[Loop, ...]  # the forest, in program order
    # arrays written/read via protected Load/Store and Read
    params: tuple[str, ...] = ()

    def __post_init__(self):
        object.__setattr__(self, "loops", tuple(self.loops))
        object.__setattr__(self, "params", tuple(self.params))

    # -- structural helpers -------------------------------------------------

    def mem_ops(self) -> list[tuple[Union[Load, Store], tuple[Loop, ...]]]:
        """All memory ops in topological (program) order, each with its
        enclosing loop path (outermost first)."""
        out = []

        def walk(stmts, path):
            for s in stmts:
                if isinstance(s, Loop):
                    walk(s.body, path + (s,))
                elif isinstance(s, (Load, Store)):
                    out.append((s, path))

        walk(self.loops, ())
        return out

    def op_index(self) -> dict[str, int]:
        """Topological order index for each memory op id."""
        return {op.id: i for i, (op, _) in enumerate(self.mem_ops())}

    def find_op(self, op_id: str) -> tuple[Union[Load, Store], tuple[Loop, ...]]:
        for op, path in self.mem_ops():
            if op.id == op_id:
                return op, path
        raise KeyError(op_id)

    def fingerprint(self) -> str:
        """Stable structural hash of the program (hex sha256).

        Canonical recursive encoding of the IR forest — statement kinds,
        op ids, expression trees, trips, ivars, guards, hints — so two
        structurally identical programs hash equal across processes and
        sessions (``repr``/``hash`` of nested dataclasses are not stable
        enough to key an on-disk cache). Array *contents* and parameter
        *values* are deliberately excluded: the DSE result cache
        hashes those separately.
        """
        import hashlib

        h = hashlib.sha256()

        def put(x):
            h.update(repr(x).encode())
            h.update(b"\x00")

        def enc(node):
            if node is None or isinstance(node, (str, int, float, bool)):
                put(node)
            elif isinstance(node, frozenset):
                put("{")
                for x in sorted(node):
                    enc(x)
                put("}")
            elif isinstance(node, (tuple, list)):
                put("(")
                for x in node:
                    enc(x)
                put(")")
            elif dataclasses.is_dataclass(node):
                put(type(node).__name__)
                for f in dataclasses.fields(node):
                    enc(getattr(node, f.name))
            else:  # pragma: no cover
                raise TypeError(f"cannot fingerprint {node!r}")

        enc(self)
        return h.hexdigest()

    def static_positions(self) -> tuple[dict[int, int], dict[str, int]]:
        """(loop object id -> index in parent body, op id -> index in its
        body). Together with per-depth counters these give a global
        lexicographic program order — the polyhedral 2d+1 schedule."""
        loop_pos: dict[int, int] = {}
        op_pos: dict[str, int] = {}

        def walk(stmts):
            for idx, s in enumerate(stmts):
                if isinstance(s, Loop):
                    loop_pos[id(s)] = idx
                    walk(s.body)
                elif isinstance(s, (Load, Store)):
                    op_pos[s.id] = idx

        walk(self.loops)
        return loop_pos, op_pos


# ---------------------------------------------------------------------------
# Sequential oracle interpreter
# ---------------------------------------------------------------------------


class UnavailableLoadValue(KeyError):
    """A ``LoadVal`` consumed before its ``Load`` produced a value —
    e.g. a trip reading a load of the loop it bounds. Distinguished
    from other ``KeyError``s (typo'd arrays/params) so the speculative
    AGU (``core/speculate.py``) converts only genuine
    use-before-availability into its auto-reject diagnostic."""


class _Env:
    """Chained mutable scopes for loop vars / ivars / locals."""

    def __init__(self, parent: Optional["_Env"] = None):
        self.parent = parent
        self.vals: dict[str, float] = {}

    def get(self, name: str):
        e = self
        while e is not None:
            if name in e.vals:
                return e.vals[name]
            e = e.parent
        raise KeyError(name)

    def set_existing(self, name: str, v) -> bool:
        e = self
        while e is not None:
            if name in e.vals:
                e.vals[name] = v
                return True
            e = e.parent
        return False

    def define(self, name: str, v):
        self.vals[name] = v


def _eval(e: Expr, env: _Env, arrays, params, loadvals) -> float:
    if isinstance(e, Const):
        return e.v
    if isinstance(e, Param):
        return params[e.name]
    if isinstance(e, (Var, Local)):
        return env.get(e.name)
    if isinstance(e, Read):
        idx = int(_eval(e.index, env, arrays, params, loadvals))
        return arrays[e.array][idx]
    if isinstance(e, LoadVal):
        try:
            return loadvals[e.load_id]
        except KeyError:
            raise UnavailableLoadValue(e.load_id) from None
    if isinstance(e, Bin):
        return _binop(
            e.op,
            _eval(e.a, env, arrays, params, loadvals),
            _eval(e.b, env, arrays, params, loadvals),
        )
    if isinstance(e, Un):
        return _UN_FNS[e.op](_eval(e.a, env, arrays, params, loadvals))
    raise TypeError(f"cannot eval {e!r}")


def interpret(
    program: Program,
    arrays: dict[str, np.ndarray],
    params: Optional[dict[str, int]] = None,
    trace_hook: Optional[Callable] = None,
    aux_exprs: Optional[dict[str, tuple]] = None,
    aux_hook: Optional[Callable] = None,
    loop_hook: Optional[Callable] = None,
) -> dict[str, np.ndarray]:
    """Run the program sequentially; returns the final array state.

    This is THE semantics. Every executor must reproduce it bit-for-bit
    (modulo float associativity, which we avoid by executing in the same
    per-element order).

    ``trace_hook(op_id, addr, is_store, valid, value)`` is called for
    every memory operation *in program order*, including mis-speculated
    stores (guard false -> valid=False, value=None) — the request exists
    in the decoupled machine even when the effect doesn't (§6).

    ``aux_exprs`` maps an op id to a tuple of extra expressions; when
    that op fires, each is evaluated in the op's environment and the
    results are passed to ``aux_hook(op_id, values_tuple)`` *before* the
    trace hook — for guarded stores the aux values are produced even
    when the guard fails (the CU-side operand stream exists regardless
    of the §6 valid bit). This is how ``core/optable`` captures the
    environment slots of its partially-evaluated compute bodies without
    leaking memory (LoadVal) values out of the oracle.

    ``loop_hook(loop, phase, reader)`` is called at every loop
    *instance* boundary — ``phase="enter"`` before the instance's
    ivars/trip are evaluated, ``phase="exit"`` after its last iteration
    (a zero-trip instance fires both) — with ``reader(name)`` exposing
    the enclosing environment's locals. This is how the FIFO token
    protocol (``core/fifo.py``, DESIGN.md §11) observes the
    one-token-per-leaf-instance push/pop stream without re-deriving
    loop structure.

    Load values are visible downstream of their ``Load`` within the
    enclosing body *and* inside nested loops of that body — including
    loop trip counts and ivar updates. Load-dependent trips (the §6
    speculation workloads, ``core/speculate.py``) are therefore plain
    programs to the oracle; only the decoupled machine needs the
    speculative AGU to run them.
    """
    params = params or {}
    arrays = {k: np.array(v, copy=True) for k, v in arrays.items()}

    def run_aux(op_id, env, loadvals, guard_ok=True):
        # guard-false rows (§6) still need an aux row for per-op
        # ordinal alignment, but the guard may be the very bounds check
        # that makes the value operands evaluable — evaluate those
        # defensively and emit NaN placeholders (the backend masks the
        # whole row by its recomputed valid bit)
        if aux_exprs is not None and op_id in aux_exprs:
            vals = []
            for e in aux_exprs[op_id]:
                if guard_ok:
                    vals.append(_eval(e, env, arrays, params, loadvals))
                else:
                    try:
                        vals.append(_eval(e, env, arrays, params, loadvals))
                    except Exception:
                        vals.append(np.nan)
            aux_hook(op_id, tuple(vals))

    def run_body(stmts: Sequence[Stmt], env: _Env, outer_loadvals):
        # chained visibility: loads of enclosing iterations stay readable
        loadvals: dict[str, float] = dict(outer_loadvals)
        for s in stmts:
            if isinstance(s, Load):
                a = int(_eval(s.addr, env, arrays, params, loadvals))
                v = arrays[s.array][a]
                run_aux(s.id, env, loadvals)
                if trace_hook is not None:
                    trace_hook(s.id, a, False, True, float(v))
                loadvals[s.id] = v
            elif isinstance(s, Store):
                a = int(_eval(s.addr, env, arrays, params, loadvals))
                guard_ok = s.guard is None or _eval(
                    s.guard, env, arrays, params, loadvals
                )
                run_aux(s.id, env, loadvals, guard_ok=guard_ok)
                if not guard_ok:
                    if trace_hook is not None:
                        trace_hook(s.id, a, True, False, None)
                    continue
                v = _eval(s.value, env, arrays, params, loadvals)
                if trace_hook is not None:
                    trace_hook(s.id, a, True, True, float(v))
                arrays[s.array][a] = v
            elif isinstance(s, SetLocal):
                v = _eval(s.value, env, arrays, params, loadvals)
                if not env.set_existing(s.name, v):
                    env.define(s.name, v)
            elif isinstance(s, Loop):
                run_loop(s, env, loadvals)
            else:
                raise TypeError(f"unknown stmt {s!r}")

    def run_loop(loop: Loop, env: _Env, loadvals):
        if loop_hook is not None:
            loop_hook(loop, "enter", env.get)
        outer = _Env(env)
        for iv in loop.ivars:
            outer.define(iv.name, _eval(iv.init, env, arrays, params, loadvals))
        trip = int(_eval(loop.trip, env, arrays, params, loadvals))
        for i in range(trip):
            inner = _Env(outer)
            inner.define(loop.var, i)
            run_body(loop.body, inner, loadvals)
            for iv in loop.ivars:
                cur = outer.get(iv.name)
                step = _eval(iv.step, inner, arrays, params, loadvals)
                outer.vals[iv.name] = cur + step if iv.op == "+" else cur * step
        if loop_hook is not None:
            loop_hook(loop, "exit", env.get)
        return

    top = _Env()
    for lp in program.loops:
        run_loop(lp, top, {})
    return arrays


# ---------------------------------------------------------------------------
# Carrying programs over from the JAX package
# ---------------------------------------------------------------------------

_IR_CLASSES = {
    c.__name__: c
    for c in (
        Const, Param, Var, Local, Read, LoadVal, Bin, Un,
        MonotonicHint, Load, Store, IVar, SetLocal, Loop, Program,
    )
}


def from_reference(node):
    """Rebuild a LoopIR tree built with the JAX package's classes
    (``repro.core.loopir``) as this package's classes.

    Walks ``dataclasses.fields`` and maps each node by
    ``type(node).__name__`` to the class of the same name here, so a
    program written against the reference runs on the port with the
    same ``Program.fingerprint()``. Nothing of the reference is
    imported: any structurally matching tree is accepted. Leaves
    (strings, numbers, ``None``) pass through; tuples, lists and
    frozensets are rebuilt element by element.
    """
    if node is None or isinstance(node, (str, int, float, bool, np.generic)):
        return node
    if isinstance(node, frozenset):
        return frozenset(from_reference(x) for x in node)
    if isinstance(node, (tuple, list)):
        return type(node)(from_reference(x) for x in node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        cls = _IR_CLASSES.get(type(node).__name__)
        if cls is None:
            raise TypeError(
                f"from_reference: no LoopIR class named "
                f"{type(node).__name__!r}"
            )
        return cls(**{
            f.name: from_reference(getattr(node, f.name))
            for f in dataclasses.fields(node)
        })
    raise TypeError(f"from_reference: cannot convert {node!r}")
