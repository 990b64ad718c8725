"""Affine analysis + vectorized iteration spaces for the AGU/CU front-end.

The per-iteration Python IR walks in ``schedule._trace_pe`` (AGU) and
``dae.CU`` (compute unit) were the last scalar bottlenecks after the
event engine made simulation scale with requests (DESIGN.md §7). For
affine loop nests — and, more generally, for any nest whose trips,
induction updates and address expressions are *vectorizable* — the whole
request stream has a closed form. This module provides the three pieces
the trace compiler (``schedule.compile_pe_trace``) and the vectorized
compute unit (``dae.VecCU``) share:

  * **classification** (`classify_pe`, `classify_cu`): decides per PE
    whether the compiled path is exact, and names the offending op/loop
    when it is not. The compiled subset:
      - trips at depth d reference only consts/params/`Read` gathers and
        vars/ivars of depths < d (params-dependent and outer-var ragged
        trips are fine; negative trips clamp to zero like ``range``);
      - `+` ivar steps may vary per iteration (closed form by segmented
        cumsum); `*` ivar steps must be loop-invariant (closed form by
        integer powers) — the FFT ``stride *= 2`` case;
      - addresses reference consts/params/vars/ivars/`Read` gathers
        (arbitrarily nested: CSR's ``idx[rp[i] + k]`` is a gather of a
        gather) — everything numpy can evaluate elementwise;
      - **no loop-carried locals** (`Local`/`SetLocal` chains are
        inherently sequential) and **no protected load values**
        (`LoadVal` — loss of decoupling, the AGU cannot run ahead).
    Anything outside the subset falls back per-PE to the interpreter
    (`trace_mode="auto"`) or raises `TraceCompileError` naming the
    offending op (`trace_mode="compiled"`).
  * **iteration spaces** (`build_iter_space`): the PE's ragged loop nest
    flattened level by level into numpy arrays — per depth: flat body
    invocation count, parent links, 0-based iteration index, lastIter
    flags, ancestor indices (= the §4 never-reset counters, minus one)
    and an environment of loop-var/ivar value vectors.
  * **vectorized evaluation** (`vec_eval`): LoopIR expression -> numpy
    array over a flat iteration space, mirroring the interpreter's
    Python semantics elementwise (same truncation, floor-div, mod).

Exactness contract: for every program in the subset the compiled
streams equal the interpreter's **bit for bit** (pinned by the random
differential fuzz suite in tests/test_trace_compile.py). The only
numerically delicate ops are the ivar *accumulations* (cumsum / powers):
they are restricted at build time to integer dtypes AND to magnitudes
provably inside int64 (the interpreter computes them with Python's
arbitrary-precision ints, so a wrapped value would silently diverge) —
float elementwise math is order-identical and stays allowed everywhere
else.

The CR algebra (monotonic.py / cr.py, paper §3) answers a different
question — *monotonicity* for the hazard checks; `classify_pe` reuses it
to tag each address as CR-affine for reporting, but compilability is the
broader vectorizability criterion above (FFT's multiplicative chain is
non-affine yet compiles; a loop-carried local is affine-valued yet does
not).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.core import loopir as ir
from repro_torch.core import monotonic as mono


class TraceCompileError(Exception):
    """The compiled trace path cannot (exactly) represent this PE."""


# ---------------------------------------------------------------------------
# expression scan: what does an expression reference?
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ExprScan:
    max_depth: int = 0  # deepest loop depth whose var/ivar appears
    locals: set = dataclasses.field(default_factory=set)
    loads: set = dataclasses.field(default_factory=set)
    ivars: set = dataclasses.field(default_factory=set)  # ivar names used
    unknown_vars: set = dataclasses.field(default_factory=set)
    unsupported: set = dataclasses.field(default_factory=set)  # node/op names


def scan_expr(
    e: ir.Expr,
    var_depth: dict[str, int],
    ivar_depth: dict[str, int],
) -> ExprScan:
    """Recursively collect the references of ``e``: deepest loop depth,
    loop-carried locals, protected loads, unsupported node kinds."""
    out = ExprScan()

    def walk(x: ir.Expr):
        if isinstance(x, (ir.Const, ir.Param)):
            return
        if isinstance(x, ir.Var):
            if x.name in var_depth:
                out.max_depth = max(out.max_depth, var_depth[x.name])
            elif x.name in ivar_depth:
                out.max_depth = max(out.max_depth, ivar_depth[x.name])
                out.ivars.add(x.name)
            else:
                out.unknown_vars.add(x.name)
            return
        if isinstance(x, ir.Local):
            out.locals.add(x.name)
            return
        if isinstance(x, ir.LoadVal):
            out.loads.add(x.load_id)
            return
        if isinstance(x, ir.Read):
            walk(x.index)
            return
        if isinstance(x, ir.Bin):
            if x.op not in _NP_BINOPS:
                out.unsupported.add(f"binop {x.op!r}")
                return
            walk(x.a)
            walk(x.b)
            return
        if isinstance(x, ir.Un):
            if x.op not in ir._UN_FNS:
                out.unsupported.add(f"unop {x.op!r}")
                return
            walk(x.a)
            return
        out.unsupported.add(type(x).__name__)

    walk(e)
    return out


# ---------------------------------------------------------------------------
# classification
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PEClass:
    """Compiled-path verdict for one PE (AGU or CU view)."""

    pe_id: int
    compilable: bool
    reasons: list[str]  # empty iff compilable; each names the offender
    # reporting: per-op CR classification of the address (paper §3 view)
    op_affine: dict[str, bool] = dataclasses.field(default_factory=dict)

    def describe(self) -> str:
        if self.compilable:
            return f"PE {self.pe_id}: compiled"
        return f"PE {self.pe_id}: interp ({'; '.join(self.reasons)})"


def _depth_maps(pe) -> tuple[dict[str, int], dict[str, int]]:
    var_depth = {lp.var: d for d, lp in enumerate(pe.path, 1)}
    ivar_depth = {}
    for d, lp in enumerate(pe.path, 1):
        for iv in lp.ivars:
            ivar_depth[iv.name] = d
    return var_depth, ivar_depth


def _check(
    scan: ExprScan, what: str, ctx_depth: int, reasons: list[str]
) -> None:
    """Append human-readable rejection reasons for one expression."""
    if scan.loads:
        reasons.append(
            f"{what} depends on protected load value(s) "
            f"{sorted(scan.loads)} (loss of decoupling)"
        )
    if scan.locals:
        reasons.append(
            f"{what} depends on loop-carried local(s) {sorted(scan.locals)}"
        )
    if scan.unknown_vars:
        reasons.append(f"{what} references unknown var(s) {sorted(scan.unknown_vars)}")
    if scan.unsupported:
        reasons.append(f"{what} uses unsupported {sorted(scan.unsupported)}")
    if scan.max_depth > ctx_depth:
        reasons.append(
            f"{what} references depth-{scan.max_depth} state but is "
            f"evaluated at depth {ctx_depth}"
        )


def classify_pe(pe) -> PEClass:
    """AGU view: can every trip, ivar update, and address be compiled?"""
    var_depth, ivar_depth = _depth_maps(pe)
    reasons: list[str] = []

    for d, lp in enumerate(pe.path, 1):
        s = scan_expr(lp.trip, var_depth, ivar_depth)
        _check(s, f"trip of loop {lp.var!r}", d - 1, reasons)
        for iv in lp.ivars:
            si = scan_expr(iv.init, var_depth, ivar_depth)
            _check(si, f"init of ivar {iv.name!r}", d - 1, reasons)
            ss = scan_expr(iv.step, var_depth, ivar_depth)
            same_loop = {
                n for n in ss.ivars if ivar_depth.get(n) == d
            }
            if same_loop:
                reasons.append(
                    f"step of ivar {iv.name!r} references same-loop "
                    f"ivar(s) {sorted(same_loop)} (sequential recurrence)"
                )
            if iv.op == "*":
                # closed form is init * step**j: step must be invariant
                # within the loop it steps
                _check(
                    ss, f"step of multiplicative ivar {iv.name!r}", d - 1,
                    reasons,
                )
            else:
                _check(ss, f"step of ivar {iv.name!r}", d, reasons)

    op_affine: dict[str, bool] = {}
    for s, d in pe.stmts:
        if not isinstance(s, (ir.Load, ir.Store)):
            continue
        sc = scan_expr(s.addr, var_depth, ivar_depth)
        _check(sc, f"address of op {s.id!r}", d, reasons)
        # §3 CR view, for reporting only (hint-free): affine in the
        # polyhedral sense is strictly narrower than compilable
        cre = mono.to_cr_or_none(s.addr, pe.path)
        op_affine[s.id] = cre is not None and mono.crlib.is_affine_expr(cre)

    return PEClass(
        pe_id=pe.id,
        compilable=not reasons,
        reasons=reasons,
        op_affine=op_affine,
    )


def classify_cu(pe) -> PEClass:
    """CU view: can the value stream be computed without the generator?

    Requires a *load-free* value chain — the generator exists to block on
    protected load values; without loads every store value/guard (and
    the iteration space) is computable up front.
    """
    base = classify_pe(pe)
    reasons = list(base.reasons)
    var_depth, ivar_depth = _depth_maps(pe)
    for s, d in pe.stmts:
        if isinstance(s, ir.Load):
            reasons.append(
                f"op {s.id!r} is a protected load (CU must block on its value)"
            )
        elif isinstance(s, ir.Store):
            sv = scan_expr(s.value, var_depth, ivar_depth)
            _check(sv, f"value of store {s.id!r}", d, reasons)
            if s.guard is not None:
                sg = scan_expr(s.guard, var_depth, ivar_depth)
                _check(sg, f"guard of store {s.id!r}", d, reasons)
    return PEClass(
        pe_id=pe.id,
        compilable=not reasons,
        reasons=reasons,
        op_affine=base.op_affine,
    )


# ---------------------------------------------------------------------------
# vectorized expression evaluation
# ---------------------------------------------------------------------------


_NP_BINOPS = ir.NP_BINOPS


def vec_eval(
    e: ir.Expr,
    env: dict[str, np.ndarray],
    arrays: dict[str, np.ndarray],
    params: dict[str, int],
    n: int,
) -> np.ndarray:
    """Evaluate ``e`` over a flat iteration space of ``n`` points.

    ``env`` maps loop vars / ivars to length-``n`` vectors. Matches the
    scalar interpreter elementwise: numpy's ``//``/``%`` agree with
    Python's on ints and floats, gathers truncate indices toward zero
    like ``int()``, and mixed int/float promotion mirrors Python
    arithmetic on the same values.
    """
    if isinstance(e, ir.Const):
        v = e.v
        dtype = np.int64 if isinstance(v, int) and not isinstance(v, bool) else np.float64
        return np.full(n, v, dtype=dtype)
    if isinstance(e, ir.Param):
        v = params[e.name]
        dtype = np.int64 if isinstance(v, (int, np.integer)) else np.float64
        return np.full(n, v, dtype=dtype)
    if isinstance(e, (ir.Var, ir.Local)):
        return env[e.name]
    if isinstance(e, ir.Read):
        idx = vec_eval(e.index, env, arrays, params, n)
        return np.asarray(arrays[e.array])[_as_index(idx)]
    if isinstance(e, ir.Bin):
        return _NP_BINOPS[e.op](
            vec_eval(e.a, env, arrays, params, n),
            vec_eval(e.b, env, arrays, params, n),
        )
    if isinstance(e, ir.Un):
        return ir._UN_FNS[e.op](vec_eval(e.a, env, arrays, params, n))
    raise TraceCompileError(f"cannot vectorize {type(e).__name__}")


def _as_index(v: np.ndarray) -> np.ndarray:
    """``int()``-style truncation toward zero, as the interpreter casts
    addresses and read indices."""
    if np.issubdtype(v.dtype, np.integer):
        return v
    return np.trunc(v).astype(np.int64)


# ---------------------------------------------------------------------------
# iteration spaces
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class IterSpace:
    """A PE's ragged loop nest, flattened per depth (1-indexed lists with
    a dummy depth-0 root of one point).

    At depth d, the flat enumeration order is exactly the interpreter's
    execution order of the depth-d body invocations, so flat index ==
    §4 counter value - 1 (counters increment per invocation and never
    reset).
    """

    depth: int
    counts: list[int]  # counts[d]: number of depth-d body invocations
    parent: list[Optional[np.ndarray]]  # parent[d]: index into depth d-1
    index: list[Optional[np.ndarray]]  # index[d]: 0-based iteration number
    is_last: list[Optional[np.ndarray]]  # lastIter flag (§4.2(3))
    anc: list[list[np.ndarray]]  # anc[d][k-1]: depth-k ancestor flat index
    env: list[dict[str, np.ndarray]]  # visible loop vars + ivars per depth


# accumulated ivar values must stay comfortably inside int64: the
# interpreter computes them with arbitrary-precision Python ints, so a
# wrapped cumsum/power would silently break the bit-for-bit contract.
# (The global cumsum may wrap internally — two's-complement differences
# are still exact — but the *values* themselves must fit.)
_ACC_BOUND_BITS = 60.0


def build_iter_space(pe, arrays, params) -> IterSpace:
    """Flatten the PE's loop nest into closed-form numpy arrays.

    Raises TraceCompileError for the residual dynamically-detected
    cases (non-integer or int64-overflowing ivar accumulation).
    Structural ineligibility is `classify_pe`'s job — callers should
    classify first.
    """
    D = pe.depth
    counts: list[int] = [1]
    parent: list[Optional[np.ndarray]] = [None]
    index: list[Optional[np.ndarray]] = [None]
    is_last: list[Optional[np.ndarray]] = [None]
    anc: list[list[np.ndarray]] = [[]]
    env: list[dict[str, np.ndarray]] = [{}]

    for d in range(1, D + 1):
        loop = pe.path[d - 1]
        n_par = counts[d - 1]
        trips = vec_eval(loop.trip, env[d - 1], arrays, params, n_par)
        trips = _as_index(np.asarray(trips))  # int() truncation
        reps = np.maximum(trips, 0)  # range(trip): negative == empty
        total = int(reps.sum())
        par = np.repeat(np.arange(n_par, dtype=np.int64), reps)
        offs = np.zeros(n_par, dtype=np.int64)
        if n_par:
            np.cumsum(reps[:-1], out=offs[1:])
        j = np.arange(total, dtype=np.int64) - offs[par]
        if loop.predictable:
            last = j == (reps[par] - 1)
        else:
            # §4.2(3): unpredictable exit — the lastIter hint is 0
            last = np.zeros(total, dtype=bool)

        new_env = {k: v[par] for k, v in env[d - 1].items()}
        new_env[loop.var] = j
        for iv in loop.ivars:
            init = vec_eval(iv.init, env[d - 1], arrays, params, n_par)
            init = np.asarray(init)
            if iv.op == "+":
                step = np.asarray(
                    vec_eval(iv.step, new_env, arrays, params, total)
                )
                if not (
                    np.issubdtype(init.dtype, np.integer)
                    and np.issubdtype(step.dtype, np.integer)
                ):
                    raise TraceCompileError(
                        f"ivar {iv.name!r}: non-integer '+' accumulation "
                        "(cumsum would not be bit-exact)"
                    )
                # conservative magnitude bound (float is fine: wide margin)
                mag = float(
                    np.abs(init.astype(np.float64)).max(initial=0.0)
                ) + float(np.abs(step.astype(np.float64)).sum())
                if mag > 2.0 ** _ACC_BOUND_BITS:
                    raise TraceCompileError(
                        f"ivar {iv.name!r}: '+' accumulation may exceed "
                        "int64 (the interpreter uses arbitrary precision)"
                    )
                # v_j = init + sum_{t<j} step_t, segmented per parent
                excl = np.cumsum(step) - step
                base = (
                    excl[np.minimum(offs, max(total - 1, 0))]
                    if total
                    else np.zeros(n_par, dtype=np.int64)
                )
                new_env[iv.name] = init[par] + (excl - base[par])
            else:  # '*': loop-invariant step (classify_pe enforced)
                stepc = np.asarray(
                    vec_eval(iv.step, env[d - 1], arrays, params, n_par)
                )
                if not (
                    np.issubdtype(init.dtype, np.integer)
                    and np.issubdtype(stepc.dtype, np.integer)
                ):
                    raise TraceCompileError(
                        f"ivar {iv.name!r}: non-integer '*' accumulation "
                        "(powers would not be bit-exact)"
                    )
                maxj = max(int(reps.max(initial=0)) - 1, 0)
                a = float(np.abs(init.astype(np.float64)).max(initial=0.0))
                s = float(np.abs(stepc.astype(np.float64)).max(initial=0.0))
                bits = (np.log2(a) if a > 1.0 else 0.0) + (
                    maxj * np.log2(s) if s > 1.0 else 0.0
                )
                if bits > _ACC_BOUND_BITS:
                    raise TraceCompileError(
                        f"ivar {iv.name!r}: '*' accumulation may exceed "
                        "int64 (the interpreter uses arbitrary precision)"
                    )
                new_env[iv.name] = init[par] * stepc[par] ** j

        counts.append(total)
        parent.append(par)
        index.append(j)
        is_last.append(last)
        anc.append([a[par] for a in anc[d - 1]] + [np.arange(total, dtype=np.int64)])
        env.append(new_env)

    return IterSpace(
        depth=D,
        counts=counts,
        parent=parent,
        index=index,
        is_last=is_last,
        anc=anc,
        env=env,
    )


# ---------------------------------------------------------------------------
# AGU/CU interleave order (the per-PE ``seq`` stream)
# ---------------------------------------------------------------------------

_PAST_OPS = np.int64(2**62)  # "descended past this depth's statements"


def interleave_order(
    space: IterSpace, op_ids: list[tuple[str, int, int]]
) -> dict[str, np.ndarray]:
    """Per-op generation-order sequence numbers for the given ops.

    ``op_ids`` is a list of (op_id, depth, rank-at-depth) where rank is
    the op's position among the listed ops of the same depth in
    statement order. Execution order is the interpreter's DFS: at each
    body invocation, this depth's statements run in order, then the
    inner loop runs. The order is therefore lexicographic on the padded
    key [c_1, r_1, c_2, r_2, ...] where a request at depth d carries its
    ancestors' counters, r_k = +inf for the depths it descends past, and
    r_d = its statement rank.
    """
    if not op_ids:
        return {}
    D = space.depth
    width = 2 * D
    mats = []
    for op_id, d, rank in op_ids:
        n = space.counts[d]
        key = np.full((n, width), -1, dtype=np.int64)
        for k in range(1, d + 1):
            key[:, 2 * (k - 1)] = space.anc[d][k - 1] + 1  # §4 counter
            key[:, 2 * (k - 1) + 1] = _PAST_OPS if k < d else rank
        mats.append(key)
    stacked = np.concatenate(mats, axis=0)
    order = np.lexsort(stacked.T[::-1])
    seq_all = np.empty(len(stacked), dtype=np.int64)
    seq_all[order] = np.arange(len(stacked), dtype=np.int64)
    out: dict[str, np.ndarray] = {}
    off = 0
    for op_id, d, _rank in op_ids:
        n = space.counts[d]
        out[op_id] = seq_all[off : off + n]
        off += n
    return out
