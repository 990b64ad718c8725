"""Program-order schedule generation (paper §4).

The schedule representation, per memory operation of loop depth n:

  * an n-tuple of counters, one per loop depth, each incremented by 1 at
    every invocation of that loop's body — *never reset* when inner
    loops re-enter (§4 item 2),
  * comparisons between two operations use ONLY the element at their
    innermost shared depth k, with comparator direction configured from
    topological order (§4 item 3, synthesized in hazards.py),
  * one ``lastIter`` bit per non-monotonic loop depth, computed one
    iteration in advance when the loop is ``predictable`` (§4.1/§4.2(3)),
  * at stream end the AGU emits a sentinel (schedule = +inf, addr = +inf)
    signalling no further requests (§4.2(4)).

This module runs the AGU semantics (decoupled address threads, which by
the LoD check never depend on protected load values) ahead of time and
materializes each op's full request stream — the software analogue of
the AGU "running ahead" of the compute pipeline (§2.1.1).

Two implementations produce bit-identical streams (DESIGN.md §7):

  * ``_trace_pe`` — the reference interpreter: a per-iteration Python
    walk of the PE's replicated loop control; wall-clock scales with
    leaf iterations.
  * ``compile_pe_trace`` — the affine trace compiler: when
    ``affine.classify_pe`` accepts the PE, every array (sched counters,
    addresses, lastIter hints, seq numbers) is built closed-form with
    numpy over the flattened iteration space.

``trace_program(mode=...)`` selects per PE: ``"auto"`` (default)
compiles where possible and falls back to the interpreter, ``"interp"``
forces the reference, ``"compiled"`` raises ``TraceCompileError`` naming
the offending op when a PE is outside the compiled subset.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import affine
from repro_torch.core import dae as daelib
from repro_torch.core import loopir as ir

TraceCompileError = affine.TraceCompileError

TRACE_MODES = ("auto", "compiled", "interp")

SENTINEL = np.int64(2**62)


@dataclasses.dataclass
class OpTrace:
    """Full AGU request stream for one memory operation."""

    op_id: str
    pe_id: int
    depth: int
    is_store: bool
    sched: np.ndarray  # (n_req, depth) int64, counters start at 1
    addr: np.ndarray  # (n_req,) int64
    lastiter: np.ndarray  # (n_req, depth) bool
    seq: np.ndarray = None  # (n_req,) int64: per-PE AGU generation order

    @property
    def n_req(self) -> int:
        return len(self.addr)


@dataclasses.dataclass
class PETrace:
    pe_id: int
    ops: dict[str, OpTrace]
    n_leaf_iters: int  # total leaf-body invocations (for timing models)


def instance_rank_table(
    traces: dict[str, OpTrace],
    dae: "daelib.DAEResult",
    loop_pos: dict[int, int],
    op_pos: dict[str, int],
    fuse_group: dict[int, int],
    op_path: dict[str, tuple],
    key_len: Optional[int] = None,
) -> tuple[dict[str, np.ndarray], np.ndarray]:
    """Vectorized leaf-loop *instance* ranking of every request.

    Builds the polyhedral 2d+1 key of each request (static positions and
    per-depth counters interleaved, trailing leaf counter dropped so all
    iterations of one leaf instance share a key; fused siblings share the
    group leader's leaf position) as one int64 matrix per op, then ranks
    all requests globally with a single lexicographic ``np.unique``.

    Returns (per-op rank array aligned with the op's request stream,
    per-rank total request count). Replaces a per-request Python loop —
    this is what lets the sequential (LSQ) window logic run at paper
    scales.
    """
    if key_len is None and traces:
        # widest key any op can need: positions+counters interleaved for
        # every depth plus a trailing position slot
        key_len = max(2 * tr.depth + 1 for tr in traces.values())
    mats = []
    ops = sorted(traces)
    for op_id in ops:
        tr = traces[op_id]
        pe = dae.pes[tr.pe_id]
        path = op_path[op_id]
        key = np.full((tr.n_req, key_len), -1, dtype=np.int64)
        if tr.depth == pe.depth:
            for j in range(tr.depth - 1):
                key[:, 2 * j] = loop_pos[id(path[j])]
                key[:, 2 * j + 1] = tr.sched[:, j]
            leader = dae.pes[fuse_group[tr.pe_id]]
            key[:, 2 * (tr.depth - 1)] = loop_pos[id(leader.leaf)]
        else:  # parent-body op: its own micro-instance per iteration
            for j in range(tr.depth):
                key[:, 2 * j] = loop_pos[id(path[j])]
                key[:, 2 * j + 1] = tr.sched[:, j]
            key[:, 2 * tr.depth] = op_pos[op_id]
        mats.append(key)
    if not mats:
        return {}, np.zeros(0, dtype=np.int64)
    stacked = np.concatenate(mats, axis=0)
    _, inverse, counts = np.unique(
        stacked, axis=0, return_inverse=True, return_counts=True
    )
    inverse = inverse.reshape(-1)
    ranks: dict[str, np.ndarray] = {}
    off = 0
    for op_id in ops:
        n = traces[op_id].n_req
        ranks[op_id] = inverse[off : off + n]
        off += n
    return ranks, counts


def trace_program(
    program: ir.Program,
    dae: daelib.DAEResult,
    arrays: dict[str, np.ndarray],
    params: Optional[dict[str, int]] = None,
    mode: str = "auto",
    report: Optional[dict] = None,
    spec_out: Optional[list] = None,
    oracle_loads: Optional[dict] = None,
    predictor: str = "auto",
    spec_runahead: Optional[int] = None,
) -> dict[str, OpTrace]:
    """Generate the AGU request streams of every memory op in every PE.

    ``mode`` selects the per-PE trace path (module docstring); pass a
    dict as ``report`` to receive, per PE id, ``{"path": "compiled" |
    "interp" | "speculative", "reason": None | str, "op_affine": {...}}``.

    PEs marked speculative by ``dae.decouple(speculation="auto")`` are
    routed to the speculative AGU (``speculate.trace_spec_pe``) under
    ``"auto"``/``"interp"`` — its run-ahead is inherently interpretive,
    so ``"compiled"`` raises ``TraceCompileError`` for them. Pass a list
    as ``spec_out`` to receive the accumulated ``speculate.SpecPlan``
    (appended once; ``None`` when no PE speculates) — the engines
    consume it for epoch gating and squash traffic (DESIGN.md §10).
    ``oracle_loads`` optionally supplies the per-op oracle load streams
    the speculative AGU predicts against (callers that already ran a
    hooked ``loopir.interpret`` — validation, the DSE planner, the wave
    executor — pass theirs to avoid a second sequential walk); when
    absent and a PE speculates, one hooked run happens here.
    ``predictor`` (``dae.PREDICTORS``) and ``spec_runahead``
    (``SimParams.spec_runahead``; ``None`` = the speculate default)
    parameterize the built ``SpecPlan`` — they move gates and phantom
    traffic only, never the request streams.
    """
    assert mode in TRACE_MODES, f"unknown trace mode {mode!r}"
    params = params or {}
    out: dict[str, OpTrace] = {}
    spec_plan = None
    for pe in dae.pes:
        if pe.id in dae.spec:
            if mode == "compiled":
                raise TraceCompileError(
                    f"PE {pe.id} needs the speculative AGU (loss of "
                    f"decoupling: {'; '.join(dae.spec[pe.id].reasons)}) — "
                    f"speculative streams are interpreter-built; use "
                    f"trace_mode='auto'"
                )
            from repro_torch.core import speculate

            if spec_plan is None:
                assert predictor in daelib.PREDICTORS, (
                    f"unknown predictor {predictor!r} "
                    f"(choose from {daelib.PREDICTORS})"
                )
                spec_plan = speculate.SpecPlan(
                    predictor=predictor,
                    runahead=(
                        speculate.DEFAULT_RUNAHEAD
                        if spec_runahead is None
                        else int(spec_runahead)
                    ),
                )
                if oracle_loads is None:
                    oracle_loads = speculate.oracle_load_streams(
                        program, arrays, params
                    )
            t = speculate.trace_spec_pe(
                pe, dae.spec[pe.id], arrays, params, oracle_loads, spec_plan
            )
            if report is not None:
                report[pe.id] = {
                    "path": "speculative",
                    "reason": "; ".join(dae.spec[pe.id].reasons),
                    "op_affine": {},
                }
            out.update(t.ops)
            continue
        path, reason, cls = "interp", None, None
        if mode != "interp" and pe.fifo_in:
            # cross-PE FIFO consumers (DESIGN.md §11): streamed locals are
            # CU-side values the affine compiler has no stream for; the
            # interpreter walk skips them statically (taint set below)
            reason = (
                f"PE {pe.id} consumes cross-PE FIFO local(s) "
                f"{sorted(pe.fifo_in)} — streamed values are CU-side only"
            )
            if mode == "compiled":
                raise TraceCompileError(reason)
        elif mode != "interp":
            cls = affine.classify_pe(pe)
            if cls.compilable:
                try:
                    t = compile_pe_trace(pe, arrays, params)
                    path = "compiled"
                except TraceCompileError as e:
                    if mode == "compiled":
                        raise
                    reason = str(e)
            elif mode == "compiled":
                raise TraceCompileError(
                    f"PE {pe.id} (leaf loop {pe.leaf.var!r}) is outside "
                    f"the compiled subset: {'; '.join(cls.reasons)}"
                )
            else:
                reason = "; ".join(cls.reasons)
        if path == "interp":
            t = _trace_pe(pe, arrays, params)
        if report is not None:
            report[pe.id] = {
                "path": path,
                "reason": reason,
                "op_affine": dict(cls.op_affine) if cls is not None else {},
            }
        out.update(t.ops)
    if spec_out is not None:
        spec_out.append(spec_plan)
    return out


def _static_op_meta(
    pe: daelib.PE,
) -> tuple[list[tuple], dict[str, int], dict[str, bool]]:
    """(mem stmts with depth+rank, op depth, op is_store) — statically,
    so zero-request ops (a loop that never executes) still declare the
    depth/kind the hazard plan derived from the same static paths."""
    mem: list[tuple] = []  # (stmt, depth, rank-at-depth)
    rank_at: dict[int, int] = {}
    op_depth: dict[str, int] = {}
    op_store: dict[str, bool] = {}
    for s, d in pe.stmts:
        if isinstance(s, (ir.Load, ir.Store)):
            r = rank_at.get(d, 0)
            rank_at[d] = r + 1
            mem.append((s, d, r))
            op_depth[s.id] = d
            op_store[s.id] = isinstance(s, ir.Store)
    return mem, op_depth, op_store


def compile_pe_trace(
    pe: daelib.PE, arrays: dict[str, np.ndarray], params: dict[str, int]
) -> PETrace:
    """Closed-form construction of the PE's request streams.

    Exactly equivalent to ``_trace_pe`` for PEs inside the compiled
    subset (``affine.classify_pe``): counters are flat invocation
    indices + 1, lastIter flags come from the per-depth iteration
    spaces, addresses are one vectorized evaluation per op, and the
    per-PE ``seq`` interleave is a single lexsort of padded
    (counter, statement-rank) keys.
    """
    space = affine.build_iter_space(pe, arrays, params)
    mem, op_depth, op_store = _static_op_meta(pe)
    seqs = affine.interleave_order(space, [(s.id, d, r) for s, d, r in mem])
    ops: dict[str, OpTrace] = {}
    # emit in pe.mem_ops order, matching _trace_pe: the trace dict's key
    # order is the engines' deterministic port-scan order, so the paths
    # must agree on it or same-cycle ties resolve differently (observed
    # as a 2-cycle drift on matpower at 8x scale before this ordering)
    mem.sort(key=lambda t: pe.mem_ops.index(t[0].id))
    for s, d, _r in mem:
        n = space.counts[d]
        if n:
            addr = affine._as_index(
                np.asarray(
                    affine.vec_eval(s.addr, space.env[d], arrays, params, n)
                )
            ).astype(np.int64, copy=False)
            sched = np.stack(
                [space.anc[d][k - 1] + 1 for k in range(1, d + 1)], axis=1
            )
            lastiter = np.stack(
                [
                    space.is_last[k][space.anc[d][k - 1]]
                    for k in range(1, d + 1)
                ],
                axis=1,
            )
        else:
            addr = np.zeros(0, dtype=np.int64)
            sched = np.zeros((0, d), dtype=np.int64)
            lastiter = np.zeros((0, d), dtype=bool)
        ops[s.id] = OpTrace(
            op_id=s.id,
            pe_id=pe.id,
            depth=d,
            is_store=op_store[s.id],
            sched=sched,
            addr=addr,
            lastiter=lastiter,
            seq=seqs[s.id],
        )
    return PETrace(
        pe_id=pe.id, ops=ops, n_leaf_iters=space.counts[pe.depth]
    )


def _trace_pe(
    pe: daelib.PE, arrays: dict[str, np.ndarray], params: dict[str, int]
) -> PETrace:
    # recorded streams per op
    rec: dict[str, dict[str, list]] = {
        op_id: {"sched": [], "addr": [], "lastiter": [], "seq": []}
        for op_id in pe.mem_ops
    }
    seq_counter = [0]
    # static metadata: a zero-trip loop's ops emit no requests but must
    # still declare the depth/kind the hazard plan sees (compiled-path
    # parity; previously these silently defaulted to pe.depth / False)
    _, op_depth, op_store = _static_op_meta(pe)

    # cross-PE streamed locals (DESIGN.md §11) and anything derived from
    # them are CU-side values — the LoD check already rejects address or
    # trip uses, so the AGU walk must skip those SetLocals entirely
    tainted = set(pe.fifo_in)
    changed = True
    while changed:
        changed = False
        for s, _d in pe.stmts:
            if isinstance(s, ir.SetLocal) and s.name not in tainted:
                locs, _ = daelib.expr_deps(s.value)
                if locs & tainted:
                    tainted.add(s.name)
                    changed = True

    # group the PE's statements by depth
    by_depth: dict[int, list[ir.Stmt]] = {}
    for s, d in pe.stmts:
        by_depth.setdefault(d, []).append(s)

    counters = [0] * (pe.depth + 1)  # 1-indexed
    n_leaf = 0

    env = ir._Env()

    def eval_expr(e: ir.Expr, scope: ir._Env):
        # AGU-side evaluation: LoadVal is impossible here (LoD check)
        return ir._eval(e, scope, arrays, params, {})

    # per-depth "is current iteration the last one" flags
    last_flags = [False] * (pe.depth + 1)

    def run_depth(d: int, scope: ir._Env):
        nonlocal n_leaf
        loop = pe.path[d - 1]
        loop_scope = ir._Env(scope)
        for iv in loop.ivars:
            loop_scope.define(iv.name, eval_expr(iv.init, scope))
        trip = int(eval_expr(loop.trip, scope))
        for i in range(trip):
            counters[d] += 1
            body = ir._Env(loop_scope)
            body.define(loop.var, i)
            # §4.2(3): lastIter computed one iteration in advance when the
            # loop predicate is predictable; otherwise the hint is 0.
            last_flags[d] = (i == trip - 1) if loop.predictable else False
            if d == pe.depth:
                n_leaf += 1
            for s in by_depth.get(d, ()):  # this depth's statements
                exec_stmt(s, body, d)
            if d < pe.depth:
                run_depth(d + 1, body)
            for iv in loop.ivars:
                cur = loop_scope.get(iv.name)
                step = eval_expr(iv.step, body)
                loop_scope.vals[iv.name] = (
                    cur + step if iv.op == "+" else cur * step
                )

    def exec_stmt(s: ir.Stmt, scope: ir._Env, d: int):
        if isinstance(s, (ir.Load, ir.Store)):
            # speculation (§6): requests are generated unconditionally —
            # guarded stores get a valid bit from the CU at sim time
            a = int(eval_expr(s.addr, scope))
            r = rec[s.id]
            r["sched"].append(tuple(counters[1 : d + 1]))
            r["addr"].append(a)
            r["lastiter"].append(tuple(last_flags[1 : d + 1]))
            r["seq"].append(seq_counter[0])
            seq_counter[0] += 1
        elif isinstance(s, ir.SetLocal):
            if s.name in tainted:
                return  # FIFO-streamed (or derived): CU-side only
            # AGU keeps only address-feeding locals; evaluating all
            # load-free locals is a superset and harmless
            _, lds = daelib.expr_deps(s.value)
            if not lds:
                v = eval_expr(s.value, scope)
                if not scope.set_existing(s.name, v):
                    scope.define(s.name, v)
        # nested Loop stmts cannot appear: PE stmts are flattened

    if pe.depth >= 1:
        run_depth(1, env)

    ops = {}
    for op_id in pe.mem_ops:
        r = rec[op_id]
        d = op_depth[op_id]
        n = len(r["addr"])
        ops[op_id] = OpTrace(
            op_id=op_id,
            pe_id=pe.id,
            depth=d,
            is_store=op_store[op_id],
            sched=np.array(r["sched"], dtype=np.int64).reshape(n, d),
            addr=np.array(r["addr"], dtype=np.int64).reshape(n),
            lastiter=np.array(r["lastiter"], dtype=bool).reshape(n, d),
            seq=np.array(r["seq"], dtype=np.int64).reshape(n),
        )
    return PETrace(pe_id=pe.id, ops=ops, n_leaf_iters=n_leaf)
