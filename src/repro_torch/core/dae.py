"""DAE decoupling pass (paper §2.1.2, Fig. 3).

Decouples a loop forest into Processing Elements:

  * each *leaf* loop becomes its own PE, replicating the loop control of
    all its ancestors,
  * parent-body statements are assigned to the PE of the next leaf loop
    in topological order (Fig. 3: "Parent loop body instructions are
    included only if they come before the leaf loop"),
  * scalar values flowing between PEs become FIFO edges, written in the
    producer loop's exit block and read in the consumer's pre-header,
  * each PE is further split AGU/CU by def-use closure: the AGU keeps
    the address/trip computation (plus §4.2 schedule instrumentation,
    added later), the CU keeps value computation; dead code on each side
    is eliminated (we record instruction counts so the DCE effect is
    observable in tests/benchmarks).

Loss-of-decoupling (LoD): if an address or trip count depends on a
*protected* load value (``LoadVal``), the AGU cannot run ahead. The
paper resolves this with speculation from prior work [62]. Under
``decouple(speculation="off")`` (the default) such programs are
rejected with a diagnostic naming the offending op/loop/local; under
``speculation="auto"`` the PE is instead marked speculative
(``DAEResult.spec``) and the AGU runs ahead with a value predictor
(``predictor=`` selects from the zoo in ``PREDICTORS``), squashing
mis-speculated epochs through the §6 valid-bit machinery
(``core/speculate.py``, DESIGN.md §10).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

import numpy as np

from repro_torch.core import loopir as ir


class LossOfDecoupling(Exception):
    """Raised when an AGU would depend on a protected load value."""


class CUContractError(RuntimeError):
    """Internal-contract violation between an engine and a CU: a call
    the CU's protocol forbids (e.g. ``feed`` on a load-free ``VecCU``,
    or script-recording a FIFO-coupled PE whose consumption order is
    timing-dependent). A mis-wired CU factory fails loudly here instead
    of corrupting the value stream."""


SPECULATION_MODES = ("off", "auto")

# The speculative-AGU predictor zoo (core/speculate.py, DESIGN.md §10):
# value predictors a speculative AGU port can run ahead on. Defined here
# (not in speculate.py) so every layer that threads the knob —
# ``decouple``, ``simulator.Compiled``, ``executor.build_wave_plan``,
# ``dse.spec`` — validates against one tuple without import cycles.
# ``"auto"`` runs a per-port tournament and follows the best-scoring
# component predictor.
PREDICTORS = ("last", "stride", "context", "auto")

# The speculative AGU (``core/speculate.py`` in the JAX package) is not
# part of this package yet; every site that would route a speculative
# PE to it raises ``NotImplementedError`` with this message.
SPECULATE_NOT_PORTED = (
    "the speculative AGU (core/speculate.py) is not ported to repro_torch "
    "yet: ROADMAP.md queue 1, item 8 (speculation and streaming)"
)


@dataclasses.dataclass(frozen=True)
class SpecInfo:
    """Why one PE's AGU cannot run ahead without speculation.

    Produced by ``decouple(speculation="auto")`` instead of raising
    ``LossOfDecoupling``: ``loads`` are the protected load ops whose
    values the AGU's address/trip closure consumes (each becomes a
    value-predicted port of the speculative AGU — predictor zoo,
    DESIGN.md §10); ``reasons`` are the exact diagnostics
    ``speculation="off"`` raises.
    """

    pe_id: int
    loads: tuple  # load op ids the AGU depends on, sorted
    reasons: tuple  # one message per offending expression/local


# ---------------------------------------------------------------------------
# def-use helpers
# ---------------------------------------------------------------------------


def expr_deps(e: ir.Expr) -> tuple[set[str], set[str]]:
    """Returns (local names, protected load ids) referenced by ``e``."""
    locals_, loads = set(), set()

    def walk(x: ir.Expr):
        if isinstance(x, ir.Local):
            locals_.add(x.name)
        elif isinstance(x, ir.LoadVal):
            loads.add(x.load_id)
        elif isinstance(x, ir.Bin):
            walk(x.a)
            walk(x.b)
        elif isinstance(x, ir.Un):
            walk(x.a)
        elif isinstance(x, ir.Read):
            walk(x.index)

    walk(e)
    return locals_, loads


def _stmt_exprs(s: ir.Stmt) -> list[ir.Expr]:
    if isinstance(s, ir.Load):
        return [s.addr]
    if isinstance(s, ir.Store):
        out = [s.addr, s.value]
        if s.guard is not None:
            out.append(s.guard)
        return out
    if isinstance(s, ir.SetLocal):
        return [s.value]
    if isinstance(s, ir.Loop):
        out = [s.trip]
        for iv in s.ivars:
            out.extend([iv.init, iv.step])
        for b in s.body:
            out.extend(_stmt_exprs(b))
        return out
    raise TypeError(s)


# ---------------------------------------------------------------------------
# PE structure
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class PE:
    id: int
    # full loop path of the leaf, outermost first (replicated control)
    path: tuple[ir.Loop, ...]
    # statements executed by this PE *inside the leaf body* plus any
    # parent-body statements assigned to it: list of (stmt, depth) where
    # depth is the 1-indexed loop depth the stmt executes at
    stmts: list[tuple[ir.Stmt, int]] = dataclasses.field(default_factory=list)
    mem_ops: list[str] = dataclasses.field(default_factory=list)
    # locals this PE defines that other PEs consume -> FIFO writes
    fifo_out: set[str] = dataclasses.field(default_factory=set)
    # locals this PE consumes that other PEs define -> FIFO reads
    fifo_in: set[str] = dataclasses.field(default_factory=set)
    # AGU/CU instruction counts after the def-use split + DCE
    agu_stmt_count: int = 0
    cu_stmt_count: int = 0

    @property
    def leaf(self) -> ir.Loop:
        return self.path[-1]

    @property
    def depth(self) -> int:
        return len(self.path)


@dataclasses.dataclass
class DAEResult:
    pes: list[PE]
    op_to_pe: dict[str, int]
    # FIFO edges: (producer PE id, consumer PE id, local name, shared depth)
    fifo_edges: list[tuple[int, int, str, int]]
    # PE id -> SpecInfo for PEs that need the speculative AGU (only
    # populated under decouple(speculation="auto"); empty otherwise)
    spec: dict[int, SpecInfo] = dataclasses.field(default_factory=dict)
    # the predictor knob the speculative AGU traces under (PREDICTORS);
    # carried for diagnostics — prediction itself is trace-time-only
    # (core/speculate.py), so decoupling is predictor-independent
    predictor: str = "auto"

    def shared_depth(self, op_a: str, op_b: str, program: ir.Program) -> int:
        """Number of common loops of the two ops' original nests."""
        _, pa = program.find_op(op_a)
        _, pb = program.find_op(op_b)
        k = 0
        for la, lb in zip(pa, pb):
            if la is lb:
                k += 1
            else:
                break
        return k


def decouple(
    program: ir.Program, speculation: str = "off", predictor: str = "auto"
) -> DAEResult:
    """Run the decoupling pass over the program's loop forest.

    ``speculation`` selects the loss-of-decoupling policy: ``"off"``
    raises ``LossOfDecoupling`` when an AGU's address/trip closure
    touches a protected load value, ``"auto"`` marks the PE speculative
    instead (``DAEResult.spec``) so the trace front-end can build the
    speculative AGU (``core/speculate.py``). ``predictor`` names the
    value predictor that AGU runs ahead on (``PREDICTORS``); it cannot
    change *which* PEs are marked — only how their trace predicts — and
    is validated and carried here so every backend shares one knob.
    """
    assert speculation in SPECULATION_MODES, (
        f"unknown speculation mode {speculation!r}"
    )
    assert predictor in PREDICTORS, (
        f"unknown predictor {predictor!r} (choose from {PREDICTORS})"
    )
    pes: list[PE] = []
    op_to_pe: dict[str, int] = {}
    # local name -> PE id that defines it (for FIFO edge construction)
    local_def_pe: dict[str, int] = {}
    local_use_pes: dict[str, set[int]] = {}

    # ---- step 1: assign leaf loops and statements to PEs -----------------

    def is_leaf(lp: ir.Loop) -> bool:
        return not any(isinstance(s, ir.Loop) for s in lp.body)

    def walk(stmts, path: tuple[ir.Loop, ...], pending: list[tuple[ir.Stmt, int]]):
        """``pending`` collects parent-body stmts awaiting the next leaf."""
        for s in stmts:
            if isinstance(s, ir.Loop):
                sub_path = path + (s,)
                if is_leaf(s):
                    pe = PE(id=len(pes), path=sub_path)
                    pe.stmts = list(pending)
                    pending.clear()
                    for b in s.body:
                        pe.stmts.append((b, len(sub_path)))
                        if isinstance(b, (ir.Load, ir.Store)):
                            pe.mem_ops.append(b.id)
                            op_to_pe[b.id] = pe.id
                    pes.append(pe)
                else:
                    walk(s.body, sub_path, pending)
            else:
                pending.append((s, len(path)))
                if isinstance(s, (ir.Load, ir.Store)):
                    # memory op directly in a parent body: belongs to the
                    # next leaf PE (recorded when that PE is created)
                    pass

    for top in program.loops:
        pending: list[tuple[ir.Stmt, int]] = []
        if is_leaf(top):
            pe = PE(id=len(pes), path=(top,))
            for b in top.body:
                pe.stmts.append((b, 1))
                if isinstance(b, (ir.Load, ir.Store)):
                    pe.mem_ops.append(b.id)
                    op_to_pe[b.id] = pe.id
            pes.append(pe)
        else:
            walk(top.body, (top,), pending)
            if pending and pes:
                # trailing parent-body stmts: assign to the last PE
                pes[-1].stmts.extend(pending)

    # register mem ops that came in via ``pending`` parent stmts
    for pe in pes:
        for s, _d in pe.stmts:
            if isinstance(s, (ir.Load, ir.Store)) and s.id not in op_to_pe:
                pe.mem_ops.append(s.id)
                op_to_pe[s.id] = pe.id

    # ---- step 2: FIFO edges for cross-PE scalar locals --------------------

    for pe in pes:
        for s, _d in pe.stmts:
            if isinstance(s, ir.SetLocal):
                local_def_pe.setdefault(s.name, pe.id)
            for e in _stmt_exprs(s) if not isinstance(s, ir.Loop) else []:
                for name in expr_deps(e)[0]:
                    local_use_pes.setdefault(name, set()).add(pe.id)
        # ivar init/steps may also use locals
        for lp in pe.path:
            for iv in lp.ivars:
                for e in (iv.init, iv.step):
                    for name in expr_deps(e)[0]:
                        local_use_pes.setdefault(name, set()).add(pe.id)

    fifo_edges: list[tuple[int, int, str, int]] = []
    for name, users in sorted(local_use_pes.items()):
        if name not in local_def_pe:
            continue
        prod = local_def_pe[name]
        for u in sorted(users):
            if u != prod:
                shared = _shared_depth_pe(pes[prod], pes[u])
                fifo_edges.append((prod, u, name, shared))
                pes[prod].fifo_out.add(name)
                pes[u].fifo_in.add(name)

    # ---- step 3: AGU/CU def-use split + DCE accounting + LoD check --------

    spec: dict[int, SpecInfo] = {}
    for pe in pes:
        agu, cu, si = _split_agu_cu(pe, speculation)
        pe.agu_stmt_count = agu
        pe.cu_stmt_count = cu
        if si is not None:
            spec[pe.id] = si

    return DAEResult(
        pes=pes, op_to_pe=op_to_pe, fifo_edges=fifo_edges, spec=spec,
        predictor=predictor,
    )


class CU:
    """Compute-unit thread of one PE (the value half of the AGU/CU
    split): executes leaf iterations in order, consuming load values
    (in-order FIFO per load op) and producing store values with §6 valid
    bits. Shared by both simulator engines. A CU with protected loads
    (or loop-carried locals) is inherently sequential, so it stays a
    generator; *load-free value chains* take the vectorized ``VecCU``
    path instead (``make_cu`` decides)."""

    def __init__(self, pe: PE, arrays, params, fifo_edges=()):
        self.pe = pe
        self.arrays = arrays
        self.params = params
        self.time = 0
        self.done = False
        # load op id, or ("fifo_pop", edge idx) / ("fifo_push", edge idx)
        self.waiting_on: Optional[Union[str, tuple]] = None
        # value pending for the engine while waiting on a fifo_push
        self.push_value: float = 0.0
        # this PE's slice of DAEResult.fifo_edges, in edge-index order
        self.fifo_in_edges = [
            (i, name)
            for i, (_p, c, name, _d) in enumerate(fifo_edges)
            if c == pe.id
        ]
        self.fifo_out_edges = [
            (i, name)
            for i, (p, _c, name, _d) in enumerate(fifo_edges)
            if p == pe.id
        ]
        self.outbox: list[tuple[str, float, bool]] = []
        self.gen = self._generator()
        self._advance(prime=True)

    def _generator(self):
        pe = self.pe
        by_depth: dict[int, list[ir.Stmt]] = {}
        for s, d in pe.stmts:
            by_depth.setdefault(d, []).append(s)

        def ev(e, scope, loadvals):
            return ir._eval(e, scope, self.arrays, self.params, loadvals)

        def run_depth(d, scope, outer_loadvals):
            # load values of enclosing iterations stay visible to inner
            # trips/ivars/values (mirrors loopir.interpret's chaining —
            # load-dependent trip counts need them, DESIGN.md §10)
            loop = pe.path[d - 1]
            loop_scope = ir._Env(scope)
            if d == pe.depth:
                # one pop per consumer leaf instance, at entry — before
                # the trip/ivars so the engines stall the whole instance
                # until its token arrives (core/fifo.py token protocol)
                for eidx, name in self.fifo_in_edges:
                    v = yield ("fifo_pop", eidx)
                    loop_scope.define(name, v)
            for iv in loop.ivars:
                loop_scope.define(iv.name, ev(iv.init, scope, outer_loadvals))
            trip = int(ev(loop.trip, scope, outer_loadvals))
            for i in range(trip):
                body = ir._Env(loop_scope)
                body.define(loop.var, i)
                loadvals: dict[str, float] = dict(outer_loadvals)
                for s in by_depth.get(d, ()):
                    if isinstance(s, ir.Load):
                        v = yield ("need", s.id)
                        loadvals[s.id] = v
                    elif isinstance(s, ir.Store):
                        valid = True
                        if s.guard is not None:
                            valid = bool(ev(s.guard, body, loadvals))
                        val = ev(s.value, body, loadvals) if valid else 0.0
                        self.outbox.append((s.id, val, valid))
                    elif isinstance(s, ir.SetLocal):
                        v = ev(s.value, body, loadvals)
                        if not body.set_existing(s.name, v):
                            body.define(s.name, v)
                if d < pe.depth:
                    yield from run_depth(d + 1, body, loadvals)
                for iv in loop.ivars:
                    cur = loop_scope.get(iv.name)
                    step = ev(iv.step, body, outer_loadvals)
                    loop_scope.vals[iv.name] = (
                        cur + step if iv.op == "+" else cur * step
                    )
            if d == pe.depth:
                # one push per producer leaf instance, at exit; a
                # zero-trip instance pushes the shared-depth init value
                # (core/fifo.py guarantees that init exists)
                for eidx, name in self.fifo_out_edges:
                    yield ("fifo_push", eidx, loop_scope.get(name))

        if pe.depth >= 1:
            yield from run_depth(1, ir._Env(), {})

    def _advance(self, value: float = 0.0, prime: bool = False):
        try:
            item = next(self.gen) if prime else self.gen.send(value)
            while True:
                if item[0] == "need":
                    self.waiting_on = item[1]
                    return
                if item[0] == "fifo_pop":
                    self.waiting_on = ("fifo_pop", item[1])
                    return
                if item[0] == "fifo_push":
                    self.waiting_on = ("fifo_push", item[1])
                    self.push_value = float(item[2])
                    return
                item = next(self.gen)  # pragma: no cover (stores don't yield)
        except StopIteration:
            self.done = True
            self.waiting_on = None

    def feed(self, value: float, at_time: int):
        assert self.waiting_on is not None
        self.time = max(self.time, at_time)
        self.waiting_on = None
        self._advance(value)


class VecCU:
    """Vectorized compute unit for load-free value chains.

    When a PE has no protected loads and every store value/guard is
    vectorizable (``affine.classify_cu``), the whole outbox — store
    values with §6 valid bits, in AGU/CU generation order — is one
    closed-form numpy evaluation over the PE's iteration space instead
    of a per-iteration generator walk. The interface matches ``CU``
    exactly as the engines use it: the full ``outbox`` is ready
    immediately (a load-free generator CU also runs to completion when
    primed, so event timing is identical), ``done`` is True, and
    ``feed`` can never legally be called.
    """

    def __init__(self, pe: PE, arrays, params):
        from repro_torch.core import affine

        self.pe = pe
        self.time = 0
        self.done = True
        self.waiting_on = None
        space = affine.build_iter_space(pe, arrays, params)
        stores: list[tuple] = []  # (stmt, depth, rank-at-depth)
        rank_at: dict[int, int] = {}
        for s, d in pe.stmts:
            if isinstance(s, (ir.Load, ir.Store)):
                r = rank_at.get(d, 0)
                rank_at[d] = r + 1
                if isinstance(s, ir.Store):
                    stores.append((s, d, r))
        seqs = affine.interleave_order(
            space, [(s.id, d, r) for s, d, r in stores]
        )
        flat: list[tuple[int, str, float, bool]] = []
        for s, d, _r in stores:
            n = space.counts[d]
            if not n:
                continue
            env = space.env[d]
            val = np.asarray(affine.vec_eval(s.value, env, arrays, params, n))
            if s.guard is not None:
                valid = np.asarray(
                    affine.vec_eval(s.guard, env, arrays, params, n)
                ).astype(bool)
                val = np.where(valid, val, np.zeros_like(val))
            else:
                valid = np.ones(n, dtype=bool)
            seq = seqs[s.id]
            for i in range(n):
                flat.append((int(seq[i]), s.id, val[i].item(), bool(valid[i])))
        flat.sort()
        self.outbox: list[tuple[str, float, bool]] = [
            (op_id, v, ok) for _s, op_id, v, ok in flat
        ]

    def feed(self, value: float, at_time: int):
        raise CUContractError(
            f"PE {self.pe.id}: feed({value!r}) on a load-free VecCU — "
            "the engine delivered a value no load requested"
        )


def make_cu(pe: PE, arrays, params, trace_mode: str = "auto", fifo_edges=()):
    """CU factory: vectorized value stream for load-free PEs, the
    generator otherwise (or always, under ``trace_mode="interp"``).
    FIFO-coupled PEs always take the generator: their pop/push yields
    interleave with the engine's queue service (DESIGN.md §11)."""
    if pe.fifo_in or pe.fifo_out:
        return CU(pe, arrays, params, fifo_edges)
    if trace_mode != "interp":
        from repro_torch.core import affine

        if affine.classify_cu(pe).compilable:
            try:
                return VecCU(pe, arrays, params)
            except (affine.TraceCompileError, IndexError):
                # residual dynamic ineligibility (non-integer ivar
                # accumulation; a guard-protected Read evaluated
                # speculatively out of bounds): the generator is exact
                pass
    return CU(pe, arrays, params)


# ---------------------------------------------------------------------------
# CU script recording / replay (the DSE batch runner's shared dataflow)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class CUScript:
    """The complete, timing-independent behaviour of one PE's CU.

    A CU is pure dataflow: it consumes protected load values in a fixed
    order (``feeds``) and emits outbox items — ``(store op id, value,
    §6 valid bit)`` — at fixed points of that consumption sequence.
    *When* each feed arrives is timing; *what* happens is not. A script
    records the what once (per program/arrays/params), so a design-space
    sweep can replay the CU in O(1) Python per feed for every timing
    configuration instead of re-walking the IR per iteration
    (``ReplayCU``; see DESIGN.md §9).

    ``offsets[k]`` is the number of outbox items emitted after ``k``
    feeds (``offsets[0]`` = items emitted when the CU is primed, before
    any load value arrives; load-free PEs emit everything there).
    """

    pe_id: int
    items: list  # [(op_id, value, valid)] in emission order
    feeds: list  # load op ids, in consumption order
    offsets: list  # len(feeds)+1 cumulative item counts


def record_cu_script(
    pe: PE, arrays, params, oracle_loads: dict, trace_mode: str = "auto"
) -> CUScript:
    """Run one PE's CU to completion against the oracle's load-value
    streams and record its script.

    ``oracle_loads`` maps load op id -> the op's in-order value stream
    (``loopir.interpret``'s trace hook produces exactly this). Sound
    because the engines' validated delivery contract guarantees every
    load receives its oracle value regardless of timing parameters, so
    the recorded emission sequence is what any simulation of this
    (program, arrays, params) would produce.
    """
    if pe.fifo_in or pe.fifo_out:
        raise CUContractError(
            f"PE {pe.id}: cannot record a CU script for a FIFO-coupled "
            "PE — its pop/push interleaving is engine-serviced, not an "
            "oracle load stream (the DSE planner must not share CU "
            "scripts for streaming programs)"
        )
    cu = make_cu(pe, arrays, params, trace_mode)
    feeds: list[str] = []
    offsets: list[int] = [len(cu.outbox)]
    cursor: dict[str, int] = {}
    while cu.waiting_on is not None:
        op_id = cu.waiting_on
        i = cursor.get(op_id, 0)
        cursor[op_id] = i + 1
        feeds.append(op_id)
        cu.feed(float(oracle_loads[op_id][i]), 0)
        offsets.append(len(cu.outbox))
    assert cu.done, f"PE {pe.id}: CU neither waiting nor done"
    return CUScript(
        pe_id=pe.id, items=list(cu.outbox), feeds=feeds, offsets=offsets
    )


class ReplayCU:
    """Replay a recorded ``CUScript`` with the exact engine-facing
    behaviour of the CU it was recorded from: same ``outbox`` items in
    the same feed-relative positions, same ``waiting_on`` sequence, same
    ``done`` transitions — at O(1) Python cost per feed. Engines drain
    ``outbox`` after priming and after every ``feed``, so emission
    timing (and therefore simulated cycles) is bit-identical to running
    the generator/vectorized CU in place."""

    __slots__ = ("script", "k", "outbox", "done", "waiting_on", "time")

    def __init__(self, script: CUScript):
        self.script = script
        self.k = 0
        self.outbox = list(script.items[: script.offsets[0]])
        n = len(script.feeds)
        self.done = n == 0
        self.waiting_on = script.feeds[0] if n else None
        self.time = 0

    def feed(self, value: float, at_time: int):
        assert self.waiting_on is not None
        self.time = max(self.time, at_time)
        s = self.script
        k = self.k = self.k + 1
        self.outbox.extend(s.items[s.offsets[k - 1] : s.offsets[k]])
        if k < len(s.feeds):
            self.waiting_on = s.feeds[k]
        else:
            self.waiting_on = None
            self.done = True


def _shared_depth_pe(a: PE, b: PE) -> int:
    k = 0
    for la, lb in zip(a.path, b.path):
        if la is lb:
            k += 1
        else:
            break
    return k


def _split_agu_cu(
    pe: PE, speculation: str = "off"
) -> tuple[int, int, Optional[SpecInfo]]:
    """Compute AGU/CU statement counts after the def-use split.

    AGU closure: everything feeding addresses, trip counts and ivar
    updates. If that closure touches a protected LoadVal, the AGU can no
    longer run ahead (loss of decoupling): under ``speculation="off"``
    raise a diagnostic naming the consuming statement (op id, loop trip,
    or ivar — mirroring ``TraceCompileError``'s offender-naming); under
    ``"auto"`` collect the offending loads into a ``SpecInfo`` for the
    speculative AGU. Returns ``(agu_count, cu_count, SpecInfo | None)``.
    """
    # AGU-side expressions, each with the statement that owns it (the
    # diagnostics below must name the consumer, not just the load)
    agu_exprs: list[tuple[ir.Expr, str]] = []
    for lp in pe.path:
        agu_exprs.append((lp.trip, f"trip of loop {lp.var!r}"))
        for iv in lp.ivars:
            agu_exprs.append((iv.init, f"init of ivar {iv.name!r}"))
            agu_exprs.append((iv.step, f"step of ivar {iv.name!r}"))
    for s, _d in pe.stmts:
        if isinstance(s, (ir.Load, ir.Store)):
            agu_exprs.append((s.addr, f"address of op {s.id!r}"))

    spec_loads: set[str] = set()
    spec_reasons: list[str] = []

    def offend(what: str, lds: set) -> None:
        # collect even under "off": whether the auto hint is honest
        # depends on the *whole* closure (cross-PE loads re-reject)
        spec_loads.update(lds)
        spec_reasons.append(
            f"PE {pe.id}: {what} depends on protected load(s) "
            f"{sorted(lds)} — loss of decoupling "
            f'(speculation="auto" runs this AGU speculatively)'
        )

    needed_locals: set[str] = set()
    frontier: list[tuple[str, str]] = []  # (local name, consuming stmt)
    for e, what in agu_exprs:
        ls, lds = expr_deps(e)
        if lds:
            offend(what, lds)
        frontier.extend((name, what) for name in sorted(ls))
    # transitive closure over SetLocal defs within the PE
    setlocals = {
        s.name: s for s, _d in pe.stmts if isinstance(s, ir.SetLocal)
    }
    while frontier:
        name, what = frontier.pop()
        if name in needed_locals:
            continue
        needed_locals.add(name)
        if name in setlocals:
            ls, lds = expr_deps(setlocals[name].value)
            if lds:
                offend(f"AGU local {name!r} (SetLocal feeding {what})", lds)
            frontier.extend(
                (n, what) for n in sorted(ls - needed_locals)
            )

    streamed = sorted(needed_locals & pe.fifo_in)
    if streamed:
        # a FIFO token arrives through the CU's pop path — an AGU
        # address/trip reading it could never run ahead. Raised in both
        # speculation modes: the speculative AGU predicts load ports,
        # not cross-PE streams
        raise LossOfDecoupling(
            f"PE {pe.id}: AGU depends on cross-PE streamed local(s) "
            f"{streamed} — FIFO values cannot feed addresses or trips"
        )

    agu_count = 0
    cu_count = 0
    for s, _d in pe.stmts:
        if isinstance(s, (ir.Load, ir.Store)):
            agu_count += 1  # send_address
            cu_count += 1  # consume_value / produce_value
        elif isinstance(s, ir.SetLocal):
            if s.name in needed_locals:
                agu_count += 1
            # value-side locals always stay in the CU (DCE removes them
            # from the AGU unless address-feeding)
            cu_count += 1

    spec: Optional[SpecInfo] = None
    if spec_loads:
        foreign = sorted(spec_loads - set(pe.mem_ops))
        if foreign:
            # the predicted port must live in this PE: its delivery
            # stream is what resolves mis-speculated epochs — raised in
            # BOTH modes, so "off" never promises an auto that would
            # just re-reject
            raise LossOfDecoupling(
                f"PE {pe.id}: AGU depends on load(s) {foreign} of another "
                f"PE — cross-PE speculation is not supported"
            )
        if speculation == "off":
            # every reason, not just the first: a program can lose
            # decoupling through several expressions at once and the
            # user should see the full repair surface in one round
            raise LossOfDecoupling("; ".join(spec_reasons))
        spec = SpecInfo(
            pe_id=pe.id,
            loads=tuple(sorted(spec_loads)),
            reasons=tuple(spec_reasons),
        )
    return agu_count, cu_count, spec
