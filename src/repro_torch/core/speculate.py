"""Speculative AGU with a predictor zoo and rollback-free squash
(DESIGN.md §10).

The port's copy of ``core/speculate.py`` in the JAX package: numpy on
the host, as there, with the same predictors, epochs and squash rules.

``dae.decouple(speculation="off")`` rejects programs whose AGU
address/trip closure consumes a protected load value (loss of
decoupling): the AGU cannot run ahead of the load round trip. The
paper's lineage (speculation in dynamically scheduled HLS, [62])
resolves this by letting the AGU *predict* the value, run ahead, and
squash on mis-speculation — requests are never retracted, they stay in
flight tagged invalid, exactly the §6 valid-bit machinery the decoupled
machine already has for guarded stores.

This module builds that behaviour as a trace-level plan:

  * **Predictor zoo.** Each AGU-feeding load port gets a value
    predictor (``dae.PREDICTORS``):

      - ``"last"`` — last-value: occurrence ``k`` predicts the true
        value of ``k-1`` (0.0 cold). Repetitive trip counts (CSR row
        lengths, frontier sizes) predict well.
      - ``"stride"`` — last value plus the last observed first
        difference: locks onto arithmetic value sequences (AGU-local
        induction through memory, e.g. ``strided_scan``) after two
        occurrences.
      - ``"context"`` — a context table mapping the previous value to
        the value that followed it last time (last-value fallback on a
        cold key): learns pointer chains, so a linked list traversed
        more than once (``chase_sum``) predicts perfectly from the
        second lap on.
      - ``"auto"`` — per-port tournament: all three components run in
        parallel on the true value stream; each keeps a saturating
        accuracy score and the best-scoring one (ties to the simplest)
        makes the port's prediction.

  * **Confidence gating.** Each port carries a saturating confidence
    counter updated from the selected predictor's outcomes (+1 hit,
    -2 miss). While confidence is below threshold the port does not
    speculate: the occurrence opens a *wait* gate — downstream requests
    are delivery-gated exactly as a non-speculative AGU would be, but
    nothing was issued under a wrong value, so there is no phantom
    traffic and no squash latency. Low-confidence ports therefore fall
    back to waiting instead of squash-storming; predictors keep
    learning during the wait, so a port whose pattern becomes
    predictable (lap 2 of a pointer chase) re-enables itself.

  * **Epochs.** Requests the AGU emits are tagged with the current
    *epoch* — the id of the most recent gate preceding them in AGU
    generation order (-1 before any). A mispredicted (or suppressed)
    occurrence at ``(L, k)`` opens a new epoch whose *gate* fires when
    L's k-th value is delivered — plus ``SimParams.squash_latency`` for
    a mispredicted (squash) gate, immediately for a wait gate
    (``SpecPlan.fire_delay``): requests of that epoch may not issue
    earlier (the AGU regenerated them from the true value).

  * **Squash.** Requests the AGU issued *under* a mispredicted value
    (wrong trip tail, wrong address) are squashed, not rolled back:
    they are accounted as phantom traffic released at the gate's fire
    time — squashed loads occupy DU issue slots and DRAM bandwidth,
    squashed stores occupy issue slots and ACK at the pending-buffer
    head without DRAM (Fig. 7). Phantom traffic per (epoch, op) is
    capped at the run-ahead window ``SimParams.spec_runahead`` (a DSE
    axis in the JAX package; cap hits are surfaced in ``SpecPlan.stats()``). Phantoms
    never enter the hazard-visible port state: frontiers advance only
    on true program-order requests, which is conservative in timing and
    keeps the §5 hazard argument (and final-array exactness) untouched.

The *true* request streams themselves are computed against the
sequential oracle's load values — sound for the same reason
``dae.record_cu_script`` is: the engines' validated delivery contract
guarantees every load receives its oracle value regardless of timing,
so the speculative AGU's post-squash stream is exactly the oracle-fed
stream *under every predictor* — the knob only moves gates and phantom
traffic, never addresses. ``schedule.trace_program`` routes speculative
PEs here and returns the accumulated ``SpecPlan`` to the engines, which
stay predictor-agnostic: they consume gates/triggers/phantoms
generically and surface ``SpecPlan.stats()`` as
``SimResult.spec_stats``.

When speculation cannot even run ahead — a trip depending on a load
*inside* the loop it bounds, or an AGU value that is simply unavailable
at its use point — ``trace_spec_pe`` falls back to rejecting with
``LossOfDecoupling`` (the documented ``auto``-mode reject rule).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import dae as daelib
from repro_torch.core import loopir as ir

# re-export: the valid predictor knob values (defined next to
# SPECULATION_MODES so every layer validates against one tuple)
PREDICTORS = daelib.PREDICTORS

# Default run-ahead window: how far the speculative AGU gets before a
# mispredicted value's truth arrives and squashes it, per (epoch, op) —
# one DRAM burst's worth of requests (§2.1.1, N=16). The live value is
# ``SimParams.spec_runahead`` (threaded into ``SpecPlan.runahead``); a
# run-ahead window of real speculative dataflow hardware is a queue
# depth, not the whole dependent region.
DEFAULT_RUNAHEAD = 16

# Per-port confidence counter (saturating 0..CONF_MAX): speculate while
# >= CONF_THRESHOLD; +1 on a hit, -2 on a miss. Starts weakly confident
# so ports speculate until the pattern proves unpredictable; misses
# shut a port off after two, four consecutive would-be hits of the
# selected predictor re-enable it.
CONF_MAX = 7
CONF_INIT = 4
CONF_THRESHOLD = 4
CONF_HIT = 1
CONF_MISS = 2  # subtracted


class _LastValue:
    """Predict the previous true value (0.0 cold)."""

    name = "last"

    def __init__(self):
        self.last: Optional[float] = None

    def predict(self) -> float:
        return 0.0 if self.last is None else self.last

    def update(self, truth: float) -> None:
        self.last = truth


class _Stride:
    """Predict last + (last - previous): arithmetic value sequences."""

    name = "stride"

    def __init__(self):
        self.last: Optional[float] = None
        self.stride = 0.0

    def predict(self) -> float:
        return 0.0 if self.last is None else self.last + self.stride

    def update(self, truth: float) -> None:
        if self.last is not None:
            self.stride = truth - self.last
        self.last = truth


class _Context:
    """Predict table[previous value] — the value that followed it last
    time — with a last-value fallback on a cold key: repeated pointer
    chains predict perfectly from their second traversal on."""

    name = "context"

    def __init__(self):
        self.table: dict[float, float] = {}
        self.last: Optional[float] = None

    def predict(self) -> float:
        if self.last is None:
            return 0.0
        return self.table.get(self.last, self.last)

    def update(self, truth: float) -> None:
        if self.last is not None:
            self.table[self.last] = truth
        self.last = truth


_COMPONENTS = {"last": _LastValue, "stride": _Stride, "context": _Context}


class PortPredictor:
    """One speculative load port's predictor state: the component zoo
    (a single component for a fixed knob, all three under ``"auto"``),
    the tournament scores, and the confidence counter that gates
    whether the port speculates at all."""

    def __init__(self, knob: str):
        assert knob in PREDICTORS, f"unknown predictor {knob!r}"
        self.knob = knob
        if knob == "auto":
            # tie order = simplest first: ties go to the earliest entry
            self.components = [_LastValue(), _Stride(), _Context()]
        else:
            self.components = [_COMPONENTS[knob]()]
        self.scores = [CONF_INIT] * len(self.components)
        self.confidence = CONF_INIT
        # stats
        self.predictions = 0
        self.mispredictions = 0
        self.waits = 0

    @property
    def speculating(self) -> bool:
        return self.confidence >= CONF_THRESHOLD

    def peek(self) -> tuple[str, float]:
        """(selected component name, its prediction) — selection is the
        best tournament score, ties to the simplest component."""
        i = max(range(len(self.scores)), key=lambda j: (self.scores[j], -j))
        return self.components[i].name, self.components[i].predict()

    def observe(self, truth: float) -> None:
        """Score every component's would-be prediction against the
        delivered truth, update the confidence counter from the
        *selected* component's outcome, then advance all component
        states. Runs every occurrence — including suppressed ones — so
        predictors keep learning while the port waits."""
        sel, sel_pred = self.peek()
        for j, c in enumerate(self.components):
            ok = c.predict() == truth
            self.scores[j] = (
                min(CONF_MAX, self.scores[j] + CONF_HIT)
                if ok
                else max(0, self.scores[j] - CONF_MISS)
            )
        if sel_pred == truth:
            self.confidence = min(CONF_MAX, self.confidence + CONF_HIT)
        else:
            self.confidence = max(0, self.confidence - CONF_MISS)
        for c in self.components:
            c.update(truth)

    def port_stats(self) -> dict:
        sel, _ = self.peek()
        return {
            "predictor": sel,
            "predictions": self.predictions,
            "mispredictions": self.mispredictions,
            "waits": self.waits,
        }


@dataclasses.dataclass
class SpecPlan:
    """Engine-facing speculation schedule of one compiled program.

    ``gates[op]`` tags every request of ``op`` with its epoch id (-1 =
    epoch 0, never gated); ids are non-decreasing along each stream.
    ``triggers[g]`` is the ``(load op id, delivery index)`` whose value
    delivery resolves epoch ``g``; ``resolve_of[load op]`` maps each
    delivery index to the epoch it resolves (-1 = none).
    ``gate_kind[g]`` is ``"squash"`` (a misprediction: fires
    ``squash_latency`` after delivery, releases phantoms) or ``"wait"``
    (a confidence-suppressed occurrence: fires at delivery, no
    phantoms); ``gate_pred[g]`` names the component predictor the gate
    is attributed to. ``phantoms[g]`` lists ``(op id, count, is_store)``
    squashed requests released when gate ``g`` fires, capped per
    (epoch, op) at ``runahead`` (``SimParams.spec_runahead``).
    """

    predictor: str = "auto"  # the knob (dae.PREDICTORS)
    runahead: int = DEFAULT_RUNAHEAD
    gates: dict = dataclasses.field(default_factory=dict)
    triggers: list = dataclasses.field(default_factory=list)
    resolve_of: dict = dataclasses.field(default_factory=dict)
    phantoms: list = dataclasses.field(default_factory=list)
    gate_kind: list = dataclasses.field(default_factory=list)
    gate_pred: list = dataclasses.field(default_factory=list)
    pe_ids: list = dataclasses.field(default_factory=list)
    predictions: int = 0
    mispredictions: int = 0
    wait_gates: int = 0
    phantom_requests: int = 0
    # run-ahead cap visibility: clamp events and requests clamped away
    cap_hits: int = 0
    phantom_capped: int = 0
    # op id -> PortPredictor.port_stats() of every speculative load port
    port_stats: dict = dataclasses.field(default_factory=dict)

    @property
    def n_gates(self) -> int:
        return len(self.triggers)

    def fire_delay(self, gid: int, squash_latency: int) -> int:
        """Cycles from the trigger value's delivery to gate ``gid``
        opening: a squash gate pays ``squash_latency`` (the corrected
        epoch re-issues after the squash completes), a wait gate opens
        at delivery (nothing was issued under a wrong value). The one
        timing rule both engines share."""
        return squash_latency if self.gate_kind[gid] == "squash" else 0

    def by_predictor(self) -> dict:
        """Per-component attribution of squash activity: gates opened,
        phantom requests squashed, and run-ahead cap hits, keyed by the
        component predictor that made (or would have made) the
        prediction: the per-predictor view ``SimResult.spec_stats``
        reports."""
        out: dict[str, dict] = {}
        for g, pname in enumerate(self.gate_pred):
            d = out.setdefault(
                pname,
                {"mispredictions": 0, "wait_gates": 0, "squashed": 0,
                 "cap_hits": 0},
            )
            if self.gate_kind[g] == "squash":
                d["mispredictions"] += 1
                d["squashed"] += sum(c for _op, c, _s in self.phantoms[g])
            else:
                d["wait_gates"] += 1
        for pname, hits in getattr(self, "_cap_by", {}).items():
            out.setdefault(
                pname,
                {"mispredictions": 0, "wait_gates": 0, "squashed": 0,
                 "cap_hits": 0},
            )["cap_hits"] += hits
        return out

    def stats(self) -> dict:
        """The ``SimResult.spec_stats`` payload (JSON-friendly): global
        counters, the run-ahead cap visibility, per-port predictor
        outcomes, and per-predictor squash attribution. Shape pinned
        against the JAX package's by tests/test_torch_speculation.py."""
        return {
            "predictor": self.predictor,
            "runahead": int(self.runahead),
            "predictions": int(self.predictions),
            "mispredictions": int(self.mispredictions),
            "wait_gates": int(self.wait_gates),
            "squash_gates": int(self.mispredictions),
            "gates": int(self.n_gates),
            "phantom_requests": int(self.phantom_requests),
            "phantom_capped": int(self.phantom_capped),
            "cap_hits": int(self.cap_hits),
            "per_port": {k: dict(v) for k, v in self.port_stats.items()},
            "by_predictor": self.by_predictor(),
        }

    def summary(self) -> dict:
        """Counters for benchmarks/reports (JSON-friendly)."""
        return {
            "speculative_pes": list(self.pe_ids),
            "predictor": self.predictor,
            "runahead": int(self.runahead),
            "predictions": self.predictions,
            "mispredictions": self.mispredictions,
            "wait_gates": self.wait_gates,
            "phantom_requests": self.phantom_requests,
            "phantom_capped": self.phantom_capped,
            "gates": self.n_gates,
        }


def fire_phantoms(
    plan: SpecPlan,
    gid: int,
    now: int,
    channel_free_at: int,
    burst_size: int,
    channel_occupancy: int,
    result,
) -> int:
    """Shared squash-release accounting of both engines' ``_fire_gate``:
    count gate ``gid``'s phantoms into ``result.squashed``, charge the
    squashed *loads* to the DRAM channel (squashed stores ACK without
    DRAM, Fig. 7), and return the updated ``channel_free_at``. Wait
    gates carry no phantoms, so firing them is accounting-free. Keeping
    this in one place is what keeps the engines' ``squashed``/DRAM
    counters bit-identical (tests/test_torch_speculation*.py)."""
    n_load = 0
    total = 0
    for _op, count, is_store in plan.phantoms[gid]:
        total += count
        if not is_store:
            n_load += count
    result.squashed += total
    if n_load:
        nb = -(-n_load // burst_size)
        issue = max(now, channel_free_at)
        channel_free_at = issue + nb * channel_occupancy
        result.dram_bursts += nb
        result.dram_requests += n_load
    return channel_free_at


def interpret_hooked(
    program: ir.Program,
    arrays: dict[str, np.ndarray],
    params: Optional[dict],
    trace_hook,
    aux_exprs=None,
    aux_hook=None,
) -> dict[str, np.ndarray]:
    """``loopir.interpret`` with the speculative auto-reject applied:
    a load value consumed before it exists even sequentially (e.g. a
    trip reading a load of the loop it bounds) becomes the documented
    ``LossOfDecoupling`` — speculation cannot repair an ill-defined
    program. Other KeyErrors (typo'd array/param names) propagate
    untouched. The single conversion site shared by ``simulate()``
    (via ``oracle_load_streams``) and ``executor.execute``.
    ``aux_exprs``/``aux_hook`` pass through to ``loopir.interpret``."""
    try:
        return ir.interpret(
            program, arrays, params or {}, trace_hook=trace_hook,
            aux_exprs=aux_exprs, aux_hook=aux_hook,
        )
    except ir.UnavailableLoadValue as exc:
        raise daelib.LossOfDecoupling(
            f"value {exc} is unavailable at its use point even in the "
            f"sequential oracle — speculation cannot run ahead"
        ) from None


def oracle_load_streams(
    program: ir.Program,
    arrays: dict[str, np.ndarray],
    params: Optional[dict] = None,
) -> dict[str, list]:
    """Per-op in-order load value streams from the sequential oracle —
    the ground truth the speculative AGU's predictors are scored
    against (and what the engines are contracted to deliver)."""
    loads: dict[str, list] = {}

    def hook(op_id, addr, is_store, valid, value):
        if not is_store:
            loads.setdefault(op_id, []).append(value)

    interpret_hooked(program, arrays, params, hook)
    return loads


def trace_spec_pe(
    pe: daelib.PE,
    info: daelib.SpecInfo,
    arrays: dict[str, np.ndarray],
    params: dict,
    oracle_loads: dict[str, list],
    plan: SpecPlan,
):
    """Run the speculative AGU of one PE and record its true request
    streams plus epoch/squash bookkeeping into ``plan``.

    The predictor knob and run-ahead window are read from
    ``plan.predictor``/``plan.runahead`` (set by
    ``schedule.trace_program`` from the caller's ``predictor=`` /
    ``SimParams.spec_runahead``). Returns a ``schedule.PETrace``
    (imported lazily to avoid the schedule <-> speculate cycle) whose
    streams are identical to what ``schedule._trace_pe`` would produce
    if it could read protected load values — the hazard machinery sees
    ordinary program-order streams; speculation only adds the
    per-request epoch tags and the phantom traffic in ``plan``, and the
    streams are identical under every predictor (only gates/phantoms
    move).
    """
    from repro_torch.core import schedule as schedlib

    plan.pe_ids.append(pe.id)
    spec_loads = set(info.loads)

    rec: dict[str, dict[str, list]] = {
        op_id: {"sched": [], "addr": [], "lastiter": [], "seq": [], "gate": []}
        for op_id in pe.mem_ops
    }
    seq_counter = [0]
    _, op_depth, op_store = schedlib._static_op_meta(pe)

    by_depth: dict[int, list[ir.Stmt]] = {}
    for s, d in pe.stmts:
        by_depth.setdefault(d, []).append(s)

    counters = [0] * (pe.depth + 1)
    last_flags = [False] * (pe.depth + 1)
    n_leaf = 0

    # ---- speculation state ------------------------------------------------
    occ: dict[str, int] = {}  # delivery index per load op
    predictors: dict[str, PortPredictor] = {
        op_id: PortPredictor(plan.predictor) for op_id in spec_loads
    }
    pred_val: dict[str, float] = {}  # prediction of latest mispredicted occ
    mispred: dict[str, bool] = {}  # latest occurrence opened a gate?
    gate_of: dict[str, int] = {}  # gate of latest gated occurrence
    tainted: dict[str, int] = {}  # AGU local -> gate of the bad value
    cur_gate = [-1]  # epoch tag of requests emitted from here on

    def eval_expr(e: ir.Expr, scope: ir._Env, loadvals: dict):
        try:
            return ir._eval(e, scope, arrays, params, loadvals)
        except ir.UnavailableLoadValue as exc:
            raise daelib.LossOfDecoupling(
                f"PE {pe.id}: AGU value {exc} is unavailable at its use "
                f"point (e.g. a trip depending on a load inside the loop "
                f"it bounds) — speculation cannot run ahead"
            ) from None

    def bad_epoch(e: ir.Expr) -> Optional[int]:
        """Gate id of the most recent gated occurrence feeding ``e``'s
        current value, or None when every input was predicted right."""
        locals_, loads = daelib.expr_deps(e)
        gids = [gate_of[l] for l in loads if mispred.get(l)]
        gids += [tainted[n] for n in locals_ if n in tainted]
        return max(gids) if gids else None

    def open_gate(op_id: str, k: int, kind: str, pname: str) -> int:
        gid = len(plan.triggers)
        plan.triggers.append((op_id, k))
        plan.phantoms.append([])
        plan.gate_kind.append(kind)
        plan.gate_pred.append(pname)
        return gid

    phantom_counts: dict[tuple[int, str], int] = {}

    def phantom(gid: int, op_id: str, count: int, is_store: bool):
        # wait gates: the AGU stalled instead of running ahead under a
        # wrong value — nothing was issued, nothing squashes
        if plan.gate_kind[gid] != "squash":
            return
        # cap the squash window per (epoch, op) at plan.runahead
        # (SimParams.spec_runahead): the run-ahead AGU only gets a
        # bounded queue depth ahead before the truth arrives
        count = int(count)
        if count <= 0:
            return
        seen = phantom_counts.get((gid, op_id), 0)
        granted = min(count, plan.runahead - seen)
        if granted < count:
            plan.cap_hits += 1
            plan.phantom_capped += count - max(granted, 0)
            cap_by = getattr(plan, "_cap_by", None)
            if cap_by is None:
                cap_by = {}
                plan._cap_by = cap_by
            pname = plan.gate_pred[gid]
            cap_by[pname] = cap_by.get(pname, 0) + 1
        if granted <= 0:
            return
        phantom_counts[(gid, op_id)] = seen + granted
        plan.phantoms[gid].append((op_id, granted, is_store))
        plan.phantom_requests += granted

    def eval_trip(loop: ir.Loop, scope: ir._Env, loadvals: dict, d: int) -> int:
        trip = int(eval_expr(loop.trip, scope, loadvals))
        gid = bad_epoch(loop.trip)
        if gid is not None and plan.gate_kind[gid] == "squash":
            # the AGU entered this loop with a mispredicted bound: the
            # over-predicted tail iterations were issued and squashed.
            # First-order estimate: re-evaluate the trip under the
            # predicted values (taint through locals — and suppressed
            # occurrences — has no closed predicted value: counted as
            # gated, not phantom).
            _, loads = daelib.expr_deps(loop.trip)
            specced = [l for l in loads if mispred.get(l) and l in pred_val]
            if specced:
                lv = dict(loadvals)
                for l in specced:
                    lv[l] = pred_val[l]
                trip_pred = max(0, int(eval_expr(loop.trip, scope, lv)))
                extra = max(0, trip_pred - max(0, trip))
                for s in by_depth.get(d, ()):
                    if isinstance(s, (ir.Load, ir.Store)):
                        phantom(gid, s.id, extra, isinstance(s, ir.Store))
        return trip

    def run_depth(d: int, scope: ir._Env, outer_loadvals: dict):
        nonlocal n_leaf
        loop = pe.path[d - 1]
        loop_scope = ir._Env(scope)
        for iv in loop.ivars:
            loop_scope.define(iv.name, eval_expr(iv.init, scope, outer_loadvals))
        trip = eval_trip(loop, scope, outer_loadvals, d)
        for i in range(trip):
            counters[d] += 1
            body = ir._Env(loop_scope)
            body.define(loop.var, i)
            last_flags[d] = (i == trip - 1) if loop.predictable else False
            if d == pe.depth:
                n_leaf += 1
            loadvals = dict(outer_loadvals)
            for s in by_depth.get(d, ()):
                exec_stmt(s, body, d, loadvals)
            if d < pe.depth:
                run_depth(d + 1, body, loadvals)
            for iv in loop.ivars:
                cur = loop_scope.get(iv.name)
                step = eval_expr(iv.step, body, outer_loadvals)
                loop_scope.vals[iv.name] = (
                    cur + step if iv.op == "+" else cur * step
                )

    def exec_stmt(s: ir.Stmt, scope: ir._Env, d: int, loadvals: dict):
        if isinstance(s, (ir.Load, ir.Store)):
            gid = bad_epoch(s.addr)
            if gid is not None:
                # the run-ahead AGU issued this request with a wrong
                # address; the corrected re-issue below is epoch-gated
                # (phantom() is a no-op for wait gates)
                phantom(gid, s.id, 1, isinstance(s, ir.Store))
            a = int(eval_expr(s.addr, scope, loadvals))
            r = rec[s.id]
            r["sched"].append(tuple(counters[1 : d + 1]))
            r["addr"].append(a)
            r["lastiter"].append(tuple(last_flags[1 : d + 1]))
            r["seq"].append(seq_counter[0])
            r["gate"].append(cur_gate[0])
            seq_counter[0] += 1
            if isinstance(s, ir.Load):
                k = occ.get(s.id, 0)
                occ[s.id] = k + 1
                truth = float(oracle_loads.get(s.id, [])[k])
                loadvals[s.id] = truth
                if s.id in spec_loads:
                    pp = predictors[s.id]
                    pname, pred = pp.peek()
                    if pp.speculating:
                        plan.predictions += 1
                        pp.predictions += 1
                        if pred != truth:
                            gid = open_gate(s.id, k, "squash", pname)
                            plan.mispredictions += 1
                            pp.mispredictions += 1
                            pred_val[s.id] = pred
                            mispred[s.id] = True
                            gate_of[s.id] = gid
                            cur_gate[0] = gid
                        else:
                            mispred[s.id] = False
                            pred_val.pop(s.id, None)
                    else:
                        # confidence-suppressed: the port waits for
                        # delivery — a gate with no phantoms and no
                        # squash latency
                        gid = open_gate(s.id, k, "wait", pname)
                        plan.wait_gates += 1
                        pp.waits += 1
                        pred_val.pop(s.id, None)
                        mispred[s.id] = True
                        gate_of[s.id] = gid
                        cur_gate[0] = gid
                    pp.observe(truth)
        elif isinstance(s, ir.SetLocal):
            gid = bad_epoch(s.value)
            v = eval_expr(s.value, scope, loadvals)
            if not scope.set_existing(s.name, v):
                scope.define(s.name, v)
            if gid is not None:
                tainted[s.name] = gid
            else:
                tainted.pop(s.name, None)

    if pe.depth >= 1:
        run_depth(1, ir._Env(), {})

    ops = {}
    for op_id in pe.mem_ops:
        r = rec[op_id]
        d = op_depth[op_id]
        n = len(r["addr"])
        ops[op_id] = schedlib.OpTrace(
            op_id=op_id,
            pe_id=pe.id,
            depth=d,
            is_store=op_store[op_id],
            sched=np.array(r["sched"], dtype=np.int64).reshape(n, d),
            addr=np.array(r["addr"], dtype=np.int64).reshape(n),
            lastiter=np.array(r["lastiter"], dtype=bool).reshape(n, d),
            seq=np.array(r["seq"], dtype=np.int64).reshape(n),
        )
        plan.gates[op_id] = np.array(r["gate"], dtype=np.int64).reshape(n)
    for op_id, pp in sorted(predictors.items()):
        plan.port_stats[op_id] = pp.port_stats()
    _finalize_resolve(plan)
    return schedlib.PETrace(pe_id=pe.id, ops=ops, n_leaf_iters=n_leaf)


def _finalize_resolve(plan: SpecPlan) -> None:
    """(Re)build ``resolve_of`` from ``triggers`` — delivery index ->
    gate id per spec load port. Idempotent across multiple PEs."""
    per_op: dict[str, dict[int, int]] = {}
    for gid, (op_id, k) in enumerate(plan.triggers):
        per_op.setdefault(op_id, {})[k] = gid
    plan.resolve_of = {
        op_id: _to_resolve_array(m) for op_id, m in per_op.items()
    }


def _to_resolve_array(m: dict[int, int]) -> np.ndarray:
    n = max(m) + 1
    out = np.full(n, -1, dtype=np.int64)
    for k, gid in m.items():
        out[k] = gid
    return out
