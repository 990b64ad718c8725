"""Cycle-level simulator of the four evaluated systems (paper §7.1).

The port's copy of ``core/simulator.py`` in the JAX package: numpy on
the host, as there, with the same modes, engines, timing model,
speculative AGU and results.

Modes:
  * ``STA``  — static HLS baseline: leaf-loop *instances* execute in
    program order (with automatic static fusion of hazard-free sibling
    loops, as Intel HLS does); loops with potential intra-loop memory
    dependencies run at a conservative static II; bursting LSUs. STA is
    evaluated analytically (static schedules are closed-form by
    definition); its result arrays come from the sequential oracle.
  * ``LSQ``  — dynamic HLS with a load-store queue [60]: loop instances
    still sequential, intra-loop hazards resolved dynamically by the
    same check machinery, but a *non-bursting* LSU (burst size 1).
  * ``FUS1`` — this paper: all PEs run concurrently, every memory
    request gated only by the synthesized Hazard Safety Checks.
  * ``FUS2`` — FUS1 + store-to-load forwarding (§5.5).

LSQ/FUS modes execute real memory semantics: loads read the backing
array when their DRAM burst completes (or take a forwarded value),
stores commit at burst completion, mis-speculated stores (§6) enter the
pending buffer with their valid bit and ACK at the buffer head without a
DRAM request (Fig. 7). The final state is compared against the
sequential oracle — that comparison is what validates the hazard logic.

Timing model (``SimParams``): a single DRAM channel serves bursts in
issue order; a burst occupies the channel for ``channel_occupancy``
cycles and completes ``dram_latency`` cycles after issue; per-port
dynamic coalescing closes a burst at ``burst_size`` requests or after
``burst_timeout`` idle cycles (§2.1.1, N=16). Each port moves at most
one request per cycle (the paper's II=1 pipelines).

Two engines implement the LSQ/FUS modes (``simulate(engine=...)``):
this module's per-cycle reference ``Engine`` (scalar checks, one
request per port per cycle — the conformance oracle and debugging aid)
and the vectorized event-driven ``engine_event.EventEngine`` (the
default: batched check waves, event-queue time skipping). See
DESIGN.md §1.1-1.2 for the engine contract and drift tolerance.
"""

from __future__ import annotations

import dataclasses
import heapq
from typing import Optional

import numpy as np

from repro_torch.core import config as cfglib
from repro_torch.core import dae as daelib
from repro_torch.core import du as dulib
from repro_torch.core import fifo as fifolib
from repro_torch.core import hazards as hz
from repro_torch.core import loopir as ir
from repro_torch.core import monotonic as mono
from repro_torch.core import schedule as schedlib


@dataclasses.dataclass
class SimParams:
    dram_latency: int = 200
    burst_size: int = 16
    burst_timeout: int = 16
    channel_occupancy: int = 2  # cycles a burst holds the channel
    cu_latency: int = 8  # load value -> dependent store value
    forward_latency: int = 1
    # speculative AGU (§6 / DESIGN.md §10): cycles from a mispredicted
    # load's value delivery to the squash completing and the corrected
    # epoch becoming issuable
    squash_latency: int = 4
    # speculative run-ahead window: phantom requests per (epoch, op) a
    # mispredicting AGU gets in flight before the truth squashes it — a
    # DSE axis (dse.SweepSpec); cap hits surface in SimResult.spec_stats
    spec_runahead: int = 16
    # static II for loops with potential memory dependencies: a static
    # pipeline cannot disambiguate, so the loop is scheduled at the DRAM
    # round-trip dependence distance (load -> compute -> store visible).
    # Fitted by dse/calibrate.py against the paper Table-1 per-iteration
    # cycle targets (hist+add STA ~110, tanh+spmv ~225, pagerank ~200
    # cycles/iter at 286 MHz; see BENCH_CALIB.json — the earlier hand
    # calibration of 160 undershot the static targets by ~30%).
    sta_mem_dep_ii: int = 224
    pipeline_fill: int = 20  # static pipeline fill/drain per loop instance
    # cross-PE scalar FIFO edges (core/fifo.py, DESIGN.md §11): slots
    # per queue (a full queue backpressures its producer) and cycles
    # from a push to the token becoming poppable
    fifo_depth: int = 4
    fifo_latency: int = 1
    max_cycles: int = 50_000_000


@dataclasses.dataclass
class SimResult:
    """Outcome of one simulated (program, mode, timing) point.

    ``cycles`` is the simulated completion time under the DU timing
    model; ``arrays`` the final protected-memory state (always equal to
    the sequential oracle — that equality is what validates the hazard
    logic); ``dram_bursts``/``dram_requests`` the DRAM traffic,
    ``forwards`` the §5.5 store-to-load forwarding hit count (FUS2),
    and ``squashed`` the speculative AGU's squashed phantom request
    count (0 unless the program runs with ``speculation="auto"``,
    DESIGN.md §10; phantom loads are included in the DRAM counters).
    ``spec_stats`` is ``speculate.SpecPlan.stats()`` — predictor,
    run-ahead window, per-port and per-predictor outcomes, wait/squash
    gate counts, and run-ahead cap visibility; empty for
    non-speculative runs.
    """

    cycles: int
    arrays: dict[str, np.ndarray]
    mode: str
    dram_bursts: int = 0
    dram_requests: int = 0
    forwards: int = 0
    squashed: int = 0
    # per-edge FIFO accounting (core/fifo.py stats dicts) for streaming
    # programs; empty for everything else
    fifo_stats: list = dataclasses.field(default_factory=list)
    # speculate.SpecPlan.stats() for speculative runs; {} otherwise
    spec_stats: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class SharedArtifacts:
    """Precomputed per-(program, arrays, params) state shared across many
    simulation points by the DSE batch runner (``repro_torch.dse``,
    DESIGN.md §9). Every field is a pure function of the
    program/data — never of timing parameters — so injecting it cannot
    change any result; each field falls back to the engine's own
    computation when ``None``.

      * ``nodep_bits`` — §5.6 NoDependence bit streams keyed
        ``(dst, src)``; may be a superset of the pairs any one plan
        keeps (engines look up by pair id).
      * ``rank_table`` — ``(ranks, counts)`` from
        ``schedule.instance_rank_table`` for the LSQ instance window
        (engines copy ``counts`` before mutating).
      * ``cu_factory`` — ``pe -> CU-like``; the DSE runner passes
        recorded-script replay CUs (``dae.ReplayCU``).
      * ``sta_instances`` — ``(order, info)`` from ``_instances`` for
        the STA analytical model.
      * ``final_arrays`` — the sequential oracle's final state; STA
        results copy it instead of re-interpreting.
    """

    nodep_bits: Optional[dict] = None
    rank_table: Optional[tuple] = None
    cu_factory: Optional[object] = None
    sta_instances: Optional[tuple] = None
    final_arrays: Optional[dict] = None


# ---------------------------------------------------------------------------
# shared compile front-end
# ---------------------------------------------------------------------------


class Compiled:
    """Everything the paper's compiler derives statically for a program.

    ``trace_mode`` selects the AGU/CU front-end path (DESIGN.md §7):
    ``"auto"`` compiles affine PEs and falls back per PE, ``"compiled"``
    demands the vectorized path (raising ``schedule.TraceCompileError``
    otherwise), ``"interp"`` forces the reference interpreter. The
    engines consult it when constructing CUs (``dae.make_cu``).

    ``speculation`` selects the loss-of-decoupling policy (DESIGN.md
    §10): ``"off"`` rejects AGUs that depend on protected loads,
    ``"auto"`` marks them speculative so the trace front-end builds a
    run-ahead AGU with epoch squash. ``predictor`` picks the value
    predictor of that AGU (``dae.PREDICTORS``; dead code when nothing
    speculates).
    """

    def __init__(
        self,
        program: ir.Program,
        forwarding: bool,
        trace_mode: str = "auto",
        speculation: str = "off",
        predictor: str = "auto",
        static_prune: bool = False,
    ):
        self.program = program
        self.trace_mode = trace_mode
        self.speculation = speculation
        self.predictor = predictor
        self.static_prune = static_prune
        self.dae = daelib.decouple(
            program, speculation=speculation, predictor=predictor
        )
        # cross-PE scalar FIFO edges: the static token-protocol gate
        # (core/fifo.py, DESIGN.md §11). Programs it admits run with
        # bounded backpressured queues in both engines; programs it
        # rejects fall back to the historical NotImplementedError —
        # now naming every edge (prod PE, cons PE, local, depth)
        self.fifo = fifolib.FifoSpec(edges=(), in_edges={}, out_edges={})
        if self.dae.fifo_edges:
            edge_list = ", ".join(
                f"(pe{p} -> pe{c}, {name!r}, shared={d})"
                for p, c, name, d in self.dae.fifo_edges
            )
            try:
                self.fifo = fifolib.analyze_program(program, self.dae)
            except fifolib.FifoRejected as exc:
                raise NotImplementedError(
                    "cross-PE scalar FIFO edge(s) outside the "
                    f"bounded-queue token protocol: {edge_list} — {exc}; "
                    "communicate such scalars through a protected array"
                ) from exc
            if self.dae.spec:
                raise NotImplementedError(
                    "speculative AGUs cannot drive cross-PE FIFO "
                    f"streams (edges {edge_list}): squashed epochs have "
                    "no token-protocol semantics"
                )
        self.infos = mono.analyze_program(program)
        self.plan = hz.build_plan(
            program, self.dae, self.infos, forwarding, static_prune=static_prune
        )
        self.op_array = {op.id: op.array for op, _ in program.mem_ops()}
        self.op_path = {op.id: path for op, path in program.mem_ops()}
        self.loop_pos, self.op_pos = program.static_positions()
        # unpruned view for the *static* analysis (STA cannot prune
        # dynamically; any potential pair forces a conservative schedule)
        self.all_pairs = self.plan.pairs + [p for p, _ in self.plan.pruned]

    def pe_has_mem_dep(self, pe_id: int) -> bool:
        # a speculative PE's AGU consumes load values (loss of
        # decoupling): to a static scheduler that IS a loop-carried
        # memory dependence — the recurrence must run at the
        # load-round-trip II even without an aliasing pair
        if pe_id in self.dae.spec:
            return True
        return any(
            p.same_pe and self.dae.op_to_pe[p.dst] == pe_id
            for p in self.all_pairs
        )

    def cross_pe_pairs(self, a: int, b: int) -> list[hz.HazardPair]:
        return [
            p
            for p in self.all_pairs
            if {self.dae.op_to_pe[p.dst], self.dae.op_to_pe[p.src]} == {a, b}
        ]


# ---------------------------------------------------------------------------
# instance bookkeeping (sequential baselines + STA analytical model)
# ---------------------------------------------------------------------------


_KEY_LEN = 18


def _request_key(comp: Compiled, tr, i: int, fuse_group: dict[int, int]):
    """Program-order instance key of one request: positions and counters
    interleaved (the polyhedral 2d+1 schedule), with the trailing leaf
    counter dropped so all iterations of one leaf-loop instance share a
    key. Fused sibling leaves share the group leader's position."""
    pe = comp.dae.pes[tr.pe_id]
    path = comp.op_path[tr.op_id]
    parts: list[int] = []
    if tr.depth == pe.depth:
        for j in range(tr.depth - 1):
            parts += [comp.loop_pos[id(path[j])], int(tr.sched[i][j])]
        leader = comp.dae.pes[fuse_group[tr.pe_id]]
        parts.append(comp.loop_pos[id(leader.leaf)])
    else:  # parent-body op: its own micro-instance per iteration
        for j in range(tr.depth):
            parts += [comp.loop_pos[id(path[j])], int(tr.sched[i][j])]
        parts.append(comp.op_pos[tr.op_id])
    return tuple(parts) + (-1,) * (_KEY_LEN - len(parts))


def _instances(
    comp: Compiled,
    traces: dict[str, schedlib.OpTrace],
    fuse_group: dict[int, int],
):
    """Group requests into program-ordered leaf-loop instances."""
    keys: dict[tuple, dict] = {}
    for op_id, tr in traces.items():
        pe = comp.dae.pes[tr.pe_id]
        for i in range(tr.n_req):
            key = _request_key(comp, tr, i, fuse_group)
            d = keys.setdefault(
                key, {"requests": 0, "loads": 0, "pes": set(), "iters": {}}
            )
            d["requests"] += 1
            if not tr.is_store:
                d["loads"] += 1
            d["pes"].add(tr.pe_id)
            if tr.depth == pe.depth:
                s = d["iters"].setdefault(tr.pe_id, set())
                s.add(int(tr.sched[i][-1]))
    ordered = sorted(keys)
    return ordered, keys


# ---------------------------------------------------------------------------
# STA: analytical static-schedule model
# ---------------------------------------------------------------------------


def _fusion_groups_sta(comp: Compiled) -> dict[int, int]:
    """Static loop fusion (Intel-HLS-like): merge consecutive sibling PEs
    with identical parents, structurally equal trip counts, and no
    possible cross-PE hazard pair."""
    fuse = {pe.id: pe.id for pe in comp.dae.pes}
    # a FIFO edge is a scalar dependence between the PEs: a static
    # scheduler cannot overlap them any more than a hazard pair lets it
    fifo_pairs = {
        frozenset((p, c)) for p, c, _name, _d in comp.dae.fifo_edges
    }
    for a, b in zip(comp.dae.pes, comp.dae.pes[1:]):
        if (
            len(a.path) == len(b.path)
            and a.path[:-1] == b.path[:-1]
            and a.leaf.trip == b.leaf.trip
            and not comp.cross_pe_pairs(a.id, b.id)
            and frozenset((a.id, b.id)) not in fifo_pairs
        ):
            fuse[b.id] = fuse[a.id]
    return fuse


def _simulate_sta(
    comp: Compiled,
    traces: dict[str, schedlib.OpTrace],
    arrays: dict[str, np.ndarray],
    params: dict[str, int],
    p: SimParams,
    shared: Optional[SharedArtifacts] = None,
) -> SimResult:
    if shared is not None and shared.sta_instances is not None:
        order, info = shared.sta_instances
    else:
        fuse = _fusion_groups_sta(comp)
        order, info = _instances(comp, traces, fuse)

    total = 0
    bursts = 0
    requests = 0
    for key in order:
        d = info[key]
        # concurrent fused PEs: instance latency = max over members
        lat = 0
        for pe_id in d["pes"]:
            ii = p.sta_mem_dep_ii if comp.pe_has_mem_dep(pe_id) else 1
            lat = max(lat, len(d["iters"].get(pe_id, (1,))) * ii)
        fill = p.pipeline_fill + (p.dram_latency if d["loads"] else 0)
        # DRAM bandwidth bound for this instance (bursting LSUs)
        n_bursts = -(-d["requests"] // p.burst_size)
        bw = n_bursts * p.channel_occupancy
        total += fill + max(lat, bw)
        bursts += n_bursts
        requests += d["requests"]

    if shared is not None and shared.final_arrays is not None:
        final = {
            k: np.array(v, copy=True) for k, v in shared.final_arrays.items()
        }
    else:
        final = ir.interpret(comp.program, arrays, params)
    return SimResult(
        cycles=total,
        arrays=final,
        mode="STA",
        dram_bursts=bursts,
        dram_requests=requests,
    )


# ---------------------------------------------------------------------------
# event-driven engine (LSQ / FUS1 / FUS2)
# ---------------------------------------------------------------------------


class _Burst:
    __slots__ = ("port", "entries", "opened_at", "closed", "complete_at")

    def __init__(self, port, now):
        self.port = port
        self.entries: list[dulib.PendingEntry] = []
        self.opened_at = now
        self.closed = False
        self.complete_at = -1


# Compute-unit thread: lives in dae.py (the CU half of the AGU/CU
# split), shared by both engines. Kept under the old name for callers.
_CU = daelib.CU


class Engine:
    def __init__(
        self,
        comp: Compiled,
        traces: dict[str, schedlib.OpTrace],
        arrays: dict[str, np.ndarray],
        params: dict[str, int],
        mode: str,
        p: SimParams,
        shared: Optional[SharedArtifacts] = None,
        spec=None,
        validate_hints: bool = False,
    ):
        self.comp = comp
        self.traces = traces
        self.mode = mode
        self.p = p
        if validate_hints:
            # MonotonicHint sanitizer (DESIGN.md §12): raises
            # analysis.deps.HintViolation before any timing runs
            from repro_torch.analysis import deps as depslib

            depslib.check_hinted_traces(comp.program, traces)
        # speculative AGU plan (speculate.SpecPlan): per-request epoch
        # gates + squash traffic; None for non-speculative programs
        self.spec = spec
        if spec is not None:
            self.gate_time = np.full(
                max(spec.n_gates, 1), 2**62, dtype=np.int64
            )
            self.pending_fires = 0
        self.forwarding = mode == "FUS2"
        self.sequential = mode == "LSQ"
        self.burst_size = 1 if mode == "LSQ" else p.burst_size

        self.mem = {k: np.array(v, copy=True) for k, v in arrays.items()}
        self.params = params
        self.ports = {op_id: dulib.Port(tr) for op_id, tr in traces.items()}
        self.pairs_by_dst = comp.plan.by_dst()

        # §5.6 NoDependence bits
        if shared is not None and shared.nodep_bits is not None:
            self.nodep_bits = shared.nodep_bits
        else:
            self.nodep_bits = dulib.nodependence_bits(comp.plan.pairs, traces)

        if shared is not None and shared.cu_factory is not None:
            self.cus = {pe.id: shared.cu_factory(pe) for pe in comp.dae.pes}
        else:
            self.cus = {
                pe.id: daelib.make_cu(
                    pe, self.mem, params, getattr(comp, "trace_mode", "auto"),
                    fifo_edges=comp.dae.fifo_edges,
                )
                for pe in comp.dae.pes
            }
        # bounded backpressured FIFO queues, one per analyzed edge
        # (core/fifo.py); empty dict for non-streaming programs
        self.fifos: dict[int, fifolib.FifoQueue] = {}
        if comp.fifo:
            fifolib.check_depth(comp.fifo, p.fifo_depth)
            self.fifos = {
                e.idx: fifolib.FifoQueue(e, p.fifo_depth, p.fifo_latency)
                for e in comp.fifo.edges
            }
        self.store_values: dict[str, list[tuple[int, float, bool]]] = {}
        self.ready_loads: dict[str, list[dulib.PendingEntry]] = {}

        if self.sequential:
            if shared is not None and shared.rank_table is not None:
                ranks, counts = shared.rank_table
            else:
                fuse = {pe.id: pe.id for pe in comp.dae.pes}  # LSQ: no fusion
                ranks, counts = schedlib.instance_rank_table(
                    traces, comp.dae, comp.loop_pos, comp.op_pos, fuse,
                    comp.op_path,
                )
            self.inst_outstanding = counts.tolist()
            self.req_inst: dict[tuple[str, int], int] = {}
            for op_id, r in ranks.items():
                for i, rank in enumerate(r.tolist()):
                    self.req_inst[(op_id, i)] = rank
            self.inst_window = 0

        self.open_bursts: dict[str, _Burst] = {}
        self.channel_free_at = 0
        self.events: list[tuple[int, int, str, object]] = []
        self._n = 0
        self.now = 0
        self.port_issued_at: dict[str, int] = {k: -1 for k in self.ports}
        self.result = SimResult(cycles=0, arrays={}, mode=mode)
        # debug: per-op oracle load values for first-divergence detection
        self.oracle_loads: Optional[dict[str, list[float]]] = None
        self.issue_log: dict[tuple[str, int], list[str]] = {}

    # -- events ---------------------------------------------------------

    def _post(self, t, kind, payload=None):
        self._n += 1
        heapq.heappush(self.events, (t, self._n, kind, payload))

    # -- main loop --------------------------------------------------------

    def run(self) -> SimResult:
        for cu in self.cus.values():
            self._drain_outbox(cu)
        while True:
            cycle_progress = False
            # 1. process all events due now
            while self.events and self.events[0][0] <= self.now:
                _, _, kind, payload = heapq.heappop(self.events)
                self._event(kind, payload)
                cycle_progress = True
            # 2. settle combinational progress at this cycle
            while self._settle():
                cycle_progress = True
            if self._all_done():
                break
            # 3. advance time. If this cycle made progress, the next cycle
            # may too (per-port issue pacing resets). Otherwise nothing
            # can change until the next event — jump straight to it.
            if cycle_progress:
                self.now += 1
            elif self.events:
                self.now = max(self.now + 1, self.events[0][0])
            else:
                self._deadlock()
            if self.now > self.p.max_cycles:
                raise RuntimeError("max_cycles exceeded")
        self.result.cycles = self.now
        self.result.arrays = self.mem
        self.result.fifo_stats = [q.stats() for q in self.fifos.values()]
        if self.spec is not None:
            self.result.spec_stats = self.spec.stats()
        return self.result

    def _all_done(self):
        return (
            all(p.exhausted and not p.pending for p in self.ports.values())
            and all(cu.done for cu in self.cus.values())
            and not self.open_bursts
            # pending squash events still carry phantom DRAM accounting
            and not (self.spec is not None and self.pending_fires)
        )

    def _deadlock(self):
        lines = [f"DEADLOCK at cycle {self.now} mode={self.mode}"]
        for op_id, p in self.ports.items():
            lines.append(
                f"  {op_id}: next={p.next}/{p.trace.n_req} pending={len(p.pending)}"
                f" ack_addr={p.ack_addr} ack_sched={p.ack_sched}"
            )
        for pe_id, cu in self.cus.items():
            lines.append(f"  cu{pe_id}: done={cu.done} waiting={cu.waiting_on}")
        for q in self.fifos.values():
            lines.append(
                f"  fifo {q.edge.describe()}: occ={q.occupancy}/{q.depth}"
                f" pushed={q.pushed} popped={q.popped}"
            )
        raise RuntimeError("\n".join(lines))

    # -- cycle work ---------------------------------------------------------

    def _settle(self) -> bool:
        progressed = False
        for op_id, port in self.ports.items():
            if self.port_issued_at[op_id] == self.now:
                continue  # one request per port per cycle
            if not port.exhausted and self._try_issue(op_id, port):
                self.port_issued_at[op_id] = self.now
                progressed = True
        for op_id in list(self.open_bursts):
            b = self.open_bursts[op_id]
            if (
                not b.closed
                and b.entries
                and self.now - b.opened_at >= self.p.burst_timeout
            ):
                self._close_burst(op_id, b)
                progressed = True
        for port in self.ports.values():
            if not port.is_store and self._deliver(port):
                progressed = True
        if self.fifos and self._service_fifos():
            progressed = True
        if self.sequential and self._advance_window():
            progressed = True
        return progressed

    def _service_fifos(self) -> bool:
        """Serve CUs blocked on FIFO pops/pushes (DESIGN.md §11).

        Backpressure is the absence of service: a pop against an empty
        (or not-yet-ready) queue and a push against a full one leave
        ``waiting_on`` set, and the settle fixpoint retries once a
        matching push/pop frees the queue. Not-ready heads post a
        ``fifo_tick`` so the time-jump lands on the ready cycle.
        """
        progressed = False
        for cu in self.cus.values():
            while isinstance(cu.waiting_on, tuple):
                kind, eidx = cu.waiting_on
                q = self.fifos[eidx]
                if kind == "fifo_pop":
                    if not q.head_ready(self.now):
                        if q.q:
                            self._post(q.next_ready_time(), "fifo_tick", eidx)
                        q.pop_stalls += 1
                        break
                    cu.feed(q.pop(self.now), self.now)
                else:  # fifo_push
                    if not q.can_push():
                        q.push_stalls += 1
                        break
                    q.push(cu.push_value, self.now)
                    self._post(self.now + q.latency, "fifo_tick", eidx)
                    cu.feed(0.0, self.now)  # push ack; value is ignored
                self._drain_outbox(cu)
                progressed = True
        return progressed

    def _try_issue(self, op_id: str, port: dulib.Port) -> bool:
        idx = port.next
        if self.sequential and self.req_inst[(op_id, idx)] > self.inst_window:
            return False
        if self.spec is not None:
            # epoch gate: a request of a squashed epoch re-issues only
            # once its trigger value delivered + squash completed
            g = self.spec.gates.get(op_id)
            if g is not None and idx < len(g):
                gid = int(g[idx])
                if gid >= 0 and self.gate_time[gid] > self.now:
                    return False
        # stores: the request is sent together with its value (§5.5: a
        # store moves to the pending buffer only with its value)
        value = valid = None
        if port.is_store:
            vq = self.store_values.get(op_id)
            if not vq or vq[0][0] > self.now:
                return False
            value, valid = vq[0][1], vq[0][2]

        req_sched = port.req_sched()
        req_addr = port.req_addr()
        for pair in self.pairs_by_dst.get(op_id, ()):
            if self.sequential and not pair.same_pe:
                continue  # LSQ: cross-loop order enforced by instances
            src_port = self.ports[pair.src]
            use_next = (
                self.forwarding and pair.kind == "RAW" and src_port.is_store
            )
            nodep = False
            if pair.nodependence:
                bits = self.nodep_bits.get((pair.dst, pair.src))
                nodep = bool(bits[idx]) if bits is not None else False
            explain = [] if self.oracle_loads is not None else None
            if not dulib.check_pair(
                pair, req_sched, req_addr, src_port, use_next, nodep, explain
            ):
                return False
            if explain is not None:
                self.issue_log[(op_id, idx)] = (
                    self.issue_log.get((op_id, idx), [])
                ) + explain

        entry = dulib.PendingEntry(
            req_idx=idx,
            addr=req_addr,
            sched=req_sched,
            lastiter=port.req_lastiter(),
        )
        port.next += 1
        port.pending.append(entry)
        if self.sequential:
            pass  # outstanding decremented at ACK
        if port.is_store:
            self.store_values[op_id].pop(0)
            entry.value, entry.valid = value, valid
            if valid:
                self._enqueue_burst(port, entry)
            else:
                # Fig. 7: invalid stores skip DRAM; ACK at buffer head
                self._post(self.now + 1, "invalid_ack", op_id)
        else:
            if not (self.forwarding and self._try_forward(op_id, entry)):
                self._enqueue_burst(port, entry)
        return True

    def _try_forward(self, op_id: str, entry: dulib.PendingEntry) -> bool:
        """§5.5 associative pending-buffer search, youngest match wins.
        Only reached after the modified RAW check passed, so a miss means
        the value is already committed to memory.

        Qualification: only entries that precede the load in *program
        order* may forward — a wrap-around source (e.g. next epoch's
        store) legitimately running ahead must not satisfy this load.
        """
        best = None  # (sort key, entry, src op)
        for pair in self.pairs_by_dst.get(op_id, ()):
            if pair.kind != "RAW":
                continue
            sport = self.ports[pair.src]
            k = pair.shared_depth
            for e in sport.pending:
                if e.addr != entry.addr or not e.valid:
                    continue  # invalid entries never produce a value
                # program-order qualification at the shared depth
                if k > 0:
                    es, rs = e.sched[k - 1], entry.sched[k - 1]
                    before = es < rs or (es == rs and not pair.dst_before_src)
                elif k == 0:
                    before = not pair.dst_before_src
                if not before:
                    continue
                key = (e.sched[k - 1] if k > 0 else 0, not pair.dst_before_src)
                if best is None or key >= best[0]:
                    best = (key, e, pair.src)
        if best is not None:
            _, e, src_op = best
            entry.value = e.value
            entry.forwarded = True
            entry.fwd_src = (src_op, e.req_idx, tuple(e.sched))  # type: ignore
            self.result.forwards += 1
            self._post(
                self.now + self.p.forward_latency, "fwd_ready", (op_id, entry)
            )
            return True
        return False

    # -- bursts -----------------------------------------------------------

    def _enqueue_burst(self, port: dulib.Port, entry):
        b = self.open_bursts.get(port.op_id)
        if b is None or b.closed:
            b = _Burst(port, self.now)
            self.open_bursts[port.op_id] = b
            self._post(self.now + self.p.burst_timeout, "burst_tick", port.op_id)
        b.entries.append(entry)
        if len(b.entries) >= self.burst_size:
            self._close_burst(port.op_id, b)

    def _close_burst(self, op_id: str, b: _Burst):
        b.closed = True
        issue = max(self.now, self.channel_free_at)
        self.channel_free_at = issue + self.p.channel_occupancy
        b.complete_at = issue + self.p.channel_occupancy + self.p.dram_latency
        self.result.dram_bursts += 1
        self.result.dram_requests += len(b.entries)
        self._post(b.complete_at, "burst_done", (op_id, b))
        if self.open_bursts.get(op_id) is b:
            del self.open_bursts[op_id]

    # -- events -----------------------------------------------------------

    def _event(self, kind, payload):
        if kind == "burst_done":
            op_id, b = payload
            port = b.port
            arr = self.mem[self.comp.op_array[op_id]]
            for e in b.entries:
                if port.is_store:
                    arr[e.addr] = e.value
                else:
                    e.value = float(arr[e.addr])
                e.acked = True
            self._ack_prefix(port)
        elif kind == "burst_tick":
            op_id = payload
            b = self.open_bursts.get(op_id)
            if (
                b is not None
                and not b.closed
                and b.entries
                and self.now - b.opened_at >= self.p.burst_timeout
            ):
                self._close_burst(op_id, b)
        elif kind == "fwd_ready":
            op_id, entry = payload
            entry.acked = True
            self._ack_prefix(self.ports[op_id])
        elif kind == "invalid_ack":
            self._ack_prefix(self.ports[payload])
        elif kind == "cu_value":
            op_id, value, valid = payload
            self.store_values.setdefault(op_id, []).append(
                (self.now, value, valid)
            )
        elif kind == "spec_fire":
            self.pending_fires -= 1
            self._fire_gate(payload)
        elif kind == "fifo_tick":
            # pure wake-up: a token matured (or a slot freed) at this
            # cycle; the settle fixpoint does the actual service
            pass
        else:  # pragma: no cover
            raise ValueError(kind)

    def _fire_gate(self, gid: int):
        """Squash of epoch ``gid`` completes: open the gate and release
        the phantom traffic (``speculate.fire_phantoms``; phantoms never
        touch the hazard-visible port state, DESIGN.md §10)."""
        if self.gate_time[gid] <= self.now:
            return
        self.gate_time[gid] = self.now
        from repro_torch.core import speculate as speclib

        self.channel_free_at = speclib.fire_phantoms(
            self.spec, gid, self.now, self.channel_free_at,
            self.burst_size, self.p.channel_occupancy, self.result,
        )

    def _ack_prefix(self, port: dulib.Port):
        if (
            self.oracle_loads is not None
            and not port.is_store
        ):
            for e in port.pending:
                if e.acked and not getattr(e, "checked", False):
                    e.checked = True  # type: ignore[attr-defined]
                    exp = self.oracle_loads[port.op_id][e.req_idx]
                    if not np.isclose(e.value, exp, atol=1e-9):
                        log = "\n  ".join(
                            self.issue_log.get((port.op_id, e.req_idx), [])
                        )
                        fwd = getattr(e, "fwd_src", None)
                        fwd_log = ""
                        if fwd is not None:
                            src_lines = self.issue_log.get((fwd[0], fwd[1]), [])
                            fwd_log = (
                                f"\n  forwarded from {fwd[0]}[{fwd[1]}] "
                                f"sched={fwd[2]}:\n    " + "\n    ".join(src_lines)
                            )
                        raise AssertionError(
                            f"HAZARD VIOLATION: {port.op_id}[{e.req_idx}] "
                            f"addr={e.addr} got {e.value} expected {exp} "
                            f"at cycle {self.now} sched={e.sched} "
                            f"(forwarded={e.forwarded})\n  {log}{fwd_log}"
                        )
        while port.pending:
            e = port.pending[0]
            if not e.acked and e.valid is False:
                # Fig. 7: a mis-speculated store reaching the head of the
                # pending buffer ACKs without waiting for DRAM
                e.acked = True
            if not e.acked:
                break
            port.pending.pop(0)
            port.update_ack(e)
            if self.sequential:
                r = self.req_inst[(port.op_id, e.req_idx)]
                self.inst_outstanding[r] -= 1
            if not port.is_store:
                self.ready_loads.setdefault(port.op_id, []).append(e)
                if self.spec is not None:
                    # delivery of a gated value: a squash gate fires
                    # squash_latency later, a wait gate at delivery
                    # (SpecPlan.fire_delay)
                    rv = self.spec.resolve_of.get(port.op_id)
                    if (
                        rv is not None
                        and e.req_idx < len(rv)
                        and rv[e.req_idx] >= 0
                    ):
                        gid = int(rv[e.req_idx])
                        self.pending_fires += 1
                        self._post(
                            self.now
                            + self.spec.fire_delay(gid, self.p.squash_latency),
                            "spec_fire",
                            gid,
                        )

    def _deliver(self, port: dulib.Port) -> bool:
        ready = self.ready_loads.get(port.op_id)
        if not ready:
            return False
        cu = self.cus[self.traces[port.op_id].pe_id]
        progressed = False
        while ready and cu.waiting_on == port.op_id:
            e = ready.pop(0)
            cu.feed(e.value, self.now)
            self._drain_outbox(cu)
            progressed = True
        return progressed

    def _drain_outbox(self, cu: _CU):
        for op_id, v, valid in cu.outbox:
            self.store_values.setdefault(op_id, [])
            self._post(self.now + self.p.cu_latency, "cu_value", (op_id, v, valid))
        cu.outbox.clear()

    def _advance_window(self) -> bool:
        progressed = False
        while (
            self.inst_window < len(self.inst_outstanding)
            and self.inst_outstanding[self.inst_window] == 0
        ):
            self.inst_window += 1
            progressed = True
        return progressed


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def simulate(
    program: ir.Program,
    arrays: dict[str, np.ndarray],
    params: Optional[dict[str, int]] = None,
    mode=cfglib.UNSET,
    sim: Optional[SimParams] = None,
    validate: bool = False,
    engine=cfglib.UNSET,
    trace_mode=cfglib.UNSET,
    speculation=cfglib.UNSET,
    predictor=cfglib.UNSET,
    static_prune=cfglib.UNSET,
    validate_hints=cfglib.UNSET,
    config: Optional[cfglib.RunConfig] = None,
) -> SimResult:
    """Simulate ``program`` under one of the four evaluated systems.

    ``engine`` selects the timing engine for LSQ/FUS modes:

      * ``"event"`` (default) — vectorized event-driven engine
        (core/engine_event.py): batched numpy hazard-check waves, time
        advanced only at DRAM/CU/forwarding events. Identical final
        arrays; cycle counts match the cycle engine within the tolerance
        documented in DESIGN.md.
      * ``"cycle"`` — the reference per-cycle engine: one request per
        port per cycle, scalar checks, per-request issue logging when
        validating. Slow; use for conformance and first-divergence
        debugging.

    STA is evaluated analytically and ignores ``engine``.

    ``trace_mode`` selects the AGU/CU front-end (``"auto"`` |
    ``"compiled"`` | ``"interp"``, see ``schedule.trace_program``); both
    engines consume the same streams, so results are identical across
    trace modes — ``"compiled"`` just builds them closed-form.

    ``speculation`` selects the loss-of-decoupling policy (DESIGN.md
    §10): ``"off"`` (default) raises ``dae.LossOfDecoupling`` when an
    AGU depends on a protected load value; ``"auto"`` builds a
    speculative run-ahead AGU instead — value prediction, epoch
    tagging, rollback-free squash through the §6 valid-bit path — and
    opens load-dependent-trip/address kernels. ``predictor``
    (``dae.PREDICTORS``: ``"last"`` | ``"stride"`` | ``"context"`` |
    ``"auto"``) picks the speculative AGU's value predictor; the
    run-ahead window is ``SimParams.spec_runahead``. Final arrays stay
    bit-identical to the sequential oracle under every setting — the
    predictor only moves epoch gates and phantom traffic.

    ``static_prune`` lets the symbolic dependence certifier
    (``analysis/deps.py``, DESIGN.md §12) drop hazard pairs whose
    runtime check is provably a tautology — cycles and arrays stay
    bit-identical, the plan just carries fewer pairs. ``validate_hints``
    is the dynamic complement: every user ``MonotonicHint`` is checked
    against the op's actual address stream and a lying hint raises
    ``analysis.deps.HintViolation`` with the op id and first violating
    (instance, addr) pair.

    ``config=`` accepts a ``repro_torch.core.config.RunConfig`` carrying all
    of the above knobs at once (the individual kwargs remain as
    deprecated pass-throughs; an explicit kwarg that conflicts with an
    explicit config raises ``config.ConfigConflict``). A config's
    non-``None`` ``spec_runahead``/``fifo_depth``/``fifo_latency``
    override the matching ``sim=`` fields; ``backend``/``batch_waves``/
    ``symbolic_admission`` belong to the wave executor and are ignored
    here. Results are bit-identical between the two spellings.
    """
    cfg = cfglib.resolve(
        config, mode=mode, engine=engine, trace_mode=trace_mode,
        speculation=speculation, predictor=predictor,
        static_prune=static_prune, validate_hints=validate_hints,
    )
    mode, engine, trace_mode = cfg.mode, cfg.engine, cfg.trace_mode
    speculation, predictor = cfg.speculation, cfg.predictor
    static_prune, validate_hints = cfg.static_prune, cfg.validate_hints
    assert trace_mode in schedlib.TRACE_MODES, f"unknown trace mode {trace_mode!r}"
    params = params or {}
    p = cfg.apply_sim(sim, SimParams())
    comp = Compiled(
        program, forwarding=(mode == "FUS2"), trace_mode=trace_mode,
        speculation=speculation, predictor=predictor,
        static_prune=static_prune,
    )
    spec_out: list = []
    oracle_loads: Optional[dict[str, list[float]]] = None
    if comp.dae.spec:
        # the speculative AGU predicts against the oracle's load
        # streams; compute them once and share with validation below
        from repro_torch.core import speculate

        oracle_loads = speculate.oracle_load_streams(program, arrays, params)
    traces = schedlib.trace_program(
        program, comp.dae, arrays, params, mode=trace_mode,
        spec_out=spec_out, oracle_loads=oracle_loads,
        predictor=predictor, spec_runahead=p.spec_runahead,
    )

    if validate and mode != "STA" and oracle_loads is None:
        oracle_loads = {}

        def hook(op_id, addr, is_store, valid, value):
            if not is_store:
                oracle_loads.setdefault(op_id, []).append(value)

        ir.interpret(program, arrays, params, trace_hook=hook)

    return simulate_traced(
        comp, traces, arrays, params, mode=mode, sim=p, engine=engine,
        oracle_loads=oracle_loads if (validate and mode != "STA") else None,
        spec_plan=spec_out[0] if spec_out else None,
        validate_hints=validate_hints,
    )


def simulate_traced(
    comp: Compiled,
    traces: dict[str, schedlib.OpTrace],
    arrays: dict[str, np.ndarray],
    params: dict[str, int],
    mode: str = "FUS2",
    sim: Optional[SimParams] = None,
    engine: str = "event",
    oracle_loads: Optional[dict] = None,
    shared: Optional[SharedArtifacts] = None,
    spec_plan=None,
    validate_hints: bool = False,
) -> SimResult:
    """Simulate from an already-compiled front-end.

    The lower half of ``simulate()``: takes the ``Compiled`` analysis
    and the materialized AGU request streams instead of rebuilding them,
    plus an optional ``SharedArtifacts`` bundle. This is the entry point
    the DSE batch runner (``repro_torch.dse``) uses to run many timing/mode
    points against one compiled program — results are bit-identical to
    ``simulate()`` with the same settings, because every shared artifact
    is timing-independent (DESIGN.md §9).

    ``oracle_loads`` (op id -> in-order load value list/array) enables
    per-request validation against the sequential oracle, as
    ``simulate(validate=True)`` does. ``spec_plan`` is the
    ``speculate.SpecPlan`` the trace front-end produced for speculative
    programs (``trace_program(spec_out=...)``) — required whenever the
    compiled DAE has speculative PEs, ignored otherwise.
    """
    p = sim or SimParams()
    if mode == "STA":
        if validate_hints:
            from repro_torch.analysis import deps as depslib

            depslib.check_hinted_traces(comp.program, traces)
        return _simulate_sta(comp, traces, arrays, params, p, shared=shared)
    assert not (comp.dae.spec and spec_plan is None), (
        "speculative program simulated without its SpecPlan — pass "
        "trace_program(spec_out=...)'s plan through spec_plan"
    )

    if engine == "event":
        from repro_torch.core import engine_event

        ev = engine_event.EventEngine(
            comp, traces, arrays, params, mode, p,
            oracle_loads=oracle_loads, shared=shared, spec=spec_plan,
            validate_hints=validate_hints,
        )
        return ev.run()
    eng = Engine(
        comp, traces, arrays, params, mode, p, shared=shared, spec=spec_plan,
        validate_hints=validate_hints,
    )
    if oracle_loads is not None:
        eng.oracle_loads = {k: list(v) for k, v in oracle_loads.items()}
    return eng.run()
