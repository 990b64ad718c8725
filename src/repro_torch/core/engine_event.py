"""Vectorized event-driven simulator engine (``simulate(engine="event")``).

The port's copy of ``core/engine_event.py`` in the JAX package (numpy on
the host, as there).

The reference engine (core/simulator.Engine) steps Python once per
cycle: every port re-evaluates its scalar Hazard Safety Check every
cycle it is blocked, so wall-clock scales with *cycles*, not with
*requests*. This engine makes wall-clock scale with requests:

  * **Waves.** Each port's full request stream is already materialized
    as numpy arrays (schedule.trace_program). When a port is evaluated,
    the checks for a whole *slice* of its upcoming requests are computed
    at once against the current (frozen) src frontiers
    (du.check_pair_batch); the passing prefix issues as one wave at
    II=1, occupying consecutive cycles.
  * **Event queue.** Time advances only to event timestamps (DRAM burst
    close/complete, CU value arrival, forwarding latency, invalid-store
    ACK wakeups) — idle cycles are skipped entirely. Blocked ports are
    re-evaluated only when an event may have changed a frontier, not
    every cycle.
  * **Array-backed DU state.** The pending buffer of a port is the
    contiguous index window [head, next) of its trace plus per-request
    flag arrays; the ACK frontier registers are just row ``head - 1``.

Why a frozen frontier is sound: a Hazard Safety Check pass certifies a
*permanent* fact — every src request that precedes the dst request in
program order and could alias it has completed (or, in the §5.5
forwarding variant, has at least issued with its value). ACKs and issues
are irreversible and the remaining src stream only moves forward in
program order, so a request that passes against a frontier observed at
cycle t may issue at any cycle >= t with identical memory semantics.
Final arrays therefore match the cycle engine (and the oracle) exactly;
only *timing* can drift, because a wave freezes frontiers for up to one
inter-event gap. Waves are capped at the next event timestamp to bound
that drift; the observed envelope across the Table-1 matrix is
documented in DESIGN.md and asserted by tests/test_engine_diff.py.
"""

from __future__ import annotations

import heapq
from collections import deque
from typing import Optional

import numpy as np

from repro_torch.core import coarsen as coarsenlib
from repro_torch.core import dae as daelib
from repro_torch.core import du as dulib
from repro_torch.core import fifo as fifolib
from repro_torch.core import schedule as schedlib

SENTINEL = int(schedlib.SENTINEL)


class EvPort:
    """One DU port with its whole request stream resident as arrays.

    ``next`` is the first request not yet issued; ``head`` the first not
    yet ACK-popped. The pending buffer is the window [head, next); the
    most-recent-ACK registers are row ``head - 1`` (§4.2 sentinel rules
    applied when the stream is complete and drained).
    """

    __slots__ = (
        "trace", "op_id", "pe_id", "is_store", "depth", "n",
        "sched", "addr", "lastiter",
        "head", "next", "acked", "valid", "value", "forwarded",
        "issue_cycle", "free_at",
        "val_time", "val_data", "val_valid",
        "wake_posted", "retry_posted",
        "_fa_key", "_fa_val", "_fn_key", "_fn_val",
    )

    def __init__(self, trace: schedlib.OpTrace):
        self.trace = trace
        self.op_id = trace.op_id
        self.pe_id = trace.pe_id
        self.is_store = trace.is_store
        self.depth = trace.depth
        self.n = trace.n_req
        self.sched = np.ascontiguousarray(trace.sched)
        self.addr = trace.addr
        self.lastiter = trace.lastiter
        self.head = 0
        self.next = 0
        self.acked = np.zeros(self.n, dtype=bool)
        self.valid = np.ones(self.n, dtype=bool)
        self.value = np.zeros(self.n, dtype=np.float64)
        self.forwarded = np.zeros(self.n, dtype=bool)
        self.issue_cycle = np.full(self.n, -1, dtype=np.int64)
        self.free_at = 0  # II=1 pacing: earliest cycle of the next issue
        # store-value queue from the CU, index-aligned with requests
        self.val_time: list[int] = []
        self.val_data: list[float] = []
        self.val_valid: list[bool] = []
        self.wake_posted = -1
        self.retry_posted = -1
        self._fa_key = self._fn_key = -1
        self._fa_val = self._fn_val = None

    # ---- next-request registers (same contract as du.Port) --------------

    @property
    def exhausted(self) -> bool:
        return self.next >= self.n

    def req_sched(self) -> tuple[int, ...]:
        if self.exhausted:
            return (SENTINEL,) * self.depth
        return tuple(int(x) for x in self.sched[self.next])

    def req_addr(self) -> int:
        if self.exhausted:
            return SENTINEL
        return int(self.addr[self.next])

    def req_lastiter(self) -> tuple[bool, ...]:
        if self.exhausted:
            return (True,) * self.depth
        return tuple(bool(x) for x in self.lastiter[self.next])

    @property
    def no_pending_ack(self) -> bool:
        return self.head == self.next

    def frontier(self, use_next_request: bool):
        # registers change only when head/next move: memoize on them
        if use_next_request:
            if self._fn_key != self.next:
                self._fn_key = self.next
                self._fn_val = (
                    self.req_sched(), self.req_addr(), self.req_lastiter()
                )
            return self._fn_val
        if self._fa_key == self.head:
            return self._fa_val
        self._fa_key = self.head
        if self.head >= self.n:
            # sentinel ACK: stream complete and fully drained
            val = ((SENTINEL,) * self.depth, SENTINEL, (True,) * self.depth)
        elif self.head == 0:
            val = ((0,) * self.depth, -(2**62), (False,) * self.depth)
        else:
            i = self.head - 1
            val = (
                tuple(int(x) for x in self.sched[i]),
                int(self.addr[i]),
                tuple(bool(x) for x in self.lastiter[i]),
            )
        self._fa_val = val
        return val


class _OpenBurst:
    __slots__ = ("idxs", "open_cycle", "tick_posted")

    def __init__(self, open_cycle: int):
        self.idxs: list[int] = []
        self.open_cycle = open_cycle
        self.tick_posted = False


class EventEngine:
    """LSQ / FUS1 / FUS2 execution with vectorized waves (module doc)."""

    def __init__(self, comp, traces, arrays, params, mode, p,
                 oracle_loads: Optional[dict] = None, shared=None, spec=None,
                 validate_hints: bool = False):
        self.comp = comp
        self.traces = traces
        self.mode = mode
        self.p = p
        if validate_hints:
            # MonotonicHint sanitizer (DESIGN.md §12): raises
            # analysis.deps.HintViolation before any timing runs
            from repro_torch.analysis import deps as depslib

            depslib.check_hinted_traces(comp.program, traces)
        self.forwarding = mode == "FUS2"
        self.sequential = mode == "LSQ"
        self.burst_size = 1 if mode == "LSQ" else p.burst_size

        self.mem = {k: np.array(v, copy=True) for k, v in arrays.items()}
        self.params = params
        self.ports = {op: EvPort(tr) for op, tr in traces.items()}
        self.pairs_by_dst = comp.plan.by_dst()
        if shared is not None and shared.nodep_bits is not None:
            self.nodep_bits = shared.nodep_bits
        else:
            self.nodep_bits = dulib.nodependence_bits(comp.plan.pairs, traces)
        # reverse dependency map: when src's frontier moves (issue/pop),
        # these dst ports must be re-evaluated
        self.dsts_of: dict[str, list[str]] = {}
        for pr in comp.plan.pairs:
            self.dsts_of.setdefault(pr.src, []).append(pr.dst)
        # dirty-set scheduling: wave attempts / ACK scans / CU delivery
        # happen only for ports an event or a state change actually touched
        self.port_order = list(traces)
        self.dirty: set[str] = set(traces)
        # temporal wave coarsening (core/coarsen.BlockMemo): a
        # check-blocked attempt whose observable inputs are unchanged is
        # skipped on a key comparison instead of re-running the batch
        # checks — this is what tames the pagerank re-evaluation storm
        # without touching issue cycles (timing is bit-identical: only
        # attempts that would return False without side effects are
        # skipped; see _issue_wave for the record conditions)
        self.block_memo = coarsenlib.BlockMemo()
        self.ack_dirty: set[str] = set()
        self.deliver_dirty: set[int] = set()
        self.capped: set[str] = set()
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
        # loads popped from pending, queued for in-order CU delivery
        self.ready_loads: dict[str, deque] = {op: deque() for op in traces}
        # bounded cross-PE FIFO queues (core/fifo, DESIGN.md §11); serviced
        # from _deliver when a CU's waiting_on is a ("fifo_pop"|"fifo_push",
        # edge) tuple instead of a load op id
        self.fifos: dict[int, fifolib.FifoQueue] = {}
        if getattr(comp, "fifo", None):
            fifolib.check_depth(comp.fifo, p.fifo_depth)
            self.fifos = {
                e.idx: fifolib.FifoQueue(e, p.fifo_depth, p.fifo_latency)
                for e in comp.fifo.edges
            }
            # CUs can be fifo-blocked at t=0 with no load event ever due
            # (e.g. a load-free producer): give every PE one initial visit
            self.deliver_dirty.update(pe.id for pe in comp.dae.pes)

        if self.sequential:
            if shared is not None and shared.rank_table is not None:
                ranks, counts = shared.rank_table
            else:
                fuse = {pe.id: pe.id for pe in comp.dae.pes}  # LSQ: no fusion
                ranks, counts = schedlib.instance_rank_table(
                    traces, comp.dae, comp.loop_pos, comp.op_pos, fuse,
                    comp.op_path,
                )
            self.inst_rank = ranks
            self.inst_outstanding = counts.copy()
            self.inst_window = 0

        # speculative AGU plan (speculate.SpecPlan, DESIGN.md §10):
        # per-request epoch gates + squash traffic
        self.spec = spec
        if spec is not None:
            self.gate_time = np.full(
                max(spec.n_gates, 1), SENTINEL, dtype=np.int64
            )
            # gid -> ports with requests gated on it (wave wakeups)
            self.gate_ports: dict[int, set] = {}
            for op_id, g in spec.gates.items():
                for gid in np.unique(g[g >= 0]):
                    self.gate_ports.setdefault(int(gid), set()).add(op_id)

        self.open_bursts: dict[str, _OpenBurst] = {}
        self.channel_free_at = 0
        self.events: list[tuple[int, int, str, object]] = []
        self._n = 0
        self.now = 0
        self.oracle_loads = (
            {k: np.asarray(v) for k, v in oracle_loads.items()}
            if oracle_loads is not None
            else None
        )
        from repro_torch.core.simulator import SimResult

        self.result = SimResult(cycles=0, arrays={}, mode=mode)

    # -- events -----------------------------------------------------------

    def _post(self, t: int, kind: str, payload=None):
        self._n += 1
        heapq.heappush(self.events, (int(t), self._n, kind, payload))

    # -- main loop --------------------------------------------------------

    def run(self):
        for cu in self.cus.values():
            self._drain_outbox(cu)
        self._settle()
        while not self._all_done():
            if not self.events:
                self._deadlock()
            t = self.events[0][0]
            self.now = t
            if self.now > self.p.max_cycles:
                raise RuntimeError("max_cycles exceeded")
            while self.events and self.events[0][0] == t:
                _, _, kind, payload = heapq.heappop(self.events)
                self._event(kind, payload)
            self._settle()
        self.result.cycles = self.now
        self.result.arrays = self.mem
        self.result.fifo_stats = [q.stats() for q in self.fifos.values()]
        if self.spec is not None:
            self.result.spec_stats = self.spec.stats()
        return self.result

    def _all_done(self):
        return (
            all(p.head >= p.n for p in self.ports.values())
            and all(cu.done for cu in self.cus.values())
            and not self.open_bursts
            and not self.events
        )

    def _deadlock(self):
        lines = [f"DEADLOCK at cycle {self.now} mode={self.mode} (event engine)"]
        for op_id, p in self.ports.items():
            lines.append(
                f"  {op_id}: next={p.next}/{p.n} head={p.head}"
                f" frontier={p.frontier(False)}"
            )
        for pe_id, cu in self.cus.items():
            lines.append(f"  cu{pe_id}: done={cu.done} waiting={cu.waiting_on}")
        for q in self.fifos.values():
            lines.append(
                f"  fifo {q.edge.describe()}: occ={q.occupancy}/{q.depth}"
                f" pushed={q.pushed} popped={q.popped}"
            )
        raise RuntimeError("\n".join(lines))

    # -- settle: fixpoint of combinational progress at self.now -----------

    def _touch_dependents(self, op_id: str):
        for d in self.dsts_of.get(op_id, ()):
            self.dirty.add(d)

    def _settle(self):
        # ports capped by the previous horizon get another shot now
        self.dirty |= self.capped
        self.capped.clear()
        while self.ack_dirty or self.deliver_dirty or self.dirty:
            if self.ack_dirty:
                batch = [o for o in self.port_order if o in self.ack_dirty]
                self.ack_dirty.clear()
                for op_id in batch:
                    if self._ack_scan(self.ports[op_id]):
                        self._touch_dependents(op_id)
            if self.deliver_dirty:
                self._deliver()
            if self.sequential and self._advance_window():
                self.dirty.update(
                    op for op, p in self.ports.items() if not p.exhausted
                )
            if self.dirty:
                # deterministic trace order, like the cycle engine's scan
                batch = [o for o in self.port_order if o in self.dirty]
                self.dirty.clear()
                for op_id in batch:
                    port = self.ports[op_id]
                    if not port.exhausted and self._issue_wave(op_id, port):
                        self._touch_dependents(op_id)

    # -- wave issue -------------------------------------------------------

    def _issue_wave(self, op_id: str, port: EvPort) -> bool:
        start = max(self.now, port.free_at)
        horizon = self.events[0][0] if self.events else None
        if horizon is not None and start >= horizon:
            self.capped.add(op_id)
            return False
        n0 = port.next
        # temporal coarsening: when a prior attempt was check-blocked on
        # its first request with every consulted src *current* (no
        # future-stamped issue cycles — checks a pure function of the
        # src (head, next) windows), an attempt with an identical
        # fingerprint must fail identically, with no side effects to
        # replay — skip it (coarsen.BlockMemo doc)
        memo_key = coarsenlib.BlockMemo.key(
            n0, len(port.val_time),
            tuple(
                (self.ports[pr.src].head, self.ports[pr.src].next)
                for pr in self.pairs_by_dst.get(op_id, ())
            ),
        )
        if self.block_memo.probe(op_id, memo_key):
            return False
        m = port.n - n0
        capped = False
        if horizon is not None and horizon - start < m:
            m = horizon - start
            capped = True

        if self.sequential:
            # sequential window: ranks are non-decreasing per stream
            r = self.inst_rank[op_id][n0 : n0 + m]
            m2 = int(np.searchsorted(r, self.inst_window, side="right"))
            if m2 < m:
                m, capped = m2, False  # window-gated: woken on advance
            if m <= 0:
                return False

        # speculative AGU: cut the wave at the first unresolved epoch
        # gate (ids are non-decreasing along every stream). Fired gates
        # need no cycle lower bound: a gate's fire time is the event
        # timestamp it was processed at, so any later wave has
        # start >= now >= gate_time already.
        if self.spec is not None:
            g = self.spec.gates.get(op_id)
            if g is not None:
                gs = g[n0 : n0 + m]
                if len(gs) and gs[-1] >= 0:
                    unfired = (gs >= 0) & (
                        self.gate_time[np.maximum(gs, 0)] >= SENTINEL
                    )
                    if unfired.any():
                        m2 = int(np.argmax(unfired))
                        m, capped = m2, False  # woken by spec_fire
                        if m <= 0:
                            return False

        if port.is_store:
            # §5.5: a store issues only together with its value
            avail = len(port.val_time) - n0
            if avail < m:
                m, capped = avail, False  # value-starved: woken on cu_value
            if m <= 0:
                return False
            vt = np.asarray(port.val_time[n0 : n0 + m], dtype=np.int64)
            cyc = np.maximum(vt, start + np.arange(m, dtype=np.int64))
            # enforce II=1 spacing: cyc strictly increasing by >= 1
            cyc = np.maximum.accumulate(cyc - np.arange(m)) + np.arange(m)
            if horizon is not None:
                m2 = int(np.searchsorted(cyc, horizon, side="left"))
                if m2 < m:
                    m, capped = m2, True
                if m <= 0:
                    self.capped.add(op_id)
                    return False
                cyc = cyc[:m]
        else:
            cyc = start + np.arange(m, dtype=np.int64)

        sl_sched = port.sched[n0 : n0 + m]
        sl_addr = port.addr[n0 : n0 + m]
        ok = np.ones(m, dtype=bool)
        all_current = True  # every consulted src current so far
        for pair in self.pairs_by_dst.get(op_id, ()):
            if self.sequential and not pair.same_pe:
                continue  # LSQ: cross-loop order enforced by instances
            src = self.ports[pair.src]
            use_next = (
                self.forwarding and pair.kind == "RAW" and src.is_store
            )
            bits = None
            if pair.nodependence:
                full = self.nodep_bits.get((pair.dst, pair.src))
                bits = full[n0 : n0 + m] if full is not None else None
                if bits is None:
                    bits = np.zeros(m, dtype=bool)
            # Terms that read the src *next-request* registers would leak
            # future wave issues into earlier cycles; reconstruct them
            # per-request from the src's stamped issue cycles. Fast path:
            # when the src has no issues stamped beyond `now` (the common
            # case outside same-settle interactions), the registers are
            # constant over the wave and the frozen scalars are exact.
            src_current = (
                src.next == 0 or src.issue_cycle[src.next - 1] <= self.now
            )
            all_current &= src_current
            frontier = None
            next_state = None
            if not src_current:
                if use_next:
                    frontier = self._frontier_at(src, cyc)
                elif pair.shared_depth > 0:
                    next_state = self._next_state_at(
                        src, cyc, pair.shared_depth
                    )
            ok &= dulib.check_pair_batch(
                pair, sl_sched, sl_addr, src, use_next, bits,
                frontier=frontier, next_state=next_state,
            )
            if not ok[0]:
                # check-blocked on the first request. Record the
                # fingerprint only when every consulted src is current
                # (outcome independent of time) and outside LSQ mode
                # (the sequential window is not in the key); a current
                # prefix also guarantees _schedule_usenext_retry posts
                # nothing (all stamped issues <= now <= cyc[0]), so a
                # skipped replay loses no event.
                if all_current and not self.sequential:
                    self.block_memo.record(op_id, memo_key)
                self._schedule_usenext_retry(op_id, port, int(cyc[0]))
                return False
        L = m if ok.all() else int(np.argmin(ok))
        if L < m:
            # Prefix-blocked. Checks against ACK frontiers resolve via
            # events (touch_dependents), but the §5.5 next-request
            # frontier also advances with *time* through src issue
            # cycles stamped by earlier waves — schedule a retry at the
            # next such advance or the blocked request starves until the
            # next unrelated event.
            self._schedule_usenext_retry(op_id, port, int(cyc[L]))
        if L <= 0:
            return False
        if L == m and capped:
            self.capped.add(op_id)  # ran to the horizon: more may go then
        cyc = cyc[:L]
        end = n0 + L

        port.issue_cycle[n0:end] = cyc
        port.next = end
        port.free_at = int(cyc[-1]) + 1

        if port.is_store:
            port.value[n0:end] = port.val_data[n0:end]
            port.valid[n0:end] = port.val_valid[n0:end]
            any_invalid = False
            for j in range(L):
                i = n0 + j
                if port.valid[i]:
                    self._enqueue_burst(port, i, int(cyc[j]))
                else:
                    # Fig. 7: invalid stores skip DRAM; they ACK when
                    # they reach the pending-buffer head (_ack_scan) —
                    # flag the port or nothing ever scans it
                    any_invalid = True
            if any_invalid:
                self.ack_dirty.add(op_id)
        elif self.forwarding:
            for j in range(L):
                i = n0 + j
                if not self._try_forward(op_id, port, i, int(cyc[j])):
                    self._enqueue_burst(port, i, int(cyc[j]))
        else:
            for j in range(L):
                self._enqueue_burst(port, n0 + j, int(cyc[j]))
        return True

    def _schedule_usenext_retry(self, op_id: str, port: EvPort, fail_cyc: int):
        if not self.forwarding:
            return
        t_min = None
        for pair in self.pairs_by_dst.get(op_id, ()):
            src = self.ports[pair.src]
            if not (pair.kind == "RAW" and src.is_store):
                continue
            issued = src.issue_cycle[: src.next]
            pos = int(np.searchsorted(issued, fail_cyc, side="right"))
            if pos < src.next:
                t = int(issued[pos])
                if t_min is None or t < t_min:
                    t_min = t
        if t_min is not None and port.retry_posted < t_min:
            port.retry_posted = t_min
            self._post(t_min, "retry", op_id)

    # -- per-cycle src state reconstruction -------------------------------

    def _next_index_at(self, src: EvPort, cyc: np.ndarray) -> np.ndarray:
        """The src port's next-request *index* as of each cycle in
        ``cyc``: the count of src requests already issued by then. Issue
        cycles are strictly increasing per port, so this is exact."""
        return np.searchsorted(
            src.issue_cycle[: src.next], cyc, side="right"
        )

    def _frontier_at(self, src: EvPort, cyc: np.ndarray):
        """Per-request next-request registers (§5.5 forwarding variant)
        of ``src`` as of each dst issue cycle — sched row, addr, and
        lastIter bits, with the §4.2(4) sentinel once the stream ends."""
        nxt = self._next_index_at(src, cyc)
        done = nxt >= src.n
        idx = np.minimum(nxt, max(src.n - 1, 0))
        if src.n == 0:
            m = len(cyc)
            return (
                np.full((m, src.depth), SENTINEL, dtype=np.int64),
                np.full(m, SENTINEL, dtype=np.int64),
                np.ones((m, src.depth), dtype=bool),
            )
        f_sched = np.where(done[:, None], SENTINEL, src.sched[idx])
        f_addr = np.where(done, SENTINEL, src.addr[idx])
        f_last = np.where(done[:, None], True, src.lastiter[idx])
        return f_sched, f_addr, f_last

    def _next_state_at(self, src: EvPort, cyc: np.ndarray, k: int):
        """Per-request (next-request sched at depth k, noPendingAck) of
        ``src`` as of each dst issue cycle — the §5.2 second line."""
        nxt = self._next_index_at(src, cyc)
        if src.n == 0:
            m = len(cyc)
            return np.full(m, SENTINEL, dtype=np.int64), np.ones(m, bool)
        done = nxt >= src.n
        idx = np.minimum(nxt, src.n - 1)
        next_sched_k = np.where(done, SENTINEL, src.sched[idx, k - 1])
        no_pend = nxt == src.head
        return next_sched_k, no_pend

    # -- §5.5 forwarding --------------------------------------------------

    def _try_forward(self, op_id: str, port: EvPort, i: int, cycle: int) -> bool:
        """Associative pending-buffer search, youngest match wins; only
        program-order-earlier entries *already issued by this load's
        cycle* qualify (the buffer as the DU would see it then). Mirrors
        the cycle engine's _try_forward incl. its >= tie-breaking."""
        addr_i = int(port.addr[i])
        best = None  # (key, src op, global entry index)
        for pair in self.pairs_by_dst.get(op_id, ()):
            if pair.kind != "RAW":
                continue
            sport = self.ports[pair.src]
            h, nx = sport.head, sport.next
            if h >= nx:
                continue
            mask = (
                (sport.addr[h:nx] == addr_i)
                & sport.valid[h:nx]
                & (sport.issue_cycle[h:nx] <= cycle)
            )
            k = pair.shared_depth
            if k > 0:
                es = sport.sched[h:nx, k - 1]
                rs = int(port.sched[i, k - 1])
                before = (es < rs) | ((es == rs) & (not pair.dst_before_src))
                mask &= before
            else:
                if pair.dst_before_src:
                    continue  # dst precedes src topologically: never before
            hits = np.nonzero(mask)[0]
            if len(hits) == 0:
                continue
            j = int(hits[-1]) + h  # youngest: sched non-decreasing in stream
            key = (
                int(sport.sched[j, k - 1]) if k > 0 else 0,
                not pair.dst_before_src,
            )
            if best is None or key >= best[0]:
                best = (key, pair.src, j)
        if best is None:
            return False
        _, src_op, j = best
        port.value[i] = self.ports[src_op].value[j]
        port.forwarded[i] = True
        self.result.forwards += 1
        self._post(
            int(port.issue_cycle[i]) + self.p.forward_latency,
            "fwd_ready",
            (op_id, i),
        )
        return True

    # -- bursts -----------------------------------------------------------

    def _enqueue_burst(self, port: EvPort, i: int, cycle: int):
        op_id = port.op_id
        b = self.open_bursts.get(op_id)
        if b is not None and cycle - b.open_cycle >= self.p.burst_timeout:
            # the wave ran past the open burst's timeout: close it there
            self._close_burst(op_id, b.open_cycle + self.p.burst_timeout)
            b = None
        if b is None:
            b = _OpenBurst(cycle)
            self.open_bursts[op_id] = b
        b.idxs.append(i)
        if len(b.idxs) >= self.burst_size:
            self._close_burst(op_id, cycle)
        elif not b.tick_posted:
            # a lingering burst closes burst_timeout after opening (§2.1.1)
            b.tick_posted = True
            self._post(
                b.open_cycle + self.p.burst_timeout, "burst_tick",
                (op_id, b.open_cycle),
            )

    def _close_burst(self, op_id: str, close_cycle: int):
        b = self.open_bursts.pop(op_id)
        self._post(close_cycle, "burst_close", (op_id, np.asarray(b.idxs)))

    # -- event handlers ---------------------------------------------------

    def _event(self, kind: str, payload):
        if kind == "burst_close":
            # the DRAM channel serves bursts in close order (heap order)
            op_id, idxs = payload
            issue = max(self.now, self.channel_free_at)
            self.channel_free_at = issue + self.p.channel_occupancy
            complete = issue + self.p.channel_occupancy + self.p.dram_latency
            self.result.dram_bursts += 1
            self.result.dram_requests += len(idxs)
            self._post(complete, "burst_done", (op_id, idxs))
        elif kind == "burst_done":
            op_id, idxs = payload
            port = self.ports[op_id]
            arr = self.mem[self.comp.op_array[op_id]]
            addrs = port.addr[idxs]
            if port.is_store:
                vals = port.value[idxs]
                if len(np.unique(addrs)) == len(addrs):
                    arr[addrs] = vals
                else:  # duplicate addresses in one burst: last write wins
                    u, last = np.unique(addrs[::-1], return_index=True)
                    arr[u] = vals[::-1][last]
            else:
                port.value[idxs] = arr[addrs]
            port.acked[idxs] = True
            self.ack_dirty.add(op_id)
        elif kind == "burst_tick":
            op_id, open_cycle = payload
            b = self.open_bursts.get(op_id)
            if b is not None and b.open_cycle == open_cycle:
                self._close_burst(op_id, self.now)
        elif kind == "fwd_ready":
            op_id, i = payload
            self.ports[op_id].acked[i] = True
            self.ack_dirty.add(op_id)
        elif kind == "cu_value":
            op_id, value, valid = payload
            port = self.ports[op_id]
            port.val_time.append(self.now)
            port.val_data.append(value)
            port.val_valid.append(valid)
            self.dirty.add(op_id)
        elif kind == "wake":
            self.ack_dirty.add(payload)
        elif kind == "retry":
            self.dirty.add(payload)
        elif kind == "spec_fire":
            self._fire_gate(payload)
        elif kind == "fifo_tick":
            # a queued FIFO token matured (or a push landed): revisit the
            # PE named in the payload so _deliver can unblock it
            self.deliver_dirty.add(payload)
        else:  # pragma: no cover
            raise ValueError(kind)

    def _fire_gate(self, gid: int):
        """Squash of epoch ``gid`` completes: open the gate, wake the
        gated ports, and release the phantom traffic through the shared
        accounting (``speculate.fire_phantoms`` — one body for both
        engines keeps their counters bit-identical; phantoms never
        touch hazard-visible port state, DESIGN.md §10)."""
        if self.gate_time[gid] <= self.now:
            return
        self.gate_time[gid] = self.now
        self.dirty.update(self.gate_ports.get(gid, ()))
        from repro_torch.core import speculate as speclib

        self.channel_free_at = speclib.fire_phantoms(
            self.spec, gid, self.now, self.channel_free_at,
            self.burst_size, self.p.channel_occupancy, self.result,
        )

    # -- ACK frontier -----------------------------------------------------

    def _ack_scan(self, port: EvPort) -> bool:
        """Pop the ACKed prefix of the pending window, advancing the ACK
        registers (row head-1). Mis-speculated stores ACK one cycle after
        issue once they reach the buffer head (Fig. 7), without DRAM."""
        h0 = port.head
        h, nx = h0, port.next
        while h < nx:
            if port.acked[h]:
                h += 1
                continue
            if port.is_store and not port.valid[h]:
                t = int(port.issue_cycle[h]) + 1
                if t <= self.now:
                    port.acked[h] = True
                    h += 1
                    continue
                if port.wake_posted < t:
                    port.wake_posted = t
                    self._post(t, "wake", port.op_id)
            break
        if h == h0:
            return False
        popped = np.arange(h0, h)
        port.head = h
        if not port.is_store:
            if self.oracle_loads is not None:
                self._validate_loads(port, popped)
            self.ready_loads[port.op_id].extend(popped.tolist())
            self.deliver_dirty.add(port.pe_id)
            if self.spec is not None:
                # gated value delivered: squash gates fire
                # squash_latency later, wait gates at delivery
                # (SpecPlan.fire_delay)
                rv = self.spec.resolve_of.get(port.op_id)
                if rv is not None:
                    sel = popped[popped < len(rv)]
                    for gid in rv[sel]:
                        if gid >= 0:
                            gid = int(gid)
                            self._post(
                                self.now
                                + self.spec.fire_delay(
                                    gid, self.p.squash_latency
                                ),
                                "spec_fire", gid,
                            )
        if self.sequential:
            r = self.inst_rank[port.op_id][popped]
            np.subtract.at(self.inst_outstanding, r, 1)
        return True

    def _validate_loads(self, port: EvPort, popped: np.ndarray):
        exp = self.oracle_loads[port.op_id][popped]
        got = port.value[popped]
        bad = ~np.isclose(got, exp, atol=1e-9)
        if bad.any():
            i = int(popped[np.argmax(bad)])
            raise AssertionError(
                f"HAZARD VIOLATION: {port.op_id}[{i}] addr={port.addr[i]} "
                f"got {port.value[i]} expected {self.oracle_loads[port.op_id][i]} "
                f"at cycle {self.now} sched={tuple(port.sched[i])} "
                f"(forwarded={bool(port.forwarded[i])}) — re-run with "
                f"engine='cycle', validate=True for per-request issue logs"
            )

    # -- CU delivery ------------------------------------------------------

    def _deliver(self) -> bool:
        progressed = False
        pes = self.deliver_dirty
        self.deliver_dirty = set()
        for pe_id in pes:
            cu = self.cus[pe_id]
            while cu.waiting_on is not None:
                if isinstance(cu.waiting_on, tuple):
                    # FIFO wait (DESIGN.md §11): ("fifo_pop"|"fifo_push", e)
                    if not self._service_fifo_wait(pe_id, cu):
                        break
                    progressed = True
                    continue
                q = self.ready_loads.get(cu.waiting_on)
                if not q:
                    break
                i = q.popleft()
                cu.feed(float(self.ports[cu.waiting_on].value[i]), self.now)
                self._drain_outbox(cu)
                progressed = True
        return progressed

    def _service_fifo_wait(self, pe_id: int, cu) -> bool:
        """Try to satisfy one FIFO pop/push wait; False → still blocked."""
        kind, eidx = cu.waiting_on
        q = self.fifos[eidx]
        if kind == "fifo_pop":
            if not q.head_ready(self.now):
                if q.q:
                    # token in flight: wake this consumer when it matures
                    self._post(q.next_ready_time(), "fifo_tick", pe_id)
                q.pop_stalls += 1
                return False
            cu.feed(q.pop(self.now), self.now)
            # a slot freed: a producer backpressured on this edge can go
            self.deliver_dirty.add(q.edge.prod_pe)
        else:  # fifo_push
            if not q.can_push():
                q.push_stalls += 1
                return False
            q.push(cu.push_value, self.now)
            self._post(self.now + q.latency, "fifo_tick", q.edge.cons_pe)
            cu.feed(0.0, self.now)  # push ack; value is ignored
        self._drain_outbox(cu)
        return True

    def _drain_outbox(self, cu):  # daelib.CU or daelib.VecCU
        for op_id, v, valid in cu.outbox:
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
