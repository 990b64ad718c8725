"""Data Unit hardware model (paper §5, Fig. 4).

Per-memory-op port state and the synthesized Hazard Safety Check
evaluation. The port tracks, exactly as the paper's DU does:

  * the (address, schedule, lastIter) of the most recent ACK,
  * the (address, schedule, lastIter) of the next request to be sent,
  * a pending buffer (FIFO) of requests sent but not yet ACKed — for
    stores it also holds values (+ §6 valid bits) enabling the
    associative store-to-load forwarding search (§5.5),
  * the ``noPendingAck`` single-bit term (§5.2),
  * sentinel propagation: when the AGU stream ends, the next-request
    registers go to +inf; once the pending buffer drains the ACK
    registers follow (§4.2(4)).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import hazards as hz
from repro_torch.core import schedule as sched

SENTINEL = int(sched.SENTINEL)


@dataclasses.dataclass
class PendingEntry:
    req_idx: int
    addr: int
    sched: tuple[int, ...]
    lastiter: tuple[bool, ...]
    # store-side value state
    value: Optional[float] = None
    valid: Optional[bool] = None  # None = value not yet arrived from CU
    issued: bool = False  # sent to DRAM
    acked: bool = False
    # load-side
    forwarded: bool = False


class Port:
    """One DU port (one load or store operation)."""

    def __init__(self, trace: sched.OpTrace):
        self.trace = trace
        self.op_id = trace.op_id
        self.is_store = trace.is_store
        self.depth = trace.depth
        self.next = 0  # index of next request not yet moved to pending
        self.pending: list[PendingEntry] = []
        # ACK frontier registers
        self.ack_sched: tuple[int, ...] = tuple([0] * trace.depth)
        self.ack_addr: int = -(2**62)
        self.ack_lastiter: tuple[bool, ...] = tuple([False] * trace.depth)
        self.acked_count = 0
        # loads: values delivered to the CU, in order
        self.delivered = 0

    # ---- next-request registers ------------------------------------------

    @property
    def exhausted(self) -> bool:
        return self.next >= self.trace.n_req

    def req_sched(self) -> tuple[int, ...]:
        if self.exhausted:
            return tuple([SENTINEL] * self.depth)
        return tuple(int(x) for x in self.trace.sched[self.next])

    def req_addr(self) -> int:
        if self.exhausted:
            return SENTINEL
        return int(self.trace.addr[self.next])

    def req_lastiter(self) -> tuple[bool, ...]:
        if self.exhausted:
            return tuple([True] * self.depth)
        return tuple(bool(x) for x in self.trace.lastiter[self.next])

    @property
    def no_pending_ack(self) -> bool:
        return not any(not e.acked for e in self.pending)

    # ---- frontier views used by the checks ---------------------------------

    def frontier(self, use_next_request: bool):
        """(sched, addr, lastiter, drained) of the consulted frontier.

        ``use_next_request=True`` is the §5.5 forwarding variant: consult
        the *next request* registers instead of the most recent ACK.
        """
        if use_next_request:
            return self.req_sched(), self.req_addr(), self.req_lastiter()
        if self.exhausted and not self.pending:
            # sentinel ACK: stream complete and fully drained
            return (
                tuple([SENTINEL] * self.depth),
                SENTINEL,
                tuple([True] * self.depth),
            )
        return self.ack_sched, self.ack_addr, self.ack_lastiter

    def update_ack(self, e: PendingEntry):
        self.ack_sched = e.sched
        self.ack_addr = e.addr
        self.ack_lastiter = e.lastiter
        self.acked_count += 1


def nodependence_bits(
    pairs: list[hz.HazardPair], traces: dict[str, sched.OpTrace]
) -> dict[tuple[str, str], np.ndarray]:
    """Precompute the §5.6 NoDependence bit stream of every pair that
    synthesizes the term: bit[i] is True when dst request i's address is
    strictly above the youngest preceding src request's address (both
    streams innermost-monotonic), i.e. no intra-loop dependence exists."""
    out: dict[tuple[str, str], np.ndarray] = {}
    for pr in pairs:
        if not pr.nodependence:
            continue
        lt, st = traces[pr.dst], traces[pr.src]
        idx = np.searchsorted(st.seq, lt.seq, side="left") - 1
        prev = np.where(idx >= 0, st.addr[np.maximum(idx, 0)], -(2**62))
        out[(pr.dst, pr.src)] = lt.addr > prev
    return out


def _cmp(a: int, b: int, op: str) -> bool:
    return a <= b if op == "<=" else a < b


def check_pair(
    pair: hz.HazardPair,
    req_sched_a: tuple[int, ...],
    req_addr_a: int,
    src: Port,
    use_next_request: bool = False,
    nodep_bit: bool = False,
    explain: Optional[list] = None,
) -> bool:
    """Evaluate the synthesized Hazard Safety Check (§5.4) for the next
    dst request against the src frontier. Mirrors the paper equations
    term for term."""
    k = pair.shared_depth
    f_sched, f_addr, f_lastiter = src.frontier(use_next_request)

    # --- Program Order Safety Check (§5.2) ---
    if k == 0:
        # no shared loops: relative order == topological order. dst after
        # src topologically -> never "before" in program order.
        program_order_ok = pair.dst_before_src
    else:
        c = pair.comparator
        program_order_ok = _cmp(req_sched_a[k - 1], f_sched[k - 1], c)
        if not program_order_ok and not use_next_request:
            # second line: no further src requests in the considered range
            program_order_ok = (
                _cmp(req_sched_a[k - 1], src.req_sched()[k - 1], c)
                and src.no_pending_ack
            )
    if program_order_ok:
        if explain is not None:
            explain.append(
                f"{pair.dst}<={pair.src}: PO ok (req={req_sched_a} "
                f"f_sched={f_sched} next={src.req_sched()} "
                f"nopend={src.no_pending_ack})"
            )
        return True

    # --- No Address Reset Check (§5.3) ---
    reset_ok = all(f_lastiter[j - 1] for j in pair.lastiter_depths)
    if reset_ok and pair.l_depth is not None:
        l = pair.l_depth
        reset_ok = req_sched_a[l - 1] == f_sched[l - 1] + pair.delta
        # sentinel frontier: the source is fully complete, no reset possible
        if f_sched[l - 1] >= SENTINEL:
            reset_ok = True

    # --- §5.6 NoDependence term (intra-loop RAW) ---
    if pair.nodependence and nodep_bit and reset_ok:
        if explain is not None:
            explain.append(f"{pair.dst}<={pair.src}: NoDependence ok")
        return True

    # --- address frontier comparison (needs innermost monotonicity, §3.1) ---
    if pair.use_frontier or f_addr >= SENTINEL:
        ok = req_addr_a < f_addr and reset_ok
        if ok and explain is not None:
            explain.append(
                f"{pair.dst}<={pair.src}: ADDR ok (addr={req_addr_a} "
                f"f_addr={f_addr} reset_ok={reset_ok} f_sched={f_sched} "
                f"req_sched={req_sched_a} lastiter={f_lastiter})"
            )
        return ok

    return False


def check_pair_batch(
    pair: hz.HazardPair,
    req_sched: np.ndarray,  # (m, dst_depth) int64
    req_addr: np.ndarray,  # (m,) int64
    src,  # any object with frontier()/req_sched()/no_pending_ack
    use_next_request: bool = False,
    nodep_bits: Optional[np.ndarray] = None,  # (m,) bool, §5.6 slice
    frontier: Optional[tuple] = None,  # per-request frontier override
    next_state: Optional[tuple] = None,  # per-request (next_sched_k, no_pend)
) -> np.ndarray:
    """Vectorized ``check_pair``: evaluate the synthesized Hazard Safety
    Check for ``m`` consecutive dst requests. Returns an (m,) bool array.

    By default the src frontier is frozen at its current state for the
    whole batch — sound, because a pass certifies the permanent
    program-order/completion fact the paper's check establishes (ACKs
    are irreversible and the remaining src stream only moves forward in
    program order), so a request that passes against a frontier observed
    at cycle t may issue at any cycle >= t with identical memory
    semantics. The event engine passes per-request overrides for the
    terms that would otherwise leak *future* src state into earlier
    cycles of a wave:

      * ``frontier`` = (f_sched (m, d_src), f_addr (m,), f_last (m, d_src))
        — used for the §5.5 forwarding variant, reconstructed from the
        src port's stamped issue cycles;
      * ``next_state`` = (next_sched_k (m,), no_pending_ack (m,)) — the
        second Program-Order line, likewise time-reconstructed.

    **Config batching.** All stateful inputs additionally accept a
    leading *config* axis: ``frontier`` arrays of shape ``(C, m, d)`` /
    ``(C, m)``, ``next_state`` of ``(C, m)``, ``nodep_bits`` of
    ``(C, m)`` — one row per sweep configuration evaluating the same
    ``m`` dst requests against per-config DU states. The result then has
    shape ``(C, m)``. This is how the DSE sweep runner
    (``repro_torch.dse.runner``) evaluates one pair across a whole group of
    design points in a single call instead of C scalar-slice calls.

    Term-for-term mirror of ``check_pair``; tests assert elementwise
    equivalence against the scalar version (and config-stacked calls
    against per-config calls).
    """
    m = len(req_addr)
    k = pair.shared_depth
    le = pair.comparator == "<="

    if frontier is not None:
        f_sched_rows, f_addr, f_last_rows = frontier
    else:
        f_sched, f_addr, f_lastiter = src.frontier(use_next_request)

    def f_sched_at(depth: int):
        if frontier is not None:
            return f_sched_rows[..., depth - 1]
        return f_sched[depth - 1]

    # --- Program Order Safety Check (§5.2) ---
    # terms are Python bools or (m,) arrays; | and & broadcast either way
    if k == 0:
        po = pair.dst_before_src
    else:
        col = req_sched[:, k - 1]
        fk = f_sched_at(k)
        po = (col <= fk) if le else (col < fk)
        if not use_next_request:
            if next_state is not None:
                next_sched_k, no_pend = next_state
            else:
                next_sched_k = src.req_sched()[k - 1]
                no_pend = src.no_pending_ack
            second = (col <= next_sched_k) if le else (col < next_sched_k)
            po = po | (second & no_pend)

    # --- No Address Reset Check (§5.3) ---
    if frontier is not None:
        reset = True
        for j in pair.lastiter_depths:
            reset = reset & f_last_rows[..., j - 1]
    else:
        reset = all(f_lastiter[j - 1] for j in pair.lastiter_depths)
    if pair.l_depth is not None:
        l = pair.l_depth
        fl = f_sched_at(l)
        # sentinel frontier: source fully complete, no reset possible
        reset = reset & ((req_sched[:, l - 1] == fl + pair.delta) | (fl >= SENTINEL))

    ok = po

    # --- §5.6 NoDependence term (intra-loop RAW) ---
    if pair.nodependence and nodep_bits is not None:
        ok = ok | (nodep_bits & reset)

    # --- address frontier comparison (§3.1 monotonicity) ---
    if pair.use_frontier:
        ok = ok | ((req_addr < f_addr) & reset)
    else:
        # the addr disjunct is not synthesized; it still admits when the
        # source frontier is the completion sentinel
        ok = ok | ((req_addr < f_addr) & reset & (f_addr >= SENTINEL))

    if np.ndim(ok) == 0:
        return np.full(m, bool(ok))
    return ok
