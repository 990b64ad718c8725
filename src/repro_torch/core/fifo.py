"""Cross-PE scalar FIFO edges: static analysis + bounded-queue model.

``dae.decouple`` discovers scalar locals that flow between PEs
(``DAEResult.fifo_edges``). This module makes those edges executable
(DESIGN.md §11): each edge is a bounded in-order queue carrying **one
token per leaf-loop instance** of its producer PE —

  * the producer pushes the local's value once per producer leaf-loop
    *instance*, at instance exit (a zero-trip instance still pushes: the
    token is the local's init value at the shared depth),
  * the consumer pops once per consumer leaf-loop *instance*, at
    instance entry (before its trip count is evaluated),

so a full queue backpressures the producer and an empty queue stalls
the consumer — the latency-insensitive semantics of R-HLS state edges /
DAE4HLS explicit decoupling (PAPERS.md).

``analyze_program`` is the static gate: it rejects cyclic edge graphs
(guaranteed deadlock under zero initial tokens) with a diagnostic
naming every edge on the cycle, and rejects shapes the token protocol
cannot express (backward edges, producer/consumer rate mismatches,
missing shared-depth init, multiple definers, stores reading locals
*derived* from streamed values). ``check_depth`` rejects undersized
buffers by name. Programs that pass run under both simulator engines
(``FifoQueue`` below), the wave executor, and the Pallas backend —
see ``executor.build_wave_plan`` for the slot encoding.
"""

from __future__ import annotations

import collections
import dataclasses
from typing import Optional

from repro_torch.core import dae as daelib
from repro_torch.core import loopir as ir


class FifoRejected(Exception):
    """A program's FIFO edge set cannot run under the token protocol."""


class FifoDeadlockError(FifoRejected):
    """The edge graph is cyclic: with zero initial tokens every PE on
    the cycle waits on its predecessor forever, for any finite depth."""


class FifoUnsupportedError(FifoRejected):
    """The edge set is acyclic but outside the token protocol."""


@dataclasses.dataclass(frozen=True)
class FifoEdge:
    """One cross-PE scalar stream (index into ``DAEResult.fifo_edges``)."""

    idx: int
    prod_pe: int
    cons_pe: int
    local: str
    shared_depth: int

    def describe(self) -> str:
        return (
            f"(pe{self.prod_pe} -> pe{self.cons_pe}, "
            f"{self.local!r}, shared={self.shared_depth})"
        )


def format_edges(edges) -> str:
    return ", ".join(e.describe() for e in edges)


@dataclasses.dataclass(frozen=True)
class FifoSpec:
    """The analyzed, executable edge set of one program."""

    edges: tuple[FifoEdge, ...]
    # pe id -> ((edge idx, local name), ...) in edge-index order
    in_edges: dict[int, tuple]
    out_edges: dict[int, tuple]

    def __bool__(self) -> bool:
        return bool(self.edges)


def _pe_locals_in(expr: ir.Expr) -> set[str]:
    return daelib.expr_deps(expr)[0]


def _tainted_locals(pe: daelib.PE) -> set[str]:
    """Locals of ``pe`` transitively derived from its fifo-in locals
    (fixpoint over the PE's SetLocal statements)."""
    tainted = set(pe.fifo_in)
    changed = True
    while changed:
        changed = False
        for s, _d in pe.stmts:
            if isinstance(s, ir.SetLocal) and s.name not in tainted:
                if _pe_locals_in(s.value) & tainted:
                    tainted.add(s.name)
                    changed = True
    return tainted


def _find_cycle(edges: tuple[FifoEdge, ...]) -> Optional[list[FifoEdge]]:
    """First producer->consumer cycle in the edge graph, as the list of
    edges along it (None if the graph is a DAG)."""
    adj: dict[int, list[FifoEdge]] = {}
    for e in edges:
        adj.setdefault(e.prod_pe, []).append(e)
    WHITE, GREY, BLACK = 0, 1, 2
    color: dict[int, int] = {}
    stack: list[FifoEdge] = []

    def dfs(u: int) -> Optional[list[FifoEdge]]:
        color[u] = GREY
        for e in adj.get(u, ()):
            v = e.cons_pe
            if color.get(v, WHITE) == GREY:
                # unwind the stack to the first edge leaving v
                cyc = [e]
                for back in reversed(stack):
                    cyc.append(back)
                    if back.prod_pe == v:
                        break
                cyc.reverse()
                return cyc
            if color.get(v, WHITE) == WHITE:
                stack.append(e)
                found = dfs(v)
                stack.pop()
                if found is not None:
                    return found
        color[u] = BLACK
        return None

    for e in edges:
        if color.get(e.prod_pe, WHITE) == WHITE:
            found = dfs(e.prod_pe)
            if found is not None:
                return found
    return None


def analyze_program(program: ir.Program, dres: daelib.DAEResult) -> FifoSpec:
    """Static gate for the token protocol. Raises ``FifoDeadlockError``
    / ``FifoUnsupportedError`` (both ``FifoRejected``) with named-edge
    diagnostics; returns the executable ``FifoSpec`` otherwise."""
    edges = tuple(
        FifoEdge(idx=i, prod_pe=p, cons_pe=c, local=name, shared_depth=d)
        for i, (p, c, name, d) in enumerate(dres.fifo_edges)
    )

    # 1. cycles deadlock for ANY finite depth (zero initial tokens):
    #    checked first so cyclic programs get the deadlock diagnostic,
    #    not an incidental shape complaint about one of their edges
    cyc = _find_cycle(edges)
    if cyc is not None:
        raise FifoDeadlockError(
            "FIFO edge cycle would deadlock (every PE on the cycle "
            "waits on its predecessor; no initial tokens): "
            + format_edges(cyc)
        )

    pes = dres.pes
    for e in edges:
        prod, cons = pes[e.prod_pe], pes[e.cons_pe]
        # 2. backward edge: the consumer's leaf precedes the producer's
        #    in program order -> a loop-carried cross-PE scalar, outside
        #    the one-token-per-instance protocol
        if e.cons_pe <= e.prod_pe:
            raise FifoUnsupportedError(
                f"backward (loop-carried) FIFO edge {e.describe()}: the "
                "consumer leaf runs before the producer in program order"
            )
        # 3. rate match: one push per producer instance must meet one
        #    pop per consumer instance, so both leaves must sit directly
        #    under the shared scope
        if prod.depth != e.shared_depth + 1 or cons.depth != e.shared_depth + 1:
            raise FifoUnsupportedError(
                f"FIFO edge {e.describe()}: producer depth {prod.depth} / "
                f"consumer depth {cons.depth} != shared depth + 1 — "
                "push/pop rates would diverge"
            )
        # 4. the producer must init the local at (or above) the shared
        #    depth: a zero-trip producer instance still owes a token
        has_init = any(
            isinstance(s, ir.SetLocal) and s.name == e.local
            and d <= e.shared_depth
            for s, d in prod.stmts
        )
        if not has_init:
            raise FifoUnsupportedError(
                f"FIFO edge {e.describe()}: streamed local {e.local!r} "
                f"has no SetLocal init at depth <= {e.shared_depth} — a "
                "zero-trip producer instance would have no token value"
            )
        # 5. exactly one defining PE per streamed local
        definers = sorted(
            pe.id
            for pe in pes
            if any(
                isinstance(s, ir.SetLocal) and s.name == e.local
                for s, _d in pe.stmts
            )
        )
        if definers != [e.prod_pe]:
            raise FifoUnsupportedError(
                f"FIFO edge {e.describe()}: local {e.local!r} is defined "
                f"by PEs {definers} — the token protocol needs exactly "
                "one producer"
            )

    # 6. consumer stores must read streamed locals *directly*: a store
    #    reading a local derived from one would need the derivation to
    #    replay inside the op tables, which only see env slots + deps
    by_cons: dict[int, list[FifoEdge]] = {}
    for e in edges:
        by_cons.setdefault(e.cons_pe, []).append(e)
    for pe_id, pe_edges in by_cons.items():
        pe = pes[pe_id]
        tainted = _tainted_locals(pe)
        derived = tainted - pe.fifo_in
        if not derived:
            continue
        for s, _d in pe.stmts:
            if not isinstance(s, ir.Store):
                continue
            exprs = [s.value] + ([s.guard] if s.guard is not None else [])
            for ex in exprs:
                bad = sorted(_pe_locals_in(ex) & derived)
                if bad:
                    raise FifoUnsupportedError(
                        f"store {s.id!r} reads local(s) {bad} derived "
                        f"from streamed value(s) (edges "
                        f"{format_edges(pe_edges)}) — reference the "
                        "streamed local directly"
                    )

    in_edges: dict[int, list] = {}
    out_edges: dict[int, list] = {}
    for e in edges:
        out_edges.setdefault(e.prod_pe, []).append((e.idx, e.local))
        in_edges.setdefault(e.cons_pe, []).append((e.idx, e.local))
    return FifoSpec(
        edges=edges,
        in_edges={k: tuple(v) for k, v in in_edges.items()},
        out_edges={k: tuple(v) for k, v in out_edges.items()},
    )


def check_depth(spec: FifoSpec, depth: int) -> None:
    """Buffer sizing gate: every analyzed edge needs >= 1 slot."""
    if spec.edges and depth < 1:
        raise FifoUnsupportedError(
            f"undersized FIFO depth {depth} (< 1 slot) for edges: "
            + format_edges(spec.edges)
        )


class FifoQueue:
    """Bounded in-order queue of one edge, with occupancy accounting.

    Tokens become visible ``latency`` cycles after the push (the
    producer's exit-block write to the consumer's pre-header read).
    Both engines service these in their settle loops: a push against a
    full queue and a pop against an empty one simply leave the CU's
    ``waiting_on`` set — backpressure is the *absence* of service.
    """

    __slots__ = (
        "edge", "depth", "latency", "q",
        "pushed", "popped", "max_occupancy", "push_stalls", "pop_stalls",
    )

    def __init__(self, edge: FifoEdge, depth: int, latency: int):
        self.edge = edge
        self.depth = int(depth)
        self.latency = int(latency)
        self.q: collections.deque = collections.deque()  # (ready_time, value)
        self.pushed = 0
        self.popped = 0
        self.max_occupancy = 0
        self.push_stalls = 0
        self.pop_stalls = 0

    @property
    def occupancy(self) -> int:
        return len(self.q)

    def can_push(self) -> bool:
        return len(self.q) < self.depth

    def push(self, value: float, now: int) -> None:
        assert self.can_push(), f"push into full FIFO {self.edge.describe()}"
        self.q.append((now + self.latency, float(value)))
        self.pushed += 1
        if len(self.q) > self.max_occupancy:
            self.max_occupancy = len(self.q)

    def head_ready(self, now: int) -> bool:
        return bool(self.q) and self.q[0][0] <= now

    def next_ready_time(self) -> Optional[int]:
        return self.q[0][0] if self.q else None

    def pop(self, now: int) -> float:
        assert self.head_ready(now), f"pop from {self.edge.describe()}"
        _t, v = self.q.popleft()
        self.popped += 1
        return v

    def stats(self) -> dict:
        return {
            "edge": self.edge.describe(),
            "pushed": self.pushed,
            "popped": self.popped,
            "max_occupancy": self.max_occupancy,
            "push_stalls": self.push_stalls,
            "pop_stalls": self.pop_stalls,
        }
