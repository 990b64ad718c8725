"""Symbolic dependence certifier over the CR algebra (DESIGN.md §12).

The §3 monotonicity pass classifies *one* address stream at a time; this
module reasons about *pairs* of streams (and whole protected arrays) to
produce dependence verdicts that are stronger than the §5.6 runtime
NoDependence bits because they hold for **all in-range parameter
values**, not one observed trace:

  * ``never_conflict`` — the two streams are provably address-disjoint
    (trip-aware value ranges, residue/stride classes: ``a[2i]`` vs
    ``a[2i+1]``) or the pair's runtime check is provably a tautology,
  * ``min_distance(d)`` — any two conflicting instances are at least
    ``d`` iterations apart at the pair's shared depth,
  * ``unknown`` — no proof found (always sound).

Only the **forced-pass** subclass of ``never_conflict`` may be dropped
from a hazard plan with bit-identical timing (``hazards.build_plan(...,
static_prune=True)``): a pair whose §5.6 NoDependence disjunct is
statically true at *every* evaluation, with no lastIter/address-reset
terms, passes its check unconditionally — removing it cannot change any
issue decision. A merely address-disjoint pair can still *block* on its
program-order disjunct (the source frontier starts at a sentinel), so
dropping it would be correct but not cycle-identical; such pairs keep
their ``never_conflict`` verdict for the linter and the DSE axis
without being dropped.

The module also supplies the per-op conflict-freedom certificates behind
``coarsen.batch_conflict_free_waves``'s symbolic admission fast path,
and the dynamic half of the hint story: ``check_hint_stream`` /
``check_hinted_traces`` raise ``HintViolation`` (op id + first violating
(instance, addr)) when a user ``MonotonicHint`` lies about an observed
address stream (``validate_hints=`` in both engines and
``executor.drive_plan``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np

from repro_torch.core import cr as crlib
from repro_torch.core import loopir as ir
from repro_torch.core import monotonic as mono

NEVER = "never_conflict"
DISTANCE = "min_distance"
UNKNOWN = "unknown"


@dataclasses.dataclass(frozen=True)
class Verdict:
    """Certifier output for one hazard pair (dst, src)."""

    kind: str  # NEVER | DISTANCE | UNKNOWN
    distance: Optional[int] = None  # kind == DISTANCE: |i_k - j_k| >= distance
    forced_pass: bool = False  # droppable: runtime check statically a tautology
    evidence: str = ""

    def __str__(self):
        d = f"({self.distance})" if self.kind == DISTANCE else ""
        f = " [forced-pass]" if self.forced_pass else ""
        return f"{self.kind}{d}{f}: {self.evidence}"


@dataclasses.dataclass(frozen=True)
class OpFacts:
    """Hint-independent stream facts for one memory op.

    ``cr`` is recomputed from the address expression *ignoring* any
    ``MonotonicHint`` — the certifier never trusts user assertions, so
    its verdicts stay sound even when a hint lies (the linter reports
    the lie separately)."""

    op_id: str
    array: str
    is_store: bool
    depth: int
    path_key: tuple[int, ...]  # identity of the loop nest (same-nest test)
    cr: Optional[crlib.CRExpr]
    analyzable: bool  # cr exists and is opaque-free
    trips: dict[int, crlib.CRExpr]
    vrange: crlib.Interval  # trip-aware value range (opaque ranges honoured)
    residue: Optional[tuple[int, int]]  # (modulus, residue) or None
    min_adjacent: Optional[int]  # lower bound on addr(next) - addr(cur)


def stream_facts(program: ir.Program) -> dict[str, OpFacts]:
    """``op id -> OpFacts`` for every memory op, hints ignored."""
    out: dict[str, OpFacts] = {}
    for op, path in program.mem_ops():
        n = len(path)
        cre = mono.to_cr_or_none(op.addr, path)
        trips: dict[int, crlib.CRExpr] = {}
        for i, lp in enumerate(path):
            t = mono.to_cr_or_none(lp.trip, path)
            trips[i + 1] = (
                t if t is not None else crlib.CSym(f"__trip_{lp.var}", 0, crlib.INF)
            )
        analyzable = cre is not None and not crlib.has_opaque(cre)
        vrange = (
            crlib.value_range(cre, trips)
            if cre is not None
            else crlib.Interval(-crlib.INF, crlib.INF)
        )
        out[op.id] = OpFacts(
            op_id=op.id,
            array=op.array,
            is_store=op.is_store,
            depth=n,
            path_key=tuple(id(lp) for lp in path),
            cr=cre,
            analyzable=analyzable,
            trips=trips,
            vrange=vrange,
            residue=crlib.residue_class(cre) if analyzable else None,
            min_adjacent=(
                crlib.min_adjacent_increase(cre, trips, n) if analyzable else None
            ),
        )
    return out


def streams_disjoint(a: OpFacts, b: OpFacts) -> Optional[str]:
    """Evidence string when the two value sets provably never intersect,
    else None. Works through annotated opaque ranges (``vrange``)."""
    ra, rb = a.vrange, b.vrange
    if ra.hi < rb.lo or rb.hi < ra.lo:
        return (
            f"value ranges disjoint: {a.op_id}∈[{ra.lo},{ra.hi}] vs "
            f"{b.op_id}∈[{rb.lo},{rb.hi}]"
        )
    if crlib.residues_disjoint(a.residue, b.residue):
        (ga, rra), (gb, rrb) = a.residue, b.residue
        m = math.gcd(ga, gb)
        if m == 0:
            return f"distinct constant addresses: {rra} vs {rrb}"
        return (
            f"residue classes disjoint: {a.op_id}≡{rra % m} vs "
            f"{b.op_id}≡{rrb % m} (mod {m})"
        )
    return None


def _forced_pass(pair, fa: OpFacts, fb: OpFacts) -> Optional[Verdict]:
    """The droppable certificate: the pair's §5.6 NoDependence disjunct
    is statically true at every evaluation.

    Requirements (see DESIGN.md §12 for the proof):

      * the pair synthesized NoDependence (intra-PE same-nest RAW with a
        monotonic source) and has no reset terms (``l_depth is None``,
        no ``lastiter_depths``) — the accompanying NoAddressReset check
        is then the constant True,
      * both streams CR-analyzable (hints are not trusted) in the same
        nest,
      * the youngest program-order-preceding src request provably has a
        strictly smaller address than every dst request: for forward
        pairs that is the same-instance src (``lo(dst - src) >= 1``);
        for wraparound pairs it is the previous-instance src
        (``lo(dst - src) + min_adjacent_increase(src) >= 1``).

    The §5.6 bit then evaluates to True for every dst instance (the
    very first instance of a wrap pair sees the -2^62 sentinel, also
    True), so the whole HazardSafetyCheck is a tautology and dropping
    the pair is timing-invisible.
    """
    if not (pair.nodependence and pair.l_depth is None and not pair.lastiter_depths):
        return None
    if not (fa.analyzable and fb.analyzable and fa.path_key == fb.path_key):
        return None
    diff = crlib.cr_diff(fa.cr, fb.cr)
    dlo = crlib.value_range(diff, fa.trips).lo
    if not pair.wraparound:
        if dlo >= 1:
            return Verdict(
                NEVER,
                forced_pass=True,
                evidence=(
                    f"NoDependence statically true: dst-src same-instance "
                    f"difference ≥ {dlo}, no reset terms"
                ),
            )
        return None
    madj = fb.min_adjacent
    if madj is not None and crlib.clamp(dlo + madj) >= 1:
        return Verdict(
            NEVER,
            forced_pass=True,
            evidence=(
                f"NoDependence statically true: dst-src ≥ {dlo} same-instance, "
                f"src strictly increasing (min adjacent step {madj}), "
                f"no reset terms"
            ),
        )
    return None


def _min_distance(pair, fa: OpFacts, fb: OpFacts) -> Optional[Verdict]:
    """Distance reasoning for same-nest streams with a constant offset.

    When ``dst - src`` folds to a constant ``c != 0``, any conflicting
    instance pair (i, j) satisfies ``Σ_d s_d (i_d - j_d) = -c``. With
    ``s_k`` the (constant, positive) shared-depth step and the other
    depths bounded by their trips, ``|i_k - j_k| >= ceil((|c| - slack) /
    s_k)``; with zero slack and ``s_k ∤ c`` the streams never meet at
    all."""
    if pair.shared_depth < 1:
        return None
    if not (fa.analyzable and fb.analyzable and fa.path_key == fb.path_key):
        return None
    diff = crlib.cr_diff(fa.cr, fb.cr)
    if not isinstance(diff, crlib.CConst) or diff.v == 0:
        return None
    c = abs(diff.v)
    k = pair.shared_depth
    sk = crlib.step_at_depth(fb.cr, k)
    if not isinstance(sk, crlib.CConst) or sk.v < 1:
        return None
    slack = 0
    for d in range(1, fb.depth + 1):
        if d == k:
            continue
        sd = crlib.step_at_depth(fb.cr, d)
        if not isinstance(sd, crlib.CConst):
            return None
        if sd.v == 0:
            continue
        t_hi = fb.trips[d].range().hi
        if t_hi >= crlib.INF:
            return None
        slack += abs(sd.v) * max(t_hi - 1, 0)
    if slack == 0 and c % sk.v != 0:
        return Verdict(
            NEVER,
            evidence=(
                f"stride {sk.v} at depth {k} never covers constant offset "
                f"{diff.v}"
            ),
        )
    dist = -(-(c - slack) // sk.v)  # ceil
    if dist >= 1:
        return Verdict(
            DISTANCE,
            distance=int(dist),
            evidence=(
                f"constant offset {diff.v}, shared-depth step {sk.v}, "
                f"cross-depth slack {slack}: conflicts ≥ {dist} iterations "
                f"apart at depth {k}"
            ),
        )
    return None


def certify_pair(pair, fa: OpFacts, fb: OpFacts) -> Verdict:
    """Verdict for one hazard pair (``fa`` = dst stream, ``fb`` = src)."""
    forced = _forced_pass(pair, fa, fb)
    if forced is not None:
        return forced
    ev = streams_disjoint(fa, fb)
    if ev is not None:
        return Verdict(NEVER, evidence=ev)
    dist = _min_distance(pair, fa, fb)
    if dist is not None:
        return dist
    return Verdict(UNKNOWN, evidence="no disjointness or distance proof")


def certify_pairs(
    program: ir.Program,
    pairs,
    facts: Optional[dict[str, OpFacts]] = None,
) -> dict[tuple[str, str], Verdict]:
    """``(dst, src) -> Verdict`` for an iterable of hazard pairs."""
    if facts is None:
        facts = stream_facts(program)
    return {
        (p.dst, p.src): certify_pair(p, facts[p.dst], facts[p.src]) for p in pairs
    }


# ---------------------------------------------------------------------------
# Per-op conflict-freedom certificates (coarsener symbolic admission)
# ---------------------------------------------------------------------------


def symbolically_free_ops(
    program: ir.Program, facts: Optional[dict[str, OpFacts]] = None
) -> dict[str, bool]:
    """Ops whose requests the wave coarsener may admit without address
    enumeration (``coarsen.batch_conflict_free_waves(symbolic_free=)``).

    An op is *symbolically free* iff the certifier proves no request of
    it can ever collide with a batched store:

      * a load must be address-disjoint from every same-array store,
      * a store must be address-disjoint from every *other* same-array
        op **and** strictly increasing (hence injective — no same-batch
        self-WAW).

    Under these proofs the coarsener's per-address membership tests are
    statically False and its ``stored``-set insertions unobservable, so
    skipping them is outcome-identical (tested in tests/test_deps.py).
    """
    if facts is None:
        facts = stream_facts(program)
    by_array: dict[str, list[OpFacts]] = {}
    for f in facts.values():
        by_array.setdefault(f.array, []).append(f)
    out: dict[str, bool] = {}
    for f in facts.values():
        peers = by_array[f.array]
        free = True
        if f.is_store:
            free = f.min_adjacent is not None and f.min_adjacent >= 1
        for g in peers:
            if not free:
                break
            if g.op_id == f.op_id:
                continue
            if not (f.is_store or g.is_store):
                continue  # load/load never conflicts
            free = streams_disjoint(f, g) is not None
        out[f.op_id] = free
    return out


# ---------------------------------------------------------------------------
# Dynamic MonotonicHint sanitizer (validate_hints=)
# ---------------------------------------------------------------------------


class HintViolation(ValueError):
    """A user ``MonotonicHint`` contradicted by the observed address
    stream: op id plus the first violating (instance, addr) pair."""

    def __init__(self, op_id: str, instance, addr: int, prev_addr: int):
        self.op_id = op_id
        self.instance = instance
        self.addr = int(addr)
        self.prev_addr = int(prev_addr)
        super().__init__(
            f"MonotonicHint violated by op {op_id!r}: at instance {instance} "
            f"addr {int(addr)} < previous addr {int(prev_addr)} outside any "
            f"asserted non-monotonic depth"
        )


def _max_allowed_reset_depth(hint: ir.MonotonicHint, depth: int) -> int:
    """Deepest 1-indexed depth whose advance may legally reset the
    address under ``hint`` (0 = no resets allowed at all)."""
    if hint.non_monotonic_outer is None:
        return depth - 1  # all outer depths may reset
    return max(hint.non_monotonic_outer, default=0)


def check_hint_stream(
    op_id: str, addr: np.ndarray, sched: np.ndarray, hint: ir.MonotonicHint
) -> None:
    """Validate one op's full address stream against its hint.

    ``addr`` is the (n,) request addresses in program order, ``sched``
    the (n, depth) iteration vectors. A decrease between consecutive
    requests is legal iff the outermost schedule coordinate that
    advanced is one of the hint's asserted non-monotonic depths (or
    shallower); otherwise raises ``HintViolation`` at the first
    offending request. Vectorized — O(n·depth) numpy, no python loop."""
    if not hint.innermost_monotonic:
        return  # the hint asserts nothing checkable (any decrease legal)
    n = len(addr)
    if n < 2:
        return
    depth = sched.shape[1]
    dec = addr[1:] < addr[:-1]
    if not dec.any():
        return
    max_nm = _max_allowed_reset_depth(hint, depth)
    changed = sched[1:] != sched[:-1]
    any_changed = changed.any(axis=1)
    # 1-indexed outermost coordinate that advanced; unchanged rows can
    # never legally decrease (same instance re-request)
    dstar = np.where(any_changed, changed.argmax(axis=1) + 1, depth + 1)
    bad = dec & (dstar > max_nm)
    if bad.any():
        i = int(np.flatnonzero(bad)[0]) + 1
        raise HintViolation(op_id, tuple(int(v) for v in sched[i]), addr[i], addr[i - 1])


def check_hinted_traces(program: ir.Program, traces: dict) -> None:
    """Run ``check_hint_stream`` over every hinted op's schedule trace
    (the engines' ``validate_hints=True`` entry point)."""
    for op, _path in program.mem_ops():
        if op.hint is None:
            continue
        tr = traces[op.id]
        check_hint_stream(op.id, np.asarray(tr.addr), np.asarray(tr.sched), op.hint)


def check_hint_positions(
    op_id: str, addr: np.ndarray, resets: np.ndarray, innermost_monotonic: bool
) -> None:
    """Positional variant for the wave executor: ``resets`` lists the
    request ordinals at which an asserted non-monotonic loop was
    (re-)entered — the only places the stream may legally decrease.
    Equivalent to ``check_hint_stream`` (the executor records an enter
    of the deepest allowed reset loop exactly when the outermost
    advanced coordinate is at most that depth)."""
    if not innermost_monotonic:
        return
    n = len(addr)
    if n < 2:
        return
    dec = np.flatnonzero(addr[1:] < addr[:-1]) + 1
    if len(dec) == 0:
        return
    allowed = np.zeros(n, dtype=bool)
    rs = np.asarray(resets, dtype=np.int64)
    allowed[rs[(rs >= 0) & (rs < n)]] = True
    bad = dec[~allowed[dec]]
    if len(bad) > 0:
        i = int(bad[0])
        raise HintViolation(op_id, i, addr[i], addr[i - 1])
