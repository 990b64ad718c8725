"""Hazard pair enumeration, check synthesis, and pruning (paper §5).

For every protected base pointer (array with at least one store and a
second access that may conflict), the compiler enumerates *hazard
pairs* (dst checks src):

  * RAW: load  gated by store frontier,
  * WAR: store gated by load frontier,
  * WAW: store gated by store frontier,
  * loads never check loads (§5.4.1),
  * pairs exist in the forward direction (src topologically before dst)
    and — when the two ops share a loop — the wrap-around direction
    (dst before src, conflicting across the loop backedge).

Each pair carries the *statically configured* check (§4 item 3, §5.2-5.4):

    HazardSafetyCheck =
        ProgramOrderSafetyCheck
        || (req.addr_dst < frontier.addr_src && NoAddressResetCheck)
        || (NoDependence && NoAddressResetCheck)          # §5.6, intra-PE RAW

    ProgramOrderSafetyCheck =                              # only if k > 0
        req.sched_dst[k] (<=|<) ack.sched_src[k]
        || (req.sched_dst[k] (<=|<) req.sched_src[k] && noPendingAck_src)

    NoAddressResetCheck =                                  # §5.3
        AND-reduce(lastIter_src[j] for j in nonmono, j > k)
        && (req.sched_dst[l] == ack.sched_src[l] + delta   # deepest nonmono l <= k
            if such l exists else true)

The address-frontier disjunct is only synthesized when the *source*'s
innermost loop is monotonic (§3.1 — the paper's core requirement); for
unanalyzable sources the pair degrades to program order + completion
sentinels, which is always sound.

Pruning (§5.4.1):
  * WAR pairs where the written value depends on the read value [39],
  * transitive pruning: pair (a ⇐ c) is covered by kept pairs (a ⇐ b)
    and (b ⇐ c) for some b strictly between c and a in topological
    order, provided both links constrain at least the shared depth of
    (a, c). With store-to-load forwarding enabled, a RAW link (b=load ⇐
    c=store) no longer implies the store's ACK frontier advanced (§5.5),
    so such links are excluded from chains that cover WAW pairs.

Pairs are processed in increasing topological distance so chain links
are always final (never themselves pruned later).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import dae as daelib
from repro_torch.core import loopir as ir
from repro_torch.core import monotonic as mono


@dataclasses.dataclass(frozen=True)
class HazardPair:
    dst: str  # the op whose next request is gated
    src: str  # the dependency source whose frontier is consulted
    kind: str  # 'RAW' | 'WAR' | 'WAW'
    array: str
    shared_depth: int  # k; 0 = no shared loops
    dst_before_src: bool  # topological order; True -> comparator <=, delta=1
    wraparound: bool  # pair exists only via a loop backedge
    same_pe: bool
    # --- synthesized check configuration ---
    use_frontier: bool  # src innermost-monotonic -> addr compare allowed
    l_depth: Optional[int]  # deepest non-monotonic src depth <= k
    lastiter_depths: tuple[int, ...]  # non-monotonic src depths > k
    nodependence: bool  # §5.6 term synthesized (intra-PE RAW)

    @property
    def comparator(self) -> str:
        return "<=" if self.dst_before_src else "<"

    @property
    def delta(self) -> int:
        """δ in the No-Address-Reset equality (§5.3).

        δ=1 ("frontier may be one l-epoch behind") is only sound when the
        l-loop IS the innermost shared loop (l == k): then all src
        requests of the *new* epoch come after the dst request in program
        order, so the (ack, req) range stays inside the old epoch. When
        l < k, src requests from the new epoch can precede the dst
        request (the k-loop advances many times per l-epoch), so the
        frontier must already be in the *same* epoch: δ=0.
        """
        return 1 if (self.dst_before_src and self.l_depth == self.shared_depth) else 0


@dataclasses.dataclass
class HazardPlan:
    pairs: list[HazardPair]
    pruned: list[tuple[HazardPair, str]]  # (pair, reason)
    protected_arrays: list[str]

    def pairs_for_dst(self, op_id: str) -> list[HazardPair]:
        return self.by_dst().get(op_id, [])

    def by_dst(self) -> dict[str, list[HazardPair]]:
        """Kept pairs grouped by gated op, preserving plan order (the
        order both engines consult frontiers and resolve forward ties)."""
        out: dict[str, list[HazardPair]] = {}
        for p in self.pairs:
            out.setdefault(p.dst, []).append(p)
        return out

    def summary(self) -> str:
        total = len(self.pairs) + len(self.pruned)
        lines = [
            f"hazard pairs: {total} enumerated, {len(self.pruned)} pruned, "
            f"{len(self.pairs)} kept"
        ]
        for p in self.pairs:
            lines.append(
                f"  {p.dst} checks {p.src} [{p.kind}{'/wrap' if p.wraparound else ''}] "
                f"k={p.shared_depth} cmp={p.comparator} frontier={p.use_frontier} "
                f"l={p.l_depth} lastiter={list(p.lastiter_depths)} "
                f"nodep={p.nodependence}"
            )
        return "\n".join(lines)


def _value_depends_on_load(store: ir.Store, load_id: str) -> bool:
    _, loads = daelib.expr_deps(store.value)
    if store.guard is not None:
        loads |= daelib.expr_deps(store.guard)[1]
    return load_id in loads


def build_plan(
    program: ir.Program,
    dae: daelib.DAEResult,
    infos: dict[str, mono.AddressInfo],
    forwarding: bool = False,
    static_prune: bool = False,
) -> HazardPlan:
    """Enumerate, synthesize and prune the hazard plan (module doc).

    ``static_prune=True`` additionally drops pairs the symbolic
    dependence certifier (``analysis/deps.py``) proves *forced-pass*:
    their runtime HazardSafetyCheck is statically a tautology (the §5.6
    NoDependence disjunct is true at every evaluation and no reset
    terms exist), so removal is provably timing-invisible — cycles and
    arrays stay bit-identical (tested across every registered kernel in
    tests/test_deps.py). Dropped pairs land in ``plan.pruned`` with a
    ``"static: ..."`` reason, so ``Compiled.all_pairs`` (and hence STA)
    is unchanged. Forced-pass pairs are never used as transitive chain
    links (NoDependence links are excluded), so the kept set equals the
    baseline kept set minus exactly the dropped pairs."""
    ops = program.mem_ops()
    topo = program.op_index()
    by_array: dict[str, list] = {}
    for op, path in ops:
        by_array.setdefault(op.array, []).append((op, path))

    protected = [
        arr
        for arr, lst in by_array.items()
        if any(o.is_store for o, _ in lst) and len(lst) >= 2
    ]

    enumerated: list[HazardPair] = []
    for arr in protected:
        lst = by_array[arr]
        for op_a, path_a in lst:  # dst
            for op_b, path_b in lst:  # src
                if op_a.id == op_b.id:
                    continue
                if not (op_a.is_store or op_b.is_store):
                    continue  # loads never check loads
                k = dae.shared_depth(op_a.id, op_b.id, program)
                a_before_b = topo[op_a.id] < topo[op_b.id]
                wrap = a_before_b  # src comes later: only backedge conflicts
                if wrap and k == 0:
                    continue  # no shared loop -> src can never precede dst
                kind = (
                    "RAW"
                    if not op_a.is_store
                    else ("WAW" if op_b.is_store else "WAR")
                )
                info_b = infos[op_b.id]
                nonmono = info_b.non_monotonic
                l_candidates = [d for d in nonmono if d <= k]
                l_depth = max(l_candidates) if l_candidates else None
                lastiter_depths = tuple(sorted(d for d in nonmono if d > k))
                same_pe = dae.op_to_pe[op_a.id] == dae.op_to_pe[op_b.id]
                # §5.6: synthesized only for intra-loop RAW where the
                # source (store) stream is innermost-monotonic — the
                # NoDependence argument relies on monotonicity.
                nodep = (
                    kind == "RAW"
                    and same_pe
                    and len(path_a) == len(path_b) == k
                    and info_b.innermost_monotonic
                )
                enumerated.append(
                    HazardPair(
                        dst=op_a.id,
                        src=op_b.id,
                        kind=kind,
                        array=arr,
                        shared_depth=k,
                        dst_before_src=a_before_b,
                        wraparound=wrap,
                        same_pe=same_pe,
                        use_frontier=info_b.innermost_monotonic,
                        l_depth=l_depth,
                        lastiter_depths=lastiter_depths,
                        nodependence=nodep,
                    )
                )

    # ---- pruning ----------------------------------------------------------
    pruned: list[tuple[HazardPair, str]] = []
    kept: list[HazardPair] = []

    # rule 0 (opt-in): certifier-proven forced-pass pairs (DESIGN.md §12)
    if static_prune and enumerated:
        from repro_torch.analysis import deps as depslib

        verdicts = depslib.certify_pairs(program, enumerated)
        remaining: list[HazardPair] = []
        for p in enumerated:
            v = verdicts[(p.dst, p.src)]
            if v.forced_pass:
                pruned.append((p, f"static: {v.evidence}"))
            else:
                remaining.append(p)
        enumerated = remaining

    # rule 1: WAR where the written value depends on the read value [39]
    stage1: list[HazardPair] = []
    for p in enumerated:
        if p.kind == "WAR" and not p.wraparound:
            store, _ = program.find_op(p.dst)
            if _value_depends_on_load(store, p.src):
                pruned.append((p, "WAR write-depends-on-read"))
                continue
        stage1.append(p)

    # rule 2: transitive pruning, shortest topological distance first so
    # chain links are final when consulted
    def dist(p: HazardPair) -> int:
        return abs(topo[p.dst] - topo[p.src])

    stage1.sort(key=lambda p: (dist(p), topo[p.dst], topo[p.src]))
    kept_set: set[tuple[str, str]] = set()
    kept_by_edge: dict[tuple[str, str], HazardPair] = {}
    for p in stage1:
        middle = _find_chain(p, kept_by_edge, topo, forwarding)
        if middle is not None:
            pruned.append((p, f"transitive via {middle}"))
            continue
        kept.append(p)
        kept_set.add((p.dst, p.src))
        kept_by_edge[(p.dst, p.src)] = p

    kept.sort(key=lambda p: (topo[p.dst], topo[p.src]))
    return HazardPlan(pairs=kept, pruned=pruned, protected_arrays=protected)


def _find_chain(
    p: HazardPair,
    kept: dict[tuple[str, str], HazardPair],
    topo: dict[str, int],
    forwarding: bool,
) -> Optional[str]:
    """A middle op b such that kept pairs (dst ⇐ b) and (b ⇐ src) cover p.

    Covering conditions:
      * **backedge conservation**: the number of loop backedges the chain
        traverses must equal the pair's — wrap(link1) + wrap(link2) ==
        wrap(p). (A wrap pair relates dst@t+1 to src@t; two wrap links
        would relate dst@t+1 to src@t-1 — a different, weaker property.
        This also pins b's topological position: for forward pairs b lies
        strictly between src and dst, for wrap pairs strictly outside.)
      * both links constrain at least p.shared_depth,
      * neither link synthesizes the §5.6 NoDependence shortcut — a
        NoDependence admission does not certify any source progress, so
        such links cannot anchor transitivity,
      * under forwarding, a (load ⇐ store) link does not imply the store
        ACK advanced, so it cannot support covering a WAW pair (§5.5).
    """
    for (d1, b), link1 in kept.items():
        if d1 != p.dst or b == p.src or link1.array != p.array:
            continue
        link2 = kept.get((b, p.src))
        if link2 is None or link2.array != p.array:
            continue
        if link1.wraparound + link2.wraparound != p.wraparound:
            continue
        if link1.shared_depth < p.shared_depth or link2.shared_depth < p.shared_depth:
            continue
        if link1.nodependence or link2.nodependence:
            continue
        if forwarding and p.kind == "WAW" and link2.kind == "RAW":
            continue  # §5.5: forwarded load ACKs don't imply store ACKs
        return b
    return None
