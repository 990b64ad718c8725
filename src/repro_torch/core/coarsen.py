"""Wave coarsening: two faces of "grow the unit of progress".

Both execution paths in this repo advance in *units* whose fixed
per-unit overhead can dominate wall-clock when the units are small:

  * the TPU wave executor (``core/executor.py`` / ``kernels/wave_exec``)
    pays one gather→scatter step per wave — a kernel with thousands of
    short dependence chains produces thousands of near-empty waves,
  * the event engine (``core/engine_event.py``) pays one vectorized
    Hazard Safety Check evaluation per wave *attempt* — a port that is
    check-blocked gets re-evaluated on every event that dirties it,
    even when nothing its checks read has moved (the pagerank
    re-evaluation storm: ~100k attempts for ~43k requests).

This module holds the shared coarsening abstraction for both
(ROADMAP item 1):

  * ``batch_conflict_free_waves`` — **spatial** coarsening: merge runs
    of consecutive waves into one *step* whenever the merged batch
    stays executable as a single gather-before-scatter unit (see the
    function doc for the exact admission rule),
  * ``BlockMemo`` — **temporal** coarsening: collapse repeated blocked
    wave attempts whose entire observable input state is unchanged
    into a single key comparison, so a port is re-checked only when a
    frontier it actually reads has moved.

Both are pure bookkeeping over integer state — no numerics, no timing
model — which is what lets one module serve an executor backend and a
cycle-conformant simulator engine without coupling them.
"""

from __future__ import annotations

import numpy as np


def batch_conflict_free_waves(
    req_wave: np.ndarray,
    req_flat: np.ndarray,
    req_store: np.ndarray,
    feed_max_wave: np.ndarray,
    symbolic_free: np.ndarray = None,
) -> tuple[np.ndarray, int]:
    """Greedily merge consecutive waves into batched steps.

    Consecutive waves always have at least one cross edge (that is what
    makes them consecutive), so "merge iff no edges" would never merge
    anything. The usable slack is that a gather-before-scatter step
    tolerates WAR edges *inside* the batch: every load gathers the
    pre-step image, so a store overwriting an address a same-batch
    (earlier-wave) load reads cannot be observed by it. A wave ``w``
    joins the batch that started at wave ``b`` iff:

      * every store in ``w`` has all feeding loads in waves strictly
        before ``b`` (its value/guard are computed *before* the step's
        memory traffic moves — same-batch load values do not exist yet),
      * no store in ``w`` targets an address already **stored** in the
        batch (WAW — the step's scatter admits no duplicate write
        lanes),
      * no load in ``w`` reads an address already stored in the batch
        (RAW — it would need the post-store value, but gathers see the
        pre-step image).

    ``feed_max_wave[i]`` is the max wave over request *i*'s feeding
    loads (−1 for loads and dep-free stores) — ``executor`` computes it
    from the plan's dep maps. Returns ``(step_of_wave, n_steps)`` with
    ``step_of_wave`` non-decreasing, so waves stay contiguous inside
    their step and the wave order is preserved batch-internally.

    ``symbolic_free`` is the certifier's admission fast path
    (``analysis.deps.symbolically_free_ops``, DESIGN.md §12): a (n,)
    bool marking requests of ops *proven* address-disjoint from every
    batched store (stores additionally proven self-injective). Such
    requests skip the ``stored``-set membership test and — for stores —
    the insertion: both are statically known no-ops, so the produced
    batching is bit-identical (tested in tests/test_deps.py) while whole
    dep-edges are admitted without enumerating a single address. The
    dataflow feed check is *not* skipped — it is about value
    availability, not address conflicts.
    """
    n = len(req_wave)
    n_waves = int(req_wave.max()) + 1 if n else 0
    step_of_wave = np.zeros(n_waves, dtype=np.int64)
    if n_waves == 0:
        return step_of_wave, 0
    if symbolic_free is None:
        symbolic_free = np.zeros(n, dtype=bool)
    order = np.argsort(req_wave, kind="stable")
    bounds = np.searchsorted(req_wave[order], np.arange(n_waves + 1))
    step = 0
    batch_start = 0
    stored: set[int] = set()  # flat addresses stored by the open batch
    for w in range(n_waves):
        rows = order[bounds[w]:bounds[w + 1]]
        if w != batch_start:
            ok = True
            for i in rows:
                if req_store[i]:
                    if feed_max_wave[i] >= batch_start or (
                        not symbolic_free[i] and int(req_flat[i]) in stored
                    ):
                        ok = False
                        break
                elif not symbolic_free[i] and int(req_flat[i]) in stored:
                    ok = False
                    break
            if not ok:
                step += 1
                batch_start = w
                stored.clear()
        for i in rows:
            if req_store[i] and not symbolic_free[i]:
                stored.add(int(req_flat[i]))
        step_of_wave[w] = step
    return step_of_wave, step + 1


class BlockMemo:
    """Skip re-evaluating a blocked wave attempt whose inputs are frozen.

    The event engine calls ``key(...)`` with everything a port's Hazard
    Safety Checks can observe when every consulted src port is
    *current* (no issue cycles stamped beyond ``now`` — the fast path
    of ``engine_event._issue_wave``): the port's own ``next`` index,
    its CU value-queue length, and each src's ``(head, next)`` window.
    When a check-blocked attempt records its key and a later attempt
    probes with an identical key, the outcome is necessarily identical
    — frontiers are functions of ``(head, next)`` alone in the current
    case — so the attempt is skipped without touching the checks.

    The key is fully self-invalidating: any state change that could
    change the outcome (an src ACK pop, an src issue, this port's own
    issue, a CU value arrival) moves one of the key's components, so
    there is no explicit clear. Attempts whose blocking depends on
    *time* (horizon caps, §5.5 frontiers reconstructed from
    future-stamped issue cycles, the LSQ sequential window) must not be
    recorded — the engine only records on the check-blocked failure
    path with all srcs current and outside sequential mode.
    """

    __slots__ = ("_blocked", "hits", "misses")

    def __init__(self):
        self._blocked: dict[str, tuple] = {}
        self.hits = 0
        self.misses = 0

    @staticmethod
    def key(next_idx: int, n_vals: int, src_windows: tuple) -> tuple:
        """The observable-state fingerprint of one wave attempt."""
        return (next_idx, n_vals, src_windows)

    def probe(self, op_id: str, key: tuple) -> bool:
        """True iff this attempt is known-blocked under ``key``."""
        if self._blocked.get(op_id) == key:
            self.hits += 1
            return True
        self.misses += 1
        return False

    def record(self, op_id: str, key: tuple) -> None:
        """Remember a check-blocked attempt (see class doc for when)."""
        self._blocked[op_id] = key
