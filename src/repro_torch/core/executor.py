"""Fused executor: dynamic loop fusion as *wave partitioning*.

The port's copy of ``core/executor.py`` in the JAX package: the same
front-end, plan and driver, with the hardware backend moved from a
Pallas kernel on a TPU to a CUDA kernel on a Hopper card
(``backend="torch"``, ``kernels/wave_exec``).

This is the hardware adaptation described in DESIGN.md §2. On an FPGA
the DU stalls each request until its Hazard Safety Check passes; on a
bulk-synchronous accelerator we instead *partition* the fused request
stream into **waves**: wave(r) = 1 + max(wave of every request that must
commit before r). All requests in one wave are conflict-free and execute
data-parallel; the wave count is the critical path of the fused program
— the fine-grained cross-loop parallelism of the paper's Fig. 1(c).

Dependencies are exact (addresses are known after the AGU pass — the
same property the paper's monotonicity exploits to avoid history
searches):

  * memory edges: for each address, a load depends on the nearest
    preceding store; a store depends on the nearest preceding store and
    every load since it (computed in one program-order sweep — the
    vectorized analogue is the monotonic frontier merge in
    ``kernels/du_hazard``),
  * dataflow edges: a store depends on exactly the load requests that
    feed its compute body — per (PE, dep-edge), resolved through the
    op-table dep maps, **not** a per-PE barrier. Independent per-address
    chains (CSR row accumulations, chained SpMVs) therefore overlap
    instead of serializing behind every other chain of their PE.

Waves are then coarsened into **steps**
(``core/coarsen.batch_conflict_free_waves``): consecutive waves merge
into one gather-before-scatter step whenever the merged batch has no
internal RAW/WAW or dataflow edge (internal WAR is safe — gathers see
the pre-step image), so a backend's step count tracks the *memory*
critical path rather than the wave count.

The module is split along the backend seam (DESIGN.md §2):

  * ``build_wave_plan`` runs the AGU/CU front-end once and emits a
    **WavePlan** — the complete backend-consumable partition: per
    request the op id, array-local and flat address, kind, §6 valid
    bit, wave id and per-op ordinal, plus the ``core/optable`` compute
    bodies with their captured environment streams and dep alignment
    maps. A backend needs nothing else: no oracle callbacks, no IR
    walking.
  * ``execute`` drives a plan through a backend: ``backend="torch"``
    (default) hands the plan to ``repro_torch.kernels.wave_exec``,
    which executes every step as a gather→scatter over a flat image on
    the card (one CUDA kernel launch per segment of equal-width steps);
    ``backend="numpy"``, asked for by name, is the in-process host
    replay below. Both must produce arrays bit-identical to the
    sequential oracle.

``frontier_merge`` is the vectorized monotonic-streams primitive of the
DU hazard kernels.

``trace_mode`` (default ``"auto"``) selects where the program-order
request stream's op ids / addresses / kinds come from: the AGU trace
compiler (``schedule.trace_program``) plus one lexsort of polyhedral
2d+1 keys, with the oracle walk supplying the reference value/valid
stream; ``"interp"`` keeps the original pure-hook path. The oracle walk
runs in full either way — backends *compute* store values through the
op tables, and the walk's values are the per-request reference that
pins any divergence to the first offending request.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from repro_torch.core import config as cfglib
from repro_torch.core import loopir as ir
from repro_torch.core import optable as optablelib


@dataclasses.dataclass
class WaveStats:
    n_requests: int
    n_waves: int
    sequential_depth: int  # = n_requests (one request per step, fused b/w)
    n_steps: int = 0  # batched gather→scatter steps (<= n_waves)
    # symbolic admission fast path (analysis/deps.py, DESIGN.md §12):
    # requests of certifier-proven conflict-free ops skip the
    # coarsener's address enumeration entirely
    n_sym_requests: int = 0
    sym_ops: tuple = ()

    @property
    def parallelism(self) -> float:
        return self.n_requests / max(self.n_waves, 1)

    @property
    def step_parallelism(self) -> float:
        return self.n_requests / max(self.n_steps, 1)


@dataclasses.dataclass
class WavePlan:
    """Backend contract for fused wave execution (DESIGN.md §2).

    Request streams are in program order. Guarantees a backend may rely
    on (checked by ``validate_plan`` and the wave-backend tests):

      1. waves topologically order the exact dependences — same-address
         RAW/WAR/WAW (invalid §6 stores occupy wave slots too) and the
         per-(PE, dep-edge) dataflow edge (a store is in a strictly
         later wave than every load request feeding its compute body,
         resolved through ``dep_maps`` — not a per-PE barrier),
      2. intra-wave conflict-freedom — within one wave no two requests
         touch the same flat address unless both are loads, so a
         backend may gather all of a wave's loads and scatter all of
         its valid stores in any intra-wave order,
      3. ``dep_maps[s][l][k]`` is the ordinal of the ``l`` request whose
         value the ``k``-th ``s`` request consumes (-1 iff that request
         is guard-invalid and the load never fired before it — the row
         is masked by the valid bit),
      4. ``req_valid``/``req_value`` are *reference* streams from the
         oracle walk: a backend recomputes valid bits from the op-table
         guards and load/store values from its own gathers; the
         reference exists to pin the first divergence, not to execute,
      5. ``req_step`` coarsens waves into batched gather-before-scatter
         steps (``core/coarsen.py``): steps are contiguous wave runs
         (``req_step`` is a non-decreasing function of ``req_wave``);
         within one step no two requests touch the same flat address
         except loads with loads and the WAR pair (the load's wave
         strictly precedes the store's), and every store's feeding
         loads sit in strictly earlier *steps* — so one step may gather
         all its loads against the pre-step image and then scatter all
         its valid stores. ``batch_waves=False`` degenerates steps to
         waves (``req_step == req_wave``).
    """

    program: ir.Program
    params: dict[str, int]
    # per-op metadata (op order = program.mem_ops order)
    op_ids: list[str]
    op_array: dict[str, str]
    op_is_store: dict[str, bool]
    op_nreq: dict[str, int]
    # per-request streams (program order)
    req_op: np.ndarray  # (n,) int32 index into op_ids
    req_addr: np.ndarray  # (n,) int64 array-local address
    req_flat: np.ndarray  # (n,) int64 flat-memory address
    req_store: np.ndarray  # (n,) bool
    req_valid: np.ndarray  # (n,) bool   (reference, see contract 4)
    req_value: np.ndarray  # (n,) float64 (reference; NaN for invalid)
    req_wave: np.ndarray  # (n,) int64
    req_step: np.ndarray  # (n,) int64 batched step (contract 5)
    req_ordinal: np.ndarray  # (n,) int64 k-th request of its own op
    # compute bodies (core/optable) + captured operand streams
    tables: dict[str, optablelib.StoreTable]
    env: dict[str, list[np.ndarray]]  # store op -> per-slot streams
    dep_maps: dict[str, dict[str, np.ndarray]]  # store op -> load op -> map
    # flat protected-memory layout
    array_order: list[str]
    base: dict[str, int]
    mem_size: int
    stats: WaveStats = None
    # cross-PE FIFO edge metadata (DESIGN.md §11): one dict per edge
    # with idx/prod_pe/cons_pe/local/depth/base/n_tokens/push_op/pop_op;
    # the edge's circular slots live at [base, base+depth) inside
    # mem_size (zero-init, not in array_order)
    fifo_edges: list = dataclasses.field(default_factory=list)
    # MonotonicHint sanitizer data (DESIGN.md §12): one dict per hinted
    # op — ``op``, ``resets`` (request ordinals where an asserted
    # non-monotonic loop was re-entered, the only legal decrease
    # points), ``innermost`` (the hint's innermost_monotonic bit).
    # None when hints exist but capture was impossible (speculative
    # programs run the unhooked walk); ``drive_plan(validate_hints=
    # True)`` then refuses rather than silently skipping.
    hint_checks: Optional[list] = dataclasses.field(default_factory=list)

    @property
    def n_requests(self) -> int:
        return len(self.req_op)


@dataclasses.dataclass
class ExecResult:
    arrays: dict[str, np.ndarray]
    stats: WaveStats
    waves: np.ndarray  # per-request wave index, in program order
    plan: Optional[WavePlan] = None
    # backend="torch" only: the wave backend's run profile (steps,
    # kernel launches and their shapes, resolve and device seconds)
    run: Optional[object] = None


def frontier_merge(src_addr: np.ndarray, dst_addr: np.ndarray) -> np.ndarray:
    """For each dst request (monotonic source stream!): the number of src
    requests that must commit before it = |{i : src_addr[i] <= dst}|
    under monotonic non-decreasing src_addr. This is the §3.1 insight
    vectorized: one searchsorted instead of an address-history search.

    Returns the required src commit count per dst element.
    """
    return np.searchsorted(src_addr, dst_addr, side="right")


def _trace_stream(
    program: ir.Program,
    dae,
    arrays: dict[str, np.ndarray],
    params: dict[str, int],
    trace_mode: str,
    oracle_loads=None,
    predictor: str = "auto",
) -> tuple[list[str], list[int], list[bool]]:
    """Program-order (op id, address, is_store) stream from AGU traces.

    Global program order is lexicographic on the polyhedral 2d+1 key —
    static body positions and the §4 never-reset counters interleaved,
    with the op's own body position last. Supplies everything except
    values/valid bits, which only the oracle walk can produce
    (``oracle_loads`` feeds the speculative AGU of loss-of-decoupling
    PEs from that same walk).
    """
    from repro_torch.core import schedule as schedlib

    traces = schedlib.trace_program(
        program, dae, arrays, params, mode=trace_mode,
        oracle_loads=oracle_loads, predictor=predictor,
    )
    loop_pos, op_pos = program.static_positions()
    op_path = {op.id: path for op, path in program.mem_ops()}
    ops = sorted(traces)
    if not ops:
        return [], [], []
    width = 2 * max(tr.depth for tr in traces.values()) + 1
    mats = []
    for op_id in ops:
        tr = traces[op_id]
        path = op_path[op_id]
        key = np.full((tr.n_req, width), -1, dtype=np.int64)
        for j in range(tr.depth):
            key[:, 2 * j] = loop_pos[id(path[j])]
            key[:, 2 * j + 1] = tr.sched[:, j]
        key[:, 2 * tr.depth] = op_pos[op_id]
        mats.append(key)
    stacked = np.concatenate(mats, axis=0)
    order = np.lexsort(stacked.T[::-1])
    flat_op: list[str] = []
    flat_addr = np.concatenate([traces[o].addr for o in ops])
    flat_store: list[bool] = []
    for op_id in ops:
        tr = traces[op_id]
        flat_op.extend([op_id] * tr.n_req)
        flat_store.extend([tr.is_store] * tr.n_req)
    return (
        [flat_op[i] for i in order],
        flat_addr[order].tolist(),
        [flat_store[i] for i in order],
    )


def build_wave_plan(
    program: ir.Program,
    arrays: dict[str, np.ndarray],
    params: Optional[dict[str, int]] = None,
    trace_mode=cfglib.UNSET,
    speculation=cfglib.UNSET,
    predictor=cfglib.UNSET,
    batch_waves=cfglib.UNSET,
    fifo_depth=cfglib.UNSET,
    symbolic_admission=cfglib.UNSET,
    config: Optional[cfglib.RunConfig] = None,
) -> WavePlan:
    """Run the AGU/CU front-end and emit the backend-consumable plan.

    One hooked oracle walk supplies (a) the reference value/valid
    streams, (b) the op-table environment slots via the ``aux_exprs``
    interpreter hook, (c) the dep alignment maps (most recent request
    of each feeding load at every store request), and — for speculative
    programs — (d) the load streams the run-ahead AGU predicts against.
    ``trace_mode != "interp"`` additionally builds op/addr/kind streams
    through the trace compiler and asserts they agree with the walk.

    ``speculation="auto"`` admits loss-of-decoupling programs
    (load-dependent trips/addresses, DESIGN.md §10): the wave partition
    works off the *true* post-squash request stream — phantom squash
    traffic is a DU-timing artifact and has no wave-executor analogue.
    ``predictor`` (``dae.PREDICTORS``) is accepted for API uniformity
    with ``simulate()``: the post-squash streams are identical under
    every predictor, so the emitted plan does not depend on it.

    ``batch_waves`` (default on) coarsens the wave partition into
    batched steps (WavePlan contract 5); ``False`` keeps one step per
    wave — the partition itself is identical either way.
    ``symbolic_admission`` (default on) feeds the certifier's per-op
    conflict-freedom proofs (``analysis.deps.symbolically_free_ops``)
    to the coarsener so proven-disjoint dep-edges batch without address
    enumeration — the resulting steps are bit-identical, the flag only
    controls whether the fast path (and its ``WaveStats`` accounting)
    is used.

    Cross-PE FIFO edges (DESIGN.md §11) become ``fifo_depth`` circular
    pseudo-memory slots per edge, appended after the real arrays in the
    flat image: each push is a store-like pseudo-request (``~push:K``)
    and each pop a load-like one (``~pop:K``) at slot ``token %
    fifo_depth``, so the ordinary same-address sweep yields the
    producer-before-consumer dep edge (slot RAW) *and* bounded
    backpressure (slot WAW/WAR: push ``k+depth`` lands strictly after
    pop ``k``) — ``validate_plan`` asserts both per edge.

    ``config=`` accepts a ``repro_torch.core.config.RunConfig``; the
    executor consumes its ``trace_mode``/``speculation``/``predictor``/
    ``batch_waves``/``fifo_depth``/``symbolic_admission`` fields and
    ignores the simulator-only ones (``mode``, ``engine``, ...). A
    conflicting explicit kwarg raises ``config.ConfigConflict``.
    """
    cfg = cfglib.resolve(
        config, trace_mode=trace_mode, speculation=speculation,
        predictor=predictor, batch_waves=batch_waves,
        symbolic_admission=symbolic_admission,
    )
    trace_mode, speculation, predictor = (
        cfg.trace_mode, cfg.speculation, cfg.predictor
    )
    batch_waves, symbolic_admission = cfg.batch_waves, cfg.symbolic_admission
    # fifo_depth=None in a config means "default" (4 here, matching
    # SimParams.fifo_depth) — only a real config value can conflict
    if fifo_depth is cfglib.UNSET:
        fifo_depth = cfg.fifo_depth if cfg.fifo_depth is not None else 4
    elif cfg.fifo_depth is not None and cfg.fifo_depth != fifo_depth:
        raise cfglib.ConfigConflict(
            f"explicit fifo_depth={fifo_depth} conflicts with explicit "
            f"config=RunConfig(fifo_depth={cfg.fifo_depth})"
        )
    fifo_depth = int(fifo_depth)
    params = params or {}

    from repro_torch.core import coarsen as coarsenlib
    from repro_torch.core import dae as daelib
    from repro_torch.core import fifo as fifolib

    dae = daelib.decouple(program, speculation=speculation, predictor=predictor)
    fifo_spec = None
    if dae.fifo_edges:
        if dae.spec:
            raise NotImplementedError(
                "cross-PE FIFO streaming cannot combine with speculative "
                "AGUs (loss-of-decoupling PEs) in the wave executor"
            )
        fifo_spec = fifolib.analyze_program(program, dae)
        fifolib.check_depth(fifo_spec, fifo_depth)
    # the flat image and the op-table closures compute in f64; a
    # narrower protected array would make the oracle round every store
    # to the array dtype and the backends diverge in the last ulp —
    # reject it up front instead of tripping a divergence assert deep
    # in the wave loop (unprotected Read arrays may be any dtype)
    for arr in sorted({op.array for op, _ in program.mem_ops()}):
        if arrays[arr].dtype != np.float64:
            raise ValueError(
                f"wave executor requires float64 protected arrays: "
                f"'{arr}' is {arrays[arr].dtype}"
            )
    # consumer stores reading streamed locals compile those to CDeps on
    # the pseudo pop ops (optable stream_deps, DESIGN.md §11)
    stream_deps: dict[str, dict[str, str]] = {}
    if fifo_spec:
        for op, _path in program.mem_ops():
            if not op.is_store:
                continue
            ins = fifo_spec.in_edges.get(dae.op_to_pe[op.id], ())
            if ins:
                stream_deps[op.id] = {
                    name: f"~pop:{eidx}" for eidx, name in ins
                }
    tables = optablelib.compile_store_tables(program, stream_deps or None)
    aux_exprs = {
        op_id: t.env_exprs for op_id, t in tables.items() if t.env_exprs
    }

    # --- pass 1: hooked oracle walk (reference + CU operand capture) -----
    per_op_vv: dict[str, list[tuple[bool, Optional[float]]]] = {}
    load_streams: dict[str, list[float]] = {}
    env_rows: dict[str, list[tuple]] = {op_id: [] for op_id in aux_exprs}
    dep_rows: dict[str, dict[str, list[int]]] = {
        op_id: {ld: [] for ld in t.deps} for op_id, t in tables.items()
    }
    counts: dict[str, int] = {}
    interp_stream: list[tuple[str, int, bool]] = []
    # FIFO token capture: (pos in the real request stream, kind, edge
    # idx, token value) — pops fire at consumer leaf-instance entry
    # (before the instance's own requests), pushes at producer instance
    # exit (after them); same-pos events keep chronological order
    fifo_events: list[tuple[int, str, int, float]] = []
    n_real = [0]

    # MonotonicHint sanitizer capture (DESIGN.md §12): for every hinted
    # op, record the request ordinals at which its deepest *asserted*
    # non-monotonic loop is (re-)entered — exactly the positions where
    # the address stream may legally decrease. ``drive_plan(
    # validate_hints=True)`` replays the positional check.
    hinted = [(op, path) for op, path in program.mem_ops() if op.hint is not None]
    hint_count: dict[str, int] = {}
    hint_resets: dict[str, list[int]] = {}
    hint_marker: dict[int, list[str]] = {}
    if hinted and not dae.spec:
        from repro_torch.analysis import deps as depslib

        for op, path in hinted:
            hint_count[op.id] = 0
            hint_resets[op.id] = []
            if op.hint.innermost_monotonic:
                max_nm = depslib._max_allowed_reset_depth(op.hint, len(path))
                if max_nm >= 1:
                    hint_marker.setdefault(id(path[max_nm]), []).append(op.id)

    def aux_hook(op_id, values):
        env_rows[op_id].append(values)

    def hook(op_id, addr, is_store, valid, value):
        n_real[0] += 1
        per_op_vv.setdefault(op_id, []).append((valid, value))
        if op_id in hint_count:
            hint_count[op_id] += 1
        if is_store:
            for ld, rows in dep_rows[op_id].items():
                rows.append(counts.get(ld, 0) - 1)
        else:
            counts[op_id] = counts.get(op_id, 0) + 1
            if dae.spec:
                # only the speculative AGU consumes the load streams
                load_streams.setdefault(op_id, []).append(value)
        if trace_mode == "interp":
            interp_stream.append((op_id, addr, is_store))

    fifo_loop_hook = None
    if fifo_spec:
        push_leaves: dict[int, list] = {}
        pop_leaves: dict[int, list] = {}
        for e in fifo_spec.edges:
            push_leaves.setdefault(id(dae.pes[e.prod_pe].leaf), []).append(e)
            pop_leaves.setdefault(id(dae.pes[e.cons_pe].leaf), []).append(e)

        def fifo_loop_hook(loop, phase, reader):
            if phase == "enter":
                for e in pop_leaves.get(id(loop), ()):
                    # the enclosing scope holds the producer's token
                    # value (sequential semantics); counts updates live
                    # so a consumer store's dep row sees its own pop
                    o = f"~pop:{e.idx}"
                    counts[o] = counts.get(o, 0) + 1
                    fifo_events.append(
                        (n_real[0], "pop", e.idx, float(reader(e.local)))
                    )
            else:
                for e in push_leaves.get(id(loop), ()):
                    # zero-trip instances still push: the init value
                    fifo_events.append(
                        (n_real[0], "push", e.idx, float(reader(e.local)))
                    )

    loop_hook = fifo_loop_hook
    if hint_marker:

        def loop_hook(loop, phase, reader):
            if phase == "enter":
                for o in hint_marker.get(id(loop), ()):
                    hint_resets[o].append(hint_count[o])
            if fifo_loop_hook is not None:
                fifo_loop_hook(loop, phase, reader)

    if dae.spec:
        # speculative programs get the documented auto-reject
        # (DESIGN.md §10) through the shared conversion site
        from repro_torch.core import speculate

        speculate.interpret_hooked(
            program, arrays, params, hook,
            aux_exprs=aux_exprs, aux_hook=aux_hook,
        )
    else:
        ir.interpret(
            program, arrays, params, trace_hook=hook,
            aux_exprs=aux_exprs, aux_hook=aux_hook, loop_hook=loop_hook,
        )

    if trace_mode != "interp":
        req_op_l, req_addr_l, req_store_l = _trace_stream(
            program, dae, arrays, params, trace_mode,
            oracle_loads=load_streams if dae.spec else None,
            predictor=predictor,
        )
        n_oracle = sum(len(v) for v in per_op_vv.values())
        assert n_oracle == len(req_op_l), (
            f"trace stream has {len(req_op_l)} requests, oracle walk "
            f"{n_oracle} — trace compiler divergence"
        )
    else:
        req_op_l = [r[0] for r in interp_stream]
        req_addr_l = [r[1] for r in interp_stream]
        req_store_l = [r[2] for r in interp_stream]

    op_ids = [op.id for op, _ in program.mem_ops()]
    op_array = {op.id: op.array for op, _ in program.mem_ops()}
    op_is_store = {op.id: op.is_store for op, _ in program.mem_ops()}

    # merge the FIFO token events into the request stream as pseudo
    # requests on the edge's circular slots (module docstring) — after
    # the trace-count assert, which covers real requests only
    push_k: dict[int, int] = {}
    if fifo_events:
        pop_k: dict[int, int] = {}
        m_op: list[str] = []
        m_addr: list[int] = []
        m_store: list[bool] = []
        ev = 0
        for pos in range(len(req_op_l) + 1):
            while ev < len(fifo_events) and fifo_events[ev][0] == pos:
                _p, kind, eidx, value = fifo_events[ev]
                ev += 1
                if kind == "push":
                    o = f"~push:{eidx}"
                    k = push_k.get(eidx, 0)
                    push_k[eidx] = k + 1
                    m_store.append(True)
                else:
                    o = f"~pop:{eidx}"
                    k = pop_k.get(eidx, 0)
                    pop_k[eidx] = k + 1
                    m_store.append(False)
                m_op.append(o)
                m_addr.append(k % fifo_depth)
                per_op_vv.setdefault(o, []).append((True, value))
            if pos < len(req_op_l):
                m_op.append(req_op_l[pos])
                m_addr.append(req_addr_l[pos])
                m_store.append(req_store_l[pos])
        req_op_l, req_addr_l, req_store_l = m_op, m_addr, m_store
    if fifo_spec:
        for e in fifo_spec.edges:
            for o, st in ((f"~push:{e.idx}", True), (f"~pop:{e.idx}", False)):
                op_ids.append(o)
                op_array[o] = f"~fifo:{e.idx}"
                op_is_store[o] = st
            po = f"~push:{e.idx}"
            tables[po] = optablelib.StoreTable(
                op_id=po, array=f"~fifo:{e.idx}", deps=(),
                env_exprs=(ir.Local(e.local),),  # descriptive; slot 0 is
                value=optablelib.CEnv(0),        # the captured token
                guard=None, frozen_reads=(),
            )
            dep_rows[po] = {}

    n = len(req_op_l)
    op_index = {o: i for i, o in enumerate(op_ids)}

    req_op = np.fromiter(
        (op_index[o] for o in req_op_l), dtype=np.int32, count=n
    )
    req_addr = np.asarray(req_addr_l, dtype=np.int64) if n else np.zeros(
        0, dtype=np.int64
    )
    req_store = np.asarray(req_store_l, dtype=bool) if n else np.zeros(
        0, dtype=bool
    )

    # per-op ordinal + the (valid, value) reference streams, by ordinal
    req_ordinal = np.zeros(n, dtype=np.int64)
    req_valid = np.zeros(n, dtype=bool)
    req_value = np.full(n, np.nan, dtype=np.float64)
    taken: dict[str, int] = {}
    for i in range(n):
        o = req_op_l[i]
        k = taken.get(o, 0)
        taken[o] = k + 1
        req_ordinal[i] = k
        valid, value = per_op_vv[o][k]
        req_valid[i] = valid
        if value is not None:
            req_value[i] = value

    # --- pass 2: wave assignment (one program-order sweep) ---------------
    waves = np.zeros(n, dtype=np.int64)
    # per (array, addr): wave of last store; max wave of loads since it
    last_store_wave: dict[tuple[str, int], int] = {}
    loads_since_store: dict[tuple[str, int], int] = {}
    # per load op: wave of its k-th request (appended in program order,
    # so list position == ordinal) — the exact per-(PE, dep-edge)
    # dataflow inputs a store's wave is computed from
    wave_of_load: dict[str, list[int]] = {}
    # per request: max wave over its feeding loads (-1 for loads and
    # dep-free stores) — feeds the wave-batching admission rule
    feed_max = np.full(n, -1, dtype=np.int64)

    # FIFO pushes carry a CU local: they must land strictly after every
    # load (and pop) of the producer PE seen so far — tracked as a
    # running per-PE wave frontier over the load-like requests
    pe_frontier: dict[int, int] = {}
    push_pe: dict[str, int] = {}
    pop_pe: dict[str, int] = {}
    if fifo_spec:
        for e in fifo_spec.edges:
            push_pe[f"~push:{e.idx}"] = e.prod_pe
            pop_pe[f"~pop:{e.idx}"] = e.cons_pe

    for i in range(n):
        o = req_op_l[i]
        key = (op_array[o], req_addr_l[i])
        if req_store[i]:
            # WAW: after last store; WAR: after every load since it;
            # dataflow: after exactly the load requests feeding this
            # store's value/guard (dep maps, contract 3) — invalid §6
            # stores included, their *guard* still reads those loads
            fm = -1
            k = req_ordinal[i]
            for ld in tables[o].deps:
                m = dep_rows[o][ld][k]
                if m >= 0:
                    lw = wave_of_load[ld][m]
                    if lw > fm:
                        fm = lw
            ppe = push_pe.get(o)
            if ppe is not None:
                fm = max(fm, pe_frontier.get(ppe, -1))
            feed_max[i] = fm
            w = max(
                last_store_wave.get(key, -1) + 1,
                loads_since_store.get(key, -1) + 1,
                fm + 1,
            )
            if req_valid[i]:
                last_store_wave[key] = w
                loads_since_store[key] = -1
            else:
                # §6: invalid stores occupy a wave slot (they update the
                # frontier in hardware) but have no memory effect
                last_store_wave[key] = max(last_store_wave.get(key, -1), w)
        else:
            # RAW: after the last store to this address
            w = last_store_wave.get(key, -1) + 1
            loads_since_store[key] = max(loads_since_store.get(key, -1), w)
            wave_of_load.setdefault(o, []).append(w)
            if fifo_spec:
                pe_of = pop_pe.get(o, dae.op_to_pe.get(o))
                if pe_of is not None and w > pe_frontier.get(pe_of, -1):
                    pe_frontier[pe_of] = w
        waves[i] = w

    n_waves = int(waves.max()) + 1 if n else 0

    # --- wave coarsening: batch conflict-free waves into steps -----------
    # (needs flat addresses — computed below — so steps are assigned
    # after the layout pass)

    # --- flat protected-memory layout ------------------------------------
    # real arrays first; each FIFO edge then gets ``fifo_depth`` circular
    # slots inside ``mem_size`` (zero-init in the flat image, never
    # unpacked — ``array_order`` stays real-only), so backends execute
    # FIFO traffic as ordinary gathers/scatters without special cases
    protected = sorted({op.array for op, _ in program.mem_ops()})
    base: dict[str, int] = {}
    off = 0
    for a in protected:
        base[a] = off
        off += len(arrays[a])
    fifo_meta: list[dict] = []
    if fifo_spec:
        for e in fifo_spec.edges:
            base[f"~fifo:{e.idx}"] = off
            fifo_meta.append({
                "idx": e.idx, "prod_pe": e.prod_pe, "cons_pe": e.cons_pe,
                "local": e.local, "depth": int(fifo_depth),
                "base": off, "n_tokens": push_k.get(e.idx, 0),
                "push_op": f"~push:{e.idx}", "pop_op": f"~pop:{e.idx}",
            })
            off += fifo_depth
    op_base = np.asarray(
        [base[op_array[o]] for o in op_ids], dtype=np.int64
    ) if op_ids else np.zeros(0, dtype=np.int64)
    req_flat = (op_base[req_op] + req_addr) if n else req_addr.copy()

    env = {
        op_id: [
            np.asarray([row[k] for row in rows])
            for k in range(len(aux_exprs[op_id]))
        ]
        for op_id, rows in env_rows.items()
    }
    if fifo_spec:
        # push "stores" compute through a one-slot env stream: the
        # captured token values, in push order
        for e in fifo_spec.edges:
            env[f"~push:{e.idx}"] = [np.asarray(
                [v for _p, kind, ei, v in fifo_events
                 if kind == "push" and ei == e.idx],
                dtype=np.float64,
            )]
    dep_maps = {
        op_id: {ld: np.asarray(rows, dtype=np.int64)
                for ld, rows in per_ld.items()}
        for op_id, per_ld in dep_rows.items()
    }
    op_nreq = {o: len(per_op_vv.get(o, ())) for o in op_ids}

    # symbolic admission certificates (analysis/deps.py, DESIGN.md §12):
    # requests of certifier-proven conflict-free ops skip the
    # coarsener's address enumeration. FIFO pseudo-ops are never
    # certified (their slot streams are circular by construction).
    sym_free = None
    sym_ops: tuple = ()
    n_sym = 0
    if symbolic_admission:
        from repro_torch.analysis import deps as depslib

        free = depslib.symbolically_free_ops(program)
        sym_ops = tuple(sorted(o for o, ok in free.items() if ok))
        free_arr = np.asarray(
            [free.get(o, False) for o in op_ids], dtype=bool
        ) if op_ids else np.zeros(0, dtype=bool)
        sym_free = free_arr[req_op] if n else np.zeros(0, dtype=bool)
        n_sym = int(sym_free.sum())

    if batch_waves:
        step_of_wave, n_steps = coarsenlib.batch_conflict_free_waves(
            waves, req_flat, req_store, feed_max, symbolic_free=sym_free,
        )
        req_step = step_of_wave[waves] if n else waves.copy()
    else:
        req_step, n_steps = waves.copy(), n_waves

    # hint sanitizer data (None = hints present but capture impossible:
    # the speculative walk has no loop hook)
    hint_checks: Optional[list] = None
    if not (dae.spec and hinted):
        hint_checks = [
            {
                "op": op.id,
                "resets": np.asarray(
                    sorted(set(hint_resets.get(op.id, ()))), dtype=np.int64
                ),
                "innermost": bool(op.hint.innermost_monotonic),
            }
            for op, _path in hinted
        ]

    stats = WaveStats(
        n_requests=n, n_waves=n_waves, sequential_depth=n, n_steps=n_steps,
        n_sym_requests=n_sym, sym_ops=sym_ops,
    )
    return WavePlan(
        program=program, params=dict(params),
        op_ids=op_ids, op_array=op_array, op_is_store=op_is_store,
        op_nreq=op_nreq,
        req_op=req_op, req_addr=req_addr, req_flat=req_flat,
        req_store=req_store, req_valid=req_valid, req_value=req_value,
        req_wave=waves, req_step=req_step, req_ordinal=req_ordinal,
        tables=tables, env=env, dep_maps=dep_maps,
        array_order=protected, base=base, mem_size=off,
        stats=stats, fifo_edges=fifo_meta, hint_checks=hint_checks,
    )


def wave_store_inputs(
    plan: WavePlan, op_id: str, rows: np.ndarray,
    lv_streams: dict[str, np.ndarray],
) -> tuple[dict[str, np.ndarray], list[np.ndarray], int]:
    """Gather the op-table operands for the given requests of one store.

    ``rows`` are global request indices (all of op ``op_id``);
    ``lv_streams`` are the per-load-op value streams the backend has
    produced so far (waves strictly before the current one — WavePlan
    contract 1 guarantees they are filled). Returns (dep value arrays,
    env slot arrays, n) ready for ``StoreTable.eval_value/eval_guard``.
    """
    table = plan.tables[op_id]
    k = plan.req_ordinal[rows]
    deps: dict[str, np.ndarray] = {}
    for ld in table.deps:
        m = plan.dep_maps[op_id][ld][k]
        # -1 = guard-invalid row whose feeding load never fired; clip —
        # the garbage value is masked by the valid bit (contract 3)
        deps[ld] = lv_streams[ld][np.clip(m, 0, None)]
    env = [plan.env[op_id][s][k] for s in range(len(table.env_exprs))]
    return deps, env, len(rows)


def validate_plan(plan: WavePlan) -> None:
    """Assert the WavePlan contract (docstring items 1–3 and 5)
    vectorized.

    Cheap enough to run in tests on every kernel; backends may call it
    defensively before executing an externally produced plan.
    """
    waves, n = plan.req_wave, plan.n_requests
    # 2. intra-wave conflict-freedom: (wave, flat addr) pairs involving
    # a store are unique
    key = waves * max(plan.mem_size, 1) + plan.req_flat
    touched = key[plan.req_store]
    assert len(np.unique(touched)) == len(touched), (
        "two stores share (wave, address)"
    )
    load_keys = set(np.unique(key[~plan.req_store]).tolist())
    for kk in touched.tolist():
        assert kk not in load_keys, "load and store share (wave, address)"
    # 1+3. every store is strictly after the loads feeding it
    lv_wave: dict[str, np.ndarray] = {}
    for op_id, is_store in plan.op_is_store.items():
        if not is_store:
            rows = np.nonzero(plan.req_op == plan.op_ids.index(op_id))[0]
            w = np.zeros(plan.op_nreq[op_id], dtype=np.int64)
            w[plan.req_ordinal[rows]] = waves[rows]
            lv_wave[op_id] = w
    lv_step: dict[str, np.ndarray] = {}
    steps = plan.req_step
    for op_id, is_store in plan.op_is_store.items():
        if not is_store:
            rows = np.nonzero(plan.req_op == plan.op_ids.index(op_id))[0]
            s = np.zeros(plan.op_nreq[op_id], dtype=np.int64)
            s[plan.req_ordinal[rows]] = steps[rows]
            lv_step[op_id] = s
    for op_id, per_ld in plan.dep_maps.items():
        rows = np.nonzero(plan.req_op == plan.op_ids.index(op_id))[0]
        k = plan.req_ordinal[rows]
        for ld, m in per_ld.items():
            mm = m[k]
            ok = mm >= 0
            assert np.all(
                waves[rows][ok] > lv_wave[ld][mm[ok]]
            ), f"store {op_id} not strictly after its {ld} inputs"
            # 5. feeding loads in strictly earlier *steps* too (the
            # batching admission rule — same-step loads do not exist
            # yet when the step's store values are computed)
            assert np.all(
                steps[rows][ok] > lv_step[ld][mm[ok]]
            ), f"store {op_id} shares a step with its {ld} inputs"
            # -1 rows must be guard-invalid (contract 3)
            assert np.all(plan.req_valid[rows][~ok] == False)  # noqa: E712
    # 5. steps coarsen waves order-preservingly: the step index is a
    # non-decreasing function of the wave index
    if n:
        order = np.argsort(waves, kind="stable")
        assert np.all(np.diff(steps[order]) >= 0), (
            "steps do not coarsen waves monotonically"
        )
    # 5. step-level conflict-freedom: stores never share (step, addr)
    # with another store, and only with loads from strictly earlier
    # waves (the batch-internal WAR a gather-before-scatter step allows)
    skey = steps * max(plan.mem_size, 1) + plan.req_flat
    stouched = skey[plan.req_store]
    assert len(np.unique(stouched)) == len(stouched), (
        "two stores share (step, address)"
    )
    store_wave_of = dict(zip(stouched.tolist(),
                             waves[plan.req_store].tolist()))
    lrows = np.nonzero(~plan.req_store)[0]
    for i, kk in zip(lrows.tolist(), skey[lrows].tolist()):
        sw = store_wave_of.get(kk)
        assert sw is None or waves[i] < sw, (
            "load shares (step, address) with a non-later store"
        )
    assert n == 0 or int(waves.max()) + 1 == plan.stats.n_waves
    assert n == 0 or int(steps.max()) + 1 == plan.stats.n_steps
    assert plan.stats.n_steps <= plan.stats.n_waves or n == 0
    # FIFO edges (DESIGN.md §11): per edge, producer-before-consumer
    # ordering and bounded backpressure over the token sequence
    for fe in plan.fifo_edges:
        prow = np.nonzero(plan.req_op == plan.op_ids.index(fe["push_op"]))[0]
        crow = np.nonzero(plan.req_op == plan.op_ids.index(fe["pop_op"]))[0]
        assert len(prow) == len(crow) == fe["n_tokens"], (
            f"fifo edge {fe['idx']}: push/pop token counts diverge"
        )
        pw = waves[prow][np.argsort(plan.req_ordinal[prow])]
        cw = waves[crow][np.argsort(plan.req_ordinal[crow])]
        assert np.all(cw > pw), (
            f"fifo edge {fe['idx']}: pop not strictly after its push"
        )
        d = fe["depth"]
        if len(pw) > d:
            assert np.all(pw[d:] > cw[:-d]), (
                f"fifo edge {fe['idx']}: push overruns the {d}-slot "
                f"buffer (backpressure violated)"
            )
        ps = steps[prow][np.argsort(plan.req_ordinal[prow])]
        cs = steps[crow][np.argsort(plan.req_ordinal[crow])]
        assert np.all(cs > ps), (
            f"fifo edge {fe['idx']}: pop shares a step with its push"
        )


def validate_plan_hints(plan: WavePlan) -> None:
    """Check every hinted op's request stream against its asserted
    monotonicity (``analysis.deps.check_hint_positions``): raises
    ``HintViolation`` with op id + first violating (instance, addr)."""
    from repro_torch.analysis import deps as depslib

    if plan.hint_checks is None:
        raise NotImplementedError(
            "validate_hints: hint capture is unavailable for speculative "
            "programs (the run-ahead walk has no loop hook)"
        )
    for hc in plan.hint_checks:
        i = plan.op_ids.index(hc["op"])
        rows = np.flatnonzero(plan.req_op == i)  # program order
        depslib.check_hint_positions(
            hc["op"], plan.req_addr[rows], hc["resets"], hc["innermost"]
        )


def drive_plan(
    plan: WavePlan,
    mem_step,
    *,
    frozen: dict[str, np.ndarray],
    step_of: Optional[np.ndarray] = None,
    n_steps: Optional[int] = None,
    lib: str = "np",
    device=None,
    check: bool = True,
    max_steps: Optional[int] = None,
    validate_hints: bool = False,
) -> tuple[int, bool]:
    """Shared step-loop driver for every backend.

    Owns everything that must stay identical across backends — the
    batched-step iteration, op-table compute (store values + §6 valid
    bits from *earlier* steps' gathers, contract 5), dep/load-stream
    bookkeeping, and the request-exact divergence checks — and
    delegates only the memory move: ``mem_step(flat_addr, write_mask,
    store_vals) -> gathered f64 values per lane`` over whatever image
    the backend keeps (a numpy array here, an int64 image on the card
    in ``kernels/wave_exec``). The gather must read the
    *pre-step* image (contract 5 admits WAR inside a step).
    ``step_of``/``n_steps`` default to the plan's batched partition;
    pass ``req_wave`` for one step per wave, or ``arange(n)`` for the
    sequential baseline. Returns (steps taken, ran to completion).
    ``lib="torch"`` evaluates the op-table closures in float64 on
    ``device`` instead of in numpy.

    ``validate_hints=True`` runs the MonotonicHint sanitizer
    (``validate_plan_hints``) before stepping: a user hint contradicted
    by the actual address stream raises ``analysis.deps.HintViolation``
    instead of silently executing with an unsound hazard plan.
    """
    if validate_hints:
        validate_plan_hints(plan)
    if step_of is None:
        step_of = plan.req_step
        n_steps = plan.stats.n_steps
    lv_streams = {
        op_id: np.zeros(plan.op_nreq[op_id], dtype=np.float64)
        for op_id, s in plan.op_is_store.items() if not s
    }
    order = np.argsort(step_of, kind="stable")
    bounds = np.searchsorted(step_of[order], np.arange(n_steps + 1))
    steps = 0
    for w in range(n_steps):
        if max_steps is not None and steps >= max_steps:
            return steps, False
        batch = order[bounds[w]:bounds[w + 1]]
        store_sel = np.nonzero(plan.req_store[batch])[0]
        stores = batch[store_sel]
        # compute: store values/valid from op tables (deps are filled —
        # contract 5). Grouped per op for vectorized closure eval.
        sval = np.zeros(len(batch), dtype=np.float64)
        write = np.zeros(len(batch), dtype=bool)
        for op_i in np.unique(plan.req_op[stores]):
            sel = store_sel[plan.req_op[stores] == op_i]
            rows = batch[sel]
            op_id = plan.op_ids[op_i]
            deps, env, nn = wave_store_inputs(plan, op_id, rows, lv_streams)
            table = plan.tables[op_id]
            v = table.eval_value(deps, env, frozen, nn, lib=lib, device=device)
            g = table.eval_guard(deps, env, frozen, nn, lib=lib, device=device)
            v, g = np.asarray(v, dtype=np.float64), np.asarray(g)
            if check:
                np.testing.assert_array_equal(
                    g, plan.req_valid[rows],
                    err_msg=f"op-table guard diverged from oracle valid "
                    f"bits on {op_id}",
                )
                np.testing.assert_array_equal(
                    v[g], plan.req_value[rows][g],
                    err_msg=f"op-table store values diverged from oracle "
                    f"on {op_id}",
                )
            sval[sel] = np.where(g, v, 0.0)
            write[sel] = g
        got = mem_step(plan.req_flat[batch], write, sval)
        steps += 1
        # collect this wave's load values into the per-op streams
        load_sel = ~plan.req_store[batch]
        loads = batch[load_sel]
        if len(loads):
            got_loads = np.asarray(got, dtype=np.float64)[load_sel]
            if check:
                np.testing.assert_array_equal(
                    got_loads, plan.req_value[loads],
                    err_msg="backend gather diverged from oracle loads",
                )
            for op_i in np.unique(plan.req_op[loads]):
                m = plan.req_op[loads] == op_i
                lv_streams[plan.op_ids[op_i]][
                    plan.req_ordinal[loads[m]]
                ] = got_loads[m]
    return steps, True


def flat_image(plan: WavePlan, arrays: dict[str, np.ndarray]) -> np.ndarray:
    """The flat f64 protected-memory image a backend executes against."""
    mem = np.zeros(max(plan.mem_size, 1), dtype=np.float64)
    for a in plan.array_order:
        mem[plan.base[a]:plan.base[a] + len(arrays[a])] = arrays[a]
    return mem


def unpack_image(
    plan: WavePlan, mem: np.ndarray, arrays: dict[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """Final array dict from a flat image (unprotected arrays copied)."""
    out = {k: np.array(v, copy=True) for k, v in arrays.items()}
    for a in plan.array_order:
        out[a] = mem[plan.base[a]:plan.base[a] + len(arrays[a])].copy()
    return out


def _replay_numpy(plan: WavePlan, arrays: dict[str, np.ndarray]):
    """Reference wave backend: the shared driver over a numpy image.

    Identical to the torch backend minus the kernel — same driver,
    same op-table compute, same flat image; the memory step is a numpy
    gather + masked scatter. Every §6 valid bit, store value and
    gathered load is pinned request-exact against the oracle reference
    streams — "validated by construction": effects apply in step order,
    conflicting requests never share a step (except the WAR pair the
    gather-before-scatter ordering resolves), so agreement proves the
    partition, the batching, the dep maps and the compute bodies
    together reproduce sequential semantics.
    """
    mem = flat_image(plan, arrays)

    def mem_step(addr, write, sval):
        got = mem[addr]  # fancy indexing copies: pre-wave state
        mem[addr[write]] = sval[write]
        return got

    drive_plan(plan, mem_step, frozen=arrays, check=True)
    return unpack_image(plan, mem, arrays)


def execute(
    program: ir.Program,
    arrays: dict[str, np.ndarray],
    params: Optional[dict[str, int]] = None,
    trace_mode=cfglib.UNSET,
    speculation=cfglib.UNSET,
    predictor=cfglib.UNSET,
    backend=cfglib.UNSET,
    batch_waves=cfglib.UNSET,
    fifo_depth=cfglib.UNSET,
    symbolic_admission=cfglib.UNSET,
    validate_hints=cfglib.UNSET,
    config: Optional[cfglib.RunConfig] = None,
    *,
    device="cuda",
) -> ExecResult:
    """Wave-partitioned fused execution of ``program``.

    Builds the ``WavePlan`` (AGU/CU front-end, wave partition, op
    tables) and drives it through a backend:

      * ``backend="torch"`` (the default) —
        ``repro_torch.kernels.wave_exec``: each
        step runs as a data-parallel gather→scatter over a flat
        bit-exact int64 memory image on ``device``. ``device="cuda"``
        (the default) launches the CUDA kernel and raises
        ``RuntimeError`` when no card is present; ``device="cpu"``,
        for tests only, runs the kernel's plain torch version,
      * ``backend="numpy"`` — the host replay in this module, only
        when the caller names it.

    Both compute store values through the op tables and are asserted
    request-exact against the oracle reference stream; final arrays are
    bit-identical to ``loopir.interpret`` for every Table-1 kernel in
    both trace modes.

    ``speculation="auto"`` admits loss-of-decoupling programs
    (load-dependent trips/addresses, DESIGN.md §10): the wave partition
    works off the *true* post-squash request stream — phantom squash
    traffic is a DU-timing artifact and has no wave-executor analogue.
    ``predictor`` (``dae.PREDICTORS``) is accepted for API uniformity:
    final arrays and the wave partition are identical under every
    predictor.

    ``batch_waves`` (default on) lets both backends execute batched
    conflict-free wave runs as single steps (WavePlan contract 5);
    ``False`` forces one step per wave. Final arrays are identical.

    ``fifo_depth`` sizes every cross-PE FIFO edge's circular slot
    buffer (DESIGN.md §11). Final arrays are identical for any depth
    >= 1 — a shallower buffer only tightens backpressure, i.e. grows
    the wave/step count.

    ``symbolic_admission`` toggles the certifier's wave-batching fast
    path (bit-identical steps either way, DESIGN.md §12);
    ``validate_hints=True`` checks every ``MonotonicHint`` against the
    plan's actual request streams and raises
    ``analysis.deps.HintViolation`` on a lie.

    ``config=`` accepts a ``repro_torch.core.config.RunConfig``; the
    executor consumes every field except the simulator-only ``mode``/
    ``engine``/``spec_runahead``/``fifo_latency``/``static_prune``. A
    conflicting explicit kwarg raises ``config.ConfigConflict``. Final
    arrays are bit-identical between the two spellings.
    """
    cfg = cfglib.resolve(
        config, trace_mode=trace_mode, speculation=speculation,
        predictor=predictor, backend=backend, batch_waves=batch_waves,
        symbolic_admission=symbolic_admission, validate_hints=validate_hints,
    )
    backend, validate_hints = cfg.backend, cfg.validate_hints
    if backend == "torch":
        # a missing card raises before the plan is built, not after
        from repro_torch.kernels import wave_exec

        wave_exec.resolve_device(device)
    plan = build_wave_plan(
        program, arrays, params, fifo_depth=fifo_depth, config=cfg,
    )
    if validate_hints:
        validate_plan_hints(plan)
    run = None
    if backend == "numpy":
        out = _replay_numpy(plan, arrays)
    elif backend == "torch":
        run = wave_exec.run_plan(plan, arrays, device=device)
        out = run.arrays
    else:
        raise ValueError(f"unknown backend {backend!r}")
    return ExecResult(
        arrays=out, stats=plan.stats, waves=plan.req_wave, plan=plan, run=run
    )
