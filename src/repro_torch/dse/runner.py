"""Batched sweep runner: exact per-point runs on shared artifacts.

The port's copy of ``dse/runner.py`` in the JAX package: numpy and
``simulate()`` on the host, as there.

``sweep()`` is the public entry point (re-exported as ``dse.sweep``).
Execution model:

  * the planner collapses the requested points onto unique runs and
    groups them per (kernel, scale);
  * each group builds its shared artifacts once (``GroupContext``) and
    executes its unique runs with ``simulator.simulate_traced`` /
    the engines directly — **bit-identical** to standalone
    ``simulate()`` because every shared artifact is timing-independent
    (DESIGN.md §9; asserted per point by tests/test_torch_dse.py and
    at benchmark width by ``chip_smoke.py``'s DSE phase);
  * a result cache (``dse.cache``) short-circuits runs whose key was
    computed by any previous sweep under the same code version;
  * groups execute in parallel across processes when ``workers > 1``
    (results are deterministic, so the worker count cannot change any
    value);
  * with ``profile=True`` the runner also emits the §5.5
    forwarding-admissibility profile: for every forwarding pair it
    reconstructs each FUS2 config's next-request frontier at the
    consumer's recorded issue cycles and evaluates the forwarding-form
    hazard check for *all configs of the group in one call* through the
    config-batched ``du.check_pair_batch`` (leading config axis).

Service features (DESIGN.md §13):

  * **streaming** — ``sweep(on_point=...)`` / ``iter_points()`` deliver
    ``PointResult`` rows the moment their group completes (completion
    order; the final ``SweepResult`` stays in canonical order);
  * **resume** — ``sweep(resume=True, cache_dir=...)`` re-plans from
    the surviving npz cache: only cache-missing runs execute, and the
    journal (``cache.SweepJournal``) supplies interrupted-run
    accounting (``SweepStats``). The cache is the source of truth;
    corrupt journal lines are skipped-and-counted, never fatal;
  * **sharding** — ``sweep(shard=(i, n))`` executes only shard *i* of
    the deterministic ``dse.shard`` partition; ``merge_results()``
    reassembles the single-host result bit-identically;
  * **retry** — transient worker failures (``OSError``, a broken
    process pool) are retried with exponential backoff instead of
    aborting; a persistent or non-transient failure raises
    ``SweepGroupError`` naming the (kernel, scale, spec_class) group
    and the surviving-cache state.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Optional, Sequence, Union

import numpy as np

from repro_torch.core import du as dulib
from repro_torch.core import schedule as schedlib
from repro_torch.core import simulator
from repro_torch.dse import cache as cachelib
from repro_torch.dse.planner import Group, GroupContext, UniqueRun, plan
from repro_torch.dse.spec import SweepPoint, SweepSpec

SENTINEL = int(schedlib.SENTINEL)


@dataclasses.dataclass
class PointResult:
    """One sweep point's outcome. ``result.arrays`` may be shared with
    other points deduplicated onto the same unique run — treat results
    as read-only."""

    point: SweepPoint
    result: simulator.SimResult
    run_key: tuple
    cached: bool
    run_wall_s: float


@dataclasses.dataclass
class SweepStats:
    """Per-sweep progress/retry/timing counters (DESIGN.md §13).

    For a sharded run ``shard=(i, n)`` identifies the slice and every
    counter covers only the shard's own groups, so
    ``shard.merge_results`` can sum them back to the single-host
    numbers. ``n_resumed_runs`` counts cache hits under ``resume=True``
    (runs a previous, possibly killed, sweep already paid for);
    ``journal_entries``/``journal_corrupt`` report what the journal
    held at resume time. ``retries`` logs one dict per transient
    worker failure that was retried ({"group", "attempt", "error",
    "backoff_s"}).
    """

    n_groups: int = 0
    n_points: int = 0
    n_unique_runs: int = 0
    n_cache_hits: int = 0
    n_executed: int = 0
    n_retries: int = 0
    retries: list = dataclasses.field(default_factory=list)
    n_resumed_runs: int = 0
    journal_entries: int = 0
    journal_corrupt: int = 0
    shard: Optional[tuple] = None
    wall_s: float = 0.0


class SweepGroupError(RuntimeError):
    """A sweep group failed permanently.

    The message names the failing (kernel, scale, spec_class) planner
    group, the attempt count, and — when a cache directory is active —
    how many of the group's runs already survive in the cache (so the
    operator knows a ``resume=True`` rerun will skip them). The
    original worker exception is chained as ``__cause__``.
    """


@dataclasses.dataclass
class SweepResult:
    points: list  # [PointResult] aligned with the requested point list
    n_points: int
    n_unique_runs: int
    n_cache_hits: int
    wall_s: float
    groups: list  # per-group {"kernel", "scale", "points", "runs", "wall_s"}
    profile: list  # §5.5 admissibility rows (empty unless profile=True)
    # progress/retry/timing counters; a sharded run marks stats.shard
    # and leaves unowned entries of ``points`` as None
    stats: Optional[SweepStats] = None

    def rows(self) -> list:
        """Flat per-point dict rows (for ``launch.analysis`` helpers).
        Sharded results emit rows only for the shard's own points."""
        out = []
        for pr in self.points:
            if pr is None:
                continue
            p, r = pr.point, pr.result
            out.append({
                "kernel": p.kernel, "scale": p.scale, "mode": p.mode,
                "engine": p.engine, "trace_mode": p.trace_mode,
                "sizing": p.sizing, "sim": dict(p.sim),
                "speculation": p.speculation,
                "predictor": p.predictor,
                "static_prune": p.static_prune,
                "cycles": r.cycles, "dram_bursts": r.dram_bursts,
                "dram_requests": r.dram_requests, "forwards": r.forwards,
                "squashed": r.squashed,
                "spec_stats": r.spec_stats,
                "cached": pr.cached, "run_wall_s": pr.run_wall_s,
            })
        return out


# ---------------------------------------------------------------------------
# single-group execution (also the unit of worker parallelism)
# ---------------------------------------------------------------------------


def _frontier_rows(src_state: dict, cyc: np.ndarray):
    """Next-request registers of a source port as of each cycle in
    ``cyc``, reconstructed from its recorded issue cycles (the same
    derivation as ``EventEngine._frontier_at``, §4.2(4) sentinel
    included)."""
    n = len(src_state["addr"])
    depth = src_state["sched"].shape[1] if src_state["sched"].ndim == 2 else 0
    if n == 0:
        m = len(cyc)
        return (
            np.full((m, depth), SENTINEL, dtype=np.int64),
            np.full(m, SENTINEL, dtype=np.int64),
            np.ones((m, depth), dtype=bool),
        )
    nxt = np.searchsorted(src_state["issue_cycle"], cyc, side="right")
    done = nxt >= n
    idx = np.minimum(nxt, n - 1)
    f_sched = np.where(done[:, None], SENTINEL, src_state["sched"][idx])
    f_addr = np.where(done, SENTINEL, src_state["addr"][idx])
    f_last = np.where(done[:, None], True, src_state["lastiter"][idx])
    return f_sched, f_addr, f_last


def _forward_admissibility(ctx: GroupContext, fus2_states: dict) -> list:
    """§5.5 forwarding-slack profile, config-batched.

    ``fus2_states`` maps a config label -> per-op recorded port state of
    one FUS2 event-engine run. For every forwarding pair, each config's
    next-request frontier is reconstructed **one cycle before** each
    consumer request's recorded issue cycle, and the forwarding-form
    hazard check is evaluated for *all configs of the group in one*
    ``check_pair_batch`` call with a leading config axis.

    The returned ``slack_frac`` is the fraction of consumer requests
    that were already §5.5-admissible a cycle before they issued: high
    means the port was paced by II-1/bandwidth/waves (sizing-bound),
    low means issues were released by the hazard check itself
    (dependence-bound) — the attribution a DU-sizing sweep is after.
    """
    rows = []
    labels = sorted(fus2_states)
    if not labels:
        return rows
    for pair in ctx.comp_fwd.plan.pairs:
        if pair.kind != "RAW":
            continue
        dst_tr = ctx.traces[pair.dst]
        src_tr = ctx.traces[pair.src]
        if not src_tr.is_store or dst_tr.n_req == 0:
            continue
        stacked = [
            _frontier_rows(
                fus2_states[c][pair.src],
                fus2_states[c][pair.dst]["issue_cycle"] - 1,
            )
            for c in labels
        ]
        frontier = tuple(
            np.stack([s[j] for s in stacked]) for j in range(3)
        )
        bits = ctx.nodep_bits.get((pair.dst, pair.src))
        ok = dulib.check_pair_batch(
            pair, dst_tr.sched, dst_tr.addr, None, True,
            bits if pair.nodependence else None,
            frontier=frontier,
        )
        ok = np.broadcast_to(ok, (len(labels), dst_tr.n_req))
        rows.append({
            "kernel": ctx.group.kernel,
            "pair": (pair.dst, pair.src),
            "configs": labels,
            "slack_frac": [round(float(r.mean()), 4) for r in ok],
        })
    return rows


def _port_state(port) -> dict:
    return {
        "sched": port.sched, "addr": port.addr, "lastiter": port.lastiter,
        "issue_cycle": port.issue_cycle,
    }


def _execute_run(ctx: GroupContext, run: UniqueRun, validate: bool):
    """Run one unique point exactly; returns (SimResult, port states or
    None). The dispatch mirrors ``simulator.simulate_traced`` — the
    event engine is instantiated directly only to keep its ports for
    the profile."""
    rep = run.rep
    p = rep.sim_params()
    mode = rep.mode
    # prune_class folds STA (and static_prune=False) to the baseline
    # compile, so the pruned variant is built only when a dynamic-mode
    # run actually requests it
    prune = rep.prune_class == "prune"
    shared = ctx.shared_for(mode)
    oracle_loads = ctx.oracle_loads_if(validate and mode != "STA")
    if mode == "STA" or rep.engine == "cycle":
        res = simulator.simulate_traced(
            ctx.comp(mode, static_prune=prune), ctx.traces, ctx.arrays,
            ctx.params, mode=mode,
            sim=p, engine=rep.engine, oracle_loads=oracle_loads,
            shared=shared, spec_plan=ctx.spec_plan,
        )
        return res, None
    from repro_torch.core import engine_event

    ev = engine_event.EventEngine(
        ctx.comp(mode, static_prune=prune), ctx.traces, ctx.arrays,
        ctx.params, mode, p,
        oracle_loads=oracle_loads, shared=shared, spec=ctx.spec_plan,
    )
    res = ev.run()
    states = {op: _port_state(port) for op, port in ev.ports.items()}
    return res, states


def _run_group_task(args):
    """Execute one group (worker-safe: rebuilds everything from names).

    ``differential`` is the batch-vs-single per-request oracle check
    (the knob ``sweep()`` exposes as ``differential=``)."""
    (group, trace_modes, cache_dir, differential, profile) = args
    validate = differential
    t0 = time.perf_counter()
    ctx = GroupContext(group)
    cache = cachelib.ResultCache(cache_dir) if cache_dir else None
    if "compiled" in trace_modes:
        ctx.check_strict_compiled()
    out: dict[tuple, tuple] = {}
    fus2_states: dict[str, dict] = {}
    profile_skipped: list[str] = []

    def _label(rep):
        # sizing is display-only and may collide across unique runs;
        # disambiguate with the projected sim overrides
        base = f"{rep.sizing}/{rep.engine}"
        if base in fus2_states or base in profile_skipped:
            base = f"{base}{dict(rep.relevant_sim)}"
        return base

    for run in group.runs:
        rep = run.rep
        key = None
        if cache is not None:
            key = cachelib.result_cache_key(
                ctx.program, ctx.arrays, ctx.params, rep.mode,
                "-" if rep.mode == "STA" else rep.engine, rep.relevant_sim,
                speculation=rep.spec_class, predictor=rep.predictor_class,
                static_prune=rep.prune_class,
            )
            # validate=True means "actually check this configuration":
            # cached results carry no validation, so only write-through
            hit = None if (validate and rep.mode != "STA") else cache.get(key)
            if hit is not None:
                out[run.key] = (hit, True, 0.0, key)
                if profile and rep.mode == "FUS2" and rep.engine == "event":
                    # port states are not cached: this config cannot
                    # appear in the slack profile — surface that
                    profile_skipped.append(_label(rep))
                continue
        t1 = time.perf_counter()
        res, states = _execute_run(ctx, run, validate)
        wall = time.perf_counter() - t1
        if cache is not None:
            cache.put(key, res)
        out[run.key] = (res, False, wall, key)
        if profile and states is not None and rep.mode == "FUS2":
            fus2_states[_label(rep)] = states
    prof = _forward_admissibility(ctx, fus2_states) if profile else []
    for row in prof:
        row["class_key"] = group.class_key
    stats = {
        "kernel": group.kernel,
        "scale": group.scale,
        # planner identity — shard.merge_results sorts merged group
        # stats by it to restore the canonical single-host order
        "class_key": group.class_key,
        "points": group.n_points,
        "runs": len(group.runs),
        "cache_hits": sum(1 for r in out.values() if r[1]),
        "wall_s": round(time.perf_counter() - t0, 4),
    }
    if profile_skipped:
        stats["profile_skipped"] = profile_skipped
    return out, stats, prof


# ---------------------------------------------------------------------------
# task execution with retry
# ---------------------------------------------------------------------------


def _surviving_cache_note(group: Group, cache_dir: Optional[str]) -> str:
    """How many of ``group``'s runs already survive in the cache —
    computed defensively: this runs inside failure handling and must
    never mask the original error."""
    if not cache_dir:
        return ""
    try:
        from repro_torch.core import programs

        program, arrays, params = programs.get(group.kernel).make(group.scale)
        cache = cachelib.ResultCache(cache_dir)
        n = sum(
            1
            for run in group.runs
            if os.path.exists(cache._file(cachelib.result_cache_key(
                program, arrays, params, run.rep.mode,
                "-" if run.rep.mode == "STA" else run.rep.engine,
                run.rep.relevant_sim, speculation=run.rep.spec_class,
                predictor=run.rep.predictor_class,
                static_prune=run.rep.prune_class,
            )))
        )
        return (
            f"; surviving cache: {n}/{len(group.runs)} of the group's runs "
            f"already stored under {cache_dir!r} — a resume=True rerun "
            f"skips them"
        )
    except Exception:
        return f"; surviving-cache state unavailable (cache_dir={cache_dir!r})"


def _group_error(
    task, exc: BaseException, attempts: int, cache_dir: Optional[str]
) -> SweepGroupError:
    group = task[0]
    spec_cls = group.class_key[2] if group.class_key else group.speculation
    return SweepGroupError(
        f"sweep group (kernel={group.kernel!r}, scale={group.scale}, "
        f"spec_class={spec_cls!r}) failed after {attempts} attempt(s): "
        f"{type(exc).__name__}: {exc}"
        + _surviving_cache_note(group, cache_dir)
    )


def _transient_types() -> tuple:
    from concurrent.futures.process import BrokenProcessPool

    return (OSError, BrokenProcessPool)


def _execute_tasks(
    tasks: list, workers: int, stats: SweepStats, retries: int,
    backoff_s: float, cache_dir: Optional[str],
):
    """Yield ``(task_index, (out, gstats, prof))`` in completion order.

    Transient failures (``OSError``, a broken spawn pool) are retried
    up to ``retries`` times with exponential backoff — the pool is
    recreated each round, so a poisoned worker process cannot sink
    every remaining group. Anything else (or exhausted retries) raises
    ``SweepGroupError`` naming the group, chained from the original.
    """
    transient = _transient_types()
    pending = list(range(len(tasks)))
    attempt = 0
    while pending:
        failures: list[tuple[int, BaseException]] = []
        if workers > 1 and len(pending) > 1:
            import concurrent.futures as cf
            import multiprocessing as mp

            n = min(workers, len(pending), os.cpu_count() or 1)
            # spawn, not fork: the parent may have initialised CUDA
            # (chip_smoke.py sweeps after driving the card), and a
            # forked child of a CUDA process is unsafe; spawned workers
            # import only numpy and this package's host modules
            with cf.ProcessPoolExecutor(
                max_workers=n, mp_context=mp.get_context("spawn")
            ) as ex:
                futs = {
                    ex.submit(_run_group_task, tasks[i]): i for i in pending
                }
                for fut in cf.as_completed(futs):
                    i = futs[fut]
                    try:
                        yield i, fut.result()
                    except transient as e:
                        failures.append((i, e))
                    except Exception as e:
                        raise _group_error(
                            tasks[i], e, attempt + 1, cache_dir
                        ) from e
        else:
            for i in pending:
                try:
                    yield i, _run_group_task(tasks[i])
                except transient as e:
                    failures.append((i, e))
                except Exception as e:
                    raise _group_error(
                        tasks[i], e, attempt + 1, cache_dir
                    ) from e
        if not failures:
            return
        attempt += 1
        if attempt > retries:
            i, e = failures[0]
            raise _group_error(tasks[i], e, attempt, cache_dir) from e
        delay = backoff_s * (2 ** (attempt - 1))
        for i, e in failures:
            g = tasks[i][0]
            stats.n_retries += 1
            stats.retries.append({
                "group": (g.kernel, g.scale, g.speculation),
                "attempt": attempt,
                "error": f"{type(e).__name__}: {e}",
                "backoff_s": delay,
            })
        if delay > 0:
            time.sleep(delay)
        pending = [i for i, _ in failures]


# ---------------------------------------------------------------------------
# public entry points
# ---------------------------------------------------------------------------


def _sweep_events(
    spec, cache_dir, workers, differential, profile, resume, shard,
    retries, backoff_s,
):
    """Generator core shared by ``sweep()`` and ``iter_points()``:
    yields ``PointResult`` rows as groups complete, returns the final
    ``SweepResult`` (canonical order) as the generator's value."""
    t0 = time.perf_counter()
    points = list(spec.points() if isinstance(spec, SweepSpec) else spec)
    groups = plan(points)
    stats = SweepStats(
        n_points=len(points),
        n_unique_runs=sum(len(g.runs) for g in groups),
    )

    journal = None
    if resume and not cache_dir:
        raise ValueError("resume=True requires cache_dir=")
    if cache_dir:
        journal = cachelib.SweepJournal(cache_dir)
        if resume:
            entries, corrupt = journal.load()
            stats.journal_entries = len(entries)
            stats.journal_corrupt = corrupt

    sel = list(range(len(groups)))
    if shard is not None:
        from repro_torch.dse import shard as shardlib

        idx, n_shards = int(shard[0]), int(shard[1])
        if not (0 <= idx < n_shards):
            raise ValueError(f"shard index {idx} outside 0..{n_shards - 1}")
        sel = shardlib.shard_groups(groups, n_shards).groups_for(idx)
        stats.shard = (idx, n_shards)
        stats.n_points = sum(groups[i].n_points for i in sel)
        stats.n_unique_runs = sum(len(groups[i].runs) for i in sel)
    stats.n_groups = len(sel)

    tasks = []
    for i in sel:
        g = groups[i]
        tms = {points[j].trace_mode for r in g.runs for j in r.point_indices}
        tasks.append((g, tms, cache_dir, differential, profile))

    results: list[Optional[PointResult]] = [None] * len(points)
    outcome_by_task: dict[int, tuple] = {}
    for ti, (out, gstats, prof) in _execute_tasks(
        tasks, workers, stats, retries, backoff_s, cache_dir
    ):
        outcome_by_task[ti] = (out, gstats, prof)
        group = tasks[ti][0]
        for run in group.runs:
            res, cached, wall, key = out[run.key]
            if journal is not None:
                rep = run.rep
                journal.append({
                    "key": key, "kernel": rep.kernel, "scale": rep.scale,
                    "mode": rep.mode, "engine": rep.engine,
                    "sizing": rep.sizing, "cached": bool(cached),
                    "wall_s": round(wall, 4),
                })
            if cached:
                stats.n_cache_hits += 1
                if resume:
                    stats.n_resumed_runs += 1
            else:
                stats.n_executed += 1
            for j in run.point_indices:
                pr = PointResult(
                    point=points[j], result=res, run_key=run.key,
                    cached=cached, run_wall_s=wall,
                )
                results[j] = pr
                yield pr

    # deterministic final assembly: stats/profile in task (= plan) order
    group_stats = [outcome_by_task[ti][1] for ti in range(len(tasks))]
    profile_rows: list = []
    for ti in range(len(tasks)):
        profile_rows.extend(outcome_by_task[ti][2])
    stats.wall_s = time.perf_counter() - t0
    return SweepResult(
        points=results,
        n_points=stats.n_points,
        n_unique_runs=stats.n_unique_runs,
        n_cache_hits=stats.n_cache_hits,
        wall_s=stats.wall_s,
        groups=group_stats,
        profile=profile_rows,
        stats=stats,
    )


def sweep(
    spec: Union[SweepSpec, Sequence[SweepPoint]],
    *,
    cache_dir: Optional[str] = None,
    workers: int = 1,
    differential: bool = False,
    profile: bool = False,
    resume: bool = False,
    on_point=None,
    shard: Optional[tuple] = None,
    retries: int = 2,
    backoff_s: float = 0.25,
    validate: Optional[bool] = None,
) -> SweepResult:
    """Run a batched design-space sweep.

    ``spec`` is a ``SweepSpec`` grid or an explicit point list. Every
    requested point receives a ``SimResult`` **bit-identical to a
    standalone** ``simulate(...)`` **call with the same settings** —
    dedup, trace sharing, CU replay, caching, worker parallelism,
    sharding and resume are all result-invariant (DESIGN.md §9 states
    the argument; the differential tests enforce it).

    ``cache_dir`` enables the on-disk result cache (repeated sweeps
    only pay for new points) and the append-only run journal;
    ``workers > 1`` runs groups in parallel spawn processes;
    ``differential`` turns on per-request oracle validation inside the
    engines — and therefore bypasses cache *reads* for the dynamic
    modes (a cached result carries no validation; results are still
    written through); ``profile`` adds the config-batched §5.5
    forwarding-slack rows to ``SweepResult.profile``. The profile is
    built from recorded port states, so it covers only configs that
    actually ran this sweep — FUS2 runs served from the cache are
    listed under ``profile_skipped`` in their group's stats instead.

    Service knobs (DESIGN.md §13): ``resume=True`` (requires
    ``cache_dir``) re-plans from the surviving cache — only missing
    runs execute, the journal is loaded for accounting and corrupt
    lines are skipped-and-counted; ``on_point`` is called with each
    ``PointResult`` the moment its group completes (completion order);
    ``shard=(i, n)`` executes only shard *i* of the deterministic
    n-way group partition (``dse.shard``); ``retries``/``backoff_s``
    control transient-worker-failure retry.

    ``validate=`` is the deprecated spelling of ``differential=`` (it
    collided with ``simulate(validate=)``, which means oracle *array*
    checking).
    """
    if validate is not None:
        import warnings

        warnings.warn(
            "dse.sweep(validate=) is deprecated: use differential= "
            "(simulate(validate=) means oracle array checking)",
            DeprecationWarning,
            stacklevel=2,
        )
        if differential and differential != validate:
            raise ValueError(
                "both differential= and deprecated validate= were "
                "passed with different values"
            )
        differential = bool(validate)
    gen = _sweep_events(
        spec, cache_dir, workers, differential, profile, resume, shard,
        retries, backoff_s,
    )
    while True:
        try:
            pr = next(gen)
        except StopIteration as stop:
            return stop.value
        if on_point is not None:
            on_point(pr)


def iter_points(
    spec: Union[SweepSpec, Sequence[SweepPoint]],
    *,
    cache_dir: Optional[str] = None,
    workers: int = 1,
    differential: bool = False,
    resume: bool = False,
    shard: Optional[tuple] = None,
    retries: int = 2,
    backoff_s: float = 0.25,
):
    """Generator twin of ``sweep()``: yields each ``PointResult`` as
    its group completes (completion order — deterministic for
    ``workers=1``, interleaved otherwise; the *set* of rows is always
    identical to ``sweep().points``). Use for live dashboards /
    partial Pareto fronts (``launch.analysis.ParetoTracker``) without
    waiting for the full sweep."""
    return (
        pr
        for pr in _sweep_events(
            spec, cache_dir, workers, differential, False, resume, shard,
            retries, backoff_s,
        )
    )
