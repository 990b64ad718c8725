"""Sharded sweep execution: deterministic partition + exact merge.

The port's copy of ``dse/shard.py`` in the JAX package.

A shard is a subset of the planner's (kernel, scale, spec_class,
predictor_class, runahead_class) groups — the same unit ``runner``
parallelizes over, so sharding composes with ``workers`` and the cache
and cannot split a group's shared artifacts across hosts.

The partition is a pure function of the point list and the shard
count: groups are sorted by descending run count (plan index breaking
ties) and greedily assigned to the least-loaded shard (LPT). Every
host running ``sweep_shard(spec, i, n)`` with the same spec therefore
computes the same assignment without any coordination, and
``merge_results()`` reassembles the ``SweepResult`` a single host
would have produced — bit-identically, because group execution is
independent and deterministic (DESIGN.md §13).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

from repro_torch.dse.planner import Group, plan
from repro_torch.dse.spec import SweepPoint, SweepSpec


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Deterministic assignment of planner groups to shards.

    ``assignment[i]`` is the shard index of the i-th group of
    ``planner.plan(points)`` (canonical plan order); ``loads`` the
    resulting per-shard unique-run counts — the balance the LPT
    heuristic achieved (max-min bounded by the largest group).
    """

    n_shards: int
    assignment: tuple  # group index (plan order) -> shard index
    loads: tuple  # per-shard unique-run counts

    def groups_for(self, shard: int) -> list[int]:
        """Plan-order indices of the groups shard ``shard`` owns."""
        if not (0 <= shard < self.n_shards):
            raise ValueError(
                f"shard index {shard} outside 0..{self.n_shards - 1}"
            )
        return [i for i, s in enumerate(self.assignment) if s == shard]


def shard_groups(groups: Sequence[Group], n_shards: int) -> ShardPlan:
    """LPT-partition already-planned ``groups`` across ``n_shards``."""
    n_shards = int(n_shards)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    order = sorted(range(len(groups)), key=lambda i: (-len(groups[i].runs), i))
    loads = [0] * n_shards
    assignment = [0] * len(groups)
    for i in order:
        s = min(range(n_shards), key=lambda j: (loads[j], j))
        assignment[i] = s
        loads[s] += len(groups[i].runs)
    return ShardPlan(
        n_shards=n_shards, assignment=tuple(assignment), loads=tuple(loads)
    )


def shard_plan(
    spec: Union[SweepSpec, Sequence[SweepPoint]], n_shards: int
) -> ShardPlan:
    """Partition a spec's planner groups across ``n_shards`` —
    deterministic: same spec, same count, same plan on every host."""
    points = list(spec.points() if isinstance(spec, SweepSpec) else spec)
    return shard_groups(plan(points), n_shards)


def sweep_shard(
    spec: Union[SweepSpec, Sequence[SweepPoint]],
    shard: int,
    n_shards: int,
    **kwargs,
):
    """Run shard ``shard`` of ``n_shards`` of a sweep.

    Thin wrapper over ``runner.sweep(shard=(shard, n_shards))`` —
    accepts the same keyword arguments (``cache_dir``, ``workers``,
    ``resume``, ``on_point``, ...). The returned ``SweepResult`` keeps
    the full-length point list with ``None`` at indices other shards
    own, counts only its own points/runs, and marks
    ``stats.shard=(shard, n_shards)``; feed all shards to
    ``merge_results()``.
    """
    from repro_torch.dse import runner

    return runner.sweep(spec, shard=(int(shard), int(n_shards)), **kwargs)


def merge_results(shards: Sequence):
    """Union per-shard ``SweepResult``s into the single-host result.

    Validates the shards form an exact partition (every point owned by
    exactly one shard, shard indices distinct, one shard count) and
    splices points back into canonical order; group stats and profile
    rows are re-sorted by the planner's ``class_key`` order, counters
    are summed, and ``wall_s`` is the max over shards (they run
    concurrently). The result is bit-identical to
    ``runner.sweep(spec)`` run unsharded — pinned by
    tests/test_torch_sweep_service.py and ``chip_smoke.py``.
    """
    from repro_torch.dse.runner import SweepStats

    shards = list(shards)
    if not shards:
        raise ValueError("merge_results: no shard results")
    n_total = len(shards[0].points)
    counts = {
        s.stats.shard[1] if s.stats and s.stats.shard else None
        for s in shards
    }
    if len(counts) != 1 or None in counts:
        raise ValueError(
            "merge_results: inputs must all be sharded results from one "
            f"shard count, got shard markers {sorted(map(str, counts))}"
        )
    seen_idx = set()
    points: list = [None] * n_total
    for s in shards:
        if len(s.points) != n_total:
            raise ValueError(
                "merge_results: shard point lists disagree in length "
                f"({len(s.points)} vs {n_total}) — different specs?"
            )
        idx = s.stats.shard[0]
        if idx in seen_idx:
            raise ValueError(f"merge_results: duplicate shard index {idx}")
        seen_idx.add(idx)
        for i, pr in enumerate(s.points):
            if pr is None:
                continue
            if points[i] is not None:
                raise ValueError(
                    f"merge_results: point {i} owned by more than one shard"
                )
            points[i] = pr
    missing = [i for i, pr in enumerate(points) if pr is None]
    if missing:
        raise ValueError(
            f"merge_results: {len(missing)} point(s) owned by no shard "
            f"(first: {missing[0]}) — pass every shard of the partition"
        )

    tagged = []
    profile_rows = []
    for s in sorted(shards, key=lambda s: s.stats.shard[0]):
        tagged.extend(s.groups)
        profile_rows.extend(s.profile)
    group_stats = sorted(
        tagged, key=lambda g: tuple(map(str, g.get("class_key", ())))
    )
    profile_rows = sorted(
        profile_rows, key=lambda r: tuple(map(str, r.get("class_key", ())))
    )

    stats = SweepStats(
        n_groups=sum(s.stats.n_groups for s in shards),
        n_points=sum(s.stats.n_points for s in shards),
        n_unique_runs=sum(s.stats.n_unique_runs for s in shards),
        n_cache_hits=sum(s.stats.n_cache_hits for s in shards),
        n_executed=sum(s.stats.n_executed for s in shards),
        n_retries=sum(s.stats.n_retries for s in shards),
        retries=[r for s in shards for r in s.stats.retries],
        n_resumed_runs=sum(s.stats.n_resumed_runs for s in shards),
        journal_entries=sum(s.stats.journal_entries for s in shards),
        journal_corrupt=sum(s.stats.journal_corrupt for s in shards),
        shard=None,
        wall_s=max(s.stats.wall_s for s in shards),
    )
    return dataclasses.replace(
        shards[0],
        points=points,
        n_points=stats.n_points,
        n_unique_runs=stats.n_unique_runs,
        n_cache_hits=stats.n_cache_hits,
        wall_s=stats.wall_s,
        groups=group_stats,
        profile=profile_rows,
        stats=stats,
    )


def merge_caches(dst: str, *srcs: str) -> int:
    """Copy every cache entry (and journal line) absent from ``dst``
    out of the ``srcs`` cache directories; returns the number of npz
    entries copied. Content-addressed names make this a union — no
    entry can conflict."""
    import os
    import shutil

    from repro_torch.dse import cache as cachelib

    os.makedirs(dst, exist_ok=True)
    copied = 0
    journal = cachelib.SweepJournal(dst)
    for src in srcs:
        if not os.path.isdir(src):
            continue
        for fn in sorted(os.listdir(src)):
            if fn.endswith(".npz"):
                target = os.path.join(dst, fn)
                if not os.path.exists(target):
                    shutil.copyfile(os.path.join(src, fn), target)
                    copied += 1
        src_journal = cachelib.SweepJournal(src)
        entries, _corrupt = src_journal.load()
        for e in entries:
            journal.append(e)
    return copied
