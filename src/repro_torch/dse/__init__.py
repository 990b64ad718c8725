"""Batched design-space exploration over the DU simulator (DESIGN.md §9).

The port's copy of ``dse/`` in the JAX package, with the same public
surface. Like the simulator it drives, it is host code: numpy and
plain Python, importing neither torch nor any kernel, so the sweep's
spawned workers start without either.

The paper's headline numbers come from sweeping configurations — DU
sizings, schedules, systems — across the nine Table-1 kernels, not from
single points. This package turns the three single-shot layers
(compile front-end, AGU trace compiler, simulator engines) into a
many-point service:

  * ``SweepSpec`` (``dse.spec``) — a grid/list of sweep points:
    kernel × scale × mode × engine × trace_mode × speculation ×
    ``SimParams`` sizing.
  * the planner (``dse.planner``) — groups points by (kernel, scale,
    speculation class), **deduplicates** points whose results are
    provably identical (trace modes produce bit-identical streams; STA
    ignores the engine; the speculation knob folds for kernels that
    never speculate), and builds per-group shared artifacts: one
    compiled trace set (plus its ``speculate.SpecPlan`` when the group
    speculates), one hazard analysis per forwarding class, one hooked
    oracle run, shared §5.6 bit streams / LSQ rank tables, and recorded
    CU scripts replayed per timing point (``dae.ReplayCU``).
  * the runner (``dse.runner``) — exact per-point engine runs on the
    shared artifacts (bit-identical to standalone ``simulate()``),
    optionally parallel across groups, with a config-batched
    forwarding-admissibility profile through ``du.check_pair_batch``.
  * the cache (``dse.cache``) — an on-disk result store keyed by
    (code version, program, arrays, params, mode, engine, sizing) so
    repeated sweeps are incremental, plus the append-only run journal.
  * the sweep service layer (DESIGN.md §13) — ``shard``/
    ``sweep_shard``/``merge_results`` for deterministic multi-host
    partitions, ``sweep(resume=True)`` to restart from the surviving
    cache, ``sweep(on_point=...)``/``iter_points()`` for streaming
    observability, and ``calibrate`` to fit ``SimParams`` against the
    paper's per-iteration cycle targets.

Entry point::

    from repro_torch import dse
    res = dse.sweep(dse.SweepSpec(kernels=["bnn"], modes=["STA", "FUS2"]))
    for row in res.rows():
        print(row["kernel"], row["mode"], row["cycles"])

Evidence: tests/test_torch_dse.py and tests/test_torch_sweep_service.py
hold every row, shard merge, resume and calibration fit equal to the
JAX package's; ``chip_smoke.py``'s DSE phase runs the sweep at the
benchmark's width and the calibration at ``BENCH_CALIB.json``'s scales,
holding points against standalone ``simulate()`` and the fit against
that record.
"""

from repro_torch.dse.cache import ResultCache, SweepJournal, code_version
from repro_torch.dse.calibrate import CalibResult, calibrate, iteration_count
from repro_torch.dse.planner import plan
from repro_torch.dse.runner import (
    SweepGroupError,
    SweepResult,
    SweepStats,
    iter_points,
    sweep,
)
from repro_torch.dse.shard import (
    ShardPlan,
    merge_caches,
    merge_results,
    shard_plan,
    sweep_shard,
)
from repro_torch.dse.spec import RESULT_INERT_FIELDS, SweepPoint, SweepSpec, result_projection

__all__ = [
    "SweepPoint",
    "SweepSpec",
    "SweepResult",
    "SweepStats",
    "SweepGroupError",
    "SweepJournal",
    "ShardPlan",
    "CalibResult",
    "RESULT_INERT_FIELDS",
    "ResultCache",
    "calibrate",
    "code_version",
    "iter_points",
    "iteration_count",
    "merge_caches",
    "merge_results",
    "plan",
    "result_projection",
    "shard_plan",
    "sweep",
    "sweep_shard",
]
