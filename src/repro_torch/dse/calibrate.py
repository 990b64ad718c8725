"""Sweep-driven calibration of ``SimParams`` against the paper's
per-iteration cycle counts (DESIGN.md §13).

The port's copy of ``dse/calibrate.py`` in the JAX package: the same
targets, grids and two-stage fit.

The paper's Table 1 reports per-iteration cycles (cycles / innermost
loop iterations at 286 MHz) for every benchmark under the static
baseline and the fused dynamic design. ``simulator.SimParams`` was
hand-calibrated against those numbers (the ``sta_mem_dep_ii`` comment
in ``simulator.py``); this module replaces the hand fit with a sweep:

  * ``iteration_count()`` measures a kernel's innermost-loop iteration
    total from the oracle walk (one ``trace_hook`` event per iteration
    of the first direct memory op of each innermost loop), so
    *measured* per-iteration cycles are ``SimResult.cycles / iters``;
  * ``calibrate()`` runs ``dse.sweep`` grids over the timing fields
    (``sta_mem_dep_ii`` for the STA targets; ``dram_latency`` x
    ``forward_latency`` for the FUS2 targets) and picks the values
    minimizing the mean relative error against ``STA_TARGETS_CPI`` /
    ``FUS2_TARGETS_CPI`` — the dedup/caching of the DSE engine make
    the grid cheap (STA grids re-run only the analytical model).

``BENCH_CALIB.json`` holds the JAX package's fit at benchmark scale
(fitted fields + per-kernel relative errors); ``chip_smoke.py`` runs
this fit at the same scales and holds it equal to that record.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import loopir as ir
from repro_torch.core import programs
from repro_torch.core.simulator import SimParams

# Paper Table-1 per-iteration cycle targets (cycles/iter at 286 MHz)
# for the kernels whose structure this repro reproduces faithfully
# enough to calibrate against. STA targets pin the static memory-
# dependence II (hist+add's ~110 cycles/iter static pipeline is the
# number the original hand calibration in simulator.py cited); FUS2
# targets pin the dynamic path (DRAM round-trip + forwarding).
STA_TARGETS_CPI = {
    "hist+add": 110.0,
    "tanh+spmv": 225.0,
    "pagerank": 200.0,
}
FUS2_TARGETS_CPI = {
    "hist+add": 110.0,
    "tanh+spmv": 47.0,
    "pagerank": 40.0,
}

# default search grids: centred generously around the hand-calibrated
# values so the fit can contradict them (it does: see BENCH_CALIB.json,
# the JAX package's fit)
STA_II_GRID = (96, 128, 160, 192, 224, 256, 288)
DRAM_GRID = (100, 150, 200, 300, 400)
FWD_GRID = (1, 2, 4)


@dataclasses.dataclass
class CalibResult:
    """Outcome of one ``calibrate()`` fit.

    ``fitted`` maps each swept SimParams field to its error-minimizing
    value; ``params`` is a full ``SimParams`` with the fit applied;
    ``per_field`` records each field's grid and the mean relative
    error at every grid value (the fit curve); ``per_kernel`` the
    per-kernel measured/target per-iteration cycles and relative error
    *at the fitted values*; ``mean_rel_err`` the overall objective at
    the optimum.
    """

    fitted: dict
    params: SimParams
    per_field: dict
    per_kernel: dict
    mean_rel_err: float
    scales: dict = dataclasses.field(default_factory=dict)
    iters: dict = dataclasses.field(default_factory=dict)


def iteration_count(
    program: ir.Program, arrays: dict, params: Optional[dict] = None
) -> int:
    """Total innermost-loop iterations of one program execution.

    Counted exactly from the oracle walk: for each innermost loop (no
    nested ``Loop`` in its body) the first direct memory op fires one
    ``trace_hook`` event per iteration — guard-false stores included —
    so its event count *is* the loop's dynamic iteration total.
    """
    probes: set[str] = set()
    seen_loops: set[int] = set()
    for op, path in program.mem_ops():
        loop = path[-1]
        if any(isinstance(s, ir.Loop) for s in loop.body):
            continue  # op sits directly in a non-innermost loop
        if id(loop) in seen_loops:
            continue
        seen_loops.add(id(loop))
        probes.add(op.id)
    counts = {op_id: 0 for op_id in probes}

    def hook(op_id, addr, is_store, valid, value):
        if op_id in counts:
            counts[op_id] += 1

    work = {k: v.copy() for k, v in arrays.items()}
    ir.interpret(program, work, params or {}, trace_hook=hook)
    return sum(counts.values())


def _cpi_by_kernel(result, iters: dict) -> dict:
    """kernel -> cycles/iteration for one sweep's rows (one row per
    kernel expected)."""
    out = {}
    for row in result.rows():
        out[row["kernel"]] = row["cycles"] / iters[row["kernel"]]
    return out


# a grid value must beat the SimParams default by more than this mean-
# relative-error margin to displace it — a flat fit curve (the field is
# not identified by the targets) keeps the default instead of chasing
# noise (forward_latency is the live example: its curve is flat to
# ~0.3% in the JAX package's BENCH_CALIB.json)
IDENTIFIABILITY_MARGIN = 0.005


def _fit_axis(
    mode: str,
    targets: dict,
    sizings: dict,
    scales: dict,
    iters: dict,
    cache_dir: Optional[str],
    workers: int,
    default_label: Optional[str] = None,
) -> tuple[str, dict]:
    """Sweep ``sizings`` over ``targets``' kernels in ``mode``; return
    (best sizing label, {label: {"err", "cpi"}}). ``default_label``
    names the sizing equal to the SimParams defaults; it wins unless
    some grid value beats it by ``IDENTIFIABILITY_MARGIN``."""
    from repro_torch.dse import runner
    from repro_torch.dse.spec import SweepSpec

    spec = SweepSpec(
        kernels=tuple(sorted(targets)),
        scales={k: scales[k] for k in targets},
        modes=(mode,),
        sizings=sizings,
    )
    res = runner.sweep(spec, cache_dir=cache_dir, workers=workers)
    by_label: dict = {label: {} for label in sizings}
    for row in res.rows():
        cpi = row["cycles"] / iters[row["kernel"]]
        by_label[row["sizing"]][row["kernel"]] = cpi
    curve = {}
    for label, cpis in by_label.items():
        errs = [
            abs(cpis[k] - targets[k]) / targets[k] for k in sorted(targets)
        ]
        curve[label] = {
            "err": sum(errs) / len(errs),
            "cpi": {k: round(cpis[k], 3) for k in sorted(targets)},
        }
    best = min(sorted(curve), key=lambda l: curve[l]["err"])
    if (
        default_label is not None
        and default_label in curve
        and curve[default_label]["err"]
        <= curve[best]["err"] + IDENTIFIABILITY_MARGIN
    ):
        best = default_label
    return best, curve


def calibrate(
    scales: Optional[dict] = None,
    scale_div: int = 4,
    sta_grid: tuple = STA_II_GRID,
    dram_grid: tuple = DRAM_GRID,
    fwd_grid: tuple = FWD_GRID,
    cache_dir: Optional[str] = None,
    workers: int = 1,
) -> CalibResult:
    """Fit ``sta_mem_dep_ii`` (STA stage) then ``dram_latency`` x
    ``forward_latency`` (FUS2 stage) against the Table-1 per-iteration
    cycle targets, minimizing mean relative error per stage.

    ``scales`` overrides the per-kernel problem scale (default: each
    kernel's ``default_scale // scale_div``); larger scales amortize
    pipeline fill and stabilize cycles/iter. Deterministic: same
    inputs, same fit.
    """
    kernels = sorted(set(STA_TARGETS_CPI) | set(FUS2_TARGETS_CPI))
    if scales is None:
        scales = {
            k: max(programs.REGISTRY[k].default_scale // scale_div, 16)
            for k in kernels
        }
    iters = {}
    for k in kernels:
        program, arrays, params = programs.get(k).make(scales[k])
        iters[k] = iteration_count(program, arrays, params)

    defaults = SimParams()

    # stage 1: STA memory-dependence II (default joins the grid so the
    # identifiability rule can compare against it)
    sta_values = sorted(set(sta_grid) | {defaults.sta_mem_dep_ii})
    sta_sizings = {f"sta_mem_dep_ii={v}": {"sta_mem_dep_ii": v} for v in sta_values}
    sta_best, sta_curve = _fit_axis(
        "STA", STA_TARGETS_CPI, sta_sizings, scales, iters, cache_dir,
        workers,
        default_label=f"sta_mem_dep_ii={defaults.sta_mem_dep_ii}",
    )
    fitted = {"sta_mem_dep_ii": dict(sta_sizings[sta_best])["sta_mem_dep_ii"]}

    # stage 2: dynamic-path latencies (joint grid), II fixed at stage-1
    dyn_sizings = {}
    for d in sorted(set(dram_grid) | {defaults.dram_latency}):
        for f in sorted(set(fwd_grid) | {defaults.forward_latency}):
            dyn_sizings[f"dram_latency={d},forward_latency={f}"] = {
                "dram_latency": d, "forward_latency": f,
            }
    dyn_best, dyn_curve = _fit_axis(
        "FUS2", FUS2_TARGETS_CPI, dyn_sizings, scales, iters, cache_dir,
        workers,
        default_label=(
            f"dram_latency={defaults.dram_latency},"
            f"forward_latency={defaults.forward_latency}"
        ),
    )
    fitted.update(dyn_sizings[dyn_best])

    params = dataclasses.replace(SimParams(), **fitted)
    per_kernel = {}
    errs = []
    for k in kernels:
        per_kernel[k] = {}
        if k in STA_TARGETS_CPI:
            cpi = sta_curve[sta_best]["cpi"][k]
            rel = abs(cpi - STA_TARGETS_CPI[k]) / STA_TARGETS_CPI[k]
            per_kernel[k]["STA"] = {
                "target_cpi": STA_TARGETS_CPI[k], "fitted_cpi": cpi,
                "rel_err": round(rel, 4),
            }
            errs.append(rel)
        if k in FUS2_TARGETS_CPI:
            cpi = dyn_curve[dyn_best]["cpi"][k]
            rel = abs(cpi - FUS2_TARGETS_CPI[k]) / FUS2_TARGETS_CPI[k]
            per_kernel[k]["FUS2"] = {
                "target_cpi": FUS2_TARGETS_CPI[k], "fitted_cpi": cpi,
                "rel_err": round(rel, 4),
            }
            errs.append(rel)
    return CalibResult(
        fitted=fitted,
        params=params,
        per_field={
            "sta_mem_dep_ii": {"best": sta_best, "curve": sta_curve},
            "dram_latency,forward_latency": {
                "best": dyn_best, "curve": dyn_curve,
            },
        },
        per_kernel=per_kernel,
        mean_rel_err=round(sum(errs) / len(errs), 4),
        scales=dict(scales),
        iters=dict(iters),
    )
