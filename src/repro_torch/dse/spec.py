"""Sweep specification: the configuration grid of a design-space run.

The port's copy of ``dse/spec.py`` in the JAX package, with the same
axes, folds and result identity. Only the imports differ, and the
``backend`` comment below: the port's backends are ``numpy`` and
``torch``, and its ``RunConfig`` defaults to ``"torch"``; ``backend``
stays result-inert, so that default splits no result key.

A *sweep point* is one fully specified simulation:
``(kernel, scale, mode, engine, trace_mode, speculation, SimParams
sizing)``. A ``SweepSpec`` expands a grid (or several stacked grids)
into points.

Two distinct notions of identity matter downstream:

  * ``point_id`` — the user-facing identity; every requested point gets
    its own row in the sweep result.
  * ``result_key`` — the *result* identity used for dedup and caching:
    points that provably produce bit-identical ``SimResult``s share it.
    Three result-invariances fold points together (DESIGN.md §9.1):

      1. ``trace_mode`` is excluded entirely (compiled and interpreted
         AGU streams are bit-for-bit equal — the trace compiler's
         contract, asserted by tests/test_torch_trace_compile.py),
      2. ``engine`` is excluded for STA (the analytical model never
         runs an engine),
      3. the ``SimParams`` overrides are **projected onto the fields
         the mode actually reads** (``MODE_SIM_FIELDS``): STA never
         reads CU/forwarding latencies, the dynamic engines never read
         ``sta_mem_dep_ii``/``pipeline_fill``, LSQ forces burst size 1,
         and FUS1/LSQ never forward — so e.g. a calibration grid over
         ``sta_mem_dep_ii`` x all four systems re-runs only STA,
      4. the ``speculation`` knob folds to ``"-"`` for kernels the
         decoupling pass never marks speculative (``spec_class``) —
         ``"off"`` and ``"auto"`` provably share results there, and
         ``squash_latency`` overrides are projected out with it,
      5. the ``predictor`` knob (and ``spec_runahead`` overrides) fold
         the same way (``predictor_class``/``runahead_class``): they
         only reach a result through a live ``SpecPlan``, so they are
         dead code — and projected out — unless the point speculates.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Union

from repro_torch.core import programs
from repro_torch.core.config import ConfigConflict, RunConfig
from repro_torch.core.dae import PREDICTORS
from repro_torch.core.simulator import SimParams

MODES = ("STA", "LSQ", "FUS1", "FUS2")
ENGINES = ("cycle", "event")
TRACE_MODES = ("auto", "compiled", "interp")
SPECULATIONS = ("off", "auto")

# RunConfig fields that never enter the result identity, with the proof
# obligation that keeps them honest (tests/test_torch_dse.py pins that
# every RunConfig field is either projected into result_projection()'s
# output or listed here):
#   trace_mode         — compiled/interp streams are bit-equal
#   backend            — numpy/torch replay the same WavePlan
#                        (tests/test_torch_parity.py)
#   batch_waves        — batching coarsens steps, never results
#   symbolic_admission — admission fast path emits bit-identical steps
#   validate_hints     — a checker: raises or changes nothing
RESULT_INERT_FIELDS = (
    "trace_mode", "backend", "batch_waves", "symbolic_admission",
    "validate_hints",
)

_SIM_FIELDS = tuple(f.name for f in dataclasses.fields(SimParams))

# SimParams fields each mode actually reads (audited against
# simulator._simulate_sta and the two engines; the batch-vs-single
# differential in tests/test_dse.py would catch any drift). The result
# identity of a point projects its overrides onto this set.
# ``squash_latency`` and ``spec_runahead`` are additionally projected
# out unless the point actually speculates
# (``SweepPoint.spec_class == "auto"``) — the engines only read them
# through a live SpecPlan.
_DYN_COMMON = (
    "dram_latency", "burst_timeout", "channel_occupancy", "cu_latency",
    "max_cycles", "fifo_depth", "fifo_latency",
)
_SPEC_FIELDS = ("squash_latency", "spec_runahead")
MODE_SIM_FIELDS = {
    "STA": (
        "dram_latency", "burst_size", "channel_occupancy",
        "pipeline_fill", "sta_mem_dep_ii",
    ),
    "LSQ": _DYN_COMMON + _SPEC_FIELDS,  # burst 1; never forwards
    "FUS1": _DYN_COMMON + ("burst_size",) + _SPEC_FIELDS,
    "FUS2": _DYN_COMMON + ("burst_size", "forward_latency") + _SPEC_FIELDS,
}


def _canon_sim(sim: Union[None, dict, SimParams]) -> tuple:
    """Canonical sorted (field, value) tuple of non-default overrides."""
    if sim is None:
        return ()
    if isinstance(sim, SimParams):
        sim = dataclasses.asdict(sim)
    elif isinstance(sim, (tuple, list)):
        sim = dict(sim)
    default = SimParams()
    out = []
    for k in sorted(sim):
        if k not in _SIM_FIELDS:
            raise ValueError(f"unknown SimParams field {k!r}")
        v = int(sim[k])
        if v != getattr(default, k):
            out.append((k, v))
    return tuple(out)


# -- the result-identity projection (DESIGN.md §9.1) -------------------------
# Module-level so SweepPoint's properties and result_projection() share
# one implementation: the result invariances live in exactly one place.


def _spec_class(kernel: str, speculation: str) -> str:
    if not programs.REGISTRY[kernel].speculative:
        return "-"
    return speculation


def _predictor_class(mode: str, spec_cls: str, predictor: str) -> str:
    if mode == "STA" or spec_cls != "auto":
        return "-"
    return predictor


def _runahead_class(mode: str, spec_cls: str, sim: tuple) -> Union[str, int]:
    if mode == "STA" or spec_cls != "auto":
        return "-"
    return int(dict(sim).get("spec_runahead", SimParams().spec_runahead))


def _relevant_sim(mode: str, spec_cls: str, sim: tuple) -> tuple:
    fields = MODE_SIM_FIELDS[mode]
    if spec_cls != "auto":
        fields = tuple(f for f in fields if f not in _SPEC_FIELDS)
    return tuple((k, v) for k, v in sim if k in fields)


def _prune_class(mode: str, static_prune: bool) -> str:
    if mode == "STA" or not static_prune:
        return "-"
    return "prune"


def _merge_config_sim(config: RunConfig, sim) -> tuple:
    """Fold a RunConfig's SimParams overrides into a sizing, canonical
    tuple out; a field explicitly present in both with different values
    raises ``ConfigConflict``."""
    merged = dict(_canon_sim(sim))
    for f, v in config.sim_overrides().items():
        if f in merged and merged[f] != v:
            raise ConfigConflict(
                f"sizing sets {f}={merged[f]} but config=RunConfig "
                f"carries {f}={v}"
            )
        merged[f] = v
    return _canon_sim(merged)


def result_projection(
    kernel: str, scale: int, config: RunConfig, sim=()
) -> tuple:
    """Project one run configuration onto its *result identity* — THE
    single place the DSE dedup key and the on-disk cache key derive
    from a ``RunConfig``.

    ``sim`` carries SimParams overrides (dict / canonical tuple /
    ``SimParams``); the config's non-``None`` sim fields fold in first.
    The output tuple is ``(kernel, scale, mode, engine_class,
    relevant_sim, spec_class, predictor_class, prune_class)`` with the
    result invariances applied (``SweepPoint.result_key`` delegates
    here; fields listed in ``RESULT_INERT_FIELDS`` are dropped by
    construction).
    """
    sim_t = _merge_config_sim(config, sim)
    spec_cls = _spec_class(kernel, config.speculation)
    return (
        kernel, int(scale), config.mode,
        "-" if config.mode == "STA" else config.engine,
        _relevant_sim(config.mode, spec_cls, sim_t),
        spec_cls,
        _predictor_class(config.mode, spec_cls, config.predictor),
        _prune_class(config.mode, config.static_prune),
    )


@dataclasses.dataclass(frozen=True)
class SweepPoint:
    """One simulation configuration of the design space."""

    kernel: str  # a programs.REGISTRY name
    scale: int
    mode: str = "FUS2"
    engine: str = "event"
    trace_mode: str = "auto"
    sim: tuple = ()  # canonical ((field, value), ...) SimParams overrides
    sizing: str = "base"  # display label for the sim overrides
    speculation: str = "off"  # loss-of-decoupling policy (DESIGN.md §10)
    predictor: str = "auto"  # speculative-AGU value predictor (dae.PREDICTORS)
    # hazard-plan variant (DESIGN.md §12): certifier-proven forced-pass
    # pairs dropped before pruning. Results are proven bit-identical to
    # the baseline plan (tests/test_deps.py); the axis exists to A/B
    # planner cost and pair counts at sweep scale
    static_prune: bool = False

    def __post_init__(self):
        assert self.kernel in programs.REGISTRY, f"unknown kernel {self.kernel!r}"
        assert self.mode in MODES, f"unknown mode {self.mode!r}"
        assert self.engine in ENGINES, f"unknown engine {self.engine!r}"
        assert self.trace_mode in TRACE_MODES, (
            f"unknown trace mode {self.trace_mode!r}"
        )
        assert self.speculation in SPECULATIONS, (
            f"unknown speculation mode {self.speculation!r}"
        )
        assert self.predictor in PREDICTORS, (
            f"unknown predictor {self.predictor!r}"
        )
        object.__setattr__(self, "sim", _canon_sim(self.sim))

    def sim_params(self) -> SimParams:
        return dataclasses.replace(SimParams(), **dict(self.sim))

    @property
    def point_id(self) -> tuple:
        return (
            self.kernel, self.scale, self.mode, self.engine,
            self.trace_mode, self.sim, self.speculation, self.predictor,
            self.static_prune,
        )

    @property
    def config(self) -> RunConfig:
        """This point's knobs as a ``repro_torch.core.config.RunConfig``.

        SimParams overrides stay in ``self.sim`` (the config's three
        sim-overlap fields remain ``None`` = inherit); the
        executor-only fields keep their defaults — both are result-
        inert here by construction.
        """
        return RunConfig(
            mode=self.mode, engine=self.engine, trace_mode=self.trace_mode,
            speculation=self.speculation, predictor=self.predictor,
            static_prune=self.static_prune,
        )

    @property
    def spec_class(self) -> str:
        """Speculation part of the result identity: ``"-"`` for kernels
        that never speculate (the knob provably cannot change their
        result — ``decouple`` marks no PE, so ``"off"`` and ``"auto"``
        fold together), else the knob value itself."""
        return _spec_class(self.kernel, self.speculation)

    @property
    def predictor_class(self) -> str:
        """Predictor part of the result identity: ``"-"`` unless the
        point actually speculates (``spec_class == "auto"``) — on
        everything else the predictor knob is dead code and every value
        folds to one result. STA folds too: the analytical model never
        consults the SpecPlan."""
        return _predictor_class(self.mode, self.spec_class, self.predictor)

    @property
    def runahead_class(self) -> Union[str, int]:
        """Run-ahead-window part of the result identity: ``"-"`` unless
        the point speculates, else the resolved ``spec_runahead``
        (override or default) — it only reaches a result through a live
        ``SpecPlan`` (``"-"`` for STA, as ``predictor_class``)."""
        return _runahead_class(self.mode, self.spec_class, self.sim)

    @property
    def relevant_sim(self) -> tuple:
        """``sim`` projected onto the fields this point's mode reads
        (``MODE_SIM_FIELDS``) — the SimParams part of the result
        identity. ``squash_latency``/``spec_runahead`` only count when
        the point actually speculates."""
        return _relevant_sim(self.mode, self.spec_class, self.sim)

    @property
    def prune_class(self) -> str:
        """Hazard-plan-variant part of the result identity: ``"-"`` for
        the baseline plan, ``"prune"`` with ``static_prune``. The
        certifier's drops are *proven* timing-invisible, but unlike the
        registry-metadata folds (``spec_class``) that proof rests on
        the certifier itself — keying the variants separately means a
        certifier bug can never silently serve a baseline cache entry
        for a pruned point (or vice versa). The certifier's code is in
        the cache's ``code_version`` (repro_torch.analysis is hashed), so
        verdict changes invalidate pruned entries wholesale. STA folds
        to ``"-"``: it consumes ``all_pairs``, which static pruning
        provably leaves unchanged (drops land in ``plan.pruned``)."""
        return _prune_class(self.mode, self.static_prune)

    @property
    def result_key(self) -> tuple:
        """Dedup/cache identity: what the SimResult depends on.

        Excludes ``trace_mode`` entirely, ``engine`` for STA, any
        SimParams override the mode never reads, and folds the
        speculation and predictor knobs for non-speculative kernels
        (``spec_class``/``predictor_class``) — the result-invariances
        the planner exploits (DESIGN.md §9.1). The hazard-plan variant
        travels as ``prune_class``. Delegates to
        ``result_projection()`` — the one projection implementation.
        """
        return result_projection(self.kernel, self.scale, self.config, self.sim)


@dataclasses.dataclass
class SweepSpec:
    """A grid of sweep points (cross product of the axes).

    ``sizings`` maps a label to ``SimParams`` overrides (a dict of
    field -> value, or a full ``SimParams``); ``{"base": {}}`` is the
    default timing model. ``scales`` maps kernel -> problem scale and
    defaults to each kernel's registered ``default_scale`` divided by
    ``scale_div`` (tests use large divisors to stay tiny). Several
    grids can be stacked via ``extra`` (e.g. an STA-only engine grid);
    duplicate points are dropped at expansion.

    ``config=`` seeds the grid from a ``repro_torch.core.config.RunConfig``:
    every axis left at its default collapses to the config's value
    (``SweepSpec(config=RunConfig(mode="STA"))`` sweeps only STA), an
    explicitly set axis wins unless the config field is *also*
    non-default and absent from the axis — that raises
    ``ConfigConflict``. The config's non-``None``
    ``spec_runahead``/``fifo_depth``/``fifo_latency`` fold into every
    sizing (conflicting sizing values raise).
    """

    kernels: Sequence[str] = tuple(programs.TABLE1)
    scales: Optional[dict] = None
    scale_div: int = 1
    modes: Sequence[str] = ("STA", "LSQ", "FUS1", "FUS2")
    engines: Sequence[str] = ("event",)
    trace_modes: Sequence[str] = ("auto",)
    sizings: Optional[dict] = None
    # loss-of-decoupling axis: sweeps over speculative kernels need
    # ("auto",) — an "off" point on such a kernel raises exactly like
    # standalone simulate() would
    speculations: Sequence[str] = ("off",)
    # speculative-AGU predictor axis (dae.PREDICTORS); folds to one
    # result for points that never speculate (predictor_class)
    predictors: Sequence[str] = ("auto",)
    # hazard-plan-variant axis (DESIGN.md §12): certifier-dropped
    # forced-pass pairs on/off; results are proven bit-identical, the
    # axis A/Bs planner cost and pair counts
    static_prunes: Sequence[bool] = (False,)
    extra: Sequence["SweepSpec"] = ()
    # a RunConfig seeding every defaulted axis (see class docstring)
    config: Optional[RunConfig] = None

    def _axis(self, axis_name: str, cfg_field: str) -> tuple:
        """Resolve one axis against ``self.config`` (see docstring)."""
        val = tuple(getattr(self, axis_name))
        if self.config is None:
            return val
        cfg_v = getattr(self.config, cfg_field)
        if val != tuple(SweepSpec.__dataclass_fields__[axis_name].default):
            cfg_default = RunConfig.__dataclass_fields__[cfg_field].default
            if cfg_v != cfg_default and cfg_v not in val:
                raise ConfigConflict(
                    f"SweepSpec.{axis_name}={val} does not contain the "
                    f"explicit config value {cfg_field}={cfg_v!r}"
                )
            return val
        return (cfg_v,)

    def points(self) -> list[SweepPoint]:
        sizings = self.sizings if self.sizings is not None else {"base": {}}
        if self.config is not None and self.config.sim_overrides():
            sizings = {
                label: dict(_merge_config_sim(self.config, sim))
                for label, sim in sizings.items()
            }
        out: list[SweepPoint] = []
        seen: set[tuple] = set()
        for k in self.kernels:
            if self.scales is not None:
                scale = int(self.scales[k])
            else:
                scale = max(programs.REGISTRY[k].default_scale // self.scale_div, 8)
            for mode in self._axis("modes", "mode"):
                for engine in self._axis("engines", "engine"):
                    for tm in self._axis("trace_modes", "trace_mode"):
                        for spec_mode in self._axis("speculations", "speculation"):
                            for pred in self._axis("predictors", "predictor"):
                                for sp in self._axis("static_prunes", "static_prune"):
                                    for label, sim in sizings.items():
                                        p = SweepPoint(
                                            kernel=k, scale=scale, mode=mode,
                                            engine=engine, trace_mode=tm,
                                            sim=_canon_sim(sim), sizing=label,
                                            speculation=spec_mode,
                                            predictor=pred,
                                            static_prune=bool(sp),
                                        )
                                        if p.point_id not in seen:
                                            seen.add(p.point_id)
                                            out.append(p)
        for sub in self.extra:
            for p in sub.points():
                if p.point_id not in seen:
                    seen.add(p.point_id)
                    out.append(p)
        return out
