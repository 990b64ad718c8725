"""Unified run configuration: one frozen record for every knob.

The port's copy of ``core/config.py`` in the JAX package, with the same
fields, defaults and checks. ``RunConfig`` consolidates the knobs into a
single frozen dataclass accepted as ``config=`` by
``executor.execute``, ``executor.build_wave_plan`` and
``simulator.simulate`` (the DSE sweep, which also takes it in the JAX
package, is not ported yet). The differences are the backend's vocabulary and
default: ``BACKENDS`` is ``("numpy", "torch")``, where ``"torch"`` is
the counterpart of the reference's ``"pallas"`` — the wave executor's
hardware backend on a CUDA card — and ``backend`` defaults to
``"torch"`` (the reference defaults to ``"numpy"``), so the entry point
runs on the card unless the caller names the host replay. The device it
runs on is a keyword of ``execute``, not a field here.

The legacy kwargs remain as deprecated pass-throughs. Mixing them with
an explicit ``config=`` is allowed only when they agree — a conflicting
explicit kwarg raises ``ConfigConflict`` rather than silently picking a
winner. Each entry point consumes the fields that apply to it and
ignores the rest (``backend`` means nothing to ``simulate()``;
``engine`` means nothing to the wave executor) — the ignored fields are
exactly the ones the DSE result identity proves inert for that layer
(``dse.spec.RESULT_INERT_FIELDS``).

Three fields (``spec_runahead``, ``fifo_depth``, ``fifo_latency``)
overlap ``SimParams``. They default to ``None`` = "take the SimParams
value"; a non-``None`` value overrides it, and a conflict with an
explicitly different ``sim=SimParams(...)`` raises.

This module is dependency-free by design (no core imports), so every
layer can import it. The value vocabularies are re-asserted against
their canonical homes (``dae.PREDICTORS``, ``schedule.TRACE_MODES``)
by ``tests/test_config.py``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

MODES = ("STA", "LSQ", "FUS1", "FUS2")
ENGINES = ("cycle", "event")
TRACE_MODES = ("auto", "compiled", "interp")
SPECULATIONS = ("off", "auto")
PREDICTORS = ("last", "stride", "context", "auto")
BACKENDS = ("numpy", "torch")

# the SimParams fields RunConfig can override (None = inherit)
SIM_FIELDS = ("spec_runahead", "fifo_depth", "fifo_latency")


class ConfigConflict(ValueError):
    """An explicit legacy kwarg (or ``sim=``/axis value) disagrees with
    an explicit ``config=RunConfig(...)``."""


class _Unset:
    """Sentinel distinguishing "kwarg not passed" from any real value."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "<unset>"


UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """One fully specified run configuration.

    Fields and the layers that consume them (README "The knobs" has the
    full table; ``tools/check_docs.py`` cross-checks it against this
    class):

      * ``mode`` — evaluated system (simulate/engines, DSE).
      * ``engine`` — timing engine for the dynamic modes
        (simulate/engines, DSE; STA provably ignores it).
      * ``trace_mode`` — AGU/CU front-end (simulate, executor, DSE;
        proven bit-identical across values, so excluded from the DSE
        result identity).
      * ``speculation`` — loss-of-decoupling policy (simulate,
        executor, DSE).
      * ``predictor`` — speculative-AGU value predictor (simulate,
        executor, DSE; dead unless the point speculates).
      * ``spec_runahead`` / ``fifo_depth`` / ``fifo_latency`` —
        ``SimParams`` overrides (``None`` = inherit from ``sim=``);
        ``fifo_depth`` also sizes the wave plan's circular slot
        encoding in the executor.
      * ``static_prune`` — certifier-pruned hazard plan (simulate,
        DSE).
      * ``validate_hints`` — dynamic ``MonotonicHint`` checking
        (simulate, executor; a checker, never changes results).
      * ``backend`` / ``batch_waves`` / ``symbolic_admission`` — wave
        executor only (``execute()``; proven result-inert everywhere
        else).
    """

    mode: str = "FUS2"
    engine: str = "event"
    trace_mode: str = "auto"
    speculation: str = "off"
    predictor: str = "auto"
    spec_runahead: Optional[int] = None
    fifo_depth: Optional[int] = None
    fifo_latency: Optional[int] = None
    static_prune: bool = False
    validate_hints: bool = False
    backend: str = "torch"
    batch_waves: bool = True
    symbolic_admission: bool = True

    def __post_init__(self):
        _check("mode", self.mode, MODES)
        _check("engine", self.engine, ENGINES)
        _check("trace_mode", self.trace_mode, TRACE_MODES)
        _check("speculation", self.speculation, SPECULATIONS)
        _check("predictor", self.predictor, PREDICTORS)
        _check("backend", self.backend, BACKENDS)
        for f in SIM_FIELDS:
            v = getattr(self, f)
            if v is not None:
                v = int(v)
                object.__setattr__(self, f, v)
                if v < (0 if f == "fifo_latency" else 1):
                    raise ValueError(f"RunConfig.{f} must be >= 1, got {v}")
        for f in ("static_prune", "validate_hints", "batch_waves",
                  "symbolic_admission"):
            object.__setattr__(self, f, bool(getattr(self, f)))

    # -- SimParams reconciliation -------------------------------------------

    def sim_overrides(self) -> dict:
        """The non-``None`` SimParams-field overrides this config
        carries (``{field: value}``)."""
        return {
            f: getattr(self, f)
            for f in SIM_FIELDS
            if getattr(self, f) is not None
        }

    def apply_sim(self, sim, default):
        """Merge this config's SimParams overrides into ``sim``.

        ``sim`` is the (possibly ``None``) explicit ``sim=`` argument;
        ``default`` a default-constructed instance of the same
        dataclass. A field ``sim`` left at its default takes the
        config's value; a field set to something *different* from both
        the default and the config raises ``ConfigConflict`` — the two
        explicit specifications disagree.
        """
        base = sim if sim is not None else default
        out = {}
        for f, v in self.sim_overrides().items():
            cur = getattr(base, f)
            if cur != getattr(default, f) and cur != v:
                raise ConfigConflict(
                    f"sim=SimParams({f}={cur}) conflicts with explicit "
                    f"config=RunConfig({f}={v})"
                )
            if cur != v:
                out[f] = v
        return dataclasses.replace(base, **out) if out else base


def _check(field: str, value, allowed) -> None:
    if value not in allowed:
        # "unknown <field> <value>" wording is load-bearing: pre-config
        # entry points raised it and callers match on it
        raise ValueError(
            f"unknown {field} {value!r}: RunConfig.{field} must be one of "
            f"{allowed}"
        )


def resolve(config: Optional[RunConfig], **legacy) -> RunConfig:
    """Resolve an entry point's ``config=`` + legacy kwargs to one
    ``RunConfig``.

    ``legacy`` maps RunConfig field names to either ``UNSET`` (the
    kwarg was not passed) or the explicitly passed value. Rules:

      * no ``config=``: the explicit kwargs fill a default
        ``RunConfig`` (full backward compatibility),
      * ``config=`` given and every explicit kwarg agrees with it:
        the config wins (redundant kwargs are harmless),
      * ``config=`` given and an explicit kwarg disagrees:
        ``ConfigConflict`` — never silently pick a winner.
    """
    explicit = {k: v for k, v in legacy.items() if v is not UNSET}
    if config is None:
        return RunConfig(**explicit) if explicit else RunConfig()
    if not isinstance(config, RunConfig):
        raise TypeError(f"config= must be a RunConfig, got {config!r}")
    conflicts = {
        k: (getattr(config, k), v)
        for k, v in explicit.items()
        if getattr(config, k) != v
    }
    if conflicts:
        detail = ", ".join(
            f"{k}: config={c!r} vs kwarg={v!r}"
            for k, (c, v) in sorted(conflicts.items())
        )
        raise ConfigConflict(
            f"explicit kwargs conflict with explicit config= ({detail}); "
            "drop the kwargs or pass a matching RunConfig"
        )
    return config
