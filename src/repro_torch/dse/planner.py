"""Sweep planner: group, deduplicate, and share compiled artifacts.

The port's copy of ``dse/planner.py`` in the JAX package.

``plan()`` partitions sweep points into per-(kernel, scale) groups and
collapses each group's points onto *unique runs* by ``result_key`` —
the dedup exploits the two proven result-invariances (trace modes are
bit-identical; STA ignores the engine; see ``dse.spec``).

``GroupContext`` then materializes, lazily and at most once per group,
everything a run needs that does not depend on timing parameters:

  * the program + input arrays/params (``programs.REGISTRY``),
  * ``Compiled`` per forwarding class (FUS2 forwards; the rest do not),
  * one AGU trace set (``schedule.trace_program(mode="auto")``) shared
    by every point — the trace-sharing contract of DESIGN.md §9; a
    point that demands ``trace_mode="compiled"`` triggers the same
    strict check (and the same ``TraceCompileError``) standalone
    ``simulate()`` would raise,
  * the hooked sequential oracle (final arrays + per-op load values),
  * recorded CU scripts (``dae.record_cu_script``) replayed per run,
  * §5.6 NoDependence bits over the union of both plans' pairs, and
    the LSQ instance rank table,
  * STA instance decomposition.

All of these are pure functions of (program, arrays, params), so runs
seeded with them are bit-identical to standalone ``simulate()``.
"""

from __future__ import annotations

import dataclasses
from functools import cached_property
from typing import Optional

from repro_torch.core import dae as daelib
from repro_torch.core import du as dulib
from repro_torch.core import loopir as ir
from repro_torch.core import programs
from repro_torch.core import schedule as schedlib
from repro_torch.core import simulator
from repro_torch.dse.spec import SweepPoint


@dataclasses.dataclass
class UniqueRun:
    """One actual simulation serving one or more sweep points."""

    key: tuple  # SweepPoint.result_key
    rep: SweepPoint  # representative point (defines mode/engine/sim)
    point_indices: list  # indices into the sweep's point list


@dataclasses.dataclass
class Group:
    kernel: str
    scale: int
    runs: list  # [UniqueRun]
    # the decoupling policy this group compiles under: "auto" only when
    # its points actually speculate (SweepPoint.spec_class); points
    # whose knob provably cannot change the result share the "off"
    # compile (the fourth result-invariance, dse.spec)
    speculation: str = "off"
    # the speculative-AGU predictor and run-ahead window the group's
    # shared SpecPlan is traced under (dse.spec fifth invariance):
    # distinct values produce distinct gate schedules, so they get
    # distinct groups; non-speculative (and STA-folded) groups keep the
    # defaults — their plan is unused
    predictor: str = "auto"
    spec_runahead: Optional[int] = None
    # the planner's group identity (kernel, scale, spec_class,
    # predictor_class, runahead_class): stable across shards —
    # ``shard.merge_results`` sorts by it to restore the canonical
    # single-host group order
    class_key: tuple = ()

    @property
    def n_points(self) -> int:
        return sum(len(r.point_indices) for r in self.runs)


def plan(points: list[SweepPoint]) -> list[Group]:
    """Group points by (kernel, scale, spec/predictor/run-ahead class),
    dedup by result key. The predictor and run-ahead classes fold to
    ``"-"`` for points that never consult a SpecPlan (dse.spec), so
    e.g. all STA points of a speculative kernel share one group — and
    one run — across every predictor value."""
    groups: dict[tuple, dict[tuple, UniqueRun]] = {}
    for i, p in enumerate(points):
        g = groups.setdefault(
            (p.kernel, p.scale, p.spec_class, p.predictor_class,
             p.runahead_class),
            {},
        )
        run = g.get(p.result_key)
        if run is None:
            g[p.result_key] = UniqueRun(key=p.result_key, rep=p, point_indices=[i])
        else:
            run.point_indices.append(i)
    return [
        Group(
            kernel=k, scale=s, runs=list(g.values()),
            speculation="auto" if sc == "auto" else "off",
            predictor=pc if pc != "-" else "auto",
            spec_runahead=rc if rc != "-" else None,
            class_key=(k, s, sc, pc, rc),
        )
        for (k, s, sc, pc, rc), g in sorted(
            groups.items(), key=lambda kv: tuple(map(str, kv[0]))
        )
    ]


class GroupContext:
    """Lazily-built shared artifacts for one (kernel, scale) group."""

    def __init__(self, group: Group):
        self.group = group
        prog, arrays, params = programs.get(group.kernel).make(group.scale)
        self.program = prog
        self.arrays = arrays
        self.params = params
        self._strict_checked = False
        # statically-pruned hazard-plan variants (DESIGN.md §12), keyed
        # by forwarding class; built only when a run asks for one
        self._comp_pruned: dict[bool, simulator.Compiled] = {}

    # -- compile front-end -------------------------------------------------

    @cached_property
    def comp_fwd(self) -> simulator.Compiled:
        return simulator.Compiled(
            self.program, forwarding=True, speculation=self.group.speculation,
            predictor=self.group.predictor,
        )

    @cached_property
    def comp_nofwd(self) -> simulator.Compiled:
        return simulator.Compiled(
            self.program, forwarding=False, speculation=self.group.speculation,
            predictor=self.group.predictor,
        )

    def comp(self, mode: str, static_prune: bool = False) -> simulator.Compiled:
        """Shared compile for ``mode``. ``static_prune`` selects the
        certifier-pruned hazard-plan variant (DESIGN.md §12); its kept
        pairs are a subset of the baseline's, so the group's
        ``nodep_bits`` (built over the baseline plans' union) cover
        every pair the pruned plan can look up."""
        if not static_prune:
            return self.comp_fwd if mode == "FUS2" else self.comp_nofwd
        fwd = mode == "FUS2"
        comp = self._comp_pruned.get(fwd)
        if comp is None:
            comp = simulator.Compiled(
                self.program, forwarding=fwd,
                speculation=self.group.speculation,
                predictor=self.group.predictor, static_prune=True,
            )
            self._comp_pruned[fwd] = comp
        return comp

    @cached_property
    def _traced(self) -> tuple:
        """(trace set, SpecPlan | None) — one shared build per group.
        Speculative groups reuse the group's hooked oracle run for the
        predictor's load streams (no second sequential walk)."""
        spec_out: list = []
        traces = schedlib.trace_program(
            self.program, self.comp_nofwd.dae, self.arrays, self.params,
            mode="auto", spec_out=spec_out,
            oracle_loads=(
                self.oracle_loads if self.comp_nofwd.dae.spec else None
            ),
            predictor=self.group.predictor,
            spec_runahead=self.group.spec_runahead,
        )
        return traces, (spec_out[0] if spec_out else None)

    @property
    def traces(self) -> dict[str, schedlib.OpTrace]:
        """The single shared AGU trace set (compiled where possible)."""
        return self._traced[0]

    @property
    def spec_plan(self):
        """Shared speculation plan (``speculate.SpecPlan``), or None."""
        return self._traced[1]

    def check_strict_compiled(self) -> None:
        """Raise ``TraceCompileError`` exactly as ``simulate()`` with
        ``trace_mode="compiled"`` would, if any PE is off the compiled
        path. (The streams themselves are shared either way.)"""
        if not self._strict_checked:
            report: dict = {}
            schedlib.trace_program(
                self.program, self.comp_nofwd.dae, self.arrays, self.params,
                mode="compiled", report=report,
            )
            self._strict_checked = True

    # -- oracle ------------------------------------------------------------

    @cached_property
    def _oracle(self) -> tuple:
        loads: dict[str, list] = {}

        def hook(op_id, addr, is_store, valid, value):
            if not is_store:
                loads.setdefault(op_id, []).append(value)

        final = ir.interpret(self.program, self.arrays, self.params, hook)
        return final, loads

    @property
    def final_arrays(self) -> dict:
        return self._oracle[0]

    @property
    def oracle_loads(self) -> dict:
        return self._oracle[1]

    # -- shared engine state -----------------------------------------------

    @cached_property
    def cu_scripts(self) -> dict[int, daelib.CUScript]:
        return {
            pe.id: daelib.record_cu_script(
                pe, self.arrays, self.params, self.oracle_loads
            )
            for pe in self.comp_nofwd.dae.pes
        }

    def cu_factory(self, pe: daelib.PE) -> daelib.ReplayCU:
        return daelib.ReplayCU(self.cu_scripts[pe.id])

    @cached_property
    def nodep_bits(self) -> dict:
        """§5.6 bit streams over the union of both forwarding classes'
        kept pairs (engines look entries up by (dst, src) id)."""
        pairs = {
            (p.dst, p.src): p
            for p in self.comp_nofwd.plan.pairs + self.comp_fwd.plan.pairs
        }
        return dulib.nodependence_bits(list(pairs.values()), self.traces)

    @cached_property
    def rank_table(self) -> tuple:
        comp = self.comp_nofwd
        fuse = {pe.id: pe.id for pe in comp.dae.pes}
        return schedlib.instance_rank_table(
            self.traces, comp.dae, comp.loop_pos, comp.op_pos, fuse,
            comp.op_path,
        )

    @cached_property
    def sta_instances(self) -> tuple:
        comp = self.comp_nofwd
        fuse = simulator._fusion_groups_sta(comp)
        return simulator._instances(comp, self.traces, fuse)

    # -- assembly ----------------------------------------------------------

    def shared_for(self, mode: str) -> simulator.SharedArtifacts:
        """The ``SharedArtifacts`` bundle for one run of this group."""
        if mode == "STA":
            return simulator.SharedArtifacts(
                sta_instances=self.sta_instances,
                final_arrays=self.final_arrays,
            )
        # FIFO streaming PEs (DESIGN.md §11) run live generator CUs —
        # their pop/push waits cannot be pre-recorded as a replay
        # script, so those groups skip the cu_factory fast path
        streaming = bool(self.comp_nofwd.dae.fifo_edges)
        return simulator.SharedArtifacts(
            nodep_bits=self.nodep_bits,
            rank_table=self.rank_table if mode == "LSQ" else None,
            cu_factory=None if streaming else self.cu_factory,
        )

    def oracle_loads_if(self, validate: bool) -> Optional[dict]:
        return self.oracle_loads if validate else None
