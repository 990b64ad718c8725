"""LoopIR program linter: static diagnostics with stable RPL0xx codes.

The port's copy of ``analysis/lint.py`` in the JAX package: the same
codes, severities, messages and CLI, run over this package's programs.

Runs the symbolic dependence certifier (``analysis/deps.py``), the §3
monotonicity pass and the FIFO/decoupling front-ends over a program and
reports everything they can *prove* about it before a single cycle is
simulated:

  ========  ========  ====================================================
  code      severity  meaning
  ========  ========  ====================================================
  RPL001    error     contradictory ``MonotonicHint``: the CR analysis
                      (which never trusts hints) proves the asserted
                      monotonicity false, or the hint names an impossible
                      reset depth — ``validate_hints=True`` would raise
                      ``HintViolation`` at runtime
  RPL002    warning   redundant ``MonotonicHint``: the address is fully
                      CR-analyzable and the analysis already derives at
                      least what the hint asserts — drop the hint
  RPL003    info      provably-dead hazard pair: the certifier proves the
                      kept pair can never observe a conflict (forced-pass
                      pairs additionally vanish under ``static_prune``)
  RPL004    error     statically-doomed FIFO topology: the cross-PE edge
                      set deadlocks or falls outside the token protocol
                      for every depth (``fifo.analyze_program`` reject)
  RPL005    info      loss-of-decoupling pre-diagnosis: ``speculation=
                      "off"`` would raise ``LossOfDecoupling``; ``"auto"``
                      recovers by marking the PE speculative (escalated to
                      an error when even ``"auto"`` rejects the program)
  ========  ========  ====================================================

Codes are stable across releases (tests pin them); severities order
``error > warning > info`` and the CLI exits non-zero iff any error or
warning was emitted — info diagnostics are advisory.

CLI (``python -m repro_torch.analysis.lint``):

    python -m repro_torch.analysis.lint --all            # every registered kernel
    python -m repro_torch.analysis.lint bnn "tanh+spmv"  # selected kernels
    python -m repro_torch.analysis.lint path/to/prog.py  # a file defining
                                                         # `program` or `make()`,
                                                         # built with
                                                         # repro_torch.core.loopir
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import Optional

from repro_torch.analysis import deps as depslib
from repro_torch.core import cr as crlib
from repro_torch.core import dae as daelib
from repro_torch.core import fifo as fifolib
from repro_torch.core import hazards as hz
from repro_torch.core import loopir as ir
from repro_torch.core import monotonic as mono
from repro_torch.core import programs

SEVERITIES = ("error", "warning", "info")

# stable code registry: codes are never renumbered or reused (pinned by
# tests/test_torch_lint.py against the JAX package's); new checks
# append RPL006, RPL007, ...
CODES = {
    "RPL001": "contradictory MonotonicHint",
    "RPL002": "redundant MonotonicHint",
    "RPL003": "provably-dead hazard pair",
    "RPL004": "statically-doomed FIFO topology",
    "RPL005": "loss-of-decoupling pre-diagnosis",
}


@dataclasses.dataclass(frozen=True)
class Diagnostic:
    """One linter finding (stable ``code``, sortable, printable)."""

    code: str  # RPL001..RPL005
    severity: str  # error | warning | info
    kernel: str  # program label the finding belongs to
    where: str  # op id, "dst<-src" pair, or FIFO edge description
    message: str

    def format(self) -> str:
        return f"{self.kernel}: {self.code} {self.severity} [{self.where}]: {self.message}"


def _sort_key(d: Diagnostic) -> tuple:
    return (d.kernel, d.code, d.where, d.message)


# ---------------------------------------------------------------------------
# RPL001 / RPL002 — MonotonicHint checks
# ---------------------------------------------------------------------------


def _boundary_change_hi(
    cre: crlib.CRExpr, trips: dict[int, crlib.CRExpr], d: int, n: int
) -> Optional[int]:
    """Upper bound on ``addr(after) - addr(before)`` across an advance of
    loop depth ``d`` — the ``hi`` mirror of ``cr.min_adjacent_increase``,
    except the inner loops provably completed ``trip - 1`` iterations
    before resetting, so the elapsed interval is ``[trip_lo-1,
    trip_hi-1]``, not ``[0, trip_hi-1]``. None when the stream is opaque,
    holds a multiplicative recurrence, or an inner loop may run zero
    iterations (the adjacent request then spans several advances and the
    single-step bound is unsound)."""
    if crlib.has_opaque(cre) or any(c.op == "*" for c in cre.crs()):
        return None
    sd = crlib.step_at_depth(cre, d)
    if sd is None:
        return None
    hi = sd.range().hi
    for j in range(d + 1, n + 1):
        sj = crlib.step_at_depth(cre, j)
        if sj is None:
            return None
        t = trips[j].range()
        if t.lo < 1:
            return None
        back = crlib.Interval(crlib.clamp(-max(t.hi - 1, 0)), -(t.lo - 1))
        hi = crlib.clamp(hi + (sj.range() * back).hi)
    return hi


def _lint_hints(
    program: ir.Program, kernel: str, facts: dict[str, depslib.OpFacts]
) -> list[Diagnostic]:
    out: list[Diagnostic] = []
    for op, path in program.mem_ops():
        if op.hint is None:
            continue
        n = len(path)
        f = facts[op.id]

        # structural: asserted reset depths must name an *outer* loop
        if op.hint.non_monotonic_outer is not None:
            bad = sorted(
                d for d in op.hint.non_monotonic_outer if d < 1 or d >= n
            )
            if bad:
                out.append(Diagnostic(
                    "RPL001", "error", kernel, op.id,
                    f"hint asserts non-monotonic depth(s) {bad} outside the "
                    f"op's outer depths 1..{n - 1}",
                ))

        if not f.analyzable:
            continue  # opaque address: the hint is load-bearing

        cre, trips = f.cr, f.trips
        hint_nm = (
            frozenset(range(1, n))
            if op.hint.non_monotonic_outer is None
            else frozenset(op.hint.non_monotonic_outer)
        )

        # contradictions: CR (hints untrusted) proves a decrease the
        # hint declares impossible — the exact decreases validate_hints
        # would catch dynamically
        contradicted = False
        if op.hint.innermost_monotonic:
            ub = _boundary_change_hi(cre, trips, n, n)
            if (
                ub is not None and ub <= -1
                and trips[n].range().hi >= 2
            ):
                out.append(Diagnostic(
                    "RPL001", "error", kernel, op.id,
                    f"hint asserts innermost monotonicity but the address "
                    f"provably decreases by ≥ {-ub} every innermost "
                    f"iteration",
                ))
                contradicted = True
            for d in range(1, n):
                if d in hint_nm:
                    continue
                ub = _boundary_change_hi(cre, trips, d, n)
                if (
                    ub is not None and ub <= -1
                    and trips[d].range().hi >= 2
                ):
                    out.append(Diagnostic(
                        "RPL001", "error", kernel, op.id,
                        f"hint omits depth {d} from non_monotonic_outer but "
                        f"the address provably decreases by ≥ {-ub} across "
                        f"every depth-{d} advance",
                    ))
                    contradicted = True
        if contradicted:
            continue

        # redundancy: the CR analysis already derives at least this much
        info = mono.analyze_op(
            dataclasses.replace(op, hint=None), tuple(path)
        )
        implies_innermost = (
            info.innermost_monotonic or not op.hint.innermost_monotonic
        )
        if implies_innermost and info.non_monotonic <= hint_nm:
            out.append(Diagnostic(
                "RPL002", "warning", kernel, op.id,
                f"hint is redundant: the address is CR-analyzable and the "
                f"analysis derives {info.describe()!s} without it",
            ))
    return out


# ---------------------------------------------------------------------------
# RPL003 — provably-dead hazard pairs
# ---------------------------------------------------------------------------


def _lint_pairs(
    program: ir.Program,
    kernel: str,
    dres: daelib.DAEResult,
    facts: dict[str, depslib.OpFacts],
) -> list[Diagnostic]:
    infos = mono.analyze_program(program)
    plan = hz.build_plan(program, dres, infos, forwarding=False)
    out: list[Diagnostic] = []
    for pair, verdict in certify_plan(program, plan, facts).items():
        if verdict.kind != depslib.NEVER:
            continue
        where = f"{pair[0]}<-{pair[1]}"
        if verdict.forced_pass:
            out.append(Diagnostic(
                "RPL003", "info", kernel, where,
                f"hazard pair is provably dead ({verdict.evidence}); "
                f"static_prune=True drops it with bit-identical timing",
            ))
        else:
            out.append(Diagnostic(
                "RPL003", "info", kernel, where,
                f"hazard pair can never observe a conflict "
                f"({verdict.evidence}); kept because its program-order "
                f"disjunct may still pace issue",
            ))
    return out


def certify_plan(
    program: ir.Program, plan: hz.HazardPlan, facts=None
) -> dict[tuple[str, str], depslib.Verdict]:
    """Certifier verdicts for a plan's *kept* pairs (linter view)."""
    return depslib.certify_pairs(program, plan.pairs, facts=facts)


# ---------------------------------------------------------------------------
# RPL004 / RPL005 — front-end pre-diagnosis
# ---------------------------------------------------------------------------


def _lint_frontend(
    program: ir.Program, kernel: str
) -> tuple[list[Diagnostic], Optional[daelib.DAEResult]]:
    out: list[Diagnostic] = []
    try:
        dres = daelib.decouple(program, speculation="off")
    except daelib.LossOfDecoupling as exc:
        out.append(Diagnostic(
            "RPL005", "info", kernel, "decouple",
            f"speculation='off' loses decoupling ({exc}); "
            f"speculation='auto' recovers by marking the PE speculative",
        ))
        try:
            dres = daelib.decouple(program, speculation="auto")
        except daelib.LossOfDecoupling as exc2:
            out.append(Diagnostic(
                "RPL005", "error", kernel, "decouple",
                f"speculation='auto' also rejects the program: {exc2}",
            ))
            return out, None
    if dres.fifo_edges:
        try:
            fifolib.analyze_program(program, dres)
        except fifolib.FifoRejected as exc:
            out.append(Diagnostic(
                "RPL004", "error", kernel, "fifo",
                f"FIFO topology statically doomed "
                f"({type(exc).__name__}): {exc}",
            ))
    return out, dres


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------


def lint_program(program: ir.Program, kernel: str = "<program>") -> list[Diagnostic]:
    """All diagnostics for one program, deterministically sorted."""
    facts = depslib.stream_facts(program)
    out = _lint_hints(program, kernel, facts)
    frontend, dres = _lint_frontend(program, kernel)
    out += frontend
    if dres is not None:
        out += _lint_pairs(program, kernel, dres, facts)
    return sorted(out, key=_sort_key)


def lint_kernel(name: str, scale: Optional[int] = None) -> list[Diagnostic]:
    """Lint one registered kernel at ``scale`` (default: registered)."""
    bench = programs.get(name)
    prog, _arrays, _params = bench.make(scale or bench.default_scale)
    return lint_program(prog, kernel=name)


def _load_program_file(path: str) -> ir.Program:
    """A lintable file defines ``program`` (an ``ir.Program``) or
    ``make()`` returning one (optionally a (program, arrays, params)
    tuple, the registry convention)."""
    ns: dict = {"__name__": "__lint__", "__file__": path}
    with open(path, "r", encoding="utf-8") as f:
        exec(compile(f.read(), path, "exec"), ns)
    obj = ns.get("program")
    if obj is None and callable(ns.get("make")):
        obj = ns["make"]()
    if isinstance(obj, tuple):
        obj = obj[0]
    if not isinstance(obj, ir.Program):
        raise SystemExit(
            f"{path}: expected a `program` variable or `make()` callable "
            f"yielding an ir.Program"
        )
    return obj


def main(argv: Optional[list[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis.lint",
        description="Static linter for LoopIR programs (stable RPL0xx codes).",
    )
    ap.add_argument(
        "targets", nargs="*",
        help="registered kernel names, or a path to a Python file "
        "defining `program` / `make()`",
    )
    ap.add_argument(
        "--all", action="store_true", help="lint every registered kernel"
    )
    ap.add_argument(
        "--scale", type=int, default=None,
        help="problem scale for registered kernels (default: registered)",
    )
    args = ap.parse_args(argv)
    if not args.all and not args.targets:
        ap.error("nothing to lint: pass kernel names, a file, or --all")

    jobs: list[tuple[str, ir.Program]] = []
    names = sorted(programs.REGISTRY) if args.all else []
    for t in args.targets:
        if t in programs.REGISTRY:
            names.append(t)
        else:
            jobs.append((t, _load_program_file(t)))
    for name in names:
        bench = programs.get(name)
        prog, _a, _p = bench.make(args.scale or bench.default_scale)
        jobs.append((name, prog))

    diags: list[Diagnostic] = []
    for label, prog in sorted(jobs, key=lambda j: j[0]):
        diags += lint_program(prog, kernel=label)
    for d in diags:
        print(d.format())
    counts = {s: sum(1 for d in diags if d.severity == s) for s in SEVERITIES}
    print(
        f"linted {len(jobs)} program(s): {counts['error']} error(s), "
        f"{counts['warning']} warning(s), {counts['info']} info"
    )
    return 1 if counts["error"] or counts["warning"] else 0


if __name__ == "__main__":
    sys.exit(main())
