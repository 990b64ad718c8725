"""Address monotonicity analysis (paper §3).

Translates LoopIR address expressions into the CR algebra (the moral
equivalent of running LLVM's SCEV on the address def-use chain), then
classifies every memory operation:

  * ``affine``               — polyhedral tools could handle it,
  * ``innermost_monotonic``  — the paper's *requirement* for using the
                               frontier (``addr_a < ack.addr_b``) check,
  * ``non_monotonic``        — set of 1-indexed loop depths (within the
                               op's own nest) that may *reset* the
                               address (§3.4.1), driving `lastIter`
                               instrumentation and the No-Address-Reset
                               check.

Data-dependent addresses (``Read`` of an index array) cannot be analyzed
by the CR formalism; they are handled through user assertions
(``MonotonicHint``, §3.3) or conservatively marked non-monotonic at
every depth — such ops never use the frontier comparison and are
disambiguated purely by program order + completion sentinels.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Union

from repro_torch.core import cr as crlib
from repro_torch.core import loopir as ir


@dataclasses.dataclass(frozen=True)
class AddressInfo:
    op_id: str
    depth: int  # loop-nest depth of the op (n >= 1)
    cr: Optional[crlib.CRExpr]  # None if not analyzable (data-dependent)
    affine: bool
    innermost_monotonic: bool
    non_monotonic: frozenset[int]  # 1-indexed depths that may reset the address
    from_hint: bool = False

    def describe(self) -> str:
        kind = (
            "affine"
            if self.affine
            else ("monotonic" if self.innermost_monotonic else "unanalyzable")
        )
        src = " (user-asserted)" if self.from_hint else ""
        return (
            f"{self.op_id}: {kind}{src}, depth={self.depth}, "
            f"non-monotonic depths={sorted(self.non_monotonic)}"
        )


class _Untranslatable(Exception):
    pass


def to_cr_or_none(
    e: ir.Expr, path: tuple[ir.Loop, ...]
) -> Optional[crlib.CRExpr]:
    """Translate an expression evaluated inside loop nest ``path`` to the
    CR algebra, or None when no translation exists. Public wrapper used
    by the affine trace compiler (core/affine.py) to tag compiled
    addresses with their §3 classification without re-deriving the
    depth/ivar maps."""
    depth_of = {lp.var: i + 1 for i, lp in enumerate(path)}
    ivars: dict[str, tuple[ir.IVar, int]] = {}
    for i, lp in enumerate(path):
        for iv in lp.ivars:
            ivars[iv.name] = (iv, i + 1)
    try:
        return _to_cr(e, depth_of, ivars)
    except _Untranslatable:
        return None


def _to_cr(
    e: ir.Expr,
    depth_of: dict[str, int],
    ivars: dict[str, tuple[ir.IVar, int]],
) -> crlib.CRExpr:
    """Translate a LoopIR expression to a CR expression.

    ``depth_of`` maps canonical loop vars to 1-indexed depth;
    ``ivars`` maps auxiliary induction variables to (IVar, depth).
    """
    if isinstance(e, ir.Const):
        if float(e.v) != int(e.v):
            raise _Untranslatable("non-integer constant in address")
        return crlib.CConst(int(e.v))
    if isinstance(e, ir.Param):
        return crlib.CSym(e.name, e.lo, e.hi)
    if isinstance(e, ir.Var):
        if e.name in depth_of:
            # canonical induction variable: {0, +, 1}@depth
            return crlib.CR(crlib.CConst(0), "+", crlib.CConst(1), depth_of[e.name])
        if e.name in ivars:
            iv, d = ivars[e.name]
            base = _to_cr(iv.init, depth_of, ivars)
            step = _to_cr(iv.step, depth_of, ivars)
            return crlib.CR(base, iv.op, step, d)
        raise _Untranslatable(f"unknown var {e.name}")
    if isinstance(e, ir.Read):
        return crlib.COpaque(e.array, e.lo, e.hi)
    if isinstance(e, ir.LoadVal):
        return crlib.COpaque(f"loadval:{e.load_id}")
    if isinstance(e, ir.Bin):
        if e.op == "+":
            return crlib.cr_add(
                _to_cr(e.a, depth_of, ivars), _to_cr(e.b, depth_of, ivars)
            )
        if e.op == "-":
            return crlib.cr_add(
                _to_cr(e.a, depth_of, ivars),
                crlib.cr_mul(crlib.CConst(-1), _to_cr(e.b, depth_of, ivars)),
            )
        if e.op == "*":
            return crlib.cr_mul(
                _to_cr(e.a, depth_of, ivars), _to_cr(e.b, depth_of, ivars)
            )
        raise _Untranslatable(f"op {e.op} not CR-translatable")
    if isinstance(e, ir.Local):
        raise _Untranslatable(f"loop-carried local {e.name} in address")
    raise _Untranslatable(f"cannot translate {type(e).__name__}")


def analyze_op(
    op: Union[ir.Load, ir.Store], path: tuple[ir.Loop, ...]
) -> AddressInfo:
    """Classify one memory op. ``path`` is its loop nest, outermost first."""
    n = len(path)
    assert n >= 1, "memory ops must be inside at least one loop"
    depth_of = {lp.var: i + 1 for i, lp in enumerate(path)}
    ivars: dict[str, tuple[ir.IVar, int]] = {}
    for i, lp in enumerate(path):
        for iv in lp.ivars:
            ivars[iv.name] = (iv, i + 1)

    # --- user assertion path (§3.3) -------------------------------------
    if op.hint is not None:
        if op.hint.non_monotonic_outer is None:
            nm = frozenset(range(1, n))  # all outer depths reset
        else:
            nm = frozenset(op.hint.non_monotonic_outer)
        if not op.hint.innermost_monotonic:
            nm = nm | {n}
        return AddressInfo(
            op_id=op.id,
            depth=n,
            cr=None,
            affine=False,
            innermost_monotonic=op.hint.innermost_monotonic,
            non_monotonic=nm,
            from_hint=True,
        )

    # --- CR path ----------------------------------------------------------
    try:
        cre = _to_cr(op.addr, depth_of, ivars)
    except _Untranslatable:
        cre = None
    if cre is None or crlib.has_opaque(cre):
        # unanalyzable without an annotation: conservatively non-monotonic
        # at every depth. The op is still *supported* (paper hist-style
        # codes): consumers fall back to program order and sentinels.
        return AddressInfo(
            op_id=op.id,
            depth=n,
            cr=cre,
            affine=False,
            innermost_monotonic=False,
            non_monotonic=frozenset(range(1, n + 1)),
        )

    affine = crlib.is_affine_expr(cre)
    monotonic = crlib.is_monotonic_expr(cre)

    # trip counts per depth for the §3.4.1 comparison (symbolic)
    trips: dict[int, crlib.CRExpr] = {}
    for i, lp in enumerate(path):
        try:
            trips[i + 1] = _to_cr(lp.trip, depth_of, ivars)
        except _Untranslatable:
            trips[i + 1] = crlib.CSym(f"__trip_{lp.var}", 0, crlib.INF)

    nm = crlib.non_monotonic_depths(cre, trips, n)
    innermost_monotonic = monotonic and (n not in nm)
    return AddressInfo(
        op_id=op.id,
        depth=n,
        cr=cre,
        affine=affine,
        innermost_monotonic=innermost_monotonic,
        non_monotonic=frozenset(nm),
    )


def analyze_program(program: ir.Program) -> dict[str, AddressInfo]:
    """Address monotonicity analysis of every memory op (paper §3).

    Maps op id -> ``AddressInfo``: whether the address is affine /
    innermost-monotonic (the requirement for the DU's frontier
    comparison) and which outer loop depths may reset it (driving the
    lastIter instrumentation and No-Address-Reset check). Data-dependent
    addresses honour user ``MonotonicHint`` assertions (§3.3), else are
    conservatively non-monotonic at every depth. This is the first
    stage of ``simulator.Compiled``; the hazard plan
    (``hazards.build_plan``) consumes the result."""
    return {op.id: analyze_op(op, path) for op, path in program.mem_ops()}
