"""Chain of Recurrences (CR) algebra with interval ranges.

Implements the compiler theory from paper §3 (Address Monotonicity):

  * a CR is ``{base, op, step}`` attached to a loop; ``base``/``step`` may
    themselves be expressions containing CRs of *outer* loops,
  * *affine*    iff it is an add-recurrence whose step is a constant
    expression containing no CRs (paper §3.2),
  * *monotonic* (short for monotonically non-decreasing) iff every CR in
    the expression has a non-negative step (paper §3.2, [71]),
  * non-monotonic *outer* loop detection per §3.4.1:
    depth ``k`` is non-monotonic iff there is a deeper depth ``j > k``
    with ``CR_k.step < CR_j.step * tripCount_j`` — evaluated with symbols
    substituted by their *maximum* values, making the check conservative
    (false positives possible, never false negatives).

Symbolic values carry integer intervals (value-range analysis); interval
arithmetic is used wherever the paper substitutes maxima.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Union

INF = 10**18  # effectively unbounded


# ---------------------------------------------------------------------------
# Interval (value-range) arithmetic
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Interval:
    lo: int
    hi: int

    def __post_init__(self):
        assert self.lo <= self.hi, f"bad interval [{self.lo}, {self.hi}]"

    def __add__(self, o: "Interval") -> "Interval":
        return Interval(clamp(self.lo + o.lo), clamp(self.hi + o.hi))

    def __sub__(self, o: "Interval") -> "Interval":
        return Interval(clamp(self.lo - o.hi), clamp(self.hi - o.lo))

    def __mul__(self, o: "Interval") -> "Interval":
        cs = [self.lo * o.lo, self.lo * o.hi, self.hi * o.lo, self.hi * o.hi]
        return Interval(clamp(min(cs)), clamp(max(cs)))

    def union(self, o: "Interval") -> "Interval":
        return Interval(min(self.lo, o.lo), max(self.hi, o.hi))

    @property
    def nonneg(self) -> bool:
        return self.lo >= 0

    @property
    def is_const(self) -> bool:
        return self.lo == self.hi


def clamp(v: int) -> int:
    return max(-INF, min(INF, v))


# ---------------------------------------------------------------------------
# Expression nodes usable inside CRs (constants, symbols, arithmetic)
# ---------------------------------------------------------------------------

class CRExpr:
    """Base class for expressions appearing in CR bases/steps."""

    def range(self) -> Interval:  # pragma: no cover - abstract
        raise NotImplementedError

    def contains_cr(self) -> bool:
        return False

    def crs(self) -> list["CR"]:
        return []

    # small-constructor conveniences -------------------------------------
    def __add__(self, o):
        return cr_add(self, lift(o))

    def __radd__(self, o):
        return cr_add(lift(o), self)

    def __mul__(self, o):
        return cr_mul(self, lift(o))

    def __rmul__(self, o):
        return cr_mul(lift(o), self)


@dataclasses.dataclass(frozen=True)
class CConst(CRExpr):
    v: int

    def range(self) -> Interval:
        return Interval(self.v, self.v)

    def __repr__(self):
        return str(self.v)


@dataclasses.dataclass(frozen=True)
class CSym(CRExpr):
    """A symbolic runtime parameter with a known (conservative) range."""

    name: str
    lo: int = 0
    hi: int = INF

    def range(self) -> Interval:
        return Interval(self.lo, self.hi)

    def __repr__(self):
        return self.name


@dataclasses.dataclass(frozen=True)
class CAdd(CRExpr):
    a: CRExpr
    b: CRExpr

    def range(self) -> Interval:
        return self.a.range() + self.b.range()

    def contains_cr(self) -> bool:
        return self.a.contains_cr() or self.b.contains_cr()

    def crs(self):
        return self.a.crs() + self.b.crs()

    def __repr__(self):
        return f"({self.a} + {self.b})"


@dataclasses.dataclass(frozen=True)
class CMul(CRExpr):
    a: CRExpr
    b: CRExpr

    def range(self) -> Interval:
        return self.a.range() * self.b.range()

    def contains_cr(self) -> bool:
        return self.a.contains_cr() or self.b.contains_cr()

    def crs(self):
        return self.a.crs() + self.b.crs()

    def __repr__(self):
        return f"({self.a} * {self.b})"


@dataclasses.dataclass(frozen=True)
class COpaque(CRExpr):
    """A value the analysis cannot see through (e.g. a data-dependent read).

    Carries an optional user-asserted range, mirroring the paper's
    programmer annotations for sparse formats (§3.3).
    """

    name: str
    lo: int = -INF
    hi: int = INF

    def range(self) -> Interval:
        return Interval(self.lo, self.hi)

    def __repr__(self):
        return f"opaque({self.name})"


@dataclasses.dataclass(frozen=True)
class CR(CRExpr):
    """{base, op, step} recurrence attached to loop ``depth`` (1-indexed,
    1 = outermost of the op's nest, matching paper notation)."""

    base: CRExpr
    op: str  # '+' or '*'
    step: CRExpr
    depth: int

    def __post_init__(self):
        assert self.op in ("+", "*")

    def contains_cr(self) -> bool:
        return True

    def crs(self):
        return [self] + self.base.crs() + self.step.crs()

    def range(self) -> Interval:
        # Conservative: base range unioned with base evolved by
        # step*trip — without trip info we use [lo(base), INF) for
        # non-negative steps, full range otherwise.
        b = self.base.range()
        s = self.step.range()
        if self.op == "+":
            if s.nonneg:
                return Interval(b.lo, INF)
            if s.hi <= 0:
                return Interval(-INF, b.hi)
            return Interval(-INF, INF)
        # multiplicative recurrence
        if s.lo >= 1 and b.lo >= 0:
            return Interval(b.lo, INF)
        return Interval(-INF, INF)

    # --- paper §3.2 predicates ------------------------------------------

    @property
    def is_affine(self) -> bool:
        """Add recurrence whose step is a constant expression w/o CRs."""
        return (
            self.op == "+"
            and not self.step.contains_cr()
            and (not self.base.contains_cr() or all(c.is_affine for c in self.base.crs()))
        )

    @property
    def is_monotonic(self) -> bool:
        """Monotonically non-decreasing: non-negative step (×: step>=1,
        non-negative base)."""
        s = self.step.range()
        if self.op == "+":
            ok = s.nonneg
        else:
            ok = s.lo >= 1 and self.base.range().lo >= 0
        return ok and all(c.is_monotonic for c in self.base.crs()) and all(
            c.is_monotonic for c in self.step.crs()
        )

    def __repr__(self):
        return f"{{{self.base}, {self.op}, {self.step}}}@{self.depth}"


def lift(v: Union[int, CRExpr]) -> CRExpr:
    if isinstance(v, CRExpr):
        return v
    return CConst(int(v))


# ---------------------------------------------------------------------------
# CR construction algebra (simplifying constructors)
# ---------------------------------------------------------------------------

def cr_add(a: CRExpr, b: CRExpr) -> CRExpr:
    a, b = lift(a), lift(b)
    if isinstance(a, CConst) and isinstance(b, CConst):
        return CConst(a.v + b.v)
    if isinstance(a, CConst) and a.v == 0:
        return b
    if isinstance(b, CConst) and b.v == 0:
        return a
    # {b1,+,s1}@d + {b2,+,s2}@d = {b1+b2,+,s1+s2}@d
    if isinstance(a, CR) and isinstance(b, CR) and a.depth == b.depth and a.op == b.op == "+":
        return CR(cr_add(a.base, b.base), "+", cr_add(a.step, b.step), a.depth)
    # {b,+,s}@d + c = {b+c,+,s}@d  (fold into deeper CR's base)
    if isinstance(a, CR) and a.op == "+" and not _mentions_depth(b, a.depth):
        return CR(cr_add(a.base, b), "+", a.step, a.depth)
    if isinstance(b, CR) and b.op == "+" and not _mentions_depth(a, b.depth):
        return CR(cr_add(b.base, a), "+", b.step, b.depth)
    return CAdd(a, b)


def cr_mul(a: CRExpr, b: CRExpr) -> CRExpr:
    a, b = lift(a), lift(b)
    if isinstance(a, CConst) and isinstance(b, CConst):
        return CConst(a.v * b.v)
    if isinstance(a, CConst):
        if a.v == 0:
            return CConst(0)
        if a.v == 1:
            return b
    if isinstance(b, CConst):
        if b.v == 0:
            return CConst(0)
        if b.v == 1:
            return a
    # c * {b,+,s}@d = {c*b,+,c*s}@d when c is invariant w.r.t. loop d
    # (contains no CR at depth >= d — e.g. FFT's stride {1,×,2}@outer
    # multiplying the inner counter)
    if isinstance(a, CR) and a.op == "+" and _invariant_at(b, a.depth):
        return CR(cr_mul(a.base, b), "+", cr_mul(a.step, b), a.depth)
    if isinstance(b, CR) and b.op == "+" and _invariant_at(a, b.depth):
        return CR(cr_mul(b.base, a), "+", cr_mul(b.step, a), b.depth)
    # c * {b,×,s}@d = {c*b,×,s}@d for constant c
    if isinstance(a, CR) and a.op == "*" and isinstance(b, CConst):
        return CR(cr_mul(a.base, b), "*", a.step, a.depth)
    if isinstance(b, CR) and b.op == "*" and isinstance(a, CConst):
        return CR(cr_mul(b.base, a), "*", b.step, b.depth)
    return CMul(a, b)


def _invariant_at(e: CRExpr, depth: int) -> bool:
    return all(c.depth < depth for c in e.crs()) and not has_opaque(e)


def _mentions_depth(e: CRExpr, depth: int) -> bool:
    return any(c.depth == depth for c in e.crs())


# ---------------------------------------------------------------------------
# Whole-expression predicates (paper §3.2 / §3.4.1)
# ---------------------------------------------------------------------------

def is_affine_expr(e: CRExpr) -> bool:
    crs = e.crs()
    return bool(crs) and all(c.is_affine for c in crs) and not has_opaque(e)


def is_monotonic_expr(e: CRExpr) -> bool:
    """Paper: an address expression is monotonic w.r.t. a loop depth iff
    the CR expression consists of only monotonic CRs."""
    if has_opaque(e):
        return False
    crs = e.crs()
    return all(c.is_monotonic for c in crs)


def has_opaque(e: CRExpr) -> bool:
    """True iff ``e`` contains a ``COpaque`` term anywhere — i.e. the
    analysis cannot see the whole value evolution (a data-dependent read
    or an untranslatable sub-expression hides part of it)."""
    if isinstance(e, COpaque):
        return True
    if isinstance(e, (CAdd, CMul)):
        return has_opaque(e.a) or has_opaque(e.b)
    if isinstance(e, CR):
        return has_opaque(e.base) or has_opaque(e.step)
    return False


def step_at_depth(e: CRExpr, depth: int) -> Optional[CRExpr]:
    """The (summed) step contribution of loop ``depth`` to expression
    ``e``.

    If no CR at ``depth`` appears and the expression is opaque-free, the
    address is invariant in that loop — the step is literally 0. (The
    paper's "CR_k might not exist -> trivially non-monotonic" covers the
    *unanalyzable* case, which the opaque path handles before we get
    here.) Returns None only when an opaque term hides the dependence.
    """
    steps = [c.step for c in e.crs() if c.depth == depth]
    if not steps:
        return None if has_opaque(e) else CConst(0)
    out = steps[0]
    for s in steps[1:]:
        out = cr_add(out, s)
    return out


def _factors(e: CRExpr) -> tuple[int, tuple]:
    """Flatten a product into (constant coefficient, sorted symbolic
    factors) for light symbolic comparison."""
    if isinstance(e, CConst):
        return e.v, ()
    if isinstance(e, CMul):
        ca, fa = _factors(e.a)
        cb, fb = _factors(e.b)
        return ca * cb, tuple(sorted(fa + fb, key=repr))
    return 1, (e,)


def symbolic_ge(a: CRExpr, b: CRExpr) -> bool:
    """Best-effort proof that ``a >= b`` for all symbol values.

    1. structural equality,
    2. equal symbolic factor multisets with coefficient comparison
       (proves 2*half >= 1*half, M >= M, ...),
    3. conservative interval fallback: min(a) >= max(b).
    Returns False when no proof is found (callers treat that as "may be
    smaller" — conservative for the §3.4.1 check).
    """
    if a == b:
        return True
    ca, fa = _factors(a)
    cb, fb = _factors(b)
    if fa == fb and ca >= cb >= 0:
        return True
    # pointwise CR comparison: same loop & operator, step_a >= step_b and
    # base_a >= base_b (>=0 for multiplicative) implies a >= b everywhere
    if (
        isinstance(a, CR)
        and isinstance(b, CR)
        and a.depth == b.depth
        and a.op == b.op
        and b.base.range().lo >= 0
        and b.step.range().lo >= (1 if a.op == "*" else 0)
        and symbolic_ge(a.base, b.base)
        and symbolic_ge(a.step, b.step)
    ):
        return True
    return a.range().lo >= b.range().hi


def non_monotonic_depths(
    e: CRExpr, trip_counts: dict[int, CRExpr], n_depths: int
) -> set[int]:
    """§3.4.1 detection: depth k (1..n_depths) is non-monotonic if some
    deeper depth j contributes more per full execution than one k-step:
    ``CR_k.step < CR_j.step * tripCount_j``.

    ``trip_counts[j]`` is the (symbolic) trip count of depth j. The
    comparison is attempted symbolically first (structural equality of
    the simplified expressions handles the paper's row-major ``M`` vs
    ``M`` case); otherwise symbols fall back to conservative interval
    comparison (min step vs max contribution) — false positives
    possible, never false negatives. The innermost depth is
    non-monotonic iff its step can be negative (the paper *requires*
    innermost monotonicity; callers reject such ops or demand
    annotations).
    """
    out: set[int] = set()
    steps: dict[int, Optional[CRExpr]] = {
        k: step_at_depth(e, k) for k in range(1, n_depths + 1)
    }
    for k in range(1, n_depths + 1):
        sk = steps[k]
        if sk is None:
            out.add(k)
            continue
        rk = sk.range()
        if rk.lo < 0:
            out.add(k)
            continue
        for j in range(k + 1, n_depths + 1):
            sj = steps[j]
            if sj is None:
                # deeper depth contributes an unknown amount
                out.add(k)
                break
            contrib = cr_mul(sj, trip_counts.get(j, CSym(f"__trip{j}", 0, INF)))
            # monotonic w.r.t. this j iff step_k >= step_j * trip_j, proven
            # symbolically where possible (row-major M vs M; FFT 2*half
            # vs half) else by conservative intervals
            if not symbolic_ge(sk, contrib):
                out.add(k)
                break
    return out


# ---------------------------------------------------------------------------
# Dependence-certificate primitives (analysis/deps.py, DESIGN.md §12)
#
# Everything below reasons about the *value set* and *evolution* of an
# address stream over a full loop nest, rather than per-depth
# monotonicity: trip-aware value ranges (interval disjointness), residue
# classes (stride disjointness: a[2i] vs a[2i+1]), exact stream
# differences, and a lower bound on the increase between consecutive
# nest instances. All are conservative — a ``None``/trivial answer is
# always allowed, a definite answer must hold for every in-range
# assignment of symbols.
# ---------------------------------------------------------------------------


def cr_diff(a: CRExpr, b: CRExpr) -> CRExpr:
    """``a - b`` with zero-step add-recurrences collapsed to their base.

    The collapse makes identical (or offset-identical) streams fold to a
    constant: ``{0,+,1}@1 - {0,+,1}@1`` becomes ``0``, not
    ``{0,+,0}@1`` — which is what lets the certifier prove exact
    per-instance differences."""
    return _collapse(cr_add(a, cr_mul(CConst(-1), b)))


def _collapse(e: CRExpr) -> CRExpr:
    if isinstance(e, CR):
        base = _collapse(e.base)
        step = _collapse(e.step)
        if e.op == "+" and step == CConst(0):
            return base
        return CR(base, e.op, step, e.depth)
    if isinstance(e, CAdd):
        return cr_add(_collapse(e.a), _collapse(e.b))
    if isinstance(e, CMul):
        return cr_mul(_collapse(e.a), _collapse(e.b))
    return e


def value_range(e: CRExpr, trips: dict[int, CRExpr]) -> Interval:
    """Trip-aware range of ``e`` over one full execution of its nest.

    Unlike ``CR.range`` (which has no trip information and answers
    ``[lo, INF)`` for any non-negative step), an add-recurrence at depth
    ``d`` contributes ``step * [0, trip_d - 1]``, so two streams with
    disjoint footprints (``a[i]`` vs ``a[T + i]`` with ``i < T``) get
    provably disjoint intervals. ``trips[d]`` is the symbolic trip count
    of depth ``d``; missing depths fall back to unbounded. Opaque terms
    contribute their asserted range (§3.3 annotations), so hinted
    data-dependent streams still participate in range disjointness."""
    if isinstance(e, CR):
        if e.op == "+":
            b = value_range(e.base, trips)
            s = value_range(e.step, trips)
            t = trips.get(e.depth)
            t_hi = t.range().hi if t is not None else INF
            iters = Interval(0, clamp(max(t_hi - 1, 0)))
            return b + s * iters
        return e.range()
    if isinstance(e, CAdd):
        return value_range(e.a, trips) + value_range(e.b, trips)
    if isinstance(e, CMul):
        return value_range(e.a, trips) * value_range(e.b, trips)
    return e.range()


def base_value(e: CRExpr) -> Optional[int]:
    """The concrete value of ``e`` at the all-zero iteration vector, or
    None when it is not a known integer (symbols, opaque terms,
    multiplicative recurrences)."""
    if isinstance(e, CConst):
        return e.v
    if isinstance(e, CR):
        return base_value(e.base) if e.op == "+" else None
    if isinstance(e, CAdd):
        a, b = base_value(e.a), base_value(e.b)
        return None if a is None or b is None else a + b
    if isinstance(e, CMul):
        a, b = base_value(e.a), base_value(e.b)
        return None if a is None or b is None else a * b
    return None


def residue_class(e: CRExpr) -> Optional[tuple[int, int]]:
    """``(g, r)`` such that every value of ``e`` is ``≡ r (mod g)``.

    Requires every recurrence to be additive with a *constant* step and
    a constant base value: the stream is then ``r + Σ_d s_d·i_d`` with
    ``g = gcd(s_d)``. ``g == 0`` means the stream is the single constant
    ``r``. Returns None when no such proof exists. This is the stride
    lens of the certifier: ``a[2i]`` → ``(2, 0)`` vs ``a[2i+1]`` →
    ``(2, 1)`` proves disjointness regardless of trip counts."""
    if has_opaque(e):
        return None
    crs = e.crs()
    if any(c.op != "+" for c in crs):
        return None
    b0 = base_value(e)
    if b0 is None:
        return None
    g = 0
    for d in {c.depth for c in crs}:
        s = step_at_depth(e, d)
        if not isinstance(s, CConst):
            return None
        g = math.gcd(g, abs(s.v))
    return (g, b0 % g if g else b0)


def residues_disjoint(
    a: Optional[tuple[int, int]], b: Optional[tuple[int, int]]
) -> bool:
    """True iff the two residue classes can never produce equal values:
    distinct constants, or residues that differ mod ``gcd(g_a, g_b) ≥ 2``."""
    if a is None or b is None:
        return False
    (ga, ra), (gb, rb) = a, b
    m = math.gcd(ga, gb)
    if m == 0:
        return ra != rb
    return m >= 2 and (ra - rb) % m != 0


def min_adjacent_increase(
    e: CRExpr, trips: dict[int, CRExpr], n_depths: int
) -> Optional[int]:
    """Conservative lower bound on ``e(next) - e(cur)`` over *adjacent*
    instances of an ``n_depths``-deep nest (lexicographic order).

    When the outermost coordinate that advances is depth ``m``, the
    difference is ``step_m - Σ_{j>m} step_j · (executed iterations of
    j)``, so the bound at ``m`` is ``lo(step_m) + Σ_{j>m}
    lo(step_j · [-(trip_j - 1), 0])`` and the result is the min over
    ``m``. ``≥ 1`` proves the stream strictly increasing (hence
    injective). None when opaque or multiplicative recurrences make the
    per-iteration delta unknown."""
    if has_opaque(e) or any(c.op == "*" for c in e.crs()):
        return None
    lo = None
    for m in range(1, n_depths + 1):
        sm = step_at_depth(e, m)
        if sm is None:
            return None
        bound = sm.range().lo
        for j in range(m + 1, n_depths + 1):
            sj = step_at_depth(e, j)
            if sj is None:
                return None
            t = trips.get(j)
            t_hi = t.range().hi if t is not None else INF
            back = Interval(clamp(-max(t_hi - 1, 0)), 0)
            bound = clamp(bound + (sj.range() * back).lo)
        lo = bound if lo is None else min(lo, bound)
    return lo
