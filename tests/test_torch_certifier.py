"""The port's symbolic dependence certifier against the JAX package's, on
the CPU.

``repro_torch.analysis.deps`` is what the wave executor's main path
calls (``build_wave_plan``'s symbolic admission, the ``MonotonicHint``
checks) and what ``static_prune`` rests on. Held here, equal to the
reference's:

  * ``certify_pairs`` verdicts over every kept and pruned hazard pair,
    on the 25 seeded random affine programs and on the registered
    non-speculative programs;
  * the ``symbolically_free_ops`` certificates, and the wave plans'
    symbolic-admission counts;
  * the ``HintViolation`` a contradictory hint raises: the same op,
    instance, address and previous address through ``execute(...,
    validate_hints=True, device="cpu")`` (the stream position, which the
    op's trace maps onto the engines' instance) and through
    ``simulate(mode="FUS2")`` under both engines.

Random programs are drawn with the reference's LoopIR
(``loopir_strategies``) and carried over with ``loopir.from_reference``.
"""

import numpy as np
import pytest

from repro.analysis import deps as ref_deps
from repro.core import dae as ref_dae
from repro.core import executor as ref_executor
from repro.core import hazards as ref_hz
from repro.core import loopir as ref_ir
from repro.core import monotonic as ref_mono
from repro.core import programs as ref_programs
from repro.core import simulator as ref_simulator
from repro_torch.analysis import deps
from repro_torch.core import dae, executor, hazards as hz
from repro_torch.core import loopir as ir
from repro_torch.core import monotonic as mono
from repro_torch.core import programs, schedule, simulator

from loopir_strategies import random_affine_program
from test_torch_parity import canon

NONSPEC = sorted(
    n for n in ref_programs.REGISTRY if not ref_programs.get(n).speculative
)


def _small_scale(name):
    return max(8, ref_programs.get(name).default_scale // 8)


def _verdicts(dae_mod, mono_mod, hz_mod, deps_mod, prog):
    dres = dae_mod.decouple(prog)
    plan = hz_mod.build_plan(prog, dres, mono_mod.analyze_program(prog),
                             forwarding=False)
    pairs = list(plan.pairs) + [p for p, _r in plan.pruned]
    facts = deps_mod.stream_facts(prog)
    verdicts = deps_mod.certify_pairs(prog, pairs, facts=facts)
    free = deps_mod.symbolically_free_ops(prog, facts=facts)
    return [(p.dst, p.src, p.kind) for p in pairs], verdicts, free


def _assert_certifier_equal(ref_prog, prog):
    want = _verdicts(ref_dae, ref_mono, ref_hz, ref_deps, ref_prog)
    got = _verdicts(dae, mono, hz, deps, prog)
    assert got[0] == want[0], "hazard pairs differ"
    assert canon(got[1]) == canon(want[1]), "certify_pairs verdicts differ"
    assert got[2] == want[2], "symbolically_free_ops differ"
    return got


@pytest.mark.parametrize("seed", range(25))
def test_certifier_matches_reference_fuzz(seed):
    rng = np.random.default_rng(seed)
    ref_prog, _arrays, _params = random_affine_program(rng)
    _assert_certifier_equal(ref_prog, ir.from_reference(ref_prog))


@pytest.mark.parametrize("name", NONSPEC)
def test_certifier_matches_reference_registered(name):
    ref_prog, _a, _p = ref_programs.get(name).make(_small_scale(name))
    prog, _a, _p = programs.get(name).make(_small_scale(name))
    _assert_certifier_equal(ref_prog, prog)


def test_certifier_finds_forced_pass_on_table1_kernel():
    """tanh+spmv's intra-PE RAW on the gather array is provably
    droppable, in both packages."""
    prog, _a, _p = programs.get("tanh+spmv").make(64)
    _pairs, verdicts, _free = _assert_certifier_equal(
        ref_programs.get("tanh+spmv").make(64)[0], prog
    )
    assert any(v.forced_pass for v in verdicts.values())


@pytest.mark.parametrize("name", ["RAWloop", "stream_dot", "hist+add"])
def test_symbolic_admission_counts_match_reference(name):
    ref_prog, arrays, params = ref_programs.get(name).make(_small_scale(name))
    prog, _a, _p = programs.get(name).make(_small_scale(name))
    for on in (True, False):
        want = ref_executor.build_wave_plan(
            ref_prog, arrays, params, symbolic_admission=on
        )
        got = executor.build_wave_plan(
            prog, arrays, params, symbolic_admission=on
        )
        assert got.stats.n_sym_requests == want.stats.n_sym_requests
        assert got.stats.sym_ops == want.stats.sym_ops
        np.testing.assert_array_equal(got.req_step, want.req_step)
    assert got.stats.n_sym_requests == 0  # off: nothing admitted
    assert want.stats.n_sym_requests == 0


# ---------------------------------------------------------------------------
# contradictory hints: the same HintViolation in both packages
# ---------------------------------------------------------------------------


def _lying_hint_program(ir_mod, n=8):
    """Address (n-1)-i strictly decreases inside the innermost loop while
    the hint swears it is monotonic."""
    hint = ir_mod.MonotonicHint(innermost_monotonic=True)
    loop = ir_mod.Loop("i", ir_mod.Const(n), (
        ir_mod.Load("ld_a", "A",
                    ir_mod.Bin("-", ir_mod.Const(n - 1), ir_mod.Var("i")),
                    hint=hint),
        ir_mod.Store("st_o", "out", ir_mod.Var("i"), ir_mod.LoadVal("ld_a")),
    ))
    arrays = {
        "A": np.arange(n, dtype=np.float64),
        "out": np.zeros(n, dtype=np.float64),
    }
    return ir_mod.Program("lying_hint", loops=(loop,)), arrays, {}


def _omitted_reset_program(ir_mod, outer=3, inner=4, resets=frozenset()):
    """Address j resets every outer iteration; the hint's explicit
    ``non_monotonic_outer`` omits depth 1 (unless ``resets`` admits it),
    so every reset is a lie."""
    hint = ir_mod.MonotonicHint(
        innermost_monotonic=True, non_monotonic_outer=resets
    )
    loop = ir_mod.Loop("i", ir_mod.Const(outer), (
        ir_mod.Loop("j", ir_mod.Const(inner), (
            ir_mod.Load("ld_a", "A", ir_mod.Var("j"), hint=hint),
            ir_mod.Store("st_o", "out",
                         ir_mod.Var("i") * inner + ir_mod.Var("j"),
                         ir_mod.LoadVal("ld_a")),
        )),
    ))
    arrays = {
        "A": np.arange(inner, dtype=np.float64),
        "out": np.zeros(outer * inner, dtype=np.float64),
    }
    return ir_mod.Program("omitted_reset", loops=(loop,)), arrays, {}


HINT_PROGRAMS = [_lying_hint_program, _omitted_reset_program]


def _violation(fn, error=deps.HintViolation):
    with pytest.raises(error) as exc:
        fn()
    e = exc.value
    return e.op_id, e.instance, e.addr, e.prev_addr, str(e)


def _ref_violation(fn):
    return _violation(fn, ref_deps.HintViolation)


@pytest.mark.parametrize("engine", ["event", "cycle"])
@pytest.mark.parametrize("make", HINT_PROGRAMS)
def test_hint_violation_simulate_matches_reference(make, engine):
    prog, arrays, params = make(ir)
    got = _violation(lambda: simulator.simulate(
        prog, arrays, params, mode="FUS2", engine=engine,
        validate_hints=True,
    ))
    rprog, rarrays, rparams = make(ref_ir)
    want = _ref_violation(lambda: ref_simulator.simulate(
        rprog, rarrays, rparams, mode="FUS2", engine=engine,
        validate_hints=True,
    ))
    assert got == want
    assert got[0] == "ld_a" and got[2] < got[3]


@pytest.mark.parametrize("make", HINT_PROGRAMS)
def test_hint_violation_execute_matches_reference_and_engines(make):
    """``execute`` checks hints on the plan's streams before any step
    runs and names the op's stream position; that position is the
    engines' instance once mapped through the op's trace."""
    prog, arrays, params = make(ir)
    got = _violation(lambda: executor.execute(
        prog, arrays, params, validate_hints=True, device="cpu"
    ))
    plan = executor.build_wave_plan(prog, arrays, params)
    assert _violation(lambda: executor.validate_plan_hints(plan)) == got
    rprog, rarrays, rparams = make(ref_ir)
    want = _ref_violation(lambda: ref_executor.execute(
        rprog, rarrays, rparams, validate_hints=True
    ))
    assert got == want
    op, pos, addr, prev, _msg = got
    trace = schedule.trace_program(
        prog, dae.decouple(prog), arrays, params, mode="auto"
    )[op]
    for engine in ("event", "cycle"):
        sim = _violation(lambda: simulator.simulate(
            prog, arrays, params, mode="FUS2", engine=engine,
            validate_hints=True,
        ))
        assert (sim[0], sim[2], sim[3]) == (op, addr, prev)
        assert sim[1] == tuple(int(v) for v in trace.sched[pos])
        assert int(trace.addr[pos]) == addr


def test_truthful_hint_passes_and_runs():
    """Admitting the depth-1 reset makes the hint true: the sanitizer
    passes in both entry points and the arrays equal the oracle's."""
    fixed, arrays, params = _omitted_reset_program(ir, resets=frozenset({1}))
    oracle = ir.interpret(fixed, arrays, params)
    res = simulator.simulate(fixed, arrays, params, mode="FUS2",
                             validate_hints=True)
    ex = executor.execute(fixed, arrays, params, validate_hints=True,
                          device="cpu")
    for k in oracle:
        np.testing.assert_array_equal(res.arrays[k], oracle[k])
        np.testing.assert_array_equal(ex.arrays[k], oracle[k])
    assert res.cycles > 0


def test_check_hint_stream_matches_reference():
    sched = np.array([[0, 0], [0, 1], [1, 0], [1, 1]], dtype=np.int64)
    for ok, addrs in ((True, [5, 9, 2, 4]), (False, [5, 3, 6, 7])):
        hint = ir.MonotonicHint(innermost_monotonic=True,
                                non_monotonic_outer=frozenset({1}))
        ref_hint = ref_ir.MonotonicHint(innermost_monotonic=True,
                                        non_monotonic_outer=frozenset({1}))
        args = ("op", np.array(addrs), sched)
        if ok:
            deps.check_hint_stream(*args, hint)
            ref_deps.check_hint_stream(*args, ref_hint)
            continue
        got = _violation(lambda: deps.check_hint_stream(*args, hint))
        want = _ref_violation(
            lambda: ref_deps.check_hint_stream(*args, ref_hint)
        )
        assert got == want
        assert got[1:4] == ((0, 1), 3, 5)
