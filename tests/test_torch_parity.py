"""The port's front-end against the JAX package's, on the Table-1
programs: the program registry, the sequential oracle, the
monotonicity verdicts, ``loopir.from_reference`` and every ``WavePlan``
field under both trace modes — all bit-identical.

Scales are those of ``tests/test_pallas_parity.py``. Both packages get
the same inputs: each builds a program from its own registry, and the
arrays must come out bit-identical before anything else is compared.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import executor as ref_executor
from repro.core import loopir as ref_ir
from repro.core import monotonic as ref_monotonic
from repro.core import programs as ref_programs
from repro_torch.core import executor, loopir as ir, monotonic, programs

SCALES = {
    "RAWloop": 96, "WARloop": 96, "WAWloop": 96,
    "bnn": 12, "pagerank": 16, "fft": 32, "matpower": 12,
    "hist+add": 96, "tanh+spmv": 64,
}
TABLE1 = tuple(ref_programs.TABLE1)


def canon(x):
    """A package-independent, bit-exact encoding of nested values:
    dataclasses by class name and fields, arrays by dtype, shape and
    bytes, floats by their hex form (NaN-aware)."""
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        return (type(x).__name__,) + tuple(
            (f.name, canon(getattr(x, f.name))) for f in dataclasses.fields(x)
        )
    if isinstance(x, np.ndarray):
        return ("nd", x.dtype.str, x.shape, x.tobytes())
    if isinstance(x, dict):
        return ("dict",) + tuple((k, canon(v)) for k, v in sorted(x.items()))
    if isinstance(x, (list, tuple)):
        return (type(x).__name__,) + tuple(canon(v) for v in x)
    if isinstance(x, frozenset):
        return ("frozenset",) + tuple(sorted(canon(v) for v in x))
    if isinstance(x, (float, np.floating)):
        return ("f", float(x).hex())
    return x


def _make_both(name):
    ref = ref_programs.get(name).make(SCALES[name])
    port = programs.get(name).make(SCALES[name])
    return ref, port


def _assert_arrays_bit_identical(a, b, what):
    assert sorted(a) == sorted(b), what
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, f"{what}: {k}"
        assert x.tobytes() == y.tobytes(), f"{what}: {k} differs"


def test_registry_matches_reference():
    assert tuple(programs.TABLE1) == TABLE1
    assert programs.all_names() == ref_programs.all_names()


@pytest.mark.parametrize("name", TABLE1)
def test_programs_oracle_and_verdicts_match(name):
    (rprog, rarrays, rparams), (prog, arrays, params) = _make_both(name)
    assert prog.fingerprint() == rprog.fingerprint()
    assert params == rparams
    _assert_arrays_bit_identical(arrays, rarrays, f"{name}: make()")
    _assert_arrays_bit_identical(
        ir.interpret(prog, arrays, params),
        ref_ir.interpret(rprog, rarrays, rparams),
        f"{name}: oracle",
    )
    assert canon(monotonic.analyze_program(prog)) == canon(
        ref_monotonic.analyze_program(rprog)
    )


@pytest.mark.parametrize("name", TABLE1)
def test_from_reference_rebuilds_program(name):
    (rprog, rarrays, rparams), (prog, _, _) = _make_both(name)
    conv = ir.from_reference(rprog)
    assert type(conv) is ir.Program
    assert conv.fingerprint() == rprog.fingerprint() == prog.fingerprint()
    assert canon(conv) == canon(prog)
    for op, _path in conv.mem_ops():
        assert type(op) in (ir.Load, ir.Store)
    _assert_arrays_bit_identical(
        ir.interpret(conv, rarrays, rparams),
        ref_ir.interpret(rprog, rarrays, rparams),
        f"{name}: oracle on the converted program",
    )


def test_from_reference_rejects_unknown_nodes():
    @dataclasses.dataclass(frozen=True)
    class Mystery:
        v: int

    with pytest.raises(TypeError, match="Mystery"):
        ir.from_reference(Mystery(1))


def test_wave_plan_has_reference_fields():
    names = [f.name for f in dataclasses.fields(executor.WavePlan)]
    assert names == [f.name for f in dataclasses.fields(ref_executor.WavePlan)]
    stats = [f.name for f in dataclasses.fields(executor.WaveStats)]
    assert stats == [f.name for f in dataclasses.fields(ref_executor.WaveStats)]


@pytest.mark.parametrize("trace_mode", ["interp", "compiled"])
@pytest.mark.parametrize("name", TABLE1)
def test_wave_plan_fields_match(name, trace_mode):
    (rprog, rarrays, rparams), (prog, arrays, params) = _make_both(name)
    rplan = ref_executor.build_wave_plan(
        rprog, rarrays, rparams, trace_mode=trace_mode
    )
    plan = executor.build_wave_plan(prog, arrays, params, trace_mode=trace_mode)
    executor.validate_plan(plan)
    for f in dataclasses.fields(plan):
        got, want = getattr(plan, f.name), getattr(rplan, f.name)
        if f.name == "program":
            assert got.fingerprint() == want.fingerprint()
        else:
            assert canon(got) == canon(want), f"{name}/{trace_mode}: {f.name}"
