"""A program outside the affine trace compiler's subset, pinned in both
packages.

``tests/loopir_strategies.py`` can draw a program whose nested geometric
induction variables (``iv9 *= 2`` inside ``iv7 *= 3``) drive an address
past int64. The reference's differential fuzz test
(``test_trace_compile.py::test_compiled_trace_equals_interpreter``)
fails on it, since neither path can trace it: the interpreter overflows
converting the address to an int64 array, and the compiler rejects the
``*`` accumulation at build time. The port is faithful to that: both
packages reject the program the same way, and this test holds them to
it with the program written out as LoopIR.
"""

import numpy as np
import pytest

from repro.core import dae as ref_dae
from repro.core import loopir as ref_ir
from repro.core import schedule as ref_schedule
from repro_torch.core import dae as port_dae
from repro_torch.core import loopir as port_ir
from repro_torch.core import schedule as port_schedule

BIG = 1_000_000_000_000_000_000  # the strategy's bounds on idx_a/idx_b reads

PACKAGES = {
    "repro": (ref_ir, ref_dae, ref_schedule),
    "repro_torch": (port_ir, port_dae, port_schedule),
}


def _program(ir):
    """The fuzz program, built with one package's LoopIR."""
    C, V, P = ir.Const, ir.Var, ir.Param("P", lo=0, hi=8)

    def lin(var, a, b):  # var * a + b
        return ir.Bin("+", ir.Bin("*", V(var), C(a)), C(b))

    def idx(array, e):  # array[e % 24]
        return ir.Read(array, ir.Bin("%", e, C(24)), lo=-BIG, hi=BIG)

    def load(op, addr):
        return ir.Load(op, "A", addr, hint=None)

    def store(op, addr):
        return ir.Store(op, "A", addr, C(1.0), guard=None, hint=None)

    v3 = ir.Loop(
        "v3", ir.Bin("+", V("v1"), C(0)),
        (store("op4", ir.Bin("+", idx("idx_a", lin("v3", 2, 3)),
                             lin("v1", 1, 2))),
         load("op5", ir.Bin("+", idx("idx_a", lin("v1", 3, 1)),
                            lin("v2", 1, 3)))),
        ivars=(), predictable=False,
    )
    v4 = ir.Loop(
        "v4", ir.Bin("-", C(0), V("v2")),
        (load("op6", ir.Bin("+", idx("idx_a", lin("iv4", 3, 1)),
                            lin("v2", 1, 1))),),
        ivars=(ir.IVar("iv4", C(1), "*", C(3)),), predictable=True,
    )
    v2 = ir.Loop(
        "v2", ir.Bin("+", V("v1"), C(0)),
        (store("op3", ir.Bin("+", idx("idx_a", lin("v1", 2, 2)),
                             lin("v1", 2, 3))),
         v3, v4),
        ivars=(), predictable=True,
    )
    v1 = ir.Loop(
        "v1", C(2),
        (load("op1", ir.Bin("+", idx("idx_a", lin("v1", 1, 2)),
                            lin("v1", 2, 1))),
         load("op2", ir.Bin("+", idx("idx_a", lin("v1", 1, 1)),
                            lin("v1", 2, 0))),
         v2),
        ivars=(), predictable=True,
    )
    v6 = ir.Loop(
        "v6", P,
        (store("op7", ir.Bin("+", idx("idx_a", lin("v5", 2, 2)),
                             lin("v6", 1, 1))),),
        ivars=(ir.IVar("iv6", C(2), "*", C(3)),), predictable=True,
    )
    v8 = ir.Loop(
        "v8", P,
        (store("op10", ir.Bin("+", lin("v5", 3, 3), lin("v5", 3, 1))),
         load("op11", idx("idx_b", ir.Bin(
             "+", idx("idx_a", lin("v5", 1, 3)), lin("v5", 1, 3))))),
        ivars=(), predictable=False,
    )
    v9 = ir.Loop(
        "v9", ir.Bin("+", V("iv7"), C(0)),
        (store("op12", ir.Bin("+", idx("idx_a", lin("v9", 2, 0)),
                              lin("v7", 1, 4))),
         load("op13", ir.Bin("+", lin("iv9", 3, 0), P))),
        ivars=(ir.IVar("iv9", C(2), "*", C(2)),), predictable=False,
    )
    v7 = ir.Loop(
        "v7", P,
        (load("op8", ir.Bin("+", lin("iv7", 3, 0), P)),
         store("op9", ir.Bin("+", lin("v7", 1, 0), P)),
         v8, v9),
        ivars=(ir.IVar("iv7", C(2), "*", C(3)),), predictable=False,
    )
    v5 = ir.Loop("v5", P, (v6, v7), ivars=(), predictable=True)
    return ir.Program("fuzz", loops=(v1, v5), params=("P",))


def _arrays():
    return {
        "idx_a": np.array([29, 30, 14, 4, 37, 16, 26, 6, 14, 1, 25, 30, 0,
                           29, 9, 37, 9, 32, 8, 5, 13, 20, 6, 25]),
        "idx_b": np.array([35, 14, 4, 18, 24, 2, 15, 29, 16, 12, 3, 11, 0,
                           32, 6, 26, 3, 38, 29, 33, 1, 33, 26, 31]),
        "trips": np.array([2, 0, 0, 2, 0, 1, 1, 2, 0, 1, 3, 2, 1, 1, 1, 2,
                           1, 0, 0, 1, 0, 1, 0, 0]),
        "vals": np.array([
            0.94965852, -0.35633665, 1.86096083, 0.70797527, 0.22432292,
            -0.35494737, -0.72037351, -0.22516415, 0.70312608, -0.22216779,
            0.73876681, -0.49298337, 0.13284503, 0.37591595, 0.12173537,
            -0.14778285, -0.86207638, -1.62965605, -0.03923404, 0.16352642,
            -0.47442732, 0.70093379, 0.804239, -1.81947327]),
        "A": np.array([0.0]),
    }


@pytest.mark.parametrize("mode", ["interp", "compiled"])
@pytest.mark.parametrize("package", sorted(PACKAGES))
def test_geometric_ivar_past_int64_is_rejected_alike(package, mode):
    """The interpreter overflows on the address; the compiler rejects the
    ``*`` accumulation of ``iv9`` before tracing."""
    ir, dae, schedule = PACKAGES[package]
    prog = _program(ir)
    error = OverflowError if mode == "interp" else schedule.TraceCompileError
    with pytest.raises(error) as info:
        schedule.trace_program(prog, dae.decouple(prog), _arrays(), {"P": 5},
                               mode=mode)
    if mode == "compiled":
        assert "iv9" in str(info.value) and "int64" in str(info.value)


def test_fuzz_program_is_the_same_in_both_packages():
    """Built from the same literals, the two packages' programs convert
    into each other (``from_reference``)."""
    assert port_ir.from_reference(_program(ref_ir)) == _program(port_ir)
