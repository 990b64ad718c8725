"""The port's linter against the JAX package's, on the CPU.

``repro_torch.analysis.lint`` is numpy and plain Python, as the
reference's is. Held here: the code registry and severities, the
committed ``--all`` fixture byte for byte, every registered program's
diagnostics as ``(code, severity, kernel, where, message)`` tuples equal
to the reference's, the doomed-FIFO and contradictory-hint programs,
and a program file loaded through the CLI. Each package builds its
programs from its own registry (or its own LoopIR classes) with the
same scale, so the diagnostics must be equal, not merely alike.
"""

import io
import os
from contextlib import redirect_stdout

import pytest

from repro.analysis import lint as ref_lint
from repro.core import loopir as ref_ir
from repro.core import programs as ref_programs
from repro_torch.analysis import lint
from repro_torch.core import loopir as ir
from repro_torch.core import programs

from test_torch_certifier import HINT_PROGRAMS, _omitted_reset_program

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "lint_all.txt")


def _tuples(diags):
    return [(d.code, d.severity, d.kernel, d.where, d.message) for d in diags]


def _run_main(main, argv):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def test_lint_codes_and_severities_pinned():
    assert sorted(lint.CODES) == [
        "RPL001", "RPL002", "RPL003", "RPL004", "RPL005",
    ]
    assert lint.CODES == ref_lint.CODES
    assert tuple(lint.SEVERITIES) == ("error", "warning", "info")
    assert tuple(lint.SEVERITIES) == tuple(ref_lint.SEVERITIES)


def test_lint_all_matches_committed_fixture():
    """``python -m repro_torch.analysis.lint --all`` reproduces the
    reference's committed fixture byte for byte, summary line included."""
    rc, out = _run_main(lint.main, ["--all"])
    assert rc == 0
    with open(FIXTURE, "r", encoding="utf-8") as f:
        assert out == f.read()


@pytest.mark.parametrize("name", sorted(ref_programs.REGISTRY))
def test_lint_program_matches_reference(name):
    assert sorted(programs.REGISTRY) == sorted(ref_programs.REGISTRY)
    scale = ref_programs.get(name).default_scale
    want = ref_lint.lint_kernel(name, scale)
    got = lint.lint_kernel(name, scale)
    assert _tuples(got) == _tuples(want)


def _fifo_cycle(ir_mod):
    """A cross-PE scalar cycle: each loop's local feeds the other's."""
    n = 8
    loops = (
        ir_mod.Loop("i", ir_mod.Const(n), (
            ir_mod.SetLocal("x", ir_mod.Var("i") + ir_mod.Local("y")),
            ir_mod.Store("st_a", "A", ir_mod.Var("i"), ir_mod.Local("x")),
        )),
        ir_mod.Loop("j", ir_mod.Const(n), (
            ir_mod.SetLocal("y", ir_mod.Var("j") + ir_mod.Local("x")),
            ir_mod.Store("st_b", "B", ir_mod.Var("j"), ir_mod.Local("y")),
        )),
    )
    return ir_mod.Program("fifo_cycle", loops=loops)


def test_lint_flags_doomed_fifo_topology():
    got = lint.lint_program(_fifo_cycle(ir), kernel="fifo_cycle")
    assert any(d.code == "RPL004" and d.severity == "error" for d in got)
    want = ref_lint.lint_program(_fifo_cycle(ref_ir), kernel="fifo_cycle")
    assert _tuples(got) == _tuples(want)


@pytest.mark.parametrize("make", HINT_PROGRAMS)
def test_contradictory_hint_gives_rpl001(make):
    prog = make(ir)[0]
    got = lint.lint_program(prog, kernel=prog.name)
    hits = [d for d in got if d.code == "RPL001"]
    assert hits and all(d.severity == "error" for d in hits)
    assert any(d.where == "ld_a" for d in hits)
    want = ref_lint.lint_program(make(ref_ir)[0], kernel=prog.name)
    assert _tuples(got) == _tuples(want)


def test_truthful_hint_is_flagged_redundant():
    """Admitting the depth-1 reset makes the hint true, and the address
    is fully CR-analyzable, so the hint is redundant (RPL002)."""
    prog = _omitted_reset_program(ir, resets=frozenset({1}))[0]
    got = lint.lint_program(prog, kernel="fixed")
    assert any(d.code == "RPL002" and d.where == "ld_a" for d in got)
    assert not any(d.code == "RPL001" for d in got)
    want = ref_lint.lint_program(
        _omitted_reset_program(ref_ir, resets=frozenset({1}))[0],
        kernel="fixed",
    )
    assert _tuples(got) == _tuples(want)


# a lintable file: the lying-hint program, written against one package's
# LoopIR, as a ``program`` variable or a ``make()`` returning the
# registry's (program, arrays, params) tuple
_FILE = '''
import numpy as np
from {pkg}.core import loopir as ir

n = 8
hint = ir.MonotonicHint(innermost_monotonic=True)
lying = ir.Program("lying_hint", loops=(ir.Loop("i", ir.Const(n), (
    ir.Load("ld_a", "A", ir.Bin("-", ir.Const(n - 1), ir.Var("i")),
            hint=hint),
    ir.Store("st_o", "out", ir.Var("i"), ir.LoadVal("ld_a")),
)),))
{tail}
'''
_TAILS = {
    "program": "program = lying\n",
    "make": "def make():\n    return lying, {'A': np.arange(8.0)}, {}\n",
}


@pytest.mark.parametrize("form", sorted(_TAILS))
def test_cli_lints_a_program_file(tmp_path, form):
    """The CLI executes a user file that builds its program with the
    port's LoopIR and prints what the reference prints for the same
    file written against its own (same path, so the same label)."""
    path = tmp_path / "prog.py"
    path.write_text(_FILE.format(pkg="repro_torch", tail=_TAILS[form]))
    rc, out = _run_main(lint.main, [str(path)])
    path.write_text(_FILE.format(pkg="repro", tail=_TAILS[form]))
    ref_rc, ref_out = _run_main(ref_lint.main, [str(path)])
    assert (rc, out) == (ref_rc, ref_out)
    assert rc == 1
    assert f"{path}: RPL001 error [ld_a]" in out
    assert out.endswith(
        "linted 1 program(s): 1 error(s), 0 warning(s), 0 info\n"
    )


def test_cli_rejects_a_file_without_a_program(tmp_path):
    path = tmp_path / "empty.py"
    path.write_text("x = 1\n")
    with pytest.raises(SystemExit, match="expected a `program`"):
        lint.main([str(path)])
