"""Each fault planted under the timed path, and the control in the
program's place, make a whole run come out not correct; the sound run
does not."""

import pytest

import pb_cases
from pb_cases import DECODE, TRAIN

from portbench import checks, faults

KINDS = {DECODE: "serve", TRAIN: "train"}


@pytest.mark.parametrize("cell", [DECODE, TRAIN])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_a_fault_is_not_correct(cell, fault):
    with faults.FAULTS[fault](KINDS[cell]):
        out = pb_cases.run(cell)
    assert not out["correct"], (fault, out["checks"])


@pytest.mark.parametrize("cell", [DECODE, TRAIN])
def test_the_control_is_not_correct(cell):
    """The reference in TF32 (emulated on the CPU) in the program's place
    fails at least one of the cell's limits; the program passes them."""
    out = pb_cases.run(cell, seconds=3.0, control=True,
                       sizes=pb_cases.CONTROL_SIZES[cell],
                       traffic=pb_cases.CONTROL_TRAFFIC[cell])
    assert out["correct"], out["checks"]
    limits = {k: v["limit"] for k, v in out["checks"].items()}
    assert not checks.verdict(out["control"], limits)[0], out["control"]
