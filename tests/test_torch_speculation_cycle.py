"""The port's speculative AGU on the cycle engine against the JAX
package's, on the CPU: every ``SimResult`` field, ``spec_stats``
included, for the four ``SPEC_KERNELS`` in the four modes and under the
four predictors. The event engine's half, the wave plans and the
arrays are in ``test_torch_speculation.py``.
"""

import pytest

from repro_torch.core import loopir as ir, programs
from test_torch_speculation import (
    MODES,
    PREDICTORS,
    SCALES,
    SPEC,
    assert_bits,
    assert_sim_equal,
)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SPEC)
def test_spec_simulate_cycle_matches_reference(name, mode):
    got = assert_sim_equal(name, mode, "cycle")
    oracle = ir.interpret(*programs.get(name).make(SCALES[name]))
    assert_bits(got.arrays, oracle, f"{name}/{mode}")


@pytest.mark.parametrize("predictor", PREDICTORS)
@pytest.mark.parametrize("name", SPEC)
def test_spec_predictors_cycle_match_reference(name, predictor):
    got = assert_sim_equal(name, "FUS2", "cycle", predictor=predictor)
    assert got.spec_stats["predictor"] == predictor
