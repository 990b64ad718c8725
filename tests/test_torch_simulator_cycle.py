"""The port's per-cycle reference engine against the JAX package's, on
the CPU: every ``SimResult`` field equal (cycles and counters exactly,
arrays bit for bit) on the nine Table-1 kernels and the streaming
kernels in all four modes. The event engine's half, with the shared
helpers, is ``test_torch_simulator.py``.
"""

import pytest

from test_torch_simulator import MODES, PROGRAMS, assert_sim_equal


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", PROGRAMS)
def test_simulate_cycle_matches_reference(name, mode):
    assert_sim_equal(name, mode, "cycle")
