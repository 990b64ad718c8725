"""The port's cross-PE FIFO streaming on the wave backend against the JAX
package's, on the CPU.

The three streaming programs (``programs.STREAM_KERNELS``) at
``tests/test_fifo.py``'s small scales, at FIFO depths 1, 2 and 4: every
``WavePlan`` field equals the reference's, and the final arrays of
``execute(backend="torch", device="cpu")`` equal the reference's
``execute(backend="pallas")``, the oracle and the hand-written
``kernels/dynloop/ref.py`` oracles bit for bit; deeper queues never need
more waves. ``simulate()`` at each depth gives the reference's
``SimResult`` (``fifo_stats`` included) on both engines.
"""

import dataclasses

import pytest

from repro.core import executor as ref_executor
from repro.core import programs as ref_programs
from repro.core import simulator as ref_simulator
from repro.kernels.dynloop import ref as ref_dynloop
from repro_torch.core import executor, loopir as ir, programs, simulator
from repro_torch.kernels import wave_exec
from repro_torch.kernels.dynloop import ref as dynloop
from test_torch_parity import canon
from test_torch_speculation import assert_bits

SCALES = {"stream_dot": 12, "filter_pipe": 48, "stream_join": 32}
STREAM = tuple(ref_programs.STREAM_KERNELS)
DEPTHS = (1, 2, 4)


def make_both(name):
    return (ref_programs.get(name).make(SCALES[name]),
            programs.get(name).make(SCALES[name]))


def stream_oracle(lib, name, arrays, params):
    """The final arrays of streaming program ``name`` from the
    hand-written oracles of ``lib`` (either package's
    ``kernels/dynloop/ref.py``)."""
    if name == "stream_dot":
        return {"out": lib.stream_dot_ref(arrays["a"], arrays["bv"],
                                          arrays["out"], params["nb"],
                                          params["k"])}
    if name == "filter_pipe":
        return {"y": lib.filter_pipe_ref(arrays["x"], arrays["y"])}
    assert name == "stream_join", name
    return {"z": lib.stream_join_ref(arrays["u"], arrays["w"], arrays["z"])}


def test_stream_kernels_are_registered_alike():
    assert programs.STREAM_KERNELS == ref_programs.STREAM_KERNELS
    for name in STREAM:
        assert programs.get(name).streaming


@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", STREAM)
def test_stream_wave_plan_and_arrays_match_reference(name, depth):
    (rprog, rarrays, rparams), (prog, arrays, params) = make_both(name)
    rplan = ref_executor.build_wave_plan(rprog, rarrays, rparams,
                                         fifo_depth=depth)
    plan = executor.build_wave_plan(prog, arrays, params, fifo_depth=depth)
    executor.validate_plan(plan)
    assert plan.fifo_edges
    for f in dataclasses.fields(plan):
        got, want = getattr(plan, f.name), getattr(rplan, f.name)
        if f.name == "program":
            assert got.fingerprint() == want.fingerprint()
        else:
            assert canon(got) == canon(want), f"{name}@{depth}: {f.name}"
    ref = ref_executor.execute(rprog, rarrays, rparams, fifo_depth=depth,
                               backend="pallas")
    res = executor.execute(prog, arrays, params, fifo_depth=depth,
                           backend="torch", device="cpu")
    assert_bits(res.arrays, ir.interpret(prog, arrays, params),
                f"{name}@{depth} vs oracle")
    assert_bits(res.arrays, ref.arrays, f"{name}@{depth} vs pallas")
    want = stream_oracle(dynloop, name, arrays, params)
    assert canon(want) == canon(stream_oracle(ref_dynloop, name, rarrays,
                                              rparams))
    assert_bits(res.arrays, want, f"{name}@{depth} vs kernels/dynloop/ref.py")
    assert dataclasses.asdict(res.stats) == dataclasses.asdict(ref.stats)


@pytest.mark.parametrize("name", STREAM)
def test_stream_waves_shrink_with_depth(name):
    """Deeper queues only relax the slots' WAW/WAR edges; the wave
    backend runs each plan's steps to completion, gathers checked."""
    prog, arrays, params = programs.get(name).make(SCALES[name])
    waves = {}
    for depth in DEPTHS:
        plan = executor.build_wave_plan(prog, arrays, params, fifo_depth=depth)
        run = wave_exec.run_plan(plan, arrays, device="cpu", check=True)
        assert run.complete and run.n_steps == plan.stats.n_steps
        waves[depth] = plan.stats.n_waves
    assert waves[1] >= waves[2] >= waves[4]
    assert waves[1] > waves[4]


@pytest.mark.parametrize("engine", ["event", "cycle"])
@pytest.mark.parametrize("depth", DEPTHS)
@pytest.mark.parametrize("name", STREAM)
def test_stream_simulate_at_depth_matches_reference(name, depth, engine):
    (rprog, rarrays, rparams), (prog, arrays, params) = make_both(name)
    want = ref_simulator.simulate(
        rprog, rarrays, rparams, mode="FUS2", engine=engine,
        sim=ref_simulator.SimParams(fifo_depth=depth),
    )
    got = simulator.simulate(prog, arrays, params, mode="FUS2", engine=engine,
                             sim=simulator.SimParams(fifo_depth=depth))
    for field in vars(want):
        assert canon(getattr(got, field)) == canon(getattr(want, field)), (
            f"{name}@{depth}/{engine}: SimResult.{field}"
        )
    assert got.fifo_stats
    assert_bits(got.arrays, stream_oracle(dynloop, name, arrays, params),
                f"{name}@{depth}/{engine} vs kernels/dynloop/ref.py")
