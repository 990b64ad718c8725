"""The port's speculative AGU against the JAX package's, on the CPU.

The four loss-of-decoupling programs (``programs.SPEC_KERNELS``) at
``tests/test_pallas_parity.py``'s scales run under
``speculation="auto"`` through both packages: every ``WavePlan`` field
and the final arrays of ``execute(backend="torch", device="cpu")`` equal
the reference's ``execute(backend="pallas")`` under ``trace_mode``
``"interp"`` and ``"auto"``; ``"compiled"`` raises ``TraceCompileError``
(speculative streams are interpreter-built); the arrays equal the
oracle and the hand-written ``kernels/dynloop/ref.py`` oracles bit for
bit; and every ``SimResult`` field of the event engine, ``spec_stats``
included, equals the reference's in the four modes and under the four
predictors. The cycle engine's half is
``test_torch_speculation_cycle.py``.
"""

import dataclasses

import numpy as np
import pytest

from repro.core import executor as ref_executor
from repro.core import programs as ref_programs
from repro.core import simulator as ref_simulator
from repro.kernels import wave_exec as ref_wave_exec
from repro.kernels.dynloop import ref as ref_dynloop
from repro_torch.core import affine, executor, loopir as ir, programs
from repro_torch.core import simulator
from repro_torch.kernels import wave_exec
from repro_torch.kernels.dynloop import ref as dynloop
from test_torch_parity import canon

SCALES = {"spmv_ldtrip": 24, "bfs_front": 48, "chase_sum": 32,
          "strided_scan": 24}
SPEC = tuple(ref_programs.SPEC_KERNELS)
MODES = ("STA", "LSQ", "FUS1", "FUS2")
PREDICTORS = ("last", "stride", "context", "auto")


def make_both(name):
    return (ref_programs.get(name).make(SCALES[name]),
            programs.get(name).make(SCALES[name]))


def spec_oracle(lib, name, arrays, params):
    """The final arrays of speculative program ``name`` from the
    hand-written oracles of ``lib`` (either package's
    ``kernels/dynloop/ref.py``)."""
    if name == "spmv_ldtrip":
        rowlen, y = lib.spmv_ldtrip_ref(arrays["deg"], arrays["rp"],
                                        arrays["cidx"], arrays["val"],
                                        arrays["x"])
        return {"rowlen": rowlen, "y": y}
    if name == "bfs_front":
        foff, visit = lib.bfs_front_ref(arrays["off0"], arrays["front"],
                                        arrays["nodeval"],
                                        len(arrays["visit"]))
        return {"foff": foff, "visit": visit}
    if name == "chase_sum":
        return {"out": lib.chase_sum_ref(arrays["nxt"], arrays["w"],
                                         params["steps"])}
    assert name == "strided_scan", name
    return {"out": lib.strided_scan_ref(arrays["ptr"], arrays["w"],
                                        params["n"])}


def assert_bits(got, want, what):
    for k in want:
        assert np.asarray(got[k]).tobytes() == np.asarray(want[k]).tobytes(), (
            f"{what}: {k}"
        )


def assert_sim_equal(name, mode, engine, **kw):
    (rprog, rarrays, rparams), (prog, arrays, params) = make_both(name)
    want = ref_simulator.simulate(rprog, rarrays, rparams, mode=mode,
                                  engine=engine, speculation="auto", **kw)
    got = simulator.simulate(prog, arrays, params, mode=mode, engine=engine,
                             speculation="auto", **kw)
    assert list(vars(got)) == list(vars(want))
    for field in vars(want):
        assert canon(getattr(got, field)) == canon(getattr(want, field)), (
            f"{name}/{mode}/{engine}/{kw}: SimResult.{field}"
        )
    return got


def test_spec_kernels_are_registered_alike():
    assert programs.SPEC_KERNELS == ref_programs.SPEC_KERNELS
    for name in SPEC:
        assert programs.get(name).speculative


@pytest.mark.parametrize("trace_mode", ["interp", "auto"])
@pytest.mark.parametrize("name", SPEC)
def test_spec_wave_plan_and_arrays_match_reference(name, trace_mode):
    (rprog, rarrays, rparams), (prog, arrays, params) = make_both(name)
    assert prog.fingerprint() == rprog.fingerprint()
    rplan = ref_executor.build_wave_plan(rprog, rarrays, rparams,
                                         trace_mode=trace_mode,
                                         speculation="auto")
    plan = executor.build_wave_plan(prog, arrays, params,
                                    trace_mode=trace_mode, speculation="auto")
    executor.validate_plan(plan)
    for f in dataclasses.fields(plan):
        got, want = getattr(plan, f.name), getattr(rplan, f.name)
        if f.name == "program":
            assert got.fingerprint() == want.fingerprint()
        else:
            assert canon(got) == canon(want), f"{name}/{trace_mode}: {f.name}"
    ref = ref_executor.execute(rprog, rarrays, rparams, trace_mode=trace_mode,
                               speculation="auto", backend="pallas")
    res = executor.execute(prog, arrays, params, trace_mode=trace_mode,
                           speculation="auto", backend="torch", device="cpu")
    oracle = ir.interpret(prog, arrays, params)
    assert_bits(res.arrays, oracle, f"{name}/{trace_mode} vs oracle")
    assert_bits(res.arrays, ref.arrays, f"{name}/{trace_mode} vs pallas")
    assert dataclasses.asdict(res.stats) == dataclasses.asdict(ref.stats)


@pytest.mark.parametrize("name", SPEC)
def test_spec_run_plan_matches_reference_and_dynloop_oracles(name):
    """Same steps and device launches as the reference driver, the device
    gathers checked inside (``check=True``), and final arrays equal to
    both packages' hand-written oracles bit for bit."""
    (rprog, rarrays, rparams), (prog, arrays, params) = make_both(name)
    res = wave_exec.run_plan(
        executor.build_wave_plan(prog, arrays, params, speculation="auto"),
        arrays, device="cpu", check=True,
    )
    ref = ref_wave_exec.run_plan(
        ref_executor.build_wave_plan(rprog, rarrays, rparams,
                                     speculation="auto"),
        rarrays,
    )
    assert res.complete and ref.complete
    assert (res.n_steps, res.n_segments) == (ref.n_steps, ref.n_segments)
    want = spec_oracle(dynloop, name, arrays, params)
    assert canon(want) == canon(spec_oracle(ref_dynloop, name, rarrays,
                                            rparams))
    assert_bits(res.arrays, want, f"{name} vs kernels/dynloop/ref.py")


@pytest.mark.parametrize("name", SPEC)
def test_spec_compiled_trace_mode_raises(name):
    prog, arrays, params = programs.get(name).make(SCALES[name])
    with pytest.raises(affine.TraceCompileError, match="speculative AGU"):
        executor.build_wave_plan(prog, arrays, params, trace_mode="compiled",
                                 speculation="auto")
    with pytest.raises(affine.TraceCompileError, match="speculative AGU"):
        simulator.simulate(prog, arrays, params, mode="FUS2",
                           trace_mode="compiled", speculation="auto")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SPEC)
def test_spec_simulate_event_matches_reference(name, mode):
    got = assert_sim_equal(name, mode, "event")
    oracle = ir.interpret(*programs.get(name).make(SCALES[name]))
    assert_bits(got.arrays, oracle, f"{name}/{mode}")
    if mode != "STA":
        assert got.spec_stats["predictions"] > 0


@pytest.mark.parametrize("predictor", PREDICTORS)
@pytest.mark.parametrize("name", SPEC)
def test_spec_predictors_event_match_reference(name, predictor):
    got = assert_sim_equal(name, "FUS2", "event", predictor=predictor)
    assert got.spec_stats["predictor"] == predictor
