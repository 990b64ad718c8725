"""The port's simulator front to back against the JAX package's, on the
CPU: hazard plans, the DU checks, every ``SimResult`` field of the event
engine in all four modes, and the DU-kernel cross-checks of a WavePlan.

Programs are the nine Table-1 kernels and the streaming kernels at
``tests/test_engine_diff.py``'s scales (32; fft 64). Each package builds
its program from its own registry with the same scale. Results must be
equal, not close: cycles and counters exactly, arrays bit for bit
(``canon``). The cycle engine's half is ``test_torch_simulator_cycle.py``.
"""

import numpy as np
import pytest

from benchmarks.bench_pallas import frontier_crosschecks as ref_crosschecks
from repro.core import dae as ref_dae
from repro.core import du as ref_du
from repro.core import executor as ref_executor
from repro.core import hazards as ref_hazards
from repro.core import monotonic as ref_monotonic
from repro.core import programs as ref_programs
from repro.core import schedule as ref_schedule
from repro.core import simulator as ref_simulator
from repro_torch.core import dae, du, executor, hazards, monotonic
from repro_torch.core import programs, schedule, simulator
from repro_torch.crosschecks import frontier_crosschecks
from test_torch_parity import canon

MODES = ("STA", "LSQ", "FUS1", "FUS2")
PROGRAMS = tuple(ref_programs.TABLE1) + tuple(ref_programs.STREAM_KERNELS)


def scale(name):
    return 64 if name == "fft" else 32


def make_both(name):
    return (ref_programs.get(name).make(scale(name)),
            programs.get(name).make(scale(name)))


def assert_sim_equal(name, mode, engine):
    (rprog, rarrays, rparams), (prog, arrays, params) = make_both(name)
    want = ref_simulator.simulate(rprog, rarrays, rparams, mode=mode,
                                  engine=engine)
    got = simulator.simulate(prog, arrays, params, mode=mode, engine=engine)
    assert [f for f in vars(got)] == [f for f in vars(want)]
    for field in vars(want):
        assert canon(getattr(got, field)) == canon(getattr(want, field)), (
            f"{name}/{mode}/{engine}: SimResult.{field}"
        )


def test_stream_kernels_are_registered_alike():
    assert programs.STREAM_KERNELS == ref_programs.STREAM_KERNELS
    assert programs.SPEC_KERNELS == ref_programs.SPEC_KERNELS


def test_sim_params_defaults_match_reference():
    assert canon(simulator.SimParams()) == canon(ref_simulator.SimParams())
    p = simulator.SimParams()
    assert (p.sta_mem_dep_ii, p.dram_latency) == (224, 200)


@pytest.mark.parametrize("static_prune", [False, True])
@pytest.mark.parametrize("forwarding", [False, True])
@pytest.mark.parametrize("name", PROGRAMS)
def test_hazard_plan_matches_reference(name, forwarding, static_prune):
    (rprog, _, _), (prog, _, _) = make_both(name)
    want = ref_hazards.build_plan(
        rprog, ref_dae.decouple(rprog), ref_monotonic.analyze_program(rprog),
        forwarding, static_prune=static_prune,
    )
    got = hazards.build_plan(
        prog, dae.decouple(prog), monotonic.analyze_program(prog),
        forwarding, static_prune=static_prune,
    )
    assert canon(got) == canon(want)
    assert got.summary() == want.summary()


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", PROGRAMS)
def test_simulate_event_matches_reference(name, mode):
    assert_sim_equal(name, mode, "event")


def _frontier_stub(dulib, trace, head, nxt, no_pend):
    """A src port of module ``dulib`` frozen with ``head`` requests
    ACKed and ``nxt`` issued (a drained stream's sentinels included)."""
    port = dulib.Port(trace)
    port.next = nxt
    if head > 0:
        port.ack_sched = tuple(int(x) for x in trace.sched[head - 1])
        port.ack_addr = int(trace.addr[head - 1])
        port.ack_lastiter = tuple(bool(x) for x in trace.lastiter[head - 1])
    if not no_pend:
        port.pending.append(dulib.PendingEntry(
            req_idx=head, addr=0, sched=(), lastiter=(),
        ))
    return port


@pytest.mark.parametrize("name", ref_programs.TABLE1)
def test_du_checks_match_reference(name):
    """``nodependence_bits``, ``check_pair_batch`` and ``check_pair`` on
    every kept pair's real request streams, against src ports frozen at
    seeded points of their own streams."""
    (rprog, rarrays, rparams), (prog, arrays, params) = make_both(name)
    rcomp = ref_simulator.Compiled(rprog, forwarding=True)
    comp = simulator.Compiled(prog, forwarding=True)
    rtraces = ref_schedule.trace_program(rprog, rcomp.dae, rarrays, rparams)
    traces = schedule.trace_program(prog, comp.dae, arrays, params)
    assert canon(du.nodependence_bits(comp.plan.pairs, traces)) == canon(
        ref_du.nodependence_bits(rcomp.plan.pairs, rtraces)
    )
    rng = np.random.default_rng(len(name))
    n_checked = 0
    for pair, rpair in zip(comp.plan.pairs, rcomp.plan.pairs):
        dst, src = traces[pair.dst], traces[pair.src]
        for _ in range(4):
            head = int(rng.integers(0, src.n_req + 1))
            nxt = int(rng.integers(head, src.n_req + 1))
            no_pend = head == nxt
            use_next = bool(rng.integers(2))
            bits = rng.integers(0, 2, dst.n_req).astype(bool)
            port = _frontier_stub(du, src, head, nxt, no_pend)
            rport = _frontier_stub(ref_du, rtraces[pair.src], head,
                                   nxt, no_pend)
            got = du.check_pair_batch(pair, dst.sched, dst.addr, port,
                                      use_next, bits)
            want = ref_du.check_pair_batch(rpair, dst.sched, dst.addr,
                                           rport, use_next, bits)
            np.testing.assert_array_equal(got, want)
            for i in range(0, dst.n_req, max(1, dst.n_req // 8)):
                req = tuple(int(x) for x in dst.sched[i])
                a = int(dst.addr[i])
                assert du.check_pair(pair, req, a, port, use_next,
                                     bool(bits[i])) == bool(want[i])
            n_checked += dst.n_req
    assert n_checked > 0


@pytest.mark.parametrize("name", ref_programs.TABLE1)
def test_frontier_crosschecks_match_reference(name):
    (rprog, rarrays, rparams), (prog, arrays, params) = make_both(name)
    want = ref_crosschecks(
        name, ref_executor.build_wave_plan(rprog, rarrays, rparams), rarrays,
    )
    got = frontier_crosschecks(
        name, executor.build_wave_plan(prog, arrays, params), arrays,
        device="cpu",
    )
    assert got == want


@pytest.mark.parametrize("mode", ["STA", "FUS2"])
@pytest.mark.parametrize("name", ref_programs.SPEC_KERNELS)
def test_speculative_programs_need_speculation(name, mode):
    """Without ``speculation="auto"`` a loss-of-decoupling program is
    refused, as in the reference; with it, it runs
    (``test_torch_speculation.py``)."""
    prog, arrays, params = programs.get(name).make(scale(name))
    with pytest.raises(dae.LossOfDecoupling, match="loss of decoupling"):
        simulator.simulate(prog, arrays, params, mode=mode)
    with pytest.raises(dae.LossOfDecoupling):
        executor.build_wave_plan(prog, arrays, params)
