"""The port's wave executor against the JAX package's, on the CPU.

``execute(backend="torch", device="cpu")`` runs the whole main path —
plan, resolve phase, device phase through the wave kernel's plain torch
version — and must give arrays bit-identical to the reference's
``execute(backend="pallas")`` (Pallas in interpret mode) and to the
oracle. The plain kernel is also held bit for bit against the reference
Pallas kernel on seeded random tables, WAR aliasing, clipped gathers and
NaN payloads included.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import executor as ref_executor
from repro.core import programs as ref_programs
from repro.kernels import wave_exec as ref_wave_exec
from repro.kernels.wave_exec.kernel import wave_loop as ref_wave_loop
from repro_torch.core import executor, loopir as ir, optable, programs
from repro_torch.kernels import wave_exec
from repro_torch.kernels.wave_exec import kernel
from repro_torch.kernels.wave_exec.ref import random_tables, wave_loop_ref

SCALES = {
    "RAWloop": 96, "WARloop": 96, "WAWloop": 96,
    "bnn": 12, "pagerank": 16, "fft": 32, "matpower": 12,
    "hist+add": 96, "tanh+spmv": 64,
}
TABLE1 = tuple(ref_programs.TABLE1)


def _bits(a):
    return np.ascontiguousarray(a, dtype=np.float64).view(np.int64)


def _assert_bits(got, want, what):
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]),
                                      err_msg=f"{what}: {k}")


@pytest.mark.parametrize("name", TABLE1)
def test_execute_torch_matches_pallas_and_oracle(name):
    prog, arrays, params = programs.get(name).make(SCALES[name])
    rprog, rarrays, rparams = ref_programs.get(name).make(SCALES[name])
    ref = ref_executor.execute(rprog, rarrays, rparams, backend="pallas")
    oracle = ir.interpret(prog, arrays, params)
    for tm in ("interp", "compiled"):
        res = executor.execute(prog, arrays, params, trace_mode=tm,
                               backend="torch", device="cpu")
        _assert_bits(res.arrays, oracle, f"{name}/{tm} vs oracle")
        _assert_bits(res.arrays, ref.arrays, f"{name}/{tm} vs pallas")
        np.testing.assert_array_equal(res.plan.req_wave, ref.plan.req_wave)
        np.testing.assert_array_equal(res.plan.req_step, ref.plan.req_step)
        assert dataclasses.asdict(res.stats) == dataclasses.asdict(ref.stats)


@pytest.mark.parametrize("name", ["pagerank", "hist+add", "tanh+spmv"])
def test_run_plan_profile_matches_reference(name):
    """Same steps and the same number of device launches as the
    reference driver (its segments of equal-width steps), final arrays
    bit-identical; the device gathers are checked inside (check=True)."""
    prog, arrays, params = programs.get(name).make(SCALES[name])
    rprog, rarrays, rparams = ref_programs.get(name).make(SCALES[name])
    res = wave_exec.run_plan(
        executor.build_wave_plan(prog, arrays, params), arrays, device="cpu",
    )
    ref = ref_wave_exec.run_plan(
        ref_executor.build_wave_plan(rprog, rarrays, rparams), rarrays,
    )
    assert res.complete and ref.complete
    assert (res.n_steps, res.n_segments) == (ref.n_steps, ref.n_segments)
    _assert_bits(res.arrays, ref.arrays, name)


@pytest.mark.parametrize("seed,m,s,w", [
    (0, 257, 3, 64), (1, 1025, 4, 256), (2, 33, 2, 8),
])
def test_wave_loop_ref_matches_pallas_kernel(seed, m, s, w):
    rng = np.random.default_rng(seed)
    mem, addrs, writes, svals = random_tables(rng, m, s, w)
    ref_mem, ref_vals = ref_wave_loop(
        jnp.asarray(mem.view(np.uint32).reshape(m, 2)),
        jnp.asarray(addrs), jnp.asarray(writes.astype(np.int32)),
        jnp.asarray(svals.view(np.uint32).reshape(s, w, 2)),
        interpret=True,
    )
    want_mem = np.asarray(ref_mem).reshape(-1).view(np.int64)
    want_vals = np.asarray(ref_vals).reshape(-1).view(np.int64).reshape(s, w)
    for fn in (wave_loop_ref, kernel.wave_loop):
        got_mem, got_vals = fn(
            torch.from_numpy(mem.copy()), torch.from_numpy(addrs),
            torch.from_numpy(writes), torch.from_numpy(svals),
        )
        np.testing.assert_array_equal(got_mem.numpy(), want_mem)
        np.testing.assert_array_equal(got_vals.numpy(), want_vals)
    # one step at a time gives the same image
    step_mem = torch.from_numpy(mem.copy())
    for j in range(s):
        _, v = kernel.wave_step(
            step_mem, torch.from_numpy(addrs[j]), torch.from_numpy(writes[j]),
            torch.from_numpy(svals[j]),
        )
        np.testing.assert_array_equal(v.numpy(), want_vals[j])
    np.testing.assert_array_equal(step_mem.numpy(), want_mem)


def test_out_of_range_write_lanes_diverge_outside_the_contract():
    """Outside the caller contract (write addresses in [0, M)) the two
    kernels differ: the Pallas scatter wraps a negative address the
    NumPy way and drops one past the end; the port drops both."""
    m = 9
    mem = np.arange(m, dtype=np.int64)
    addrs = np.array([[-5, 20, 0, 1, 2, 3, 4, 5]], dtype=np.int32)
    writes = np.array([[1, 1, 0, 0, 0, 0, 0, 0]], dtype=bool)
    svals = np.array([[100, 200, 0, 0, 0, 0, 0, 0]], dtype=np.int64)
    ref_mem, _ = ref_wave_loop(
        jnp.asarray(mem.view(np.uint32).reshape(m, 2)), jnp.asarray(addrs),
        jnp.asarray(writes.astype(np.int32)),
        jnp.asarray(svals.view(np.uint32).reshape(1, 8, 2)), interpret=True,
    )
    wrapped = mem.copy()
    wrapped[m - 5] = 100
    np.testing.assert_array_equal(
        np.asarray(ref_mem).reshape(-1).view(np.int64), wrapped
    )
    got, _ = kernel.wave_loop(
        torch.from_numpy(mem.copy()), torch.from_numpy(addrs),
        torch.from_numpy(writes), torch.from_numpy(svals),
    )
    np.testing.assert_array_equal(got.numpy(), mem)


def test_wave_loop_cpu_does_not_count_launches():
    before = kernel.wave_loop.launches
    mem = torch.zeros(9, dtype=torch.int64)
    kernel.wave_loop(mem, torch.zeros((1, 8), dtype=torch.int32),
                     torch.zeros((1, 8), dtype=torch.bool),
                     torch.zeros((1, 8), dtype=torch.int64))
    assert kernel.wave_loop.launches == before


def test_grid_sync_runs_only_on_a_card():
    """The barrier kernel has no plain version: a CPU device raises
    before anything is built."""
    with pytest.raises(ValueError, match="CUDA device"):
        kernel.grid_sync(1, 1, device="cpu")


def test_wave_loop_rejects_bad_tables():
    mem = torch.zeros(9, dtype=torch.int64)
    good = (torch.zeros((1, 8), dtype=torch.int32),
            torch.zeros((1, 8), dtype=torch.bool),
            torch.zeros((1, 8), dtype=torch.int64))
    with pytest.raises(ValueError, match="mem"):
        kernel.wave_loop(mem.double(), *good)
    with pytest.raises(ValueError, match="addrs"):
        kernel.wave_loop(mem, good[0].long(), *good[1:])
    with pytest.raises(ValueError, match="writes"):
        kernel.wave_loop(mem, good[0], good[1].int(), good[2])


def _closure_ops(tables):
    ops = set()

    def walk(n):
        if isinstance(n, optable.CBin):
            ops.add(n.op)
            walk(n.a)
            walk(n.b)
        elif isinstance(n, optable.CUn):
            ops.add(n.op)
            walk(n.a)
        elif isinstance(n, optable.CGather):
            walk(n.index)

    for t in tables.values():
        walk(t.value)
        if t.guard is not None:
            walk(t.guard)
    return ops


INEXACT_OPS = {"tanh", "exp", "//", "%"}


@pytest.mark.parametrize("name,inexact", [
    ("pagerank", set()),  # closures use only * and +: bit-exact
    ("tanh+spmv", {"tanh"}),  # tanh rounds differently: rtol 1e-12
])
def test_compute_torch(name, inexact):
    prog, arrays, params = programs.get(name).make(SCALES[name])
    plan = executor.build_wave_plan(prog, arrays, params)
    assert _closure_ops(plan.tables) & INEXACT_OPS == inexact
    oracle = ir.interpret(prog, arrays, params)
    res = wave_exec.run_plan(plan, arrays, device="cpu", compute="torch",
                             check=not inexact)
    for k in oracle:
        if inexact:
            np.testing.assert_allclose(res.arrays[k], oracle[k], rtol=1e-12)
        else:
            np.testing.assert_array_equal(_bits(res.arrays[k]),
                                          _bits(oracle[k]))


def test_sequential_path_exact_and_truncatable():
    prog, arrays, params = programs.get("hist+add").make(SCALES["hist+add"])
    plan = executor.build_wave_plan(prog, arrays, params)
    oracle = ir.interpret(prog, arrays, params)
    full = wave_exec.run_sequential(plan, arrays, device="cpu", check=True)
    assert full.complete and full.n_steps == plan.stats.n_requests
    assert full.n_segments == 1
    _assert_bits(full.arrays, oracle, "sequential")
    part = wave_exec.run_sequential(plan, arrays, device="cpu", max_steps=7)
    assert not part.complete and part.n_steps == 7


def test_backend_recomputes_guards_not_oracle():
    prog, arrays, params = programs.get("tanh+spmv").make(64)
    plan = executor.build_wave_plan(prog, arrays, params)
    stores = np.nonzero(plan.req_store & ~plan.req_valid)[0]
    assert len(stores), "tanh+spmv must have guard-failed stores"
    plan.req_valid[stores[0]] = True  # corrupt the reference
    with pytest.raises(AssertionError, match="guard diverged"):
        wave_exec.run_plan(plan, arrays, device="cpu")


def test_backend_vocabulary():
    prog, arrays, params = programs.get("RAWloop").make(8)
    with pytest.raises(ValueError, match="unknown backend"):
        executor.execute(prog, arrays, params, backend="pallas")
    with pytest.raises(ValueError, match="unsupported device"):
        executor.execute(prog, arrays, params, backend="torch", device="meta")


def test_empty_program():
    prog = ir.Program(name="empty", loops=(), params=())
    res = executor.execute(prog, {"a": np.zeros(4)}, {}, backend="torch",
                           device="cpu")
    assert res.stats.n_requests == 0 and res.stats.n_waves == 0
    np.testing.assert_array_equal(res.arrays["a"], np.zeros(4))


@pytest.mark.parametrize("name", ref_programs.SPEC_KERNELS)
def test_speculative_programs_not_ported_yet(name):
    prog, arrays, params = programs.get(name).make(8)
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        executor.execute(prog, arrays, params, speculation="auto",
                         backend="torch", device="cpu")
