"""Card-only tests of the port: the CUDA wave kernel against its plain
torch version, and the main path on the card against the oracle.

The kernel has no CPU mode, so every test here carries the ``cuda``
marker and skips itself (with the reason) where no CUDA device is
present. On a machine with an H100 and ``nvcc``:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports only the port, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import executor, loopir as ir, programs
from repro_torch.kernels import wave_exec
from repro_torch.kernels.wave_exec import kernel
from repro_torch.kernels.wave_exec.ref import random_tables, wave_loop_ref

pytestmark = pytest.mark.cuda

SCALES = {
    "RAWloop": 96, "WARloop": 96, "WAWloop": 96,
    "bnn": 12, "pagerank": 16, "fft": 32, "matpower": 12,
    "hist+add": 96, "tanh+spmv": 64,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the wave kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("seed,m,s,w", [
    (0, 257, 3, 64), (1, 2**20 + 1, 4, 2**18), (2, 33, 1, 8),
])
def test_wave_loop_kernel_matches_plain(cuda, seed, m, s, w):
    mem, addrs, writes, svals = random_tables(
        np.random.default_rng(seed), m, s, w
    )
    tabs = [torch.from_numpy(t).to(cuda) for t in (addrs, writes, svals)]
    before = kernel.wave_loop.launches
    got_mem, got_vals = kernel.wave_loop(torch.from_numpy(mem).to(cuda), *tabs)
    want_mem, want_vals = wave_loop_ref(torch.from_numpy(mem).to(cuda), *tabs)
    torch.cuda.synchronize()
    assert kernel.wave_loop.launches == before + 1
    assert torch.equal(got_mem, want_mem)
    assert torch.equal(got_vals, want_vals)


def test_launch_grid_and_grid_sync(cuda):
    """Grids are capped at the co-resident limit, which a cooperative
    launch of the barrier kernel accepts; it counts no wave launch."""
    cap = kernel.launch_grid(2**30, cuda)
    assert kernel.launch_grid(1, cuda) == 1
    assert kernel.launch_grid(kernel.THREADS * 3 + 1, cuda) == min(cap, 4)
    before = kernel.wave_loop.launches
    kernel.grid_sync(cap, 4, cuda)
    torch.cuda.synchronize()
    assert kernel.wave_loop.launches == before


@pytest.mark.parametrize("name", programs.TABLE1)
def test_execute_on_card_matches_oracle(cuda, name):
    prog, arrays, params = programs.get(name).make(SCALES[name])
    before = kernel.wave_loop.launches
    res = executor.execute(prog, arrays, params, backend="torch")
    assert kernel.wave_loop.launches - before == res.run.n_segments
    oracle = ir.interpret(prog, arrays, params)
    for k in oracle:
        assert res.arrays[k].dtype == oracle[k].dtype, f"{name}: {k}"
        assert res.arrays[k].tobytes() == oracle[k].tobytes(), f"{name}: {k}"


def test_compute_torch_on_card_is_bit_exact_on_exact_ops(cuda):
    """pagerank's closures use only * and +, which float64 on the card
    rounds exactly as numpy does: check=True passes."""
    prog, arrays, params = programs.get("pagerank").make(SCALES["pagerank"])
    plan = executor.build_wave_plan(prog, arrays, params)
    res = wave_exec.run_plan(plan, arrays, compute="torch", check=True)
    oracle = ir.interpret(prog, arrays, params)
    for k in oracle:
        assert res.arrays[k].tobytes() == oracle[k].tobytes(), k
