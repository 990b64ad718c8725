"""Card-only tests of the port: the CUDA kernels (wave steps, hazard
frontier, forwarding, ELL SpMV, histogram, flash and decode attention,
selective scan, grouped expert matmul, the Mamba-1 decode step, also
through the serve step; K6 also with the sliding window in every tile,
with a value head dim of its own (MLA) and at S=1 over 1500 keys
(whisper's cross attention), K6/K7 at zamba2's D=112, K7 over a
wrapped ring) against their plain torch versions, a reduced qwen3-14b's
and falcon-mamba-7b's prefill and decode step, a reduced zamba2-7b's,
gemma3-4b's, minicpm3-4b's and whisper-tiny's prefill and teacher-forced
decode, and a reduced phi3.5-moe's prefill and dropless MoE
layer on the card against the CPU; for training, K6's rows' log-sum-exp
(and its output bits with and without it), ``flash_mha``'s and
``selective_scan``'s gradients against the plain versions', every reduced
family's loss and gradients against the CPU, ``train.main``'s K6 launches
a step, and the grad guard of the wrappers without a backward; the main path on the card against the oracle (a speculative
and a streaming program included), the substrate ops, and the DU-kernel
cross-checks of a WavePlan on the card.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips itself (with the reason) where no CUDA device is
present. On a machine with an H100 and ``nvcc``:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports only the port, so it runs where JAX is not installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import tracing
from repro_torch.configs import base as configs
from repro_torch.core import executor, loopir as ir, programs
from repro_torch.crosschecks import FORWARD_PROGRAM, WAVE_PAIRS
from repro_torch.crosschecks import frontier_crosschecks
from repro_torch.kernels import wave_exec
from repro_torch.kernels.csr_spmv import kernel as k4
from repro_torch.kernels.csr_spmv.ops import csr_spmv_ref, spmv_from_csr
from repro_torch.kernels.dynloop import ref as dynloop
from repro_torch.kernels.du_hazard import kernel as k2
from repro_torch.kernels.du_hazard.ref import hazard_frontier_batch_ref
from repro_torch.kernels.fused_stream import kernel as k3
from repro_torch.kernels.fused_stream.ops import fused_raw_loops, min_lookback
from repro_torch.kernels.fused_stream.ref import fused_stream_ref
from repro_torch.kernels.histogram import kernel as k5
from repro_torch.kernels.histogram.ops import hist_add, histogram_ref
from repro_torch.kernels.wave_exec import kernel
from repro_torch.kernels.wave_exec.ref import random_tables, wave_loop_ref
from repro_torch.kernels.attention import kernel as attn
from repro_torch.kernels.attention.ref import (
    decode_attention_ref,
    decode_gqa_ref,
    flash_attention_ref,
    flash_gqa_ref,
)
from repro_torch.kernels.mamba_step import kernel as k10
from repro_torch.kernels.mamba_step.ref import mamba_step_ref
from repro_torch.kernels.moe_group_mm import kernel as k9
from repro_torch.kernels.moe_group_mm.ref import group_matmul_ref
from repro_torch.kernels.ssm_scan import kernel as k8
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref, ssm_scan_ref
from repro_torch.launch import steps as launch_steps
from repro_torch.models import convert, layers as L, ssm as S
from repro_torch.models import transformer as T

pytestmark = pytest.mark.cuda

SCALES = {
    "RAWloop": 96, "WARloop": 96, "WAWloop": 96,
    "bnn": 12, "pagerank": 16, "fft": 32, "matpower": 12,
    "hist+add": 96, "tanh+spmv": 64,
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels have no CPU mode")
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


def _limits(cuda):
    return kernel.limits(torch.device(cuda).index or 0)


def _wave_case(cuda, seed, m, s, w):
    """Seeded tables (``random_tables``: WAR aliasing, clipped gathers,
    NaN payloads) on the card; below 8 lanes every lane loads, lane 0
    out of range, and the last lane writes."""
    rng = np.random.default_rng(seed)
    if w >= 8:
        mem, addrs, writes, svals = random_tables(rng, m, s, w)
    else:
        mem = rng.integers(-2**62, 2**62, size=m, dtype=np.int64)
        addrs = rng.integers(0, m - 1, size=(s, w)).astype(np.int32)
        addrs[:, 0] = m + 7
        writes = np.zeros((s, w), dtype=bool)
        writes[:, -1] = True
        addrs[:, -1] = rng.permutation(m - 1)[:s] if s < m else 0
        svals = rng.integers(-2**62, 2**62, size=(s, w), dtype=np.int64)
    return (torch.from_numpy(mem).to(cuda),
            *(torch.from_numpy(t).to(cuda) for t in (addrs, writes, svals)))


def _check_path(cuda, path, mem, addrs, writes, svals):
    before = (kernel.wave_loop.launches, kernel.wave_loop.wide_launches)
    got_mem, got_vals = kernel.run_path(mem.clone(), addrs, writes, svals,
                                        path)
    want_mem, want_vals = wave_loop_ref(mem.clone(), addrs, writes, svals)
    torch.cuda.synchronize()
    wide = int(path.kind == "wide")
    assert (kernel.wave_loop.launches, kernel.wave_loop.wide_launches) == (
        before[0] + 1, before[1] + wide)
    assert torch.equal(got_mem, want_mem), path
    assert torch.equal(got_vals, want_vals), path


@pytest.mark.parametrize("kind", ["resident", "wide"])
@pytest.mark.parametrize("s,w", [(3, 1), (3, 8), (2, 1025), (2, 4096),
                                 (2, 32768), (2049, 8), (1, 1025)])
def test_wave_loop_both_paths_match_plain(cuda, kind, s, w):
    """Each path forced, at W of 1, 8, 1025, 4096 and 32768 and S of 1,
    2, 3 and 2049, bit for bit against the plain version (32768 lanes
    are past one block: the wide path only). The wide path also with
    four lanes a thread forced at a narrow width, and one where the grid
    walks the lanes in more than one pass."""
    lim = _limits(cuda)
    m = 4097
    if kind == "resident":
        if w > kernel.RESIDENT_THREADS * kernel.RESIDENT_LANES[-1]:
            assert kernel.choose_path(m, w, lim).kind == "wide"
            return
        path = kernel.choose_path(m, w, lim)
        assert path == kernel.resident_path(w)
    else:
        path = kernel.wide_path(w, lim.max_grid)
    assert path.kind == kind
    case = _wave_case(cuda, s * w, m, s, w)
    _check_path(cuda, path, *case)
    if kind == "wide":
        for lanes in (1, 4):
            _check_path(cuda, kernel.Path("wide", 1, kernel.THREADS, lanes),
                        *case)


def test_wave_loop_one_block_at_its_capacity(cuda):
    """An image of exactly one block's words on the resident path, at
    each width of lanes a thread it is built for, and the wrapper's own
    choice there and one word past it (the wide path)."""
    lim = _limits(cuda)
    assert lim.words_per_block >= 1024
    m = lim.words_per_block
    for lanes in kernel.RESIDENT_LANES:
        w = lanes * kernel.RESIDENT_THREADS
        assert kernel.launch_path(m, w, cuda) == kernel.resident_path(w)
        _check_path(cuda, kernel.resident_path(w),
                    *_wave_case(cuda, lanes, m, 3, w))
    past = kernel.launch_path(m + 1, 1025, cuda)
    assert past == kernel.wide_path(1025, lim.max_grid)
    case = _wave_case(cuda, 99, m + 1, 3, 1025)
    before = kernel.wave_loop.wide_launches
    got, vals = kernel.wave_loop(case[0].clone(), *case[1:])
    assert kernel.wave_loop.wide_launches == before + 1
    want, want_vals = wave_loop_ref(case[0].clone(), *case[1:])
    assert torch.equal(got, want) and torch.equal(vals, want_vals)


@pytest.mark.parametrize("kind", ["resident", "wide"])
def test_wave_loop_drops_out_of_range_write_lanes(cuda, kind):
    """Write lanes at -5 and M + 3 are dropped on both paths; a load of
    the same step at a write lane's address reads the pre-step word."""
    m = 9
    mem = torch.arange(m, dtype=torch.int64, device=cuda)
    mem[3] = 0x7FF8000000000000 | 77  # a NaN payload
    addrs = torch.tensor([[-5, m + 3, 2, 2, 3, 0, 1, m + 50]],
                         dtype=torch.int32, device=cuda)
    writes = torch.tensor([[1, 1, 1, 0, 0, 0, 0, 0]], dtype=torch.bool,
                          device=cuda)
    svals = torch.tensor([[100, 200, 300, 0, 0, 0, 0, 0]],
                         dtype=torch.int64, device=cuda)
    lim = _limits(cuda)
    path = (kernel.choose_path(m, 8, lim) if kind == "resident"
            else kernel.wide_path(8, lim.max_grid))
    _check_path(cuda, path, mem, addrs, writes, svals)
    got, vals = kernel.run_path(mem.clone(), addrs, writes, svals, path)
    assert got.tolist() == [0, 1, 300, mem[3].item(), 4, 5, 6, 7, 8]
    assert vals[0, 3].item() == 2 and vals[0, 7].item() == 8


def test_resident_sync_counts_no_launch(cuda):
    before = kernel.wave_loop.launches
    for threads in (64, kernel.RESIDENT_THREADS):
        kernel.resident_sync(threads, 4, cuda)
    torch.cuda.synchronize()
    assert kernel.wave_loop.launches == before


@pytest.mark.parametrize("name,kw", [
    *[(n, {}) for n in programs.TABLE1],
    *[(n, {"speculation": "auto"}) for n in programs.SPEC_KERNELS],
    *[(n, {"fifo_depth": 1}) for n in programs.STREAM_KERNELS],
])
def test_every_program_on_card_takes_its_paths(cuda, name, kw):
    """One launch a segment, bit for bit against the oracle, and the
    segments whose image and lanes fit one block on the resident path."""
    bench = programs.get(name)
    prog, arrays, params = bench.make(SCALES.get(name, bench.default_scale))
    before = (kernel.wave_loop.launches, kernel.wave_loop.wide_launches)
    res = executor.execute(prog, arrays, params, backend="torch", **kw)
    assert kernel.wave_loop.launches - before[0] == res.run.n_segments > 0
    lim = _limits(cuda)
    one_block = sum(
        res.plan.mem_size + 1 <= lim.words_per_block
        and w <= kernel.RESIDENT_THREADS * kernel.RESIDENT_LANES[-1]
        for _, w in res.run.segments)
    assert (kernel.wave_loop.wide_launches - before[1]
            == res.run.n_segments - one_block)
    oracle = ir.interpret(prog, arrays, params)
    for k in oracle:
        assert res.arrays[k].tobytes() == oracle[k].tobytes(), f"{name}: {k}"


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


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("k,s,d,unsorted,offset", [
    (1, 3, 5, ((0, None),), 0),
    (4, 3000, 2049, ((3, None),), 0),
    (3, 0, 7, (), 0),
    (2, 1, 300, (), 0),
    (2, 16384, 1000, (), 0),
    (3, 32768, 2000, ((2, None),), 0),
    (2, 65536, 1500, (), 1),
    (5, 70001, 4099, ((1, 4095), (3, None)), 0),
    (1, 2**20, 3001, (), 0),
])
def test_hazard_frontier_kernel_matches_plain(cuda, k, s, d, side, unsorted,
                                              offset):
    """Non-decreasing rows with long equal-address runs (addresses in
    [-500, 500)) and negative addresses, searched; beside them unsorted
    rows, counted: ``(row, None)`` shuffles a row, ``(row, i)`` puts one
    descent at i (4095: across a check chunk's end). Consumers below and
    above every producer, INT32_MAX (counts S under either side, no pads)
    and INT32_MIN (counts 0); S = 0, S = 1, S = 16384 and 32768 (the last
    4 and 8 words of a search read as 16-byte vectors), src ``offset``
    words into a flat buffer (not 16-byte aligned: single-word probes), S
    above the samples a row keeps (70001: a window searched in global
    memory), S = 2**20 at K = 1, D not a multiple of a tile's lanes."""
    rng = np.random.default_rng(k * 10 + s)
    src = np.sort(rng.integers(-500, 500, (k, s)), axis=1).astype(np.int32)
    if s:
        src[:, 1::2] = src[:, 0::2][:, : src[:, 1::2].shape[1]]
    for row, at in unsorted:
        if at is None:
            rng.shuffle(src[row])
        else:
            src[row, at + 1] = src[row, at] - 1
    dst = rng.integers(-520, 520, (k, d)).astype(np.int32)
    dst[:, 0] = 2**31 - 1
    dst[:, 1] = -2**31
    flat = np.concatenate([np.zeros(offset, np.int32), src.ravel()])
    src_d = torch.from_numpy(flat).to(cuda)[offset:].view(k, s)
    assert (src_d.data_ptr() % 16 == 0) == (offset == 0)
    dst_d = torch.from_numpy(dst).to(cuda)
    before = k2.hazard_frontier_batch.launches
    got = k2.hazard_frontier_batch(src_d, dst_d, side=side)
    want = hazard_frontier_batch_ref(src_d, dst_d, side=side)
    torch.cuda.synchronize()
    assert k2.hazard_frontier_batch.launches == before + 1
    assert torch.equal(got, want)
    assert got[:, 0].tolist() == [s] * k
    assert got[:, 1].tolist() == [0] * k
    if s > 1 and not unsorted:  # searched rows: the search's answer
        lib = torch.searchsorted(src_d, dst_d, right=side == "right",
                                 out_int32=True)
        assert torch.equal(got, lib)


@pytest.mark.parametrize("k,s,words", [
    (1, 0, 4), (3, 1, 4 + 3 * 4), (1, 4096, 4 + 4096), (1, 4097, 8 + 2052),
    (2, 70001, 140 + 2 * 2188), (1, 2**20, 1024 + 4096),
])
def test_hazard_frontier_scratch_words(cuda, k, s, words):
    """The kernel's scratch, as the built library sizes it: one descent
    flag per 1024 src words of a row (one for S = 0), then each row's
    samples, every stride-th src word (stride a power of two, never more
    than 4096 samples), each part padded to 4 words so the samples are
    read as 16-byte vectors. The launcher refuses a buffer 4 words
    short."""
    assert k2.scratch_words(k, s) == words
    src = torch.zeros((k, s), dtype=torch.int32, device=cuda)
    dst = torch.zeros((k, 3), dtype=torch.int32, device=cuda)
    buf = torch.empty(k * 3 + 4 + words, dtype=torch.int32, device=cuda)
    at = buf.data_ptr() + 4 * ((k * 3 + 3) & ~3)
    launch = k2._lib().hazard_frontier_launch
    args = (src.data_ptr(), dst.data_ptr(), buf.data_ptr(), at)
    tail = (k, s, 3, 0, k2._max_grid(cuda.index),
            torch.cuda.current_stream(cuda).cuda_stream)
    assert launch(*args, words - 4, *tail) != 0
    assert launch(*args, words, *tail) == 0
    torch.cuda.synchronize()


_FUZZ_S = (1, 2, 3, 4, 5, 7, 8, 1023, 1024, 1025, 4095, 4096, 4097, 8192,
           8193, 12288, 16383, 16384, 16385, 32769, 65536, 65537, 131075,
           262144)


@pytest.mark.parametrize("seed", range(8))
def test_hazard_frontier_kernel_random_cases(cuda, seed):
    """Twenty seeded random batches a seed, both sides, bit for bit: K in
    [1, 6], S around the check chunk, the sample count and the vector
    widths, addresses in a narrow range or across all of int32, rows
    sorted, shuffled or with one descent, dst drawn from src or around
    it, unaligned views and int64 inputs now and then."""
    rng = np.random.default_rng(123 + seed)
    lo32, hi32 = -2**31, 2**31 - 1
    for _ in range(20):
        k, s = int(rng.integers(1, 7)), int(rng.choice(_FUZZ_S))
        d = int(rng.integers(1, 5000))
        if rng.random() < 0.3:
            lo, hi = sorted(int(v) for v in rng.integers(lo32, hi32, 2))
        else:
            lo, hi = -int(rng.integers(1, 50)), int(rng.integers(1, 50))
        src = np.sort(rng.integers(lo, hi + 1, (k, s)), axis=1)
        for r in range(k):
            u = rng.random()
            if u < 0.2:
                rng.shuffle(src[r])
            elif u < 0.3 and s > 1:  # one descent (a swap where lo32 stops it)
                i = int(rng.integers(0, s - 1))
                if src[r, i] > lo32:
                    src[r, i + 1] = src[r, i] - 1
                elif s > 2:
                    src[r, 0], src[r, -1] = src[r, -1], src[r, 0]
        src = src.clip(lo32, hi32).astype(np.int32)
        dst = rng.integers(max(lo - 5, lo32), min(hi + 5, hi32), (k, d))
        dst = dst.clip(lo32, hi32).astype(np.int32)
        on = rng.random((k, d)) < 0.4
        dst[on] = np.take_along_axis(src, rng.integers(0, s, (k, d)), 1)[on]
        dst[:, 0] = hi32
        dst[:, 1:2] = lo32
        off = int(rng.integers(0, 4)) if rng.random() < 0.3 else 0
        flat = np.concatenate([np.zeros(off, np.int32), src.ravel()])
        src_d = torch.from_numpy(flat).to(cuda)[off:].view(k, s)
        dst_d = torch.from_numpy(dst).to(cuda)
        if rng.random() < 0.2:
            src_d, dst_d = src_d.long(), dst_d.long()
        for side in ("right", "left"):
            got = k2.hazard_frontier_batch(src_d, dst_d, side=side)
            want = hazard_frontier_batch_ref(src_d, dst_d, side=side)
            assert torch.equal(got, want), (k, s, d, off, side)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lookback", [1, 3])
def test_fused_stream_kernel_matches_plain(cuda, dtype, lookback):
    rng = np.random.default_rng(lookback)
    s, d, m = 5000, 4097, 3001
    src = np.sort(rng.integers(0, m, s))
    src[1::3] = src[0::3][: len(src[1::3])]
    dst = rng.integers(-3, m + 3, d)
    dst[::2] = rng.choice(src, len(dst[::2]))
    f = np.searchsorted(src, dst, side="right")
    f[:4] = (0, -2, s + 5, s)
    t = lambda x, dt=torch.int32: torch.from_numpy(np.asarray(x)).to(cuda, dt)
    src_d, dst_d, f_d = t(src), t(dst), t(f)
    val = torch.from_numpy(rng.standard_normal(s)).to(cuda, dtype)
    mem = torch.from_numpy(rng.standard_normal(m)).to(cuda, dtype)
    valid = t(rng.random(s) < 0.7)
    for v in (valid, None):
        before = k3.fused_stream.launches
        got_v, got_h = k3.fused_stream(src_d, val, f_d, dst_d, mem, v,
                                       lookback=lookback)
        want_v, want_h = fused_stream_ref(src_d, val, f_d, dst_d, mem, v,
                                          lookback=lookback)
        torch.cuda.synchronize()
        assert k3.fused_stream.launches == before + 1
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        assert torch.equal(got_v.view(bits), want_v.view(bits))
        assert torch.equal(got_h, want_h)
        assert got_h.any() and not got_h.all()
    before = k3.fused_stream.launches
    empty_v, _ = k3.fused_stream(src_d, val, f_d[:0], dst_d[:0], mem)
    assert empty_v.shape == (0,) and k3.fused_stream.launches == before


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("lookback", range(1, 9))
def test_fused_stream_windows_and_ragged_groups(cuda, dtype, lookback):
    """Windows across index 0 and past S, runs of equal addresses longer
    than the lookback, valid bits given and not, D not a multiple of the
    consumers a thread, and frontier/address vectors that are not 16-byte
    aligned: bit for bit against the plain version."""
    rng = np.random.default_rng(100 + lookback)
    s, m = 700, 300
    src = np.sort(rng.integers(0, m, s))
    src[1::4] = src[0::4][: len(src[1::4])]
    src[2::4] = src[0::4][: len(src[2::4])]
    t = lambda x, dt=torch.int32: torch.from_numpy(np.asarray(x)).to(cuda, dt)
    val = torch.from_numpy(rng.standard_normal(s)).to(cuda, dtype)
    mem = torch.from_numpy(rng.standard_normal(m)).to(cuda, dtype)
    valid = t(rng.random(s) < 0.5)
    for d in (1, 3, 4, 5, 1023, 1026):
        dst = rng.integers(-2, m + 2, d + 1)
        dst[::2] = rng.choice(src, len(dst[::2]))
        f = np.searchsorted(src, dst, side="right")
        edges = [0, 1, 2, -3, s, s + 4, lookback - 1, s - 1]
        f[1:1 + len(edges)] = edges[:d]
        dst_d, f_d = t(dst), t(f)
        for off in (0, 1):  # off = 1: views 4 bytes past an aligned start
            args = (t(src), val, f_d[off:off + d], dst_d[off:off + d], mem)
            for v in (valid, None):
                got_v, got_h = k3.fused_stream(*args, v, lookback=lookback)
                want_v, want_h = fused_stream_ref(*args, v,
                                                  lookback=lookback)
                bits = torch.int32 if dtype == torch.float32 else torch.int64
                assert torch.equal(got_v.view(bits), want_v.view(bits)), (
                    d, off, v is None)
                assert torch.equal(got_h, want_h), (d, off, v is None)


def test_fused_stream_without_producers_reads_memory(cuda):
    mem = torch.arange(5, dtype=torch.float64, device=cuda)
    src = torch.zeros(0, dtype=torch.int32, device=cuda)
    dst = torch.tensor([-1, 0, 4, 9], dtype=torch.int32, device=cuda)
    f = torch.tensor([0, 3, -1, 2], dtype=torch.int32, device=cuda)
    got_v, got_h = k3.fused_stream(src, src.double(), f, dst, mem,
                                   lookback=4)
    assert got_v.tolist() == [0.0, 0.0, 4.0, 4.0] and not got_h.any()


def test_fused_raw_loops_on_card_matches_sequential_loop(cuda):
    rng = np.random.default_rng(11)
    m = 400
    mem0 = rng.standard_normal(m)
    src = np.sort(rng.integers(0, m, 900))
    val = rng.standard_normal(900)
    valid = (rng.random(900) < 0.6).astype(np.int32)
    dst = rng.integers(0, m, 700)
    seq = mem0.copy()
    for a, v, ok in zip(src, val, valid):
        if ok:
            seq[a] = v
    n2, n3 = k2.hazard_frontier_batch.launches, k3.fused_stream.launches
    got, hits = fused_raw_loops(src, val, dst, mem0, valid)
    assert got.device.type == "cuda"
    assert (k2.hazard_frontier_batch.launches - n2,
            k3.fused_stream.launches - n3) == (1, 1)
    assert got.cpu().numpy().tobytes() == seq[dst].tobytes()
    assert hits.any()
    assert min_lookback(torch.from_numpy(src).to(cuda)) == min_lookback(src)


@pytest.mark.parametrize("name", [*WAVE_PAIRS, FORWARD_PROGRAM])
def test_frontier_crosschecks_on_card(cuda, name):
    prog, arrays, params = programs.get(name).make(SCALES[name])
    plan = executor.build_wave_plan(prog, arrays, params)
    n2, n3 = k2.hazard_frontier_batch.launches, k3.fused_stream.launches
    checks = frontier_crosschecks(name, plan, arrays)
    assert checks == frontier_crosschecks(name, plan, arrays, device="cpu")
    forwards = int(name == FORWARD_PROGRAM)
    assert k2.hazard_frontier_batch.launches - n2 == 1
    assert k3.fused_stream.launches - n3 == forwards


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("n_pad,w,m", [
    (8, 1, 5), (1000, 16, 3001), (384, 37, 70), (200, 3, 50), (256, 4, 900),
    (136, 5, 77), (264, 17, 500),
])
def test_csr_spmv_kernel_matches_plain(cuda, n_pad, w, m, dtype, offset):
    """Bit for bit: clipped columns (negative and past ``M``), W in
    {1, 3, 4, 5, 16, 17, 37}, a ragged last row block; the vector loads
    for float32 x, W a multiple of 4 and aligned arrays, the word loads
    otherwise: float64 x, other widths, and arrays that are views
    ``offset`` words into a flat buffer (``flat[1:]`` is not 16-byte
    aligned)."""
    rng = np.random.default_rng(n_pad + w)
    size = n_pad * w + offset
    cols = torch.from_numpy(
        rng.integers(-3, m + 3, size).astype(np.int32)
    ).to(cuda)[offset:].view(n_pad, w)
    vals = torch.from_numpy(
        rng.standard_normal(size).astype(np.float32)
    ).to(cuda)[offset:].view(n_pad, w)
    x = torch.from_numpy(rng.standard_normal(m)).to(cuda, dtype)
    assert k4.vector_loads(cols, vals, x) == (
        dtype == torch.float32 and w % 4 == 0 and offset == 0
    )
    before = k4.csr_spmv.launches
    got = k4.csr_spmv(cols, vals, x, block_r=8)
    want = csr_spmv_ref(cols, vals, x)
    torch.cuda.synchronize()
    assert k4.csr_spmv.launches == before + 1
    assert got.dtype == dtype and torch.equal(got, want)
    empty = k4.csr_spmv(cols[:0], vals[:0], x)
    assert empty.shape == (0,) and k4.csr_spmv.launches == before + 1


@pytest.mark.parametrize("seed", range(5))
def test_csr_spmv_kernel_random_cases(cuda, seed):
    """Thirty seeded random layouts a seed, bit for bit: N_pad below 3000,
    W in [1, 39], M below 5000, columns past both ends, views up to 3
    words into a flat buffer, float32 or float64 x with a NaN or an
    infinity now and then."""
    rng = np.random.default_rng(456 + seed)
    for _ in range(30):
        n_pad, w = int(rng.integers(1, 3000)), int(rng.integers(1, 40))
        m = int(rng.integers(1, 5000))
        off = int(rng.integers(0, 4)) if rng.random() < 0.3 else 0
        dtype = torch.float32 if rng.random() < 0.7 else torch.float64
        size = n_pad * w + off
        cols = torch.from_numpy(
            rng.integers(-5, m + 5, size).astype(np.int32)
        ).to(cuda)[off:].view(n_pad, w)
        vals = torch.from_numpy(
            rng.standard_normal(size).astype(np.float32)
        ).to(cuda)[off:].view(n_pad, w)
        x = torch.from_numpy(rng.standard_normal(m)).to(cuda, dtype)
        if rng.random() < 0.1:
            x[int(rng.integers(0, m))] = float("nan")
        if rng.random() < 0.1:
            x[int(rng.integers(0, m))] = float("inf")
        got = k4.csr_spmv(cols, vals, x, block_r=1)
        want = csr_spmv_ref(cols, vals, x)
        bits = torch.int32 if dtype == torch.float32 else torch.int64
        assert torch.equal(got.view(bits), want.view(bits)), (n_pad, w, m,
                                                              off, dtype)


@pytest.mark.parametrize("n,bins,block", [
    (100, 16, 32), (2**20 + 3, 32, 512), (2**18, 2**16, 256), (5, 1, 64),
])
def test_histogram_kernel_matches_plain(cuda, n, bins, block):
    """Bit for bit on the shared-memory path and, above
    ``MAX_SHARED_BINS``, the global-memory path; bins outside
    ``[0, n_bins)`` are dropped."""
    rng = np.random.default_rng(n)
    d = rng.integers(-2, bins + 2, n).astype(np.int32)
    d[:3] = (-1, -bins - 1, 2**31 - 1)[:n]
    d_d = torch.from_numpy(d).to(cuda)
    before = k5.histogram.launches
    got = k5.histogram(d_d, n_bins=bins, block=block)
    want = histogram_ref(d_d, n_bins=bins)
    torch.cuda.synchronize()
    assert k5.histogram.launches == before + 1
    assert torch.equal(got, want)
    assert got.sum().item() == ((d >= 0) & (d < bins)).sum()
    assert (bins > k5.MAX_SHARED_BINS) == (bins == 2**16)


def test_substrate_ops_on_card_match_the_cpu(cuda):
    rng = np.random.default_rng(12)
    deg = rng.integers(0, 9, 300)
    rp = np.concatenate([[0], np.cumsum(deg)])
    ci = rng.integers(0, 300, int(rp[-1]))
    vv = rng.standard_normal(int(rp[-1]))
    x = rng.standard_normal(300)
    d1, d2 = rng.integers(-1, 33, 999), rng.integers(0, 32, 999)
    n4, n5 = k4.csr_spmv.launches, k5.histogram.launches
    y = spmv_from_csr(rp, ci, vv, x, block_r=64)
    h = hist_add(d1, d2, n_bins=32)
    assert y.device.type == h.device.type == "cuda"
    assert (k4.csr_spmv.launches - n4, k5.histogram.launches - n5) == (1, 2)
    assert torch.equal(y.cpu(), spmv_from_csr(rp, ci, vv, x, block_r=64,
                                              device="cpu"))
    assert torch.equal(h.cpu(), hist_add(d1, d2, n_bins=32, device="cpu"))


@pytest.mark.parametrize("name,scale,kw", [
    ("bfs_front", 48, {"speculation": "auto"}),
    ("stream_dot", 12, {"fifo_depth": 2}),
])
def test_speculative_and_streaming_programs_on_card(cuda, name, scale, kw):
    prog, arrays, params = programs.get(name).make(scale)
    before = kernel.wave_loop.launches
    res = executor.execute(prog, arrays, params, backend="torch", **kw)
    assert kernel.wave_loop.launches - before == res.run.n_segments > 0
    oracle = ir.interpret(prog, arrays, params)
    for k in oracle:
        assert res.arrays[k].tobytes() == oracle[k].tobytes(), f"{name}: {k}"
    if name == "bfs_front":
        _, visit = dynloop.bfs_front_ref(arrays["off0"], arrays["front"],
                                         arrays["nodeval"],
                                         len(arrays["visit"]))
        assert res.arrays["visit"].tobytes() == visit.tobytes()
    else:
        out = dynloop.stream_dot_ref(arrays["a"], arrays["bv"],
                                     arrays["out"], params["nb"], params["k"])
        assert res.arrays["out"].tobytes() == out.tobytes()


# attention: float32 against the plain versions within 1e-4 (the sum
# order differs; the reference's own bound for Pallas against its
# oracle); bfloat16 inputs within 2e-2, about two bfloat16 steps of
# outputs below 2 in size, since both round one float32 result; float16
# within 2e-3, two float16 steps there for the same reason
ATTN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2, torch.float16: 2e-3}


def _randn(seed, *shape, device, dtype=torch.float32):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device, dtype)


@pytest.mark.parametrize("s,s_kv,d,causal", [
    (64, 64, 32, True), (128, 128, 16, False), (1000, 1000, 128, False),
    (70, 70, 256, True), (33, 90, 64, True),
])
def test_flash_attention_kernel_matches_plain(cuda, s, s_kv, d, causal):
    q = _randn(1, 4, s, d, device=cuda)
    k, v = _randn(2, 4, s_kv, d, device=cuda), _randn(3, 4, s_kv, d,
                                                      device=cuda)
    before = attn.flash_attention.launches
    got = attn.flash_attention(q, k, v, causal=causal, sm_scale=d ** -0.5,
                               block_q=16, block_k=16)
    want = flash_attention_ref(q, k, v, causal=causal, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == q.dtype
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gqa_kernel_matches_plain(cuda, dtype):
    """qwen3-14b's heads (40 over 8, D=128) at a ragged S=300."""
    b, s, h, hk, d = 2, 300, 40, 8, 128
    q = _randn(4, b, s, h, d, device=cuda, dtype=dtype)
    k = _randn(5, b, s, hk, d, device=cuda, dtype=dtype)
    v = _randn(6, b, s, hk, d, device=cuda, dtype=dtype)
    before = attn.flash_attention.launches
    got = attn.flash_attention_gqa(q, k, v, causal=True)
    want = flash_gqa_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 1
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]
    # the sliding window runs on the card too (it raised before K6 had it)
    got_w = attn.flash_attention_gqa(q, k, v, window=16)
    want_w = flash_gqa_ref(q, k, v, causal=True, window=16)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 2
    assert (got_w.float() - want_w.float()).abs().max().item() <= (
        ATTN_TOL[dtype])


@pytest.mark.parametrize("lengths", [[1, 17, 33, 64], [0, 17, 33, 64]])
def test_decode_attention_kernel_matches_plain(cuda, lengths):
    q = _randn(7, 4, 1, 32, device=cuda)
    kc, vc = _randn(8, 4, 64, 32, device=cuda), _randn(9, 4, 64, 32,
                                                       device=cuda)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    before = attn.decode_attention.launches
    got = attn.decode_attention(q, kc, vc, lens, sm_scale=0.2, block_k=16)
    want = decode_attention_ref(q, kc, vc, lens, sm_scale=0.2)
    torch.cuda.synchronize()
    assert attn.decode_attention.launches == before + 1
    assert got.shape == q.shape
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]
    if lengths[0] == 0:  # the uniform average of the whole cache
        assert torch.allclose(got[0, 0], vc[0].mean(dim=0), atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_gqa_kernel_matches_plain(cuda, dtype):
    """40 query heads over 8 kv heads, frontiers at 0, inside, at and
    past the cache's 200 positions."""
    b, h, hk, c, d = 4, 40, 8, 200, 128
    q = _randn(10, b, h, d, device=cuda, dtype=dtype)
    kc = _randn(11, b, c, hk, d, device=cuda, dtype=dtype)
    vc = _randn(12, b, c, hk, d, device=cuda, dtype=dtype)
    lens = torch.tensor([0, 5, 200, 250], dtype=torch.int32, device=cuda)
    before = attn.decode_attention.launches
    got = attn.decode_attention_gqa(q, kc, vc, lens, sm_scale=d ** -0.5)
    want = decode_gqa_ref(q, kc, vc, lens, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert attn.decode_attention.launches == before + 1
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


def _decode_case(cuda, seed, b, h, hk, c, d, lengths, dtype=torch.float32):
    q = _randn(seed, b, h, d, device=cuda, dtype=dtype)
    kc = _randn(seed + 1, b, c, hk, d, device=cuda, dtype=dtype)
    vc = _randn(seed + 2, b, c, hk, d, device=cuda, dtype=dtype)
    lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
    return q, kc, vc, lens


def _check_decode(cuda, q, kc, vc, lens, dtype=torch.float32):
    scale = q.shape[-1] ** -0.5
    before = attn.decode_attention.launches
    got = attn.decode_attention_gqa(q, kc, vc, lens, sm_scale=scale)
    want = decode_gqa_ref(q, kc, vc, lens, sm_scale=scale)
    torch.cuda.synchronize()
    assert attn.decode_attention.launches == before + 1
    assert got.shape == q.shape and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]
    return got


@pytest.mark.parametrize("edge", [1, 2, 5, 9])
def test_decode_split_edges(cuda, edge):
    """Frontiers one before, at and one past the end of split ``edge``,
    over C=300 positions (no tile divides it), 8 query heads on 2."""
    b, h, hk, c, d = 4, 8, 2, 300, 64
    n_split, length = attn.decode_splits(b, c, hk, attn.sm_count(0))
    assert n_split > edge and length % 32 == 0
    e = edge * length
    q, kc, vc, lens = _decode_case(cuda, 20 + edge, b, h, hk, c, d,
                                   [e - 1, e, e + 1, c])
    _check_decode(cuda, q, kc, vc, lens)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_decode_lengths_zero_one_full_and_past(cuda, dtype):
    """lengths 0, 1, C and past C in one batch, in each input type; the
    row at 0 is the uniform average of its cache."""
    b, h, hk, c, d = 4, 40, 8, 161, 128
    q, kc, vc, lens = _decode_case(cuda, 30, b, h, hk, c, d, [0, 1, c, c + 7],
                                   dtype)
    got = _check_decode(cuda, q, kc, vc, lens, dtype)
    mean = vc[0].float().mean(dim=0).repeat_interleave(h // hk, dim=0)
    assert (got[0].float() - mean).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("b,h,hk,c,d,lengths", [
    (1, 4, 1, 8192, 128, [5000]),           # B*Hk = 1: the most splits
    (1, 4, 1, 8192, 128, [0]),
    (32, 40, 8, 1000, 128, None),           # B*Hk = 256
    (3, 6, 3, 37, 32, [37, 0, 20]),         # one split, C < a tile
    (2, 9, 3, 777, 70, [700, 777]),         # d % 4 != 0: word copies
    (2, 4, 2, 100, 4, [99, 3]),             # 16-byte rows of float32
])
def test_decode_split_shapes(cuda, b, h, hk, c, d, lengths):
    if lengths is None:
        g = np.random.default_rng(3)
        lengths = g.integers(1, c + 1, b).tolist()
        lengths[:3] = [1, c, 0]
    q, kc, vc, lens = _decode_case(cuda, 40, b, h, hk, c, d, lengths)
    _check_decode(cuda, q, kc, vc, lens)


@pytest.mark.parametrize("d", [3, 4, 8, 128])
def test_decode_float16_copy_widths(cuda, d):
    """float16 rows of 6, 8, 16 and 256 bytes: element, 4-byte and
    16-byte copies into shared memory."""
    q, kc, vc, lens = _decode_case(cuda, 50, 2, 4, 2, 90, d, [90, 45],
                                   torch.float16)
    _check_decode(cuda, q, kc, vc, lens, torch.float16)


def test_decode_split_counts(cuda):
    """The splits K7 takes: more than one at decode_32k's shape and at
    the serve path's, of at least 32 keys each, on a 132-SM H100 and on
    this card; fewer and longer on a card of 16 SMs."""
    assert attn.decode_splits(32, 8192, 8, 132) == (32, 256)
    assert attn.decode_splits(4, 161, 8, 132) == (6, 32)
    assert attn.decode_splits(1, 8192, 1, 132) == (256, 32)
    assert attn.decode_splits(1, 8192, 8, 132) == (64, 128)
    assert attn.decode_splits(1, 8192, 8, 16) == (32, 256)
    sms = attn.sm_count(0)
    for b, c, hk in [(32, 8192, 8), (4, 161, 8)]:
        n_split, length = attn.decode_splits(b, c, hk, sms)
        assert n_split > 1 and length >= 32 and n_split * length >= c


def test_decode_is_deterministic_and_rearms_its_tickets(cuda):
    """Two calls give the same bits; then a run of calls on one stream
    with changing frontiers, each against the plain version, shows that
    every call finds its tickets at 0."""
    b, h, hk, c, d = 4, 40, 8, 8192, 128
    g = np.random.default_rng(5)
    q, kc, vc, lens = _decode_case(cuda, 60, b, h, hk, c, d,
                                   g.integers(1, c + 1, b).tolist())
    scale = d ** -0.5
    first = attn.decode_attention_gqa(q, kc, vc, lens, sm_scale=scale)
    second = attn.decode_attention_gqa(q, kc, vc, lens, sm_scale=scale)
    torch.cuda.synchronize()
    assert torch.equal(first, second)
    for step in range(12):
        lens = torch.tensor(g.integers(-2, c + 40, b), dtype=torch.int32,
                            device=cuda)
        _check_decode(cuda, q, kc, vc, lens)
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        got = attn.decode_attention_gqa(q, kc, vc, lens, sm_scale=scale)
    torch.cuda.synchronize()
    want = decode_gqa_ref(q, kc, vc, lens, sm_scale=scale)
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("d", [32, 64, 128, 256])
@pytest.mark.parametrize("s,s_kv", [(100, 200), (200, 100), (1, 77)])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_head_dims_and_ragged_lengths(cuda, d, s, s_kv, causal):
    q = _randn(70, 1, s, 4, d, device=cuda)
    k = _randn(71, 1, s_kv, 2, d, device=cuda)
    v = _randn(72, 1, s_kv, 2, d, device=cuda)
    before = attn.flash_attention.launches
    got = attn.flash_attention_gqa(q, k, v, causal=causal)
    want = flash_gqa_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 1
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("d", [70, 256])
def test_flash_half_types(cuda, dtype, d):
    q = _randn(73, 2, 150, 4, d, device=cuda, dtype=dtype)
    k = _randn(74, 2, 150, 1, d, device=cuda, dtype=dtype)
    v = _randn(75, 2, 150, 1, d, device=cuda, dtype=dtype)
    got = attn.flash_attention_gqa(q, k, v, causal=True)
    want = flash_gqa_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


def _flash_raw(cuda, q, k, v, causal, window, sms):
    """K6 through the raw launcher with the SM count ``sms``, which picks
    the tile up to D=128 (1: 8 warps of 16 rows; 10**6: 4 warps)."""
    b, s, h, d = q.shape
    s_kv, hk, dv = k.shape[1], k.shape[2], v.shape[3]
    out = q.new_empty((b, s, h, dv))
    rc = attn._lib().flash_attention_launch(
        0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), None, b,
        s, s_kv, h, hk, d, dv, int(causal), window, d ** -0.5, sms,
        torch.cuda.current_stream(cuda).cuda_stream)
    torch.cuda.synchronize()
    assert rc == 0
    return out


@pytest.mark.parametrize("d", [32, 64, 112, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_both_tiles(cuda, d, causal):
    """Up to D=128 K6 takes 8 warps of 16 rows where the blocks fill the
    card twice and 4 warps where they do not; the SM count passed to the
    launcher picks one (1 SM: 8 warps, 10**6: 4) on the same ragged
    inputs, and each holds the plain version."""
    b, s, h, hk = 2, 300, 4, 2
    q = _randn(80, b, s, h, d, device=cuda)
    k, v = _randn(81, b, s, hk, d, device=cuda), _randn(82, b, s, hk, d,
                                                        device=cuda)
    want = flash_gqa_ref(q, k, v, causal=causal)
    for sms in (1, 10**6):
        out = _flash_raw(cuda, q, k, v, causal, 0, sms)
        assert (out - want).abs().max().item() <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("d", [64, 112, 256])
@pytest.mark.parametrize("window", [16, 1024])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_window_in_every_tile(cuda, d, window, causal):
    """K6's sliding window (keys j > i - window) against the plain
    version at a ragged S=1300, in each tile: 8 and 4 warps up to D=128
    (forced by the SM count), D=256's one tile. Window 16 is narrower
    than every tile of keys (whole tiles and warps skipped), 1024 spans
    many."""
    b, s, h, hk = 1, 1300, 4, 2
    q = _randn(90, b, s, h, d, device=cuda)
    k, v = _randn(91, b, s, hk, d, device=cuda), _randn(92, b, s, hk, d,
                                                        device=cuda)
    want = flash_gqa_ref(q, k, v, causal=causal, window=window)
    for sms in ((1, 10**6) if d <= 128 else (132,)):
        out = _flash_raw(cuda, q, k, v, causal, window, sms)
        assert (out - want).abs().max().item() <= ATTN_TOL[torch.float32]
    before = attn.flash_attention.launches
    got = attn.flash_attention_gqa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 1
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


def test_flash_window_rows_with_no_key_average_every_key(cuda):
    """Non-causal with S >= S_kv + window: rows past S_kv - 1 + window
    have no key inside their window, and the reference averages all S_kv
    keys for them; K6 then skips no tile."""
    q = _randn(93, 2, 200, 4, 64, device=cuda)
    k, v = _randn(94, 2, 50, 2, 64, device=cuda), _randn(95, 2, 50, 2, 64,
                                                         device=cuda)
    got = attn.flash_attention_gqa(q, k, v, causal=False, window=16)
    want = flash_gqa_ref(q, k, v, causal=False, window=16)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]
    mean = v.mean(dim=1).repeat_interleave(2, dim=1)  # (B, H, D)
    assert (got[:, -1] - mean).abs().max().item() <= ATTN_TOL[torch.float32]


def test_flash_zamba2_shared_block_prefill_shape(cuda):
    """zamba2-7b's shared attention at the serve prefill: B=4, S=128,
    32 query heads over 32 kv heads of 112 (14 of the DMAX-128 tile's 16
    k-steps; the last n-tiles zero-filled)."""
    q = _randn(96, 4, 128, 32, 112, device=cuda)
    k, v = _randn(97, 4, 128, 32, 112, device=cuda), _randn(
        98, 4, 128, 32, 112, device=cuda)
    got = attn.flash_attention_gqa(q, k, v, causal=True)
    want = flash_gqa_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


# (q and k, v) head dims: minicpm3's MLA prefill (96 = 64 + 32 rotary, 64),
# and V narrower, wider, and past the 8-warp tile's 128
FLASH_DV = [(96, 64), (64, 32), (192, 128), (32, 64)]


@pytest.mark.parametrize("dk,dv", FLASH_DV)
@pytest.mark.parametrize("mode", ["causal", "noncausal", "window"])
def test_flash_value_head_dim(cuda, dk, dv, mode):
    """K6 with V's head dim of its own against the plain version at a
    ragged S=300 (4 query heads over 2): causal, non-causal and with a
    window of 16, in each tile the larger dim allows (8 and 4 warps up to
    128, forced by the SM count; the 256 template's one tile for 192/128),
    and through the wrapper, whose output is ``(B, S, H, dv)``."""
    b, s, h, hk = 2, 300, 4, 2
    causal, window = mode != "noncausal", 16 if mode == "window" else 0
    q = _randn(120, b, s, h, dk, device=cuda)
    k = _randn(121, b, s, hk, dk, device=cuda)
    v = _randn(122, b, s, hk, dv, device=cuda)
    want = flash_gqa_ref(q, k, v, causal=causal, window=window)
    assert want.shape == (b, s, h, dv)
    for sms in ((1, 10**6) if max(dk, dv) <= 128 else (132,)):
        out = _flash_raw(cuda, q, k, v, causal, window, sms)
        assert (out - want).abs().max().item() <= ATTN_TOL[torch.float32]
    before = attn.flash_attention.launches
    got = attn.flash_attention_gqa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 1
    assert got.shape == (b, s, h, dv)
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("dk,dv", [(64, 64), (96, 64)])
@pytest.mark.parametrize("s,s_kv", [(1, 1500), (128, 1500), (1, 1),
                                    (77, 200)])
def test_flash_value_head_dim_ragged_lengths(cuda, dk, dv, s, s_kv):
    """Ragged lengths at whisper's heads (6 over 6): one query over 1500
    keys (the cross attention of a decode step), 128 over 1500 (the
    prefill's), one over itself (the serving quirk, causal), and 77 over
    200; at dk = dv = 64 and at MLA's 96/64."""
    b, h = 4, 6
    causal = s == s_kv
    q = _randn(123, b, s, h, dk, device=cuda)
    k = _randn(124, b, s_kv, h, dk, device=cuda)
    v = _randn(125, b, s_kv, h, dv, device=cuda)
    got = attn.flash_attention_gqa(q, k, v, causal=causal)
    want = flash_gqa_ref(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("dk,dv", FLASH_DV)
def test_flash_value_head_dim_half_types(cuda, dtype, dk, dv):
    q = _randn(126, 2, 150, 4, dk, device=cuda, dtype=dtype)
    k = _randn(127, 2, 150, 1, dk, device=cuda, dtype=dtype)
    v = _randn(128, 2, 150, 1, dv, device=cuda, dtype=dtype)
    got = attn.flash_attention_gqa(q, k, v, causal=True)
    want = flash_gqa_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2, 150, 4, dv)
    assert (got.float() - want.float()).abs().max().item() <= ATTN_TOL[dtype]


@pytest.mark.parametrize("dk,dv", [(96, 70), (70, 96)])
def test_flash_value_head_dim_unaligned(cuda, dk, dv):
    """A head dim that is not a multiple of 4 takes converted loads in
    place of the 16-byte copies, for K and V alike."""
    q = _randn(129, 1, 200, 4, dk, device=cuda)
    k = _randn(130, 1, 200, 2, dk, device=cuda)
    v = _randn(131, 1, 200, 2, dv, device=cuda)
    got = attn.flash_attention_gqa(q, k, v, causal=True)
    want = flash_gqa_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("d,causal", [(64, True), (128, False), (96, True)])
def test_flash_value_columns_split_bit_for_bit(cuda, d, causal):
    """The weights come from q and k alone and each output n-tile from
    them and its own V columns, so K6 over V's first half of columns gives
    the bits of the same columns of K6 over all of V (dv = dk), on both
    tiles: a value head dim of its own changes the output's width and
    nothing else."""
    b, s, h, hk = 2, 300, 4, 2
    q = _randn(132, b, s, h, d, device=cuda)
    k = _randn(133, b, s, hk, d, device=cuda)
    v = _randn(134, b, s, hk, d, device=cuda)
    half = v[..., :d // 2].contiguous()
    for sms in (1, 10**6):
        whole = _flash_raw(cuda, q, k, v, causal, 0, sms)
        part = _flash_raw(cuda, q, k, half, causal, 0, sms)
        assert torch.equal(part, whole[..., :d // 2])


@pytest.mark.parametrize("lengths", [[1, 60, 160, 161], [0, 7, 100, 300]])
def test_decode_rep1_d112(cuda, lengths):
    """K7 at zamba2-7b's shared attention: one query head a kv head (32
    over 32), D=112, over the serve path's 161 positions."""
    q, kc, vc, lens = _decode_case(cuda, 100, 4, 32, 32, 161, 112, lengths)
    _check_decode(cuda, q, kc, vc, lens)


def test_decode_over_a_wrapped_ring(cuda):
    """gemma3's local layers: 100 positions written into a ring of 64
    slots at ``pos % 64`` (the last 64 remain), lengths at and past the
    capacity. K7 over the ring equals the plain version over it, and
    attention over the last 64 positions in order: the ring's order does
    not change the result beyond the sum order."""
    b, h, hk, d, n, cap = 2, 8, 4, 256, 100, 64
    q = _randn(110, b, h, d, device=cuda)
    k_lin = _randn(111, b, n, hk, d, device=cuda)
    v_lin = _randn(112, b, n, hk, d, device=cuda)
    ring_k = torch.empty(b, cap, hk, d, device=cuda)
    ring_v = torch.empty_like(ring_k)
    for pos in range(n):
        ring_k[:, pos % cap] = k_lin[:, pos]
        ring_v[:, pos % cap] = v_lin[:, pos]
    lens = torch.tensor([cap, n], dtype=torch.int32, device=cuda)
    got = _check_decode(cuda, q, ring_k, ring_v, lens)
    scale = d ** -0.5
    last = decode_gqa_ref(q, k_lin[:, n - cap:].contiguous(),
                          v_lin[:, n - cap:].contiguous(),
                          torch.full((b,), cap, device=cuda), sm_scale=scale)
    assert (got - last).abs().max().item() <= ATTN_TOL[torch.float32]


def test_flash_qwen3_heads_many_tiles(cuda):
    """qwen3-14b's heads (40 over 8, D=128) causal at S=2048: the
    3xTF32 error accumulates over 64 tiles of keys."""
    q = _randn(76, 1, 2048, 40, 128, device=cuda)
    k = _randn(77, 1, 2048, 8, 128, device=cuda)
    v = _randn(78, 1, 2048, 8, 128, device=cuda)
    got = attn.flash_attention_gqa(q, k, v, causal=True)
    want = flash_gqa_ref(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= ATTN_TOL[torch.float32]


def test_reduced_qwen3_on_card_matches_the_cpu(cuda):
    """One prefill and one decode step of a reduced qwen3-14b on the card
    (K6 and K7, one launch per layer) against the same on the CPU (the
    plain versions), at the reference's decode tolerance."""
    cfg = configs.get("qwen3-14b").reduced()
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, L.FP32,
                        device="cpu")
    card = convert.from_reference(convert.to_numpy(cpu), device=cuda)
    tok = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 24)))
    n6 = attn.flash_attention.launches
    got, _ = T.prefill(card, tok.to(cuda), cfg, L.FP32)
    want, _ = T.prefill(cpu, tok, cfg, L.FP32)
    assert attn.flash_attention.launches - n6 == cfg.n_layers
    assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)

    rng = np.random.default_rng(4)
    shape = (cfg.n_layers, 2, 32, cfg.n_kv_heads, cfg.resolved_head_dim)
    ck, cv = (torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
              for _ in "kv")
    lengths = torch.tensor([3, 7], dtype=torch.int32)
    n7 = attn.decode_attention.launches
    got, got_c = T.decode_step(card, tok[:, :1].to(cuda),
                               {"kv": (ck.to(cuda), cv.to(cuda))},
                               lengths.to(cuda), cfg, L.FP32)
    want, want_c = T.decode_step(cpu, tok[:, :1], {"kv": (ck, cv)}, lengths,
                                 cfg, L.FP32)
    assert attn.decode_attention.launches - n7 == cfg.n_layers
    assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)
    for a, b in zip(got_c["kv"], want_c["kv"]):
        assert torch.allclose(a.cpu(), b, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("name,depth,s", [
    ("zamba2-7b", {"n_layers": 5}, 32), ("gemma3-4b", {"n_layers": 6}, 80),
])
def test_reduced_hybrid_and_windowed_on_card_match_the_cpu(cuda, name, depth,
                                                            s):
    """A reduced zamba2-7b (5 layers: two segments, each followed by the
    shared block, then one layer) and gemma3-4b (6 layers: 5 local at
    window 32, then 1 global) on the card against the CPU: the prefill
    (K6 once a shared application or layer, the window on the local
    ones) and S teacher-forced decode steps (K7 likewise a step; gemma3's
    rings wrap after 32), at the reference's decode tolerance."""
    cfg = dataclasses.replace(configs.get(name).reduced(), **depth)
    attn_layers = (cfg.n_layers // cfg.shared_attn_every
                   if cfg.shared_attn_every else cfg.n_layers)
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, L.FP32,
                        device="cpu")
    card = convert.from_reference(convert.to_numpy(cpu), device=cuda)
    tok = torch.from_numpy(
        np.random.default_rng(5).integers(0, cfg.vocab, (2, s)))
    n6 = attn.flash_attention.launches
    got, _ = T.prefill(card, tok.to(cuda), cfg, L.FP32)
    want, _ = T.prefill(cpu, tok, cfg, L.FP32)
    assert attn.flash_attention.launches - n6 == attn_layers
    assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)
    caches = [T.init_cache(cfg, 2, s + 1, L.FP32, device=d)
              for d in (cuda, "cpu")]
    lens = [torch.zeros(2, dtype=torch.int32, device=d) for d in (cuda, "cpu")]
    n7 = attn.decode_attention.launches
    for t in range(s):
        outs = [T.decode_step(p, tok[:, t:t + 1].to(d), c, n, cfg, L.FP32)[0]
                for p, d, c, n in zip((card, cpu), (cuda, "cpu"), caches,
                                      lens)]
        lens = [n + 1 for n in lens]
    assert attn.decode_attention.launches - n7 == attn_layers * s
    assert torch.allclose(outs[0].cpu(), outs[1], atol=2e-3, rtol=1e-3)
    assert torch.allclose(outs[1], want, atol=2e-3, rtol=1e-3)


@pytest.mark.parametrize("name,depth", [
    ("minicpm3-4b", {}), ("minicpm3-4b", {"v_head_dim": 24}),
    ("whisper-tiny", {}),
])
def test_reduced_mla_and_whisper_on_card_match_the_cpu(cuda, name, depth):
    """A reduced minicpm3-4b (also with V 24 wide against q and k's 16)
    and whisper-tiny on the card against the CPU: the prefill (K6 once an
    MLA layer; whisper's once an encoder layer and twice a decoder layer,
    self and cross) and 12 teacher-forced decode steps (MLA: no kernel;
    whisper with its encoder output: K7 and K6 once a layer a step), at the
    reference's decode tolerance."""
    cfg = dataclasses.replace(configs.get(name).reduced(), **depth)
    n = cfg.n_layers
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, L.FP32,
                        device="cpu")
    card = convert.from_reference(convert.to_numpy(cpu), device=cuda)
    s = 12
    tok = torch.from_numpy(
        np.random.default_rng(6).integers(0, cfg.vocab, (2, s)))
    fe = (torch.from_numpy(np.random.default_rng(7).standard_normal(
        (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)) * 0.02
          if cfg.enc_dec else None)
    n6 = attn.flash_attention.launches
    got, _ = T.prefill(card, tok.to(cuda), cfg, L.FP32,
                       frontend=None if fe is None else fe.to(cuda))
    want, _ = T.prefill(cpu, tok, cfg, L.FP32, frontend=fe)
    assert attn.flash_attention.launches - n6 == (
        cfg.n_enc_layers + 2 * n if cfg.enc_dec else n)
    assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)
    encs = ((T._encode(card, fe.to(cuda), cfg), T._encode(cpu, fe, cfg))
            if cfg.enc_dec else (None, None))
    caches = [T.init_cache(cfg, 2, s + 1, L.FP32, device=d)
              for d in (cuda, "cpu")]
    lens = [torch.zeros(2, dtype=torch.int32, device=d) for d in (cuda, "cpu")]
    n6, n7 = attn.flash_attention.launches, attn.decode_attention.launches
    for t in range(s):
        outs = [T.decode_step(p, tok[:, t:t + 1].to(d), c, m, cfg, L.FP32,
                              enc_out=e)[0]
                for p, d, c, m, e in zip((card, cpu), (cuda, "cpu"), caches,
                                         lens, encs)]
        lens = [m + 1 for m in lens]
    per_step = n if cfg.enc_dec else 0
    assert attn.decode_attention.launches - n7 == per_step * s
    assert attn.flash_attention.launches - n6 == per_step * s
    assert torch.allclose(outs[0].cpu(), outs[1], atol=2e-3, rtol=1e-3)
    assert torch.allclose(outs[1], want, atol=2e-3, rtol=1e-3)


# K8 against its plain version: float32 within the reference's kernel
# bound (1e-4; the exponentials and the state sum round differently);
# bfloat16 outputs within 2e-2, about two bfloat16 steps of outputs
# below 2, since both round one float32 result
SCAN_TOL = {torch.float32: 1e-4, torch.float16: 1e-2, torch.bfloat16: 2e-2}


def _scan_inputs(seed, b, s, di, n, device):
    g = torch.Generator().manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=g)  # noqa: E731
    xi, bm, cm = r(b, s, di) * 0.5, r(b, s, n) * 0.5, r(b, s, n) * 0.5
    dt = torch.nn.functional.softplus(r(b, s, di))
    a_neg = -torch.exp(r(di, n) * 0.3)
    h0 = r(b, di, n)
    return [t.to(device) for t in (xi, dt, bm, cm, a_neg, h0)]


@pytest.mark.parametrize("b,s,di,n,with_h0", [
    (1, 64, 64, 8, False), (2, 1000, 8192 - 96, 16, True),
    (3, 1, 33, 5, True), (4, 128, 512, 16, False),
])
def test_ssm_scan_kernel_matches_plain(cuda, b, s, di, n, with_h0):
    xi, dt, bm, cm, a_neg, h0 = _scan_inputs(13, b, s, di, n, cuda)
    h0 = h0 if with_h0 else None
    before = k8.ssm_scan.launches
    y, h = k8.selective_scan(xi, dt, bm, cm, a_neg, h0)
    y_ref, h_ref = selective_scan_ref(xi, dt, bm, cm, a_neg, h0)
    torch.cuda.synchronize()
    assert k8.ssm_scan.launches == before + 1
    assert y.shape == (b, s, di) and h.shape == (b, di, n)
    assert (y - y_ref).abs().max().item() <= SCAN_TOL[torch.float32]
    assert (h - h_ref).abs().max().item() <= SCAN_TOL[torch.float32]


def test_ssm_scan_kernel_reference_signature_and_bfloat16(cuda):
    xi, dt, bm, cm, a_neg, _ = _scan_inputs(14, 1, 96, 160, 16, cuda)
    got = k8.ssm_scan(xi[0], dt[0], bm[0], cm[0], a_neg)
    want = ssm_scan_ref(xi[0], dt[0], bm[0], cm[0], a_neg)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= SCAN_TOL[torch.float32]
    xb = xi.to(torch.bfloat16)
    got_b, _ = k8.selective_scan(xb, dt, bm, cm, a_neg)
    want_b, _ = selective_scan_ref(xb, dt, bm, cm, a_neg)
    torch.cuda.synchronize()
    assert got_b.dtype == torch.bfloat16
    assert ((got_b.float() - want_b.float()).abs().max().item()
            <= SCAN_TOL[torch.bfloat16])
    with pytest.raises(ValueError, match="state size"):
        k8.selective_scan(xi, dt, torch.zeros(1, 96, 17, device=cuda),
                          torch.zeros(1, 96, 17, device=cuda),
                          torch.zeros(160, 17, device=cuda))


# K8's redesign: grids of whole and partial rounds, lengths around the
# 32-position chunk, state sizes, input types, the copy paths (16-byte where di, n and pointers allow,
# plain loads else) and large |a·dt| through ex2.approx


def _check_scan(cuda, b, s, di, n, *, dtype=torch.float32, with_h0=False,
                seed=15, a_scale=1.0):
    xi, dt, bm, cm, a_neg, h0 = _scan_inputs(seed, b, s, di, n, cuda)
    xi, a_neg = xi.to(dtype), a_neg * a_scale
    h0 = h0 if with_h0 else None
    before = k8.ssm_scan.launches
    y, h = k8.selective_scan(xi, dt, bm, cm, a_neg, h0)
    y_ref, h_ref = selective_scan_ref(xi, dt, bm, cm, a_neg, h0)
    torch.cuda.synchronize()
    assert k8.ssm_scan.launches == before + 1
    assert y.dtype == dtype and y.shape == (b, s, di)
    assert h.dtype == torch.float32 and h.shape == (b, di, n)
    tol = SCAN_TOL[dtype]
    assert (y.float() - y_ref.float()).abs().max().item() <= tol
    assert (h - h_ref).abs().max().item() <= SCAN_TOL[torch.float32]
    return y, h


@pytest.mark.parametrize("blocks_per_sm", [1, 4])
@pytest.mark.parametrize("extra", [0, 8])
def test_ssm_scan_whole_and_partial_rounds(cuda, blocks_per_sm, extra):
    """di chosen from the SM count, 128 channels a block: one block an SM
    (one whole round) or four (more than fit at once: a second round);
    ``extra`` = 8 adds one ragged slab."""
    di = 128 * blocks_per_sm * attn.sm_count(0) + extra
    _check_scan(cuda, 1, 40, di, 16, with_h0=True)
    _check_scan(cuda, 2, 40, di // 2, 16, dtype=torch.bfloat16)


@pytest.mark.parametrize("s", [1, 31, 32, 33, 63, 64, 65, 4096])
def test_ssm_scan_lengths_around_the_chunk(cuda, s):
    _check_scan(cuda, 2, s, 256, 16)


@pytest.mark.parametrize("n", [1, 5, 8, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
def test_ssm_scan_state_sizes_types_and_carried_state(cuda, n, dtype):
    _check_scan(cuda, 3, 70, 200, n, dtype=dtype, with_h0=True)


@pytest.mark.parametrize("di,dtype", [
    (33, torch.float32), (36, torch.float16), (8192 - 96, torch.bfloat16),
])
def test_ssm_scan_plain_load_paths(cuda, di, dtype):
    """di that 16-byte copies cannot tile (33; 36 halves) and one that
    they can, for each input type."""
    _check_scan(cuda, 2, 45, di, 16, dtype=dtype)


def _unaligned(t):
    """A contiguous copy of ``t`` that starts 4 bytes into its storage."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


def test_ssm_scan_unaligned_inputs(cuda):
    """Inputs 4 bytes off a 16-byte boundary take the plain loads."""
    args = _scan_inputs(16, 2, 50, 256, 16, cuda)
    xi, dt, bm, cm, a_neg, h0 = (_unaligned(t) for t in args)
    assert xi.data_ptr() % 16 and bm.data_ptr() % 16
    y, h = k8.selective_scan(xi, dt, bm, cm, a_neg, h0)
    y_ref, h_ref = selective_scan_ref(xi, dt, bm, cm, a_neg, h0)
    torch.cuda.synchronize()
    assert (y - y_ref).abs().max().item() <= SCAN_TOL[torch.float32]
    assert (h - h_ref).abs().max().item() <= SCAN_TOL[torch.float32]


def test_ssm_scan_large_decay_arguments(cuda):
    """|a·dt| of tens, where ex2.approx's argument error grows and the
    decays are far below float32's 1e-4 (some flush to zero)."""
    xi, dt, bm, cm, a_neg, h0 = _scan_inputs(17, 2, 300, 128, 16, cuda)
    a_neg = a_neg * 20.0
    assert (a_neg[None, None] * dt[..., None]).abs().max().item() > 30
    y, h = k8.selective_scan(xi, dt, bm, cm, a_neg, h0)
    y_ref, h_ref = selective_scan_ref(xi, dt, bm, cm, a_neg, h0)
    torch.cuda.synchronize()
    assert (y - y_ref).abs().max().item() <= SCAN_TOL[torch.float32]
    assert (h - h_ref).abs().max().item() <= SCAN_TOL[torch.float32]


def test_ssm_scan_same_bits_twice(cuda):
    y, h = _check_scan(cuda, 4, 130, 1024, 16, with_h0=True, seed=18)
    y2, h2 = _check_scan(cuda, 4, 130, 1024, 16, with_h0=True, seed=18)
    assert torch.equal(y, y2) and torch.equal(h, h2)


# K9 against its plain version: float32 within 1e-4 (sums of up to 256
# products in another order than cuBLAS's); bfloat16 within 2e-2
GMM_TOL = {torch.float32: 1e-4, torch.float16: 2e-2, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("e,din,dout,bt,nb", [
    (4, 32, 48, 16, 8), (8, 16, 16, 8, 16), (3, 100, 130, 200, 3),
    (16, 256, 384, 128, 4),
])
def test_group_matmul_kernel_matches_plain(cuda, e, din, dout, bt, nb, dtype):
    g = torch.Generator().manual_seed(e * din)
    x = torch.randn(nb * bt, din, generator=g).to(cuda, dtype)
    w = (torch.randn(e, din, dout, generator=g) * 0.1).to(cuda, dtype)
    be = torch.randint(0, e, (nb + 2,), generator=g, dtype=torch.int32)
    be = be.to(cuda)
    before = k9.group_matmul.launches
    got = k9.group_matmul(x, w, be, block_t=bt)
    want = group_matmul_ref(x, w, be, block_t=bt)
    torch.cuda.synchronize()
    assert k9.group_matmul.launches == before + 1
    assert got.shape == (nb * bt, dout) and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= GMM_TOL[dtype]


# K9's redesign: 3xTF32 (float32) and m16n8k16 (halves) on the tensor
# cores, every block_t the reference's tests use, d_in and d_out off the
# tile, clipped expert ids and zero pad rows


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16,
                                   torch.bfloat16])
@pytest.mark.parametrize("bt", [8, 16, 32, 128, 200])
@pytest.mark.parametrize("din,dout", [(100, 130), (264, 200)])
def test_group_matmul_tensor_cores(cuda, dtype, bt, din, dout):
    e, nb = 5, 6
    g = torch.Generator().manual_seed(bt * din + dout)
    x = torch.randn(nb * bt, din, generator=g)
    x[(nb - 2) * bt:] = 0.0  # two trailing pad blocks
    w = torch.randn(e, din, dout, generator=g) * din ** -0.5
    be = torch.tensor([0, -1, 3, e + 3, 2, 4, 1], dtype=torch.int32)
    x, w, be = x.to(cuda, dtype), w.to(cuda, dtype), be.to(cuda)
    before = k9.group_matmul.launches
    got = k9.group_matmul(x, w, be, block_t=bt)
    want = group_matmul_ref(x, w, be, block_t=bt)
    torch.cuda.synchronize()
    assert k9.group_matmul.launches == before + 1
    assert got.shape == (nb * bt, dout) and got.dtype == dtype
    assert (got.float() - want.float()).abs().max().item() <= GMM_TOL[dtype]
    assert not got[(nb - 2) * bt:].any()


def test_group_matmul_clipped_ids_read_the_end_experts(cuda):
    """Ids -1 and E + 3 give the products of experts 0 and E - 1."""
    e, bt, din, dout = 3, 16, 64, 72
    g = torch.Generator().manual_seed(21)
    x = torch.randn(2 * bt, din, generator=g).to(cuda)
    w = torch.randn(e, din, dout, generator=g).to(cuda) * 0.125
    got = k9.group_matmul(x, w, torch.tensor([-1, e + 3], dtype=torch.int32,
                                             device=cuda), block_t=bt)
    want = torch.cat([x[:bt] @ w[0], x[bt:] @ w[e - 1]])
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= GMM_TOL[torch.float32]


def test_group_matmul_unaligned_views(cuda):
    """x and w 4 bytes off a 16-byte boundary take the plain loads."""
    e, bt, din, dout = 4, 32, 128, 96
    g = torch.Generator().manual_seed(22)
    x = _unaligned(torch.randn(4 * bt, din, generator=g).to(cuda))
    w = _unaligned(torch.randn(e, din, dout, generator=g).to(cuda) * 0.1)
    assert x.data_ptr() % 16 and w.data_ptr() % 16
    be = torch.tensor([2, 0, 3, 1], dtype=torch.int32, device=cuda)
    got = k9.group_matmul(x, w, be, block_t=bt)
    want = group_matmul_ref(x, w, be, block_t=bt)
    torch.cuda.synchronize()
    assert (got - want).abs().max().item() <= GMM_TOL[torch.float32]


def test_reduced_phi35_moe_on_card_matches_the_cpu(cuda):
    """A reduced phi3.5-moe's prefill (capacity path, K6 per layer) and
    its dropless MoE layer (three K9 launches) on the card against the
    CPU, at the reference's decode tolerance."""
    cfg = configs.get("phi3.5-moe-42b-a6.6b").reduced()
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, L.FP32,
                        device="cpu")
    card = convert.from_reference(convert.to_numpy(cpu), device=cuda)
    tok = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 24)))
    got, _ = T.prefill(card, tok.to(cuda), cfg, L.FP32)
    want, _ = T.prefill(cpu, tok, cfg, L.FP32)
    assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 24, cfg.d_model)).astype(np.float32))
    lp = T.layer_params(card["layers"], 0)["moe"]
    n9 = k9.group_matmul.launches
    got = L.moe_apply(lp, x.to(cuda), cfg, use_kernel=True)
    assert k9.group_matmul.launches - n9 == 3
    want = L.moe_apply(T.layer_params(cpu["layers"], 0)["moe"], x, cfg,
                       use_kernel=True)
    assert torch.allclose(got.cpu(), want, atol=1e-4, rtol=1e-4)


def test_reduced_moonlight_on_card_matches_the_cpu(cuda):
    """A reduced moonlight (MLA without a query LoRA, a dense layer, then
    MoE layers with a sigmoid router and a correction bias, dropless):
    the prefill (K6 a layer) and eight serve steps on the card against
    the CPU, at the reference's decode tolerance; K9's counter moves by
    3 a MoE layer a step, and nothing else launches K9."""
    cfg = dataclasses.replace(configs.get("moonlight-16b-a3b").reduced(),
                              n_layers=3, n_experts=8)
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, L.FP32,
                        device="cpu")
    cpu["layers"]["moe"]["router_bias"].normal_(
        0.0, 0.1, generator=torch.Generator().manual_seed(1))
    card = convert.from_reference(convert.to_numpy(cpu), device=cuda)
    tok = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 8)))
    got, _ = T.prefill(card, tok.to(cuda), cfg, L.FP32)
    want, _ = T.prefill(cpu, tok, cfg, L.FP32)
    assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)
    step = launch_steps.make_serve_step(cfg, L.FP32)
    caches = {d: (T.init_cache(cfg, 2, 9, L.FP32, device=d),
                  torch.zeros(2, dtype=torch.int32, device=d))
              for d in ("cpu", cuda)}
    n_moe = cfg.n_layers - cfg.n_dense_layers
    for t in range(tok.shape[1]):
        n9 = k9.group_matmul.launches
        got, *caches[cuda] = step(card, tok[:, t:t + 1].to(cuda),
                                  *caches[cuda])
        assert k9.group_matmul.launches - n9 == 3 * n_moe
        want, *caches["cpu"] = step(cpu, tok[:, t:t + 1], *caches["cpu"])
        assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)


def test_reduced_falcon_mamba_on_card_matches_the_cpu(cuda):
    """A reduced falcon-mamba-7b's prefill (one K8 launch per layer) and
    four decode steps (K10, two launches a layer step; n = 8 takes its
    word-at-a-time state path) on the card against the CPU, at the
    reference's decode tolerance."""
    cfg = configs.get("falcon-mamba-7b").reduced()
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, L.FP32,
                        device="cpu")
    card = convert.from_reference(convert.to_numpy(cpu), device=cuda)
    tok = torch.from_numpy(
        np.random.default_rng(3).integers(0, cfg.vocab, (2, 40)))
    n8 = k8.ssm_scan.launches
    got, cache = T.prefill(card, tok.to(cuda), cfg, L.FP32)
    want, _ = T.prefill(cpu, tok, cfg, L.FP32)
    assert k8.ssm_scan.launches - n8 == cfg.n_layers
    assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)
    cache_cpu = T.init_cache(cfg, 2, 40, L.FP32, device="cpu")
    lens = torch.zeros(2, dtype=torch.int32)
    n10 = k10.mamba_step.launches
    for t in range(4):
        got, cache = T.decode_step(card, tok[:, t:t + 1].to(cuda), cache,
                                   lens.to(cuda), cfg, L.FP32)
        want, cache_cpu = T.decode_step(cpu, tok[:, t:t + 1], cache_cpu,
                                        lens, cfg, L.FP32)
        assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)
        for key in ("conv", "h"):
            assert torch.allclose(cache["ssm"][key].cpu(),
                                  cache_cpu["ssm"][key], atol=2e-3,
                                  rtol=1e-3)
    assert k8.ssm_scan.launches - n8 == cfg.n_layers
    assert k10.mamba_step.launches - n10 == 4 * 2 * cfg.n_layers


# ---------------------------------------------------------------------------
# K10: one Mamba-1 decode step, the window and state updated in place
# ---------------------------------------------------------------------------

# y and the state against the plain step: the projections' 8192-term sums
# run in another order than cuBLAS's and expf rounds apart from torch's exp,
# by ~1e-6 relative; the state's decay keeps it from growing over steps
MSTEP_ATOL = MSTEP_RTOL = 1e-4


def _step_layer(g, di, n, k, device):
    """One layer's step parameters in ``k10.PARAMS`` order, at the model's
    init scales, with the biases, the skip and the decays drawn around
    their init values."""
    a_log = (torch.log(torch.arange(1, n + 1, dtype=torch.float32))[None]
             + 0.1 * torch.randn(di, n, generator=g))
    ps = [0.5 * torch.randn(k, di, generator=g),
          0.1 * torch.randn(di, generator=g),
          di ** -0.5 * torch.randn(di, 2 * n, generator=g),
          di ** -0.5 * torch.randn(di, 1, generator=g),
          0.5 * torch.randn(di, generator=g) - 1.0, a_log,
          1.0 + 0.1 * torch.randn(di, generator=g)]
    return [t.to(device) for t in ps]


def _within_step_tol(got, want):
    return bool(((got - want).abs()
                 <= MSTEP_ATOL + MSTEP_RTOL * want.abs()).all())


@pytest.mark.parametrize("b,di", [(1, 8192), (3, 8192), (512, 8192),
                                  (5, 8192 - 97)])
def test_mamba_step_kernel_matches_plain(cuda, b, di):
    """K10 on layer 1 of a three-layer cache at falcon-mamba-7b's widths
    (n 16, K 4; and a di that no block size divides), three steps in a row
    against the plain step on copies: y and the state within the stated
    bound, the window bit for bit, both updated in place (same
    ``data_ptr``), layers 0 and 2 untouched, two launches a step."""
    n, k = 16, 4
    g = torch.Generator().manual_seed(70 + b)
    params = _step_layer(g, di, n, k, cuda)
    conv = torch.randn(3, b, k - 1, di, generator=g).to(cuda)
    hs = torch.randn(3, b, di, n, generator=g).to(cuda)
    conv_p, hs_p = conv.clone(), hs.clone()
    ptrs = (conv[1].data_ptr(), hs[1].data_ptr())
    for step in range(3):
        xz = torch.randn(b, 2 * di, generator=g).to(cuda)
        before = k10.mamba_step.launches
        c1, h1 = conv[1], hs[1]
        y = k10.mamba_step(xz, c1, h1, *params)
        assert k10.mamba_step.launches == before + 2
        want = mamba_step_ref(xz, conv_p[1], hs_p[1], *params)
        torch.cuda.synchronize()
        assert (c1.data_ptr(), h1.data_ptr()) == ptrs
        assert y.shape == (b, di) and _within_step_tol(y, want), step
        assert _within_step_tol(hs[1], hs_p[1]), step
        assert torch.equal(conv[1], conv_p[1])
        for i in (0, 2):
            assert torch.equal(conv[i], conv_p[i])
            assert torch.equal(hs[i], hs_p[i])


def test_mamba_step_float16_takes_the_plain_step(cuda):
    """A float16 Mamba-1 step on the card (the state float32, as the
    model keeps it) is not the kernel's: ``mamba_apply`` runs the plain
    step, with no launch."""
    cfg = configs.get("falcon-mamba-7b").reduced()
    g = torch.Generator().manual_seed(3)
    p = S.mamba_init(g, cfg, L.FP32, "cpu")
    p = {k: (v if k in ("a_log", "dt_bias", "d_skip") else v.half()).to(cuda)
         for k, v in p.items()}
    st = S.mamba_init_state(cfg, 2, device=cuda, dtype=torch.float16)
    x = torch.randn(2, 1, cfg.d_model, generator=g).half().to(cuda)
    args = (x[:, 0].repeat(1, 2 * cfg.expand), st["conv"], st["h"],
            *(p[k] for k in k10.PARAMS))
    assert not k10.takes(*args)
    before = k10.mamba_step.launches
    y, new = S.mamba_apply(p, x, cfg, state=st)
    torch.cuda.synchronize()
    assert k10.mamba_step.launches == before
    assert new["h"] is not st["h"] and bool(torch.isfinite(y).all())


def test_serve_step_launches_k10_twice_a_layer(cuda):
    """A reduced falcon-mamba-7b's serve step on the card: each recorded
    ``serve.step`` moves K10's counter by two a layer and no other
    kernel's, and ``mamba_apply`` hands it the cache's own slices."""
    cfg = configs.get("falcon-mamba-7b").reduced()
    params = T.init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                           L.FP32, device=cuda)
    step = launch_steps.make_serve_step(cfg, L.FP32)
    cache = T.init_cache(cfg, 3, 8, L.FP32, device=cuda)
    lens = torch.zeros(3, dtype=torch.int32, device=cuda)
    tok = torch.randint(3, cfg.vocab, (3, 3), device=cuda)
    with tracing.recording() as rec:
        for t in range(3):
            _, cache, lens = step(params, tok[:, t:t + 1], cache, lens)
    torch.cuda.synchronize()
    counts = rec.take()["counts"]
    assert list(counts.values()) == [{"K10": 2 * cfg.n_layers}] * 3


# ---------------------------------------------------------------------------
# training: K6's lse, the gradients through K6 and K8, the loss on the card
# ---------------------------------------------------------------------------

# (B, S, S_kv, H, Hk, D, Dv, causal, window)
LSE_CASES = [
    (2, 300, 300, 4, 2, 128, 128, True, 0),
    (2, 257, 257, 8, 4, 256, 256, True, 64),
    (1, 200, 200, 4, 4, 96, 64, True, 0),
    (2, 33, 90, 6, 6, 64, 64, False, 0),
    (1, 96, 96, 4, 2, 32, 24, False, 16),
]


def _lse_ref(q, k, causal, window):
    """Each row's log-sum-exp of its scaled, masked scores, ``(B, Hk, rep,
    S)``, from the full scores."""
    from repro_torch.kernels.attention.ref import NEG_INF, window_mask

    b, s, h, d = q.shape
    hk = k.shape[2]
    qr = q.reshape(b, s, hk, h // hk, d).float() * d ** -0.5
    sc = torch.einsum("bqhrd,bkhd->bhrqk", qr, k.float())
    mask = window_mask(torch.arange(s, device=q.device),
                       torch.arange(k.shape[1], device=q.device), causal,
                       window)
    return torch.logsumexp(torch.where(mask, sc, NEG_INF), dim=-1)


@pytest.mark.parametrize("case", LSE_CASES)
def test_flash_lse_matches_plain_and_leaves_the_output_bits(cuda, case):
    """K6 with ``return_lse``: its lse against the plain loop's and the
    full scores', and its output the same bits as without (both tiles up
    to D=128, through the raw launcher's SM count)."""
    b, s, s_kv, h, hk, d, dv, causal, window = case
    q = _randn(90, b, s, h, d, device=cuda)
    k, v = _randn(91, b, s_kv, hk, d, device=cuda), _randn(
        92, b, s_kv, hk, dv, device=cuda)
    before = attn.flash_attention.launches
    out, lse = attn.flash_attention_gqa(q, k, v, causal=causal,
                                        window=window, return_lse=True)
    plain = attn.flash_attention_gqa(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert attn.flash_attention.launches == before + 2
    assert torch.equal(out, plain)
    want_out, want_lse = flash_gqa_ref(q, k, v, causal=causal, window=window,
                                       return_lse=True)
    assert lse.shape == (b, hk, h // hk, s) and lse.dtype == torch.float32
    assert (lse - want_lse).abs().max().item() <= ATTN_TOL[torch.float32]
    assert (lse - _lse_ref(q, k, causal, window)).abs().max().item() <= (
        ATTN_TOL[torch.float32])
    assert (out - want_out).abs().max().item() <= ATTN_TOL[torch.float32]
    if max(d, dv) <= 128:
        for sms in (1, 10**6):
            raw = q.new_empty((b, s, h, dv))
            raw_lse = torch.empty_like(lse)
            rc = attn._lib().flash_attention_launch(
                0, q.data_ptr(), k.data_ptr(), v.data_ptr(), raw.data_ptr(),
                raw_lse.data_ptr(), b, s, s_kv, h, hk, d, dv, int(causal),
                window, d ** -0.5, sms,
                torch.cuda.current_stream(cuda).cuda_stream)
            torch.cuda.synchronize()
            assert rc == 0
            assert torch.equal(raw, _flash_raw(cuda, q, k, v, causal, window,
                                               sms))
            assert (raw_lse - want_lse).abs().max().item() <= (
                ATTN_TOL[torch.float32])


@pytest.mark.parametrize("case", LSE_CASES)
def test_flash_mha_gradients_on_card_match_attention_ref(cuda, case):
    """``flash_mha``'s Function on the card (K6 forward with its lse, the
    blockwise recompute backward) against autograd of ``attention_ref``
    on the card, within 1e-4."""
    from repro_torch.models import flash

    b, s, s_kv, h, hk, d, dv, causal, window = case
    ins = [_randn(93, b, s, h, d, device=cuda),
           _randn(94, b, s_kv, hk, d, device=cuda),
           _randn(95, b, s_kv, hk, dv, device=cuda)]
    g = _randn(96, b, s, h, dv, device=cuda)
    leaves = [t.clone().requires_grad_() for t in ins]
    before = attn.flash_attention.launches
    out = flash.flash_mha(*leaves, causal=causal, window=window, q_block=128,
                          kv_block=64)
    got = torch.autograd.grad(out, leaves, g)
    assert attn.flash_attention.launches == before + 1  # the forward only
    leaves = [t.clone().requires_grad_() for t in ins]
    want = torch.autograd.grad(
        flash.attention_ref(*leaves, causal=causal, window=window), leaves, g)
    torch.cuda.synchronize()
    for mine, theirs in zip(got, want):
        assert (mine - theirs).abs().max().item() <= ATTN_TOL[torch.float32]


@pytest.mark.parametrize("b,s,di,n,with_h0", [
    (1, 128, 8192, 16, False), (2, 300, 256, 16, True), (3, 1, 33, 5, True),
])
def test_selective_scan_gradients_on_card_match_plain(cuda, b, s, di, n,
                                                      with_h0):
    """``selective_scan``'s Function on the card (K8 forward, the chunked
    plain recompute backward) against autograd of the plain recurrence
    on the card, within the scan's tolerances."""
    ins = _scan_inputs(97, b, s, di, n, cuda)
    if not with_h0:
        ins[-1] = None
    gy = _randn(98, b, s, di, device=cuda)
    gh = _randn(99, b, di, n, device=cuda)

    def grads(fn):
        leaves = [t.clone().requires_grad_() if t is not None else None
                  for t in ins]
        y, h = fn(*leaves)
        return torch.autograd.grad((y, h), [t for t in leaves
                                            if t is not None], (gy, gh))

    before = k8.ssm_scan.launches
    got = grads(k8.selective_scan)
    # the forward, then the backward's start state of each chunk but the first
    assert k8.ssm_scan.launches == before + 1 + (s - 1) // k8.BWD_CHUNK
    want = grads(selective_scan_ref)
    torch.cuda.synchronize()
    for mine, theirs in zip(got, want):
        assert torch.allclose(mine, theirs, rtol=1e-4, atol=1e-5)


TRAIN_ARCHS = ["qwen3-14b", "starcoder2-7b", "internvl2-76b",
               "falcon-mamba-7b", "phi3.5-moe-42b-a6.6b",
               "moonshot-v1-16b-a3b", "zamba2-7b", "gemma3-4b",
               "minicpm3-4b", "whisper-tiny"]


@pytest.mark.parametrize("name", TRAIN_ARCHS)
def test_reduced_loss_and_gradients_on_card_match_the_cpu(cuda, name):
    """Each reduced family's training loss and the gradient of every leaf
    on the card (K6 and K8 through their Functions, every layer
    recomputed) against the same on the CPU: the loss within 1e-5
    relative, each leaf within rtol 1e-3, atol 1e-4 · max|g|, the CPU
    tests' tolerances against the reference."""
    from repro_torch import pytree

    cfg = configs.get(name).reduced()
    cpu = T.init_params(torch.Generator().manual_seed(0), cfg, L.FP32,
                        device="cpu")
    card = convert.from_reference(convert.to_numpy(cpu), device=cuda)
    rng = np.random.default_rng(12)
    tok = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 48)))
    batch = {"tokens": tok, "targets": torch.roll(tok, -1, dims=1)}
    if cfg.frontend:
        batch["frontend"] = torch.from_numpy((rng.standard_normal(
            (2, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32))

    def loss_and_grads(params, dev):
        leaves = pytree.leaves(params)
        for p in leaves:
            p.requires_grad_()
        loss = T.loss_fn(params, {k: v.to(dev) for k, v in batch.items()},
                         cfg)
        return loss.item(), torch.autograd.grad(loss, leaves)

    n6, n8 = attn.flash_attention.launches, k8.ssm_scan.launches
    got_loss, got = loss_and_grads(card, cuda)
    launched = (attn.flash_attention.launches - n6,
                k8.ssm_scan.launches - n8)
    want_loss, want = loss_and_grads(cpu, "cpu")
    assert launched[0] > 0 or launched[1] > 0  # the kernels ran
    assert abs(got_loss - want_loss) <= 1e-5 * abs(want_loss)
    for (path, _), mine, theirs in zip(pytree.items(cpu), got, want):
        assert torch.allclose(
            mine.cpu(), theirs, rtol=1e-3,
            atol=1e-4 * theirs.abs().max().item()), path


def test_train_main_on_card_launches_k6_twice_a_layer_a_step(cuda,
                                                              tmp_path):
    """``train.main`` on a reduced qwen3-14b: K6 once a layer in the
    forward and once more in the recomputed backward, every step; no
    recovery; the losses those of the CPU within 2e-3. Both resume from
    one step-0 checkpoint of the card's initial state (a generator on the
    card draws other weights than one on the CPU)."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.launch import train

    cfg = configs.get("qwen3-14b").reduced()
    for dev in ("cuda", "cpu"):
        ckpt.save({"state": train.build_state(cfg, L.FP32, device=cuda),
                   "data": {"step": 0}}, str(tmp_path / dev), 0)
    argv = ["--arch", "qwen3-14b", "--reduced", "--steps", "3", "--batch",
            "2", "--seq", "64", "--ckpt-every", "1000", "--resume"]
    before = attn.flash_attention.launches
    run = train.run(argv + ["--ckpt-dir", str(tmp_path / "cuda")])
    assert attn.flash_attention.launches - before == 3 * 2 * run.cfg.n_layers
    assert run.recoveries == 0
    want = train.main(argv + ["--ckpt-dir", str(tmp_path / "cpu"),
                              "--device", "cpu"])
    assert np.allclose(run.losses, want, rtol=0, atol=2e-3)


def test_unbound_layer_views_on_card_match_per_index_views(cuda,
                                                           monkeypatch):
    """A reduced minicpm3-4b's train-step gradient on the card (``loss_fn``
    under ``torch.autograd.grad``, as ``make_train_step`` takes it)
    through ``transformer.layer_views``, one ``unbind`` a stack, against a
    view per layer (``layer_params(stack, i)``): every leaf bit for bit
    (deterministic algorithms, so the embedding's index sums in one
    order), and a peak of allocated memory no higher over the step, as no
    layer's backward zero-fills a gradient of its whole stack."""
    from repro_torch import pytree

    cfg = configs.get("minicpm3-4b").reduced()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, L.FP32, device="cuda")
    leaves = pytree.leaves(params)
    rng = np.random.default_rng(1)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab, (2, 512),
                                              dtype=np.int32)).cuda()
             for k in ("tokens", "targets")}

    def grads():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        try:
            with torch.enable_grad():
                for p in leaves:
                    p.requires_grad_(True)
                out = torch.autograd.grad(
                    T.loss_fn(params, batch, cfg, L.FP32), leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    was = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        got, got_peak = grads()
        monkeypatch.setattr(T, "layer_views", lambda stacked, n: [
            T.layer_params(stacked, i) for i in range(n)])
        want, want_peak = grads()
    finally:
        torch.use_deterministic_algorithms(was)
    for (path, _), g, w in zip(pytree.items(params), got, want):
        assert torch.equal(g, w), path
    assert got_peak <= want_peak, (got_peak, want_peak)


def test_kernels_without_a_backward_refuse_grad_on_the_card(cuda):
    """Each wrapper without an autograd Function raises naming its kernel
    when a CUDA input requires grad under grad mode, and runs under
    ``no_grad``."""
    q = _randn(1, 2, 4, 16, device=cuda).requires_grad_()
    kc = _randn(2, 2, 8, 2, 16, device=cuda)
    lens = torch.tensor([3, 8], dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="K7"):
        attn.decode_attention_gqa(q, kc, kc, lens, sm_scale=0.25)
    with torch.no_grad():
        attn.decode_attention_gqa(q, kc, kc, lens, sm_scale=0.25)
    q6 = _randn(3, 1, 8, 2, 16, device=cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="K6"):
        attn.flash_attention_gqa(q6, q6, q6)
    x = _randn(4, 128, 16, device=cuda).requires_grad_()
    w = _randn(5, 2, 16, 8, device=cuda)
    with pytest.raises(RuntimeError, match="K9"):
        k9.group_matmul(x, w, torch.zeros(1, dtype=torch.int32, device=cuda))
    vals = _randn(6, 128, 4, device=cuda).requires_grad_()
    with pytest.raises(RuntimeError, match="K4"):
        k4.csr_spmv(torch.zeros(128, 4, dtype=torch.int32, device=cuda), vals,
                    _randn(7, 8, device=cuda))
    src_val = _randn(8, 16, device=cuda).requires_grad_()
    idx = torch.arange(16, dtype=torch.int32, device=cuda)
    with pytest.raises(RuntimeError, match="K3"):
        k3.fused_stream(idx, src_val, idx, idx, _randn(9, 32, device=cuda))
    torch.cuda.synchronize()


# -- distribution: the sharded step, sharded checkpoints, K6 on shards --


@pytest.fixture
def nccl_world(cuda):
    """A default NCCL group of one rank on the card (destroyed after) and
    its (1, 1) ("data", "model") mesh."""
    import socket

    import torch.distributed as dist
    from repro_torch.launch import mesh as mesh_lib

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=0, world_size=1)
    try:
        yield mesh_lib.make_mesh((1, 1), ("data", "model"), "cuda")
    finally:
        dist.destroy_process_group()


def _sharded_train_steps(cfg, data, mesh):
    """Three ``make_train_step`` steps from one seeded state on the card:
    on plain tensors, or with ``mesh`` on DTensors (``partition``, the
    mesh context and the layer-boundary sharding set)."""
    from repro_torch.distributed import partition
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import shardctx
    from repro_torch.optim import adamw

    params = T.init_params(torch.Generator(device="cuda").manual_seed(0),
                           cfg, L.FP32, device="cuda")
    opt = adamw.init_state(params)
    if mesh is not None:
        shardctx.set_mesh_ctx(mesh, ("data",))
        T.set_activation_sharding(partition.P(("data",), "model", None))
        specs = partition.validate_divisibility(
            partition.param_specs(params), params, mesh)
        params = partition.distribute(params, specs, mesh)
        opt = partition.distribute(
            opt, {"m": specs, "v": specs, "step": partition.P()}, mesh)
        data = [partition.distribute(d, partition.batch_spec(mesh), mesh)
                for d in data]
    step = steps_lib.make_train_step(cfg, adamw.AdamWConfig(), L.FP32)
    out = []
    try:
        for batch in data:
            params, opt, m = step(params, opt, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
    finally:
        shardctx.clear_mesh_ctx()
        T.set_activation_sharding(None)
    return out, params


def test_sharded_step_on_card_matches_unsharded(nccl_world):
    """The NCCL world-1 sharded step of a reduced qwen3-14b, K6 on local
    shards, against the same steps on plain tensors: every shard is the
    whole tensor, so the products are the same (the embedding's gradient
    sums in another order: an index's atomics against F.embedding's)."""
    from repro_torch.models import flash

    cfg = configs.get("qwen3-14b").reduced()
    rng = np.random.default_rng(0)
    data = [{k: torch.from_numpy(rng.integers(0, cfg.vocab, (4, 512),
                                              dtype=np.int32)).cuda()
             for k in ("tokens", "targets")} for _ in range(3)]
    plain, _ = _sharded_train_steps(cfg, data, None)
    before = (attn.flash_attention.launches, flash._flash_sharded.calls)
    got, params = _sharded_train_steps(cfg, data, nccl_world)
    launches = attn.flash_attention.launches - before[0]
    assert launches == 2 * cfg.n_layers * 3
    assert flash._flash_sharded.calls - before[1] == launches
    assert type(params["embed"]).__name__ == "DTensor"
    np.testing.assert_allclose(np.array(got), np.array(plain), rtol=1e-6)


def test_sharded_checkpoint_round_trip_on_card(nccl_world, tmp_path):
    """DTensor params on the card saved (gathered on the main thread,
    written by rank 0) and restored onto the mesh, bit for bit."""
    from repro_torch import pytree
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import partition

    cfg = configs.get("qwen3-14b").reduced()
    params = T.init_params(torch.Generator(device="cuda").manual_seed(3),
                           cfg, L.FP32, device="cuda")
    specs = partition.param_specs(params)
    sharded = partition.distribute(params, specs, nccl_world)
    saver = ckpt.AsyncCheckpointer(str(tmp_path))
    saver.save(sharded, 7)
    saver.wait()
    like = pytree.map_leaves(torch.zeros_like, params)
    back, step = ckpt.restore(like, str(tmp_path), shardings=partition.
                              shardings_of(specs, nccl_world))
    assert step == 7
    for (key, want), got in zip(pytree.items(params), pytree.leaves(back)):
        assert type(got).__name__ == "DTensor", key
        assert torch.equal(got.full_tensor().cuda(), want), key


@pytest.mark.parametrize("h,hk,off,hl", [(40, 8, 10, 10), (32, 8, 4, 2),
                                         (12, 4, 3, 6)])
def test_flash_local_with_a_head_offset_matches_plain(cuda, h, hk, off, hl):
    """The GQA offset case: a shard of query heads ``[off, off + hl)``
    (as a mesh spec sharding q's heads but not k's gives a rank) against
    every kv head, through ``flash_mha_local`` with the global offset: K6
    pairs each query head with its global kv head, against the plain
    version's heads of the whole call."""
    from repro_torch.models import flash

    b, s, d = 2, 256, 64
    g = torch.Generator(device="cuda").manual_seed(h + off)
    q, k, v = (torch.randn(b, s, n, d, generator=g, device="cuda")
               for n in (h, hk, hk))
    want = flash_gqa_ref(q, k, v, causal=True)[:, :, off:off + hl]
    before = attn.flash_attention.launches
    got = flash.flash_mha_local(q[:, :, off:off + hl], k, v, rep=h // hk,
                                q_head_offset=off, causal=True)
    assert attn.flash_attention.launches == before + 1
    assert (got - want).abs().max().item() <= 1e-4
