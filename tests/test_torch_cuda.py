"""Card-only tests of the port: the CUDA kernels (wave steps, hazard
frontier, forwarding, ELL SpMV, histogram, flash and decode attention,
selective scan, grouped expert matmul) against their plain torch
versions, a reduced qwen3-14b's and falcon-mamba-7b's prefill and decode
step and a reduced phi3.5-moe's prefill and dropless MoE layer on the
card against the CPU, the main path on the card against the oracle (a speculative
and a streaming program included), the substrate ops, and the DU-kernel
cross-checks of a WavePlan on the card.

The kernels have no CPU mode, so every test here carries the ``cuda``
marker and skips itself (with the reason) where no CUDA device is
present. On a machine with an H100 and ``nvcc``:
``PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py``.
This file imports only the port, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

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
from repro_torch.kernels.moe_group_mm import kernel as k9
from repro_torch.kernels.moe_group_mm.ref import group_matmul_ref
from repro_torch.kernels.ssm_scan import kernel as k8
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref, ssm_scan_ref
from repro_torch.models import convert, layers as L, transformer as T

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
    with pytest.raises(NotImplementedError, match="item 12d"):
        attn.flash_attention_gqa(q, k, v, window=16)
    assert attn.flash_attention.launches == before + 1


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


@pytest.mark.parametrize("d", [32, 64, 128])
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
        out = torch.empty_like(q)
        rc = attn._lib().flash_attention_launch(
            0, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b,
            s, s, h, hk, d, int(causal), d ** -0.5, sms,
            torch.cuda.current_stream(cuda).cuda_stream)
        torch.cuda.synchronize()
        assert rc == 0
        assert (out - want).abs().max().item() <= ATTN_TOL[torch.float32]


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


# K8 against its plain version: float32 within the reference's kernel
# bound (1e-4; the exponentials and the state sum round differently);
# bfloat16 outputs within 2e-2, about two bfloat16 steps of outputs
# below 2, since both round one float32 result
SCAN_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


# K9 against its plain version: float32 within 1e-4 (sums of up to 256
# products in another order than cuBLAS's); bfloat16 within 2e-2
GMM_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


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


def test_reduced_falcon_mamba_on_card_matches_the_cpu(cuda):
    """A reduced falcon-mamba-7b's prefill (one K8 launch per layer) and
    a decode step on the card against the CPU, at the reference's decode
    tolerance."""
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
    got, cache = T.decode_step(card, tok[:, :1].to(cuda), cache,
                               lens.to(cuda), cfg, L.FP32)
    want, cache_cpu = T.decode_step(cpu, tok[:, :1], cache_cpu, lens, cfg,
                                    L.FP32)
    assert k8.ssm_scan.launches - n8 == cfg.n_layers
    assert torch.allclose(got.cpu(), want, atol=2e-3, rtol=1e-3)
    for key in ("conv", "h"):
        assert torch.allclose(cache["ssm"][key].cpu(), cache_cpu["ssm"][key],
                              atol=2e-3, rtol=1e-3)
