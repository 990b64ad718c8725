"""The wave kernel's launch plumbing on the CPU: the per-plan step tables
of ``wave_exec.ops`` and the choice between the kernel's two paths.

``ops.pack_steps`` packs every recorded step of a plan into one table
each, which the device phase uploads once and launches on by views; the
views must equal the tables built segment by segment, for every Table-1,
speculative and streaming program, and the run's ``segments`` must be the
runs of equal lane bucket. ``choose_path`` is a pure function of the
image size, the width and the card's limits (passed in here as an H100's):
a launch whose image and lanes fit one block takes the resident path,
every other the wide one, whose grid keeps a narrow launch's blocks (one
per 256 lanes) and takes four lanes a thread only where the grid stays
large.
"""

import numpy as np
import pytest

from repro_torch.core import executor, loopir as ir, programs
from repro_torch.kernels.wave_exec import kernel, ops

# small scales, as the other CPU tests of the port run them
SCALES = {
    "RAWloop": 96, "WARloop": 96, "WAWloop": 96,
    "bnn": 12, "pagerank": 16, "fft": 32, "matpower": 12,
    "hist+add": 96, "tanh+spmv": 64,
    "spmv_ldtrip": 24, "bfs_front": 48, "chase_sum": 32, "strided_scan": 32,
    "stream_dot": 12, "filter_pipe": 48, "stream_join": 32,
}
KWARGS = {
    **{n: {"speculation": "auto"} for n in programs.SPEC_KERNELS},
    **{n: {"fifo_depth": 1} for n in programs.STREAM_KERNELS},
}
PROGRAMS = (*programs.TABLE1, *programs.SPEC_KERNELS,
            *programs.STREAM_KERNELS)

# an H100 SXM's limits as the CUDA runtime reports them: 227 KB (29056 int64
# words) of shared memory a block, and 1056 co-resident wide blocks
H100 = kernel.Limits(words_per_block=29056, max_grid=1056)
ONE_BLOCK_LANES = 512 * 8
# (M, W) of every launch of the main, speculation and streaming paths at
# chip_smoke.py's scales: the image is mem_size + 1 words
PATH_LAUNCHES = [
    (32769, 16384), (32769, 32768), (16385, 16384),  # RAW/WAR/WAWloop
    *[(66049, w) for w in (512, 1024, 2048, 4096, 8192)],  # bnn
    *[(2305, 2**k) for k in range(3, 13)],  # pagerank
    (2049, 2048),  # fft
    *[(1025, 2**k) for k in range(3, 12)],  # matpower
    (97, 64), (97, 32), (97, 16), (97, 8),  # hist+add
    *[(4097, 2**k) for k in range(3, 13)],  # tanh+spmv
    (2050, 1024), (2050, 8), (1540, 2048), (1540, 8),  # streaming
    (4354, 8192), (4354, 8),
]


def _bucket(n):
    b = 8
    while b < n:
        b *= 2
    return b


def _per_segment(steps, scratch):
    """The tables of each segment as the device phase once built them:
    one padded ``(steps, width)`` block per run of equal lane bucket."""
    widths = [_bucket(len(a)) for a, _, _ in steps]
    out, s0 = [], 0
    while s0 < len(steps):
        s1 = s0
        while s1 < len(steps) and widths[s1] == widths[s0]:
            s1 += 1
        ns, wd = s1 - s0, widths[s0]
        addrs = np.full((ns, wd), scratch, dtype=np.int32)
        writes = np.zeros((ns, wd), dtype=bool)
        svals = np.zeros((ns, wd), dtype=np.float64)
        for j in range(ns):
            a, w, v = steps[s0 + j]
            addrs[j, :len(a)] = a
            writes[j, :len(a)] = w
            svals[j, :len(a)] = v
        out.append(((s0, s1), addrs, writes, svals))
        s0 = s1
    return out


@pytest.mark.parametrize("name", PROGRAMS)
def test_packed_tables_equal_per_segment_tables(name, monkeypatch):
    packed = []

    def spy(steps, scratch):
        tables = pack(steps, scratch)
        packed.append((steps, scratch, tables))
        return tables

    pack = ops.pack_steps
    monkeypatch.setattr(ops, "pack_steps", spy)
    prog, arrays, params = programs.get(name).make(SCALES[name])
    res = executor.execute(prog, arrays, params, backend="torch",
                           device="cpu", **KWARGS.get(name, {}))
    oracle = ir.interpret(prog, arrays, params)
    for k in oracle:
        assert res.arrays[k].tobytes() == oracle[k].tobytes(), k
    assert len(packed) == 1
    steps, scratch, tables = packed[0]
    want = _per_segment(steps, scratch)
    assert tables.segments == [seg for seg, *_ in want]
    assert res.run.segments == [(s1 - s0, a.shape[1])
                                for (s0, s1), a, _, _ in want]
    assert res.run.n_segments == len(want) > 0
    for at, ((s0, s1), addrs, writes, svals) in zip(tables.offsets, want):
        n = addrs.size
        np.testing.assert_array_equal(
            tables.addrs[at:at + n].reshape(addrs.shape), addrs)
        np.testing.assert_array_equal(
            tables.writes[at:at + n].reshape(addrs.shape), writes)
        np.testing.assert_array_equal(
            tables.svals[at:at + n].reshape(addrs.shape).view(np.int64),
            svals.view(np.int64))
    assert tables.addrs.size == sum(a.size for _, a, _, _ in want)


def test_pack_steps_of_no_steps():
    tables = ops.pack_steps([], 5)
    assert tables.segments == [] and tables.offsets == []
    assert tables.addrs.size == tables.writes.size == tables.svals.size == 0


def _one_lane_grid(w, limits):
    """The wide grid at one lane a thread: 256 threads a block, capped at
    the co-resident grid."""
    return max(1, min(limits.max_grid, -(-w // 256)))


@pytest.mark.parametrize("m,w", PATH_LAUNCHES)
def test_every_path_launch_takes_its_path(m, w):
    """One-block images (image and lanes fit one block) take the resident
    path on one block; every other launch the wide path, with at least
    the blocks of one lane a thread up to ``WIDE_MIN_GRID``."""
    path = kernel.choose_path(m, w, H100)
    if m <= H100.words_per_block and w <= ONE_BLOCK_LANES:
        assert path.kind == "resident", (m, w)
        assert path.blocks == 1
        assert path.threads % 32 == 0 and 32 <= path.threads <= 512
        assert path.lanes in kernel.RESIDENT_LANES
        assert path.threads * path.lanes >= w
        # the fewest lanes a thread, and the fewest warps, that cover w
        assert (path.lanes == 1
                or (path.lanes // 2) * kernel.RESIDENT_THREADS < w)
        assert (path.threads - 32) * path.lanes < w
    else:
        assert path == kernel.wide_path(w, H100.max_grid), (m, w)
        assert path.blocks >= min(_one_lane_grid(w, H100), kernel.WIDE_MIN_GRID)


@pytest.mark.parametrize("m,w,grid,lanes", [
    (2**24 + 1, 2**20, 1024, 4),  # the kernel phase
    (2**18 + 1, 2**18, 256, 4),  # L2-resident
    (29056 + 1, 8, 1, 1),  # one word past one block
])
def test_images_past_one_block_take_the_wide_path(m, w, grid, lanes):
    assert kernel.choose_path(m, w, H100) == kernel.Path(
        "wide", grid, kernel.THREADS, lanes)


@pytest.mark.parametrize("w", [1, 8, 1025, 4096, 4097, 32768])
def test_capacity_of_one_block(w):
    """An image of one block's words takes the resident path if its
    lanes fit one block (512 x 8), else the wide path; one word more takes
    the wide path."""
    one = H100.words_per_block
    wide = kernel.wide_path(w, H100.max_grid)
    assert kernel.choose_path(one, w, H100) == (
        kernel.resident_path(w) if w <= ONE_BLOCK_LANES else wide)
    assert kernel.choose_path(1, w, H100) == kernel.choose_path(one, w, H100)
    assert kernel.choose_path(one + 1, w, H100) == wide


@pytest.mark.parametrize("w", [1, 8, 255, 256, 257, 8192, 16384, 32768,
                               64512, 64513, 2**18, 2**20, 2**30])
def test_wide_grid_keeps_narrow_launches_blocks(w):
    """Below ``WIDE_MIN_GRID`` blocks of four lanes a thread the wide path
    takes one lane a thread (one block per 256 lanes); from there four lanes a thread; the grid covers the
    lanes in one pass unless the co-resident cap binds."""
    path = kernel.wide_path(w, H100.max_grid)
    four = -(-w // (kernel.THREADS * 4))
    if four < kernel.WIDE_MIN_GRID:
        assert (path.lanes, path.blocks) == (1, _one_lane_grid(w, H100))
    else:
        assert (path.lanes, path.blocks) == (4, min(H100.max_grid, four))
    assert (path.blocks * path.threads * path.lanes >= w
            or path.blocks == H100.max_grid)


def test_smaller_card_limits():
    """More lanes than one block takes go to the wide path; a smaller
    card's limits shrink both paths."""
    assert kernel.choose_path(97, ONE_BLOCK_LANES, H100).kind == "resident"
    assert kernel.choose_path(97, ONE_BLOCK_LANES + 1, H100).kind == "wide"
    small = kernel.Limits(words_per_block=1000, max_grid=64)
    assert kernel.choose_path(1000, 8, small) == kernel.resident_path(8)
    assert kernel.choose_path(1001, 8, small) == kernel.Path(
        "wide", 1, kernel.THREADS, 1)
    assert kernel.choose_path(97, 2**20, small) == kernel.Path(
        "wide", 64, kernel.THREADS, 4)
