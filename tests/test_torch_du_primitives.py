"""The port's DU primitives against the JAX package's, on the CPU.

The plain torch versions of the hazard frontier kernel (K2) and the
forwarding kernel (K3) — what the wrappers run on a CPU tensor — are held
against the Pallas kernels in interpret mode on seeded inputs: frontiers
exactly, forwarded float32 values bit for bit. One divergence is pinned
on purpose: the Pallas frontier pads its source with ``INT32_MAX`` and
counts the pads for a consumer address of ``INT32_MAX``; the port takes
no pads and counts ``S``.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.du_hazard import kernel as ref_k2
from repro.kernels.du_hazard.ops import wave_partition as ref_wave_partition
from repro.kernels.fused_stream import ops as ref_k3_ops
from repro.kernels.fused_stream.kernel import fused_stream as ref_fused_stream
from repro_torch.kernels.du_hazard import kernel as k2
from repro_torch.kernels.du_hazard.ops import (
    hazard_frontier,
    hazard_frontier_batch,
    hazard_frontier_ref,
    wave_partition,
)
from repro_torch.kernels.fused_stream import kernel as k3
from repro_torch.kernels.fused_stream.ops import (
    fused_raw_loops,
    fused_stream,
    min_lookback,
)

INT32_MAX = 2**31 - 1


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _pallas_frontier(src, dst, side="right", batch=False):
    fn = ref_k2.hazard_frontier_batch if batch else ref_k2.hazard_frontier
    return np.asarray(fn(jnp.asarray(src), jnp.asarray(dst), side=side,
                         block_d=64, block_s=64, interpret=True))


def _port_frontier(src, dst, side="right", batch=False):
    fn = hazard_frontier_batch if batch else hazard_frontier
    return fn(_t(src), _t(dst), side=side).numpy()


# ---------------------------------------------------------------------------
# K2: hazard frontier
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,d", [(64, 33), (1000, 777), (257, 512)])
@pytest.mark.parametrize("hi", [10, 500])
def test_hazard_frontier_matches_pallas(s, d, hi):
    rng = np.random.default_rng(s * 7 + hi)
    src = np.sort(rng.integers(0, hi, s)).astype(np.int32)
    dst = rng.integers(0, hi + 50, d).astype(np.int32)
    got = _port_frontier(src, dst)
    np.testing.assert_array_equal(got, _pallas_frontier(src, dst))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(
        got, np.searchsorted(src, dst, side="right")
    )


@pytest.mark.parametrize("side", ["right", "left"])
def test_hazard_frontier_sides_match_pallas(side):
    rng = np.random.default_rng(3)
    src = np.sort(rng.integers(-20, 25, 70)).astype(np.int32)
    dst = rng.integers(-25, 30, 41).astype(np.int32)
    got = _port_frontier(src, dst, side)
    np.testing.assert_array_equal(got, _pallas_frontier(src, dst, side))
    if side == "left":  # equal addresses exist: strictly fewer somewhere
        assert (got < _port_frontier(src, dst, "right")).any()


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("k,s,d", [(3, 40, 30), (6, 129, 77)])
def test_hazard_frontier_batch_matches_pallas(k, s, d, side):
    rng = np.random.default_rng(k * 100 + s)
    src = np.sort(rng.integers(0, 50, (k, s)), axis=1).astype(np.int32)
    dst = rng.integers(0, 60, (k, d)).astype(np.int32)
    got = _port_frontier(src, dst, side, batch=True)
    np.testing.assert_array_equal(
        got, _pallas_frontier(src, dst, side, batch=True)
    )
    for kk in range(k):  # K rows in one call == K single merges
        np.testing.assert_array_equal(
            got[kk], _port_frontier(src[kk], dst[kk], side)
        )


@pytest.mark.parametrize("side", ["right", "left"])
def test_hazard_frontier_counts_non_monotonic_rows_like_pallas(side):
    """The kernel counts for any source: an unsorted row is no error and
    gives the Pallas kernel's count, not a search's answer."""
    rng = np.random.default_rng(5)
    src = rng.integers(-40, 40, (4, 97)).astype(np.int32)
    src[0] = np.sort(src[0])  # one monotonic row beside unsorted ones
    dst = rng.integers(-50, 50, (4, 65)).astype(np.int32)
    got = _port_frontier(src, dst, side, batch=True)
    np.testing.assert_array_equal(
        got, _pallas_frontier(src, dst, side, batch=True)
    )
    op = np.less if side == "left" else np.less_equal
    want = op(src[:, None, :], dst[:, :, None]).sum(axis=2)
    np.testing.assert_array_equal(got, want)


def test_hazard_frontier_count_is_not_a_search():
    """src = [9, 1, 5], dst = 5: two producers are <= 5 (the count both
    kernels return); searchsorted on the unsorted row would say 3."""
    src = np.array([9, 1, 5], dtype=np.int32)
    dst = np.array([5], dtype=np.int32)
    assert _port_frontier(src, dst).tolist() == [2]
    assert _pallas_frontier(src, dst).tolist() == [2]


@pytest.mark.parametrize("side,port,pallas", [
    ("right", [3, 1, 0], [64, 1, 0]),
    ("left", [3, 1, 0], [3, 1, 0]),
])
def test_hazard_frontier_int32_max_divergence(side, port, pallas):
    """Pinned divergence: Pallas pads src with INT32_MAX up to its block
    (64 here, 256 by default) and, under side="right", a dst of
    INT32_MAX counts every pad. The port has no pads and counts S = 3;
    the reference's own searchsorted oracle agrees with the port."""
    src = np.array([1, 5, 9], dtype=np.int32)
    dst = np.array([INT32_MAX, 4, -3], dtype=np.int32)
    assert _port_frontier(src, dst, side).tolist() == port
    assert _pallas_frontier(src, dst, side).tolist() == pallas
    assert np.searchsorted(src, dst, side=side).tolist() == port


def test_hazard_frontier_empty_shapes():
    src = torch.zeros((2, 0), dtype=torch.int32)
    dst = torch.tensor([[1, 2], [3, -4]], dtype=torch.int32)
    assert hazard_frontier_batch(src, dst).tolist() == [[0, 0], [0, 0]]
    got = hazard_frontier(torch.tensor([1, 2], dtype=torch.int32),
                          torch.zeros(0, dtype=torch.int32))
    assert got.shape == (0,) and got.dtype == torch.int32


@pytest.mark.parametrize("side", ["right", "left"])
@pytest.mark.parametrize("k,s,d", [(3, 1, 20), (4, 130, 70), (2, 300, 129)])
def test_hazard_frontier_batch_mixed_rows_match_pallas(k, s, d, side):
    """One call over sorted rows with long equal-address runs and negative
    addresses beside shuffled rows; consumers below and above every
    producer and ``INT32_MIN`` (0 on either side)."""
    rng = np.random.default_rng(k * 1000 + s)
    src = np.sort(rng.integers(-60, 60, (k, s)), axis=1)
    src[:, 1::2] = src[:, 0::2][:, : src[:, 1::2].shape[1]]
    rng.shuffle(src[k - 1])
    src = src.astype(np.int32)
    dst = rng.integers(-70, 70, (k, d)).astype(np.int32)
    dst[:, 0] = -2**31
    dst[:, 1:3] = (-61, 60)
    got = _port_frontier(src, dst, side, batch=True)
    np.testing.assert_array_equal(
        got, _pallas_frontier(src, dst, side, batch=True)
    )
    assert got[:, 0].tolist() == [0] * k
    assert got[:, 1].tolist() == [0] * k
    assert got[:, 2].tolist() == [s] * k


def test_hazard_frontier_ref_chunks_like_one_pass(monkeypatch):
    """The plain version's chunking over dst changes nothing."""
    from repro_torch.kernels.du_hazard import ref

    rng = np.random.default_rng(9)
    src = _t(np.sort(rng.integers(0, 300, (3, 211))).astype(np.int32))
    dst = _t(rng.integers(-5, 310, (3, 123)).astype(np.int32))
    whole = ref.hazard_frontier_batch_ref(src, dst)
    monkeypatch.setattr(ref, "_CHUNK_ELEMS", 3 * 211 * 5)  # 5 dst a chunk
    assert torch.equal(ref.hazard_frontier_batch_ref(src, dst), whole)
    assert torch.equal(hazard_frontier_ref(src[1], dst[1]), whole[1])


def test_wave_partition_matches_reference():
    rng = np.random.default_rng(4)
    src = np.sort(rng.integers(0, 80, 120)).astype(np.int32)
    dst = rng.integers(0, 90, 75).astype(np.int32)
    waves = np.sort(rng.integers(0, 30, 120)).astype(np.int32)
    f = _port_frontier(src, dst)
    assert (f == 0).any() and (f == len(src)).any()
    got = wave_partition(_t(f), _t(waves)).numpy()
    want = np.asarray(ref_wave_partition(jnp.asarray(f), jnp.asarray(waves)))
    np.testing.assert_array_equal(got, want)
    # no producers at all: every consumer is in wave 0
    empty = wave_partition(torch.zeros(3, dtype=torch.int32),
                           torch.zeros(0, dtype=torch.int64))
    assert empty.tolist() == [0, 0, 0]


# ---------------------------------------------------------------------------
# K3: guarded store-to-load forwarding
# ---------------------------------------------------------------------------


def _stream_case(seed, s, d, m, valid_rate, dtype=np.float32):
    """Monotonic producers with equal-address runs, consumers partly on
    producer addresses, a few out of range so the memory gather clips."""
    rng = np.random.default_rng(seed)
    src = np.sort(rng.integers(0, m, s)).astype(np.int32)
    val = rng.standard_normal(s).astype(dtype)
    valid = (rng.random(s) < valid_rate).astype(np.int32)
    dst = rng.integers(0, m, d).astype(np.int32)
    dst[: d // 3] = rng.choice(src, d // 3)
    dst[-2:] = (-3, m + 7)
    memory = rng.standard_normal(m).astype(dtype)
    return src, val, valid, dst, memory


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32 if x.dtype.itemsize == 4 else np.int64)


@pytest.mark.parametrize("lookback", [1, 2, 3, 4])
def test_fused_stream_guarded_f32_bit_exact_vs_pallas(lookback):
    src, val, valid, dst, memory = _stream_case(lookback, 150, 97, 60, 0.6)
    f = np.searchsorted(src, dst, side="right").astype(np.int32)
    got_v, got_h = fused_stream(_t(src), _t(val), _t(f), _t(dst),
                                _t(memory), _t(valid), lookback=lookback)
    want_v, want_h = ref_fused_stream(
        jnp.asarray(src), jnp.asarray(val), jnp.asarray(f),
        jnp.asarray(dst), jnp.asarray(memory), jnp.asarray(valid),
        lookback=lookback, block_d=64, interpret=True,
    )
    assert got_v.dtype == torch.float32 and got_h.dtype == torch.bool
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))
    assert got_h.any() and not got_h.all()


def test_fused_stream_unguarded_and_clipped_frontiers_vs_pallas():
    """src_valid=None; frontiers past S and below 0 clip like jnp.take."""
    src, val, _, dst, memory = _stream_case(21, 40, 64, 30, 1.0)
    f = np.searchsorted(src, dst, side="right").astype(np.int32)
    f[:6] = (0, -4, 41, 55, 40, 1)
    got_v, got_h = fused_stream(_t(src), _t(val), _t(f), _t(dst),
                                _t(memory), lookback=3)
    want_v, want_h = ref_fused_stream(
        jnp.asarray(src), jnp.asarray(val), jnp.asarray(f),
        jnp.asarray(dst), jnp.asarray(memory), lookback=3, block_d=64,
        interpret=True,
    )
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))


def test_fused_stream_f64_forwards_whole_words():
    """float64 values, NaN payloads included, arrive bit for bit: from the
    youngest valid producer on a hit, from memory on a miss."""
    src, val, valid, dst, memory = _stream_case(8, 90, 70, 40, 0.7,
                                                dtype=np.float64)
    val.view(np.int64)[::9] = 0x7FF8000000000000 | np.arange(1, 11)
    memory.view(np.int64)[::5] = 0x7FF0000000000000 | np.arange(1, 9)
    f = np.searchsorted(src, dst, side="right").astype(np.int32)
    got_v, got_h = fused_stream(_t(src), _t(val), _t(f), _t(dst), _t(memory),
                                _t(valid), lookback=min_lookback(src))
    want = np.empty(len(dst), dtype=np.float64)
    hit = np.zeros(len(dst), dtype=bool)
    for j, (a, fj) in enumerate(zip(dst, f)):
        landed = [i for i in range(fj) if src[i] == a and valid[i]]
        hit[j] = bool(landed)
        want[j] = val[landed[-1]] if landed else memory[np.clip(a, 0, 39)]
    np.testing.assert_array_equal(got_h.numpy(), hit)
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want))


def test_fused_stream_no_producers_reads_memory():
    memory = torch.arange(5, dtype=torch.float64)
    dst = torch.tensor([4, -1, 9, 2], dtype=torch.int32)
    v, h = fused_stream(torch.zeros(0, dtype=torch.int32),
                        torch.zeros(0, dtype=torch.float64),
                        torch.zeros(4, dtype=torch.int32), dst, memory)
    assert v.tolist() == [4.0, 0.0, 4.0, 2.0] and not h.any()


@pytest.mark.parametrize("s,d,m", [(100, 77, 64), (512, 333, 256)])
def test_fused_raw_loops_matches_reference(s, d, m):
    src, val, _, dst, memory = _stream_case(s, s, d, m, 1.0)
    got_v, got_h = fused_raw_loops(src, val, dst, memory, device="cpu")
    want_v, want_h = ref_k3_ops.fused_raw_loops(
        jnp.asarray(src), jnp.asarray(val), jnp.asarray(dst),
        jnp.asarray(memory), interpret=True,
    )
    np.testing.assert_array_equal(_bits(got_v.numpy()), _bits(want_v))
    np.testing.assert_array_equal(got_h.numpy(), np.asarray(want_h))


@pytest.mark.parametrize("valid_rate", [1.0, 0.5, 0.0])
def test_fused_raw_loops_guarded_vs_sequential_loop(valid_rate):
    """Guard-failed producers forward nothing; the oracle is a sequential
    loop applying only the landed stores (last one wins)."""
    rng = np.random.default_rng(11)
    mem0 = rng.standard_normal(24)
    src = np.sort(rng.integers(0, 24, 50))
    val = rng.standard_normal(50)
    valid = (rng.random(50) < valid_rate).astype(np.int32)
    dst = rng.integers(0, 24, 37)
    seq = mem0.copy()
    for a, v, ok in zip(src, val, valid):
        if ok:
            seq[a] = v
    got, hits = fused_raw_loops(src, val, dst, mem0, valid, device="cpu")
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(seq[dst]))
    want_v, _ = ref_k3_ops.fused_raw_loops(
        jnp.asarray(src), jnp.asarray(val.astype(np.float32)),
        jnp.asarray(dst), jnp.asarray(mem0.astype(np.float32)),
        jnp.asarray(valid), lookback=min_lookback(src), interpret=True,
    )
    np.testing.assert_array_equal(  # the reference forwards in float32
        got.numpy().astype(np.float32), np.asarray(want_v)
    )
    if valid_rate == 0.0:
        assert not hits.any()


@pytest.mark.parametrize("addrs", [
    [], [1, 2, 3], [1, 1, 2, 2, 2, 5], [7, 7, 7, 7], [-3, -3, 0, 4, 4],
])
def test_min_lookback_matches_reference(addrs):
    a = np.array(addrs, dtype=np.int64)
    want = ref_k3_ops.min_lookback(a)
    assert min_lookback(a) == want
    assert min_lookback(torch.from_numpy(a)) == want


# ---------------------------------------------------------------------------
# the wrappers' device rules
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions():
    """A CPU tensor runs the plain version: no kernel launch is counted
    and nothing is built."""
    n2, n3 = k2.hazard_frontier_batch.launches, k3.fused_stream.launches
    src = torch.tensor([1, 3, 3, 8], dtype=torch.int32)
    dst = torch.tensor([3, 0, 9], dtype=torch.int32)
    f = hazard_frontier(src, dst)
    assert f.tolist() == [3, 0, 4]
    v, h = fused_stream(src, torch.arange(4.0), f, dst, torch.zeros(10))
    assert v.tolist() == [2.0, 0.0, 0.0] and h.tolist() == [True, False, False]
    assert (k2.hazard_frontier_batch.launches,
            k3.fused_stream.launches) == (n2, n3)
    assert k2._lib.cache_info().currsize == 0
    assert k3._lib.cache_info().currsize == 0


def test_default_device_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device works")
    a = np.array([1, 2], dtype=np.int32)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fused_raw_loops(a, np.ones(2), a, np.zeros(4))


def test_wrappers_reject_other_devices_and_bad_inputs():
    meta = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        hazard_frontier(meta, meta)
    with pytest.raises(ValueError, match="unsupported device"):
        fused_raw_loops([1], [1.0], [1], [0.0], device="meta")
    i32 = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="side"):
        hazard_frontier(i32, i32, side="middle")
    with pytest.raises(ValueError, match="one dtype"):
        fused_stream(i32, torch.zeros(3), i32, i32,
                     torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="lookback"):
        fused_stream(i32, torch.zeros(3), i32, i32, torch.zeros(3),
                     lookback=0)
