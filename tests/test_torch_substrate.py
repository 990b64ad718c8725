"""The port's substrate kernels against the JAX package's, on the CPU.

The plain torch versions of the ELL SpMV kernel (K4) and the histogram
kernel (K5) — what the wrappers run on a CPU tensor — are held against
the Pallas kernels in interpret mode on seeded inputs: SpMV to the
reference tests' ``atol=1e-4`` (the Pallas row sum's order is XLA's;
the port fixes its own), histograms bit for bit. ``csr_to_ell`` must
give the reference's arrays bit for bit, empty rows and ragged row
blocks included. The ops take ``device="cuda"`` by default and raise
without a card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.csr_spmv import kernel as ref_k4
from repro.kernels.csr_spmv import ops as ref_k4_ops
from repro.kernels.csr_spmv import ref as ref_k4_ref
from repro.kernels.histogram import kernel as ref_k5
from repro.kernels.histogram import ops as ref_k5_ops
from repro.kernels.histogram import ref as ref_k5_ref
from repro_torch.kernels.csr_spmv import kernel as k4
from repro_torch.kernels.csr_spmv.ops import (
    csr_spmv_ref,
    csr_to_ell,
    spmv_from_csr,
)
from repro_torch.kernels.histogram import kernel as k5
from repro_torch.kernels.histogram.ops import hist_add, histogram_ref


def _csr(seed, n, m=None, lo=1, hi=6):
    """A seeded CSR matrix of ``n`` rows over ``m`` columns with row
    lengths in ``[lo, hi)``, float32 values."""
    rng = np.random.default_rng(seed)
    deg = rng.integers(lo, hi, n)
    rp = np.concatenate([[0], np.cumsum(deg)])
    ci = rng.integers(0, m or n, int(rp[-1]))
    vv = rng.standard_normal(int(rp[-1])).astype(np.float32)
    return rng, rp, ci, vv


# ---------------------------------------------------------------------------
# K4: ELL SpMV
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,block_r", [(16, 8), (100, 32)])
def test_spmv_from_csr_matches_pallas_and_dense(n, block_r):
    """``tests/kernels/test_kernels.py``'s shapes and tolerance."""
    rng, rp, ci, vv = _csr(3, n)
    x = rng.standard_normal(n).astype(np.float32)
    got = spmv_from_csr(rp, ci, vv, x, block_r=block_r, device="cpu")
    assert got.dtype == torch.float32 and got.shape == (n,)
    want = ref_k4_ops.spmv_from_csr(rp, ci, vv, jnp.asarray(x),
                                    block_r=block_r, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    dense = np.zeros((n, n), np.float32)
    for r in range(n):
        for p in range(rp[r], rp[r + 1]):
            dense[r, ci[p]] += vv[p]
    np.testing.assert_allclose(got.numpy(), dense @ x, atol=1e-4)


@pytest.mark.parametrize("n,block_r,lo,hi", [
    (16, 8, 1, 6), (100, 32, 0, 9), (37, 16, 0, 3), (5, 128, 2, 40),
])
def test_csr_to_ell_bit_identical_to_reference(n, block_r, lo, hi):
    """Empty rows (``lo=0``) and ``n_rows % block_r != 0`` included."""
    _, rp, ci, vv = _csr(n + block_r, n, lo=lo, hi=hi)
    if lo == 0:
        assert (np.diff(rp) == 0).any()
    got = csr_to_ell(rp, ci, vv, n, block_r)
    want = ref_k4_ref.csr_to_ell(rp, ci, vv, n, block_r)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_csr_to_ell_float64_values_and_int64_columns_cast_alike():
    rng, rp, ci, _ = _csr(9, 24)
    vv = rng.standard_normal(int(rp[-1]))  # float64: rounded to float32
    got = csr_to_ell(rp, ci.astype(np.int64), vv, 24, 8)
    want = ref_k4_ref.csr_to_ell(rp, ci.astype(np.int64), vv, 24, 8)
    for g, w in zip(got, want):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_csr_spmv_clipped_columns_match_pallas(dtype):
    """Columns below 0 read ``x[0]``, columns at or past ``M`` read
    ``x[M-1]``, as ``jnp.take(mode="clip")`` does."""
    rng = np.random.default_rng(4)
    n_pad, w, m = 64, 7, 50
    cols = rng.integers(-20, m + 20, (n_pad, w)).astype(np.int32)
    assert (cols < 0).any() and (cols >= m).any()
    vals = rng.standard_normal((n_pad, w)).astype(np.float32)
    x = rng.standard_normal(m).astype(dtype)
    got = k4.csr_spmv(torch.from_numpy(cols), torch.from_numpy(vals),
                      torch.from_numpy(x), block_r=32)
    want = ref_k4.csr_spmv(jnp.asarray(cols), jnp.asarray(vals),
                           jnp.asarray(x), block_r=32, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    # the clip itself, exactly: one column per row
    one = k4.csr_spmv(torch.from_numpy(cols[:, :1]),
                      torch.ones((n_pad, 1)), torch.from_numpy(x),
                      block_r=32)
    want_one = x[np.clip(cols[:, 0], 0, m - 1)].astype(np.float32)
    np.testing.assert_array_equal(one.numpy(), want_one.astype(dtype))
    assert one.dtype == torch.from_numpy(x).dtype


def test_csr_spmv_ref_adds_in_column_order():
    """The plain version's sum order is fixed: w = 0, 1, ... into a
    float32 accumulator from 0, each product and sum rounded alone."""
    rng = np.random.default_rng(8)
    n_pad, w, m = 32, 5, 40
    cols = rng.integers(0, m, (n_pad, w)).astype(np.int32)
    vals = (rng.standard_normal((n_pad, w)) * 1e3).astype(np.float32)
    x = rng.standard_normal(m).astype(np.float32)
    got = csr_spmv_ref(torch.from_numpy(cols), torch.from_numpy(vals),
                       torch.from_numpy(x)).numpy()
    acc = np.zeros(n_pad, np.float32)
    for j in range(w):
        acc = (acc + (vals[:, j] * x[cols[:, j]]).astype(np.float32)
               ).astype(np.float32)
    np.testing.assert_array_equal(got, acc)


def test_csr_spmv_rejects_bad_layouts():
    cols = torch.zeros((10, 3), dtype=torch.int32)
    vals = torch.zeros((10, 3))
    x = torch.ones(4)
    with pytest.raises(ValueError, match="multiple of block_r"):
        k4.csr_spmv(cols, vals, x, block_r=4)
    with pytest.raises(ValueError, match="alike"):
        k4.csr_spmv(cols, vals[:, :2], x, block_r=5)
    with pytest.raises(ValueError, match="non-empty"):
        k4.csr_spmv(cols, vals, x[:0], block_r=5)
    with pytest.raises(ValueError, match="unsupported device"):
        k4.csr_spmv(cols.to("meta"), vals.to("meta"), x.to("meta"),
                    block_r=5)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w", [3, 4, 5, 16, 17])
def test_csr_spmv_views_and_widths_match_pallas(w, offset):
    """Arrays that are views ``offset`` words into a flat buffer
    (``flat[1:]``), widths on and off a multiple of 4 and clipped
    columns: the reference tests' ``atol=1e-4`` against the Pallas
    kernel."""
    rng = np.random.default_rng(w * 10 + offset)
    n_pad, m = 48, 90
    size = n_pad * w + offset
    cols = torch.from_numpy(
        rng.integers(-3, m + 3, size).astype(np.int32))[offset:].view(n_pad, w)
    vals = torch.from_numpy(
        rng.standard_normal(size).astype(np.float32))[offset:].view(n_pad, w)
    x = rng.standard_normal(m).astype(np.float32)
    got = k4.csr_spmv(cols, vals, torch.from_numpy(x), block_r=16)
    want = ref_k4.csr_spmv(jnp.asarray(cols.numpy()),
                           jnp.asarray(vals.numpy()), jnp.asarray(x),
                           block_r=16, interpret=True)
    assert got.shape == (n_pad,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# K5: histogram
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,bins,block", [(100, 16, 32), (1000, 64, 128)])
def test_histogram_matches_pallas_and_oracle(n, bins, block):
    """``tests/kernels/test_kernels.py``'s shapes, bit for bit."""
    d = np.random.default_rng(n).integers(0, bins, n).astype(np.int32)
    got = k5.histogram(torch.from_numpy(d), n_bins=bins, block=block)
    assert got.dtype == torch.float32 and got.shape == (bins,)
    pallas = ref_k5.histogram(jnp.asarray(d), n_bins=bins, block=block,
                              interpret=True)
    oracle = ref_k5_ref.histogram_ref(jnp.asarray(d), n_bins=bins)
    assert got.numpy().tobytes() == np.asarray(pallas).tobytes()
    assert got.numpy().tobytes() == np.asarray(oracle).tobytes()


@pytest.mark.parametrize("bins", [1, 32, 100])
def test_histogram_drops_out_of_range_bins_like_pallas(bins):
    """-1 (the Pallas pad), -n_bins-1 and bins at or past n_bins are not
    counted, and nothing outside the histogram is written."""
    rng = np.random.default_rng(bins)
    d = rng.integers(-bins - 3, 2 * bins + 3, 2000).astype(np.int32)
    d[:4] = (-1, -bins - 1, bins, 2**31 - 1)
    got = k5.histogram(torch.from_numpy(d), n_bins=bins, block=64)
    pallas = ref_k5.histogram(jnp.asarray(d), n_bins=bins, block=64,
                              interpret=True)
    oracle = ref_k5_ref.histogram_ref(jnp.asarray(d), n_bins=bins)
    assert got.numpy().tobytes() == np.asarray(pallas).tobytes()
    assert got.numpy().tobytes() == np.asarray(oracle).tobytes()
    inside = (d >= 0) & (d < bins)
    assert got.sum().item() == inside.sum() < len(d)


def test_hist_add_matches_pallas_and_numpy():
    rng = np.random.default_rng(5)
    d1 = rng.integers(0, 32, 500)
    d2 = rng.integers(-2, 34, 500)
    got = hist_add(d1, d2, n_bins=32, device="cpu")
    want = ref_k5_ops.hist_add(jnp.asarray(d1), jnp.asarray(d2), n_bins=32,
                               interpret=True)
    assert got.numpy().tobytes() == np.asarray(want).tobytes()
    keep = (d2 >= 0) & (d2 < 32)
    exp = np.bincount(d1, minlength=32) + np.bincount(d2[keep], minlength=32)
    np.testing.assert_array_equal(got.numpy(), exp.astype(np.float32))


def test_histogram_above_2_24_per_bin_diverges_from_the_oracle():
    """Above 2**24 per bin the reference's oracle, which adds 1.0 in
    float32, sticks at 2**24; the port counts in integers and rounds
    once, so 2**24 + 3 counts give float32(2**24 + 3) = 2**24 + 4.
    (The Pallas kernel adds per-block float32 counts and rounds at each
    block; interpret mode is too slow to reach 2**24 here.)"""
    d = np.zeros(2**24 + 3, dtype=np.int32)
    got = histogram_ref(torch.from_numpy(d), n_bins=1)
    assert got.tolist() == [float(np.float32(2**24 + 3))] == [2.0**24 + 4]
    oracle = ref_k5_ref.histogram_ref(jnp.asarray(d), n_bins=1)
    assert np.asarray(oracle).tolist() == [2.0**24]


def test_histogram_rejects_bad_arguments():
    d = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of 32"):
        k5.histogram(d, n_bins=4, block=48)
    with pytest.raises(ValueError, match="1-D"):
        k5.histogram(d.view(2, 4), n_bins=4)
    with pytest.raises(ValueError, match="n_bins"):
        k5.histogram(d, n_bins=-1)
    with pytest.raises(ValueError, match="unsupported device"):
        k5.histogram(d.to("meta"), n_bins=4)
    assert k5.histogram(d, n_bins=0).shape == (0,)


# ---------------------------------------------------------------------------
# device rules
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_the_plain_versions_without_a_launch():
    before = (k4.csr_spmv.launches, k5.histogram.launches)
    rng, rp, ci, vv = _csr(1, 40)
    x = rng.standard_normal(40)
    cols, vals = csr_to_ell(rp, ci, vv, 40, 8)
    got = k4.csr_spmv(torch.from_numpy(cols), torch.from_numpy(vals),
                      torch.from_numpy(x), block_r=8)
    want = csr_spmv_ref(torch.from_numpy(cols), torch.from_numpy(vals),
                        torch.from_numpy(x))
    assert got.dtype == torch.float64 and torch.equal(got, want)
    d = torch.from_numpy(rng.integers(-1, 9, 300))
    assert torch.equal(k5.histogram(d, n_bins=8),
                       histogram_ref(d, n_bins=8))
    assert (k4.csr_spmv.launches, k5.histogram.launches) == before


def test_ops_default_to_the_card_and_raise_without_one():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    _, rp, ci, vv = _csr(2, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        spmv_from_csr(rp, ci, vv, np.ones(8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        hist_add(np.zeros(4, np.int64), np.zeros(4, np.int64), n_bins=2)
    with pytest.raises(ValueError, match="unsupported device"):
        hist_add(np.zeros(4, np.int64), np.zeros(4, np.int64), n_bins=2,
                 device="meta")
