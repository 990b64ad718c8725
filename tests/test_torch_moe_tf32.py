"""K9's choice of 3×TF32, on the CPU, at phi3.5-moe's widths: the error
that splitting the operands into TF32 adds, and nothing else.

K9 (``src/repro_torch/kernels/moe_group_mm/csrc/moe_group_mm.cu``)
multiplies float32 x and w on the tensor cores in TF32: each operand is
split into ``hi = tf32(x)`` and ``lo = tf32(x - hi)`` and a product is
``lo·hi + hi·lo + hi·hi``, summed in float32. ``tf32_matmul`` (the
emulator of ``test_torch_attention_tf32.py``) takes each TF32 product
exactly and sums in float64, so it bounds the operand split alone. It
cannot show the tensor cores' float32 accumulation, which sets the
kernel's error on the card (1.8e-4 for w_in and 2.6e-4 for w_out
against cuBLAS, ``PERF.md``): these tests are no evidence of the
kernel's accuracy, only of the split's.

Two limits, both ``chip_smoke.py``'s for K9: the float32 dot-product
bound 2·γ_{d_in}·(|x||w|), which three passes and one pass both meet,
and the tighter TF32 limit ``_tf32_walk(d_in)``·(|x||w|), which three
passes meet and one pass misses, so that the card check tells a
one-pass kernel from a three-pass one.

Inputs as ``chip_smoke.gmm_inputs`` scales them: x rows (tokens, or the
MoE hidden h) N(0, 1), w N(0, 1)·d_in^-1/2; w_in 4096 → 6400 and w_out
6400 → 4096, cut to 16 rows and 1024 output columns for CPU time (each
output element's error depends on its own row and column only; a larger
output can only raise the largest error), numpy seed 0. Measured (CPU,
this file's inputs): three passes 3.7e-7 (w_in) and 3.1e-7 (w_out) max
abs error, 1.9e-5 and 8.0e-6 of the float32 bound, 6.0e-4 and 5.0e-4 of
the TF32 limit; one pass 1.2e-3 and 1.2e-3, 0.060 and 0.031 of the
float32 bound, 1.91 and 1.92 of the TF32 limit.
"""

import numpy as np
import pytest
import torch

from chip_smoke import _tf32_walk
from test_torch_attention_tf32 import tf32_matmul

F32_UNIT = 2.0**-24
MOE_ATOL = 1e-4  # the MoE path's dropless-against-capacity tolerance
ROWS, COLS = 16, 1024
PROJECTIONS = {"w_in": (4096, 6400), "w_out": (6400, 4096)}


def _gamma(n: int) -> float:
    return n * F32_UNIT / (1 - n * F32_UNIT)


def gmm_error(d_in: int, passes: int, seed: int = 0):
    """``(max abs error, max error over 2·γ_{d_in}·(|x||w|), max error
    over _tf32_walk(d_in)·(|x||w|))`` of a ``(ROWS, d_in) @ (d_in,
    COLS)`` product in ``passes`` TF32 passes against float64."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((ROWS, d_in)).astype(np.float32)
    w = (rng.standard_normal((d_in, COLS)) * d_in ** -0.5).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    got = tf32_matmul(torch.from_numpy(x), torch.from_numpy(w), passes)
    err = np.abs(got.double().numpy() - exact)
    mag = np.abs(x).astype(np.float64) @ np.abs(w).astype(np.float64)
    return (float(err.max()), float((err / (2 * _gamma(d_in) * mag)).max()),
            float((err / (_tf32_walk(d_in) * mag)).max()))


@pytest.mark.parametrize("name", PROJECTIONS)
def test_three_tf32_passes_hold_the_float32_bound(name):
    err, ratio, _ = gmm_error(PROJECTIONS[name][0], passes=3)
    assert ratio < 1e-3
    assert err < MOE_ATOL / 100


@pytest.mark.parametrize("name", PROJECTIONS)
def test_one_tf32_pass_holds_the_bound_but_misses_the_moe_atol(name):
    err, ratio, _ = gmm_error(PROJECTIONS[name][0], passes=1)
    assert ratio < 1
    assert err > MOE_ATOL


@pytest.mark.parametrize("name", PROJECTIONS)
def test_the_tf32_limit_tells_one_pass_from_three(name):
    """Three passes far inside the TF32 limit (room for the card's
    accumulation error), one pass above it."""
    d_in = PROJECTIONS[name][0]
    assert gmm_error(d_in, passes=3)[2] < 0.05
    assert gmm_error(d_in, passes=1)[2] > 1
