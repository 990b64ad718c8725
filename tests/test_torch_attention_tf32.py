"""K6's choice of 3×TF32, on the CPU: with TF32 emulated as
``cvt.rna.tf32.f32`` rounds, one pass misses the reference's attention
atol of 1e-4 at D=128 and 3×TF32 holds it.

K6 (``src/repro_torch/kernels/attention/csrc/attention.cu``) computes
S = Q·Kᵀ and O += P·V with ``mma.sync ... tf32``: each operand is cut to
TF32 (10 mantissa bits, round to nearest, ties away from zero) and the
products are summed in float32. One pass ("1×TF32") keeps about three
decimal digits. Splitting each operand into ``hi = tf32(x)`` and
``lo = tf32(x - hi)`` and summing ``hi·hi + hi·lo + lo·hi`` ("3×TF32",
CUTLASS's ``OpMultiplyAddFastF32``) leaves an error of order 2⁻²² of
each product, near float32's own.
"""

import numpy as np
import pytest
import torch

ATTN_ATOL = 1e-4  # the reference's bound for its attention kernels


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` cut to TF32 as ``cvt.rna.tf32.f32`` cuts it: the low
    13 mantissa bits cleared after adding half of their unit to the
    magnitude (round to nearest, ties away from zero)."""
    bits = x.float().contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x: torch.Tensor):
    """``(hi, lo)``, both TF32 values, ``hi + lo`` within 2⁻²² of x."""
    hi = tf32_round(x)
    return hi, tf32_round(x.float() - hi)


def tf32_matmul(a: torch.Tensor, b: torch.Tensor, passes: int):
    """``a @ b`` of float32 operands as the tensor cores compute it in
    ``passes`` (1 or 3) TF32 products, each product exact and the sum
    float32 (taken in float64 here, then rounded)."""
    if passes == 1:
        out = tf32_round(a).double() @ tf32_round(b).double()
    elif passes == 3:
        ah, al = split_tf32(a)
        bh, bl = split_tf32(b)
        ah, al, bh, bl = (t.double() for t in (ah, al, bh, bl))
        out = ah @ bh + (ah @ bl + al @ bh)
    else:
        raise ValueError(f"passes must be 1 or 3, got {passes}")
    return out.float()


def attention_error(q, k, v, passes: int, *, causal: bool = True,
                    block: int = 512) -> float:
    """Max abs error of one head's attention, q ``(S, D)`` over k, v
    ``(S_kv, D)`` float32, scale ``D**-0.5`` applied to q on load as the
    kernel does, with both products in ``passes`` TF32 passes and the
    softmax in float32; against float64. Rows go ``block`` at a time."""
    s, d = q.shape
    qs = q.float() * d ** -0.5
    err = 0.0
    for q0 in range(0, s, block):
        qb = qs[q0:q0 + block]
        pos = torch.arange(q0, q0 + qb.shape[0])[:, None]
        mask = (pos >= torch.arange(k.shape[0])[None, :]) if causal else None
        sc = tf32_matmul(qb, k.float().T, passes)
        exact = qb.double() @ k.double().T
        if mask is not None:
            sc = torch.where(mask, sc, torch.tensor(-1e30))
            exact = torch.where(mask, exact, torch.tensor(-1e30,
                                                          dtype=torch.float64))
        p = torch.exp(sc - sc.amax(dim=-1, keepdim=True))
        out = tf32_matmul(p, v.float(), passes) / p.sum(dim=-1, keepdim=True)
        want = torch.softmax(exact, dim=-1) @ v.double()
        err = max(err, float((out.double() - want).abs().max()))
    return err


def test_tf32_round_keeps_ten_mantissa_bits_ties_away():
    x = torch.tensor([1.0, 1.0 + 2**-11, 1.0 + 2**-10, -(1.0 + 2**-11),
                      1.0 + 2**-11 - 2**-23, 3.0, 0.0])
    got = tf32_round(x)
    want = torch.tensor([1.0, 1.0 + 2**-10, 1.0 + 2**-10, -(1.0 + 2**-10),
                         1.0, 3.0, 0.0])
    assert torch.equal(got, want)
    hi, lo = split_tf32(torch.tensor([np.pi], dtype=torch.float32))
    assert torch.equal(tf32_round(hi), hi)
    assert torch.equal(tf32_round(lo), lo)
    assert abs(float(hi + lo) - float(np.float32(np.pi))) <= 2**-21


@pytest.mark.parametrize("passes", [1, 3])
def test_tf32_matmul_error(passes):
    rng = np.random.default_rng(0)
    a, b = (torch.from_numpy(rng.standard_normal((64, 128))
                             .astype(np.float32)) for _ in "ab")
    exact = a.double() @ b.double().T
    err = float((tf32_matmul(a, b.T, passes).double() - exact).abs().max())
    # 1 pass: each product off by ~2 * 2**-11 relative; 3 passes: ~2**-21
    assert err > 1e-3 if passes == 1 else err < 1e-4


@pytest.mark.parametrize("seed", [0, 1])
def test_one_pass_misses_and_three_passes_hold_the_atol(seed):
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((256, 128))
                                .astype(np.float32)) for _ in "qkv")
    assert attention_error(q, k, v, 1) > ATTN_ATOL
    assert attention_error(q, k, v, 3) < ATTN_ATOL / 10
