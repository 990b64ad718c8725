"""The port's attention (K6 flash attention, K7 decode attention) against
the JAX package's.

The same inputs, made with numpy from a seed, go through the reference's
Pallas kernels in interpret mode (as ``tests/kernels/test_kernels.py``
runs them) or its model functions, and through the port's entry points
on the CPU, which run the plain torch versions. Tolerance: ``atol=1e-4``
in float32 (the reference's own for Pallas against its oracle; the sum
orders differ).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.attention import ops as ref_ops
from repro.models import flash as ref_flash
from repro_torch.kernels.attention import kernel, ops
from repro_torch.kernels.attention.ref import decode_gqa_ref, flash_gqa_ref
from repro_torch.models import flash

ATOL = 1e-4


def _normal(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("s,d,causal", [(64, 32, True), (128, 16, False)])
def test_plain_flash_attention_matches_pallas(s, d, causal):
    q, k, v = (_normal(i, 4, s, d) for i in range(3))
    want = ref_ops.flash_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        sm_scale=d ** -0.5, block_q=16, block_k=16, interpret=True)
    before = kernel.flash_attention.launches
    got = ops.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                              sm_scale=d ** -0.5, block_q=16, block_k=16)
    assert kernel.flash_attention.launches == before  # the CPU launches none
    assert got.dtype == torch.float32 and got.shape == (4, s, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    ref = ref_ops.flash_attention_ref(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), causal=causal,
                                      sm_scale=d ** -0.5)
    np.testing.assert_allclose(
        ops.flash_attention_ref(_t(q), _t(k), _t(v), causal=causal,
                                sm_scale=d ** -0.5).numpy(),
        np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("lengths", [[1, 17, 33, 64], [0, 17, 33, 64]])
def test_plain_decode_attention_matches_pallas(lengths):
    q = _normal(3, 4, 1, 32)
    kc, vc = _normal(4, 4, 64, 32), _normal(5, 4, 64, 32)
    lens = np.array(lengths, np.int32)
    want = ref_ops.decode_attention(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(lens),
        sm_scale=0.2, block_k=16, interpret=True)
    got = ops.decode_attention(_t(q), _t(kc), _t(vc), _t(lens), sm_scale=0.2,
                               block_k=16)
    assert got.shape == (4, 1, 32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    if lengths[0] == 0:
        # nothing committed: every score is -1e30, so the reference
        # averages the whole cache uniformly (not zeros)
        np.testing.assert_allclose(got[0, 0].numpy(), vc[0].mean(axis=0),
                                   atol=ATOL)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_mha_gqa_matches_reference(causal):
    b, s, h, hk, d = 2, 64, 4, 2, 16
    q, k, v = _normal(6, b, s, h, d), _normal(7, b, s, hk, d), _normal(
        8, b, s, hk, d)
    want = ref_flash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, q_block=16, kv_block=16)
    got = flash.flash_mha(_t(q), _t(k), _t(v), causal=causal, q_block=16,
                          kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    oracle = ref_flash.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), causal=causal)
    np.testing.assert_allclose(
        flash.attention_ref(_t(q), _t(k), _t(v), causal=causal).numpy(),
        np.asarray(oracle), atol=ATOL)


@pytest.mark.parametrize("s,s_kv,causal,window", [
    (37, 37, True, 0), (50, 50, True, 9), (21, 40, False, 0),
])
def test_flash_mha_ragged_matches_attention_ref(s, s_kv, causal, window):
    """A ragged last block (16 divides neither S nor S_kv), where the
    reference's ``flash_mha`` asserts; its ``attention_ref`` has no
    blocks."""
    b, h, hk, d = 2, 4, 2, 16
    q, k, v = (_normal(9, b, s, h, d), _normal(10, b, s_kv, hk, d),
               _normal(11, b, s_kv, hk, d))
    want = ref_flash.attention_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window)
    got = flash.flash_mha(_t(q), _t(k), _t(v), causal=causal, window=window,
                          q_block=16, kv_block=16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)


@pytest.mark.parametrize("s,window,block,causal", [
    (40, 16, 8, True), (40, 16, 40, True), (96, 32, 16, True),
    (40, 16, 8, False), (60, 7, 12, True),
])
def test_flash_mha_window_matches_reference(s, window, block, causal):
    """gemma3's sliding window (keys j > i - window) against the
    reference's ``flash_mha``, at S a multiple of the blocks but not of
    the window, so windows straddle blocks."""
    b, h, hk, d = 2, 8, 4, 16
    q, k, v = (_normal(30, b, s, h, d), _normal(31, b, s, hk, d),
               _normal(32, b, s, hk, d))
    want = ref_flash.flash_mha(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), causal=causal, window=window,
                               q_block=block, kv_block=block)
    got = flash.flash_mha(_t(q), _t(k), _t(v), causal=causal, window=window,
                          q_block=block, kv_block=block)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    full = flash.flash_mha(_t(q), _t(k), _t(v), causal=causal)
    assert not np.allclose(got.numpy(), full.numpy(), atol=ATOL)


@pytest.mark.parametrize("dk,dv,causal,window", [
    (96, 64, True, 0), (96, 64, False, 0), (32, 64, True, 0),
    (64, 32, True, 7),
])
def test_flash_value_head_dim_matches_reference(dk, dv, causal, window):
    """K6's plain version with V's head dim of its own (minicpm3's MLA
    prefill: q and k 96 = 64 + 32 rotary, v 64; and the other way round)
    against the reference's ``flash_mha``, whose loop sizes its
    accumulator from V (the Pallas kernel cannot take it): output
    ``(B, S, H, Dv)`` at scale ``dk**-0.5``."""
    b, s, h, hk = 2, 48, 4, 4
    q, k, v = (_normal(60, b, s, h, dk), _normal(61, b, s, hk, dk),
               _normal(62, b, s, hk, dv))
    want = ref_flash.flash_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               causal=causal, window=window, q_block=16,
                               kv_block=16)
    before = kernel.flash_attention.launches
    got = flash.flash_mha(_t(q), _t(k), _t(v), causal=causal, window=window,
                          q_block=16, kv_block=16)
    assert kernel.flash_attention.launches == before  # the CPU launches none
    assert got.shape == (b, s, h, dv)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL)
    # the reference's attention_ref reshapes to q's head dim; the port's
    # oracle takes V's
    np.testing.assert_allclose(
        flash.attention_ref(_t(q), _t(k), _t(v), causal=causal,
                            window=window).numpy(),
        np.asarray(want), atol=ATOL)


def test_only_k6_in_the_model_layout_takes_its_own_value_dim():
    """q and k must share a head dim everywhere; V may differ only for
    ``flash_attention_gqa`` (K6 in the model's layout): the reference's
    ``(BH, S, d)`` signature and K7 keep one head dim."""
    got = ops.flash_attention_gqa(torch.zeros(1, 4, 2, 8),
                                  torch.zeros(1, 4, 2, 8),
                                  torch.zeros(1, 4, 2, 5))
    assert got.shape == (1, 4, 2, 5)
    with pytest.raises(ValueError, match="head dims differ"):
        ops.flash_attention_gqa(torch.zeros(1, 4, 2, 8),
                                torch.zeros(1, 4, 2, 6),
                                torch.zeros(1, 4, 2, 6))
    with pytest.raises(ValueError, match="head dims differ"):
        ops.flash_attention(torch.zeros(2, 4, 8), torch.zeros(2, 4, 8),
                            torch.zeros(2, 4, 5))
    with pytest.raises(ValueError, match="caches"):
        ops.decode_attention_gqa(torch.zeros(2, 2, 8),
                                 torch.zeros(2, 4, 1, 8),
                                 torch.zeros(2, 4, 1, 8)[..., :5],
                                 torch.ones(2), sm_scale=1.0)


def test_flash_window_rejects_a_negative_window():
    x = torch.zeros(1, 4, 2, 8)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention_gqa(x, x, x, window=-1)


def test_decode_gqa_ref_matches_per_head_decode():
    """The model-layout plain version is the reference-signature one with
    each query head on its kv head."""
    b, h, hk, c, d = 3, 6, 2, 24, 16
    q, kc, vc = _normal(12, b, h, d), _normal(13, b, c, hk, d), _normal(
        14, b, c, hk, d)
    lens = torch.tensor([0, 5, 24])
    got = decode_gqa_ref(_t(q), _t(kc), _t(vc), lens, sm_scale=0.25)
    rep = h // hk
    for hh in range(h):
        one = ops.decode_attention_ref(
            _t(q[:, hh:hh + 1]), _t(kc[:, :, hh // rep]),
            _t(vc[:, :, hh // rep]), lens, sm_scale=0.25)
        np.testing.assert_allclose(got[:, hh].numpy(), one[:, 0].numpy(),
                                   atol=1e-6)


def test_flash_gqa_ref_block_sizes_agree():
    q, k, v = _normal(15, 1, 40, 4, 8), _normal(16, 1, 40, 1, 8), _normal(
        17, 1, 40, 1, 8)
    a = flash_gqa_ref(_t(q), _t(k), _t(v), q_block=7, kv_block=13)
    b = flash_gqa_ref(_t(q), _t(k), _t(v), q_block=512, kv_block=512)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6)


def test_wrappers_check_their_arguments():
    x = torch.zeros(2, 8, 4)
    with pytest.raises(ValueError, match="blocks must be positive"):
        ops.flash_attention(x, x, x, block_q=0)
    with pytest.raises(ValueError, match="do not group"):
        ops.flash_attention_gqa(torch.zeros(1, 4, 3, 8),
                                torch.zeros(1, 4, 2, 8),
                                torch.zeros(1, 4, 2, 8))
    with pytest.raises(ValueError, match="head dims differ"):
        ops.decode_attention(torch.zeros(2, 1, 4), torch.zeros(2, 8, 5),
                             torch.zeros(2, 8, 5), torch.ones(2))
    with pytest.raises(ValueError, match="must be"):
        ops.decode_attention_gqa(torch.zeros(2, 1, 4, 8),
                                 torch.zeros(2, 8, 1, 8),
                                 torch.zeros(2, 8, 1, 8), torch.ones(2),
                                 sm_scale=1.0)


def test_devices_other_than_cpu_and_cuda_raise():
    """``meta`` tensors (shapes alone: the dry run's account) take the
    plain version, as the CPU does; tensors on several devices raise."""
    q = torch.zeros(1, 4, 2, 8, device="meta")
    out = ops.flash_attention_gqa(q, q, q)
    assert out.device.type == "meta" and out.shape == q.shape
    with pytest.raises(ValueError, match="several devices"):
        ops.flash_attention_gqa(q, torch.zeros(1, 4, 2, 8), q)
