"""Gradients through the port's two kernels on the training path, against
the JAX package's, on the CPU.

- ``flash_mha`` (K6's autograd Function: the plain blocked loop forward
  with its rows' log-sum-exp, the blockwise recompute backward) against
  ``jax.vjp`` of the reference's ``flash_mha`` (its custom VJP), and the
  plain ``lse`` against ``_flash_fwd_impl``'s;
- ``selective_scan`` (K8's autograd Function: the plain recurrence
  forward, the chunked recompute backward) through the Mamba-1 layer's
  ``_mamba1_chunked`` against ``jax.vjp`` of the reference's, and against
  autograd of the plain recurrence at chunks shorter than S;
- the guard that every other kernel wrapper calls.

Inputs and cotangents are made with numpy from a seed. Tolerance
``atol=1e-4`` (the reference's for attention and the scan; the sums run
in other orders).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.models import flash as ref_flash
from repro.models import ssm as ref_S
from repro_torch import device
from repro_torch.configs import base as configs
from repro_torch.kernels.attention import kernel as attn
from repro_torch.kernels.ssm_scan import kernel as k8
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
from repro_torch.models import flash
from repro_torch.models import ssm as S

ATOL = 1e-4


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


def _leaf(a):
    return torch.from_numpy(np.array(a, copy=True)).requires_grad_()


# (B, S, S_kv, H, Hk, D, Dv, causal, window, q_block, kv_block)
FLASH_CASES = {
    "causal_gqa": (2, 64, 64, 4, 2, 16, 16, True, 0, 16, 32),
    "noncausal": (2, 64, 64, 4, 2, 16, 16, False, 0, 32, 16),
    "window16": (2, 64, 64, 4, 2, 16, 16, True, 16, 16, 16),
    "window16_noncausal": (1, 48, 48, 4, 4, 16, 16, False, 16, 16, 16),
    "mla_96_64": (1, 32, 32, 4, 4, 96, 64, True, 0, 16, 16),
    "v24_k32": (2, 32, 32, 4, 2, 32, 24, True, 0, 8, 16),
    "cross_16_over_32": (2, 16, 32, 4, 4, 16, 16, False, 0, 8, 8),
}


def _flash_inputs(case, seed=0):
    b, s, s_kv, h, hk, d, dv = FLASH_CASES[case][:7]
    return (_normal(seed, b, s, h, d), _normal(seed + 1, b, s_kv, hk, d),
            _normal(seed + 2, b, s_kv, hk, dv), _normal(seed + 3, b, s, h, dv))


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_mha_gradients_match_reference_vjp(case):
    causal, window, qb, kb = FLASH_CASES[case][7:]
    q, k, v, g = _flash_inputs(case)
    out_r, vjp = jax.vjp(
        lambda q, k, v: ref_flash.flash_mha(q, k, v, causal=causal,
                                            window=window, q_block=qb,
                                            kv_block=kb),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(g))
    tq, tk, tv = _leaf(q), _leaf(k), _leaf(v)
    out = flash.flash_mha(tq, tk, tv, causal=causal, window=window,
                          q_block=qb, kv_block=kb)
    assert out.grad_fn is not None  # the autograd Function, not a bare call
    got = torch.autograd.grad(out, (tq, tk, tv), torch.from_numpy(g))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(out_r),
                               atol=ATOL)
    for name, mine, theirs in zip("qkv", got, want):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs),
                                   atol=ATOL, err_msg=f"d{name}")


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_plain_lse_matches_reference_forward(case):
    causal, window, qb, kb = FLASH_CASES[case][7:]
    q, k, v, _ = _flash_inputs(case, seed=4)
    want_out, want_lse = ref_flash._flash_fwd_impl(
        causal, qb, kb, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.int32(window))
    before = attn.flash_attention.launches
    out, lse = attn.flash_attention_gqa(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_block=qb, kv_block=kb,
        return_lse=True)
    assert attn.flash_attention.launches == before  # the CPU launches none
    assert lse.dtype == torch.float32 and lse.shape == want_lse.shape
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=ATOL)
    np.testing.assert_allclose(out.numpy(), np.asarray(want_out), atol=ATOL)
    # the output is the same with or without the lse
    plain = attn.flash_attention_gqa(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window, q_block=qb, kv_block=kb)
    assert torch.equal(plain, out)


def test_flash_mha_ragged_gradients_match_attention_ref():
    """Blocks that divide neither S nor S_kv (the reference's ``flash_mha``
    asserts there): the gradients against autograd of the direct oracle."""
    b, s, h, hk, d = 2, 37, 4, 2, 16
    q, k, v, g = (_normal(20, b, s, h, d), _normal(21, b, s, hk, d),
                  _normal(22, b, s, hk, d), _normal(23, b, s, h, d))
    for causal, window in ((True, 0), (True, 9), (False, 0)):
        leaves = [_leaf(a) for a in (q, k, v)]
        got = torch.autograd.grad(
            flash.flash_mha(*leaves, causal=causal, window=window,
                            q_block=16, kv_block=16),
            leaves, torch.from_numpy(g))
        leaves = [_leaf(a) for a in (q, k, v)]
        want = torch.autograd.grad(
            flash.attention_ref(*leaves, causal=causal, window=window),
            leaves, torch.from_numpy(g))
        for mine, theirs in zip(got, want):
            np.testing.assert_allclose(mine.numpy(), theirs.numpy(),
                                       atol=ATOL)


def test_flash_mha_without_grad_runs_the_kernel_path_alone():
    """Under ``no_grad`` (serving) ``flash_mha`` calls the wrapper with no
    Function and asks for no lse: the output has no ``grad_fn``."""
    q, k, v, _ = _flash_inputs("causal_gqa")
    with torch.no_grad():
        out = flash.flash_mha(_leaf(q), _leaf(k), _leaf(v), q_block=16,
                              kv_block=16)
    assert out.grad_fn is None
    want = attn.flash_attention_gqa(torch.from_numpy(q), torch.from_numpy(k),
                                    torch.from_numpy(v), q_block=16,
                                    kv_block=16)
    assert torch.equal(out, want)


# ---------------------------------------------------------------------------
# the selective scan (K8's Function)
# ---------------------------------------------------------------------------


def _mamba1_case(seed=3, s=48):
    cfg_r = ref_configs.get("falcon-mamba-7b").reduced()
    cfg = configs.get("falcon-mamba-7b").reduced()
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    p = {"w_bc": _normal(seed, di, 2 * n, scale=di ** -0.5),
         "w_dt": _normal(seed + 1, di, 1, scale=di ** -0.5),
         "dt_bias": _normal(seed + 2, di, scale=0.1),
         "a_log": np.log(np.arange(1, n + 1, dtype=np.float32))[None].repeat(
             di, 0) + _normal(seed + 3, di, n, scale=0.05)}
    xi = _normal(seed + 4, 2, s, di, scale=0.5)
    h0 = _normal(seed + 5, 2, di, n, scale=0.1)
    gy = _normal(seed + 6, 2, s, di)
    gh = _normal(seed + 7, 2, di, n)
    return cfg_r, cfg, p, xi, h0, gy, gh


def test_mamba1_scan_gradients_match_reference_vjp():
    """``_mamba1_chunked`` (one ``selective_scan`` call) against the
    reference's chunked ``lax.scan`` under ``jax.vjp``: the gradients of
    y and h_final for xi, h0 and the four parameters B, C, the step sizes
    and ``a_log`` come from (three chunks of 16 there)."""
    cfg_r, cfg, p, xi, h0, gy, gh = _mamba1_case()
    keys = sorted(p)

    def ref(xi, h0, *vals):
        return ref_S._mamba1_chunked(dict(zip(keys, vals)), xi, cfg_r, h0,
                                     cfg_r.ssm_chunk)

    (y_r, h_r), vjp = jax.vjp(ref, jnp.asarray(xi), jnp.asarray(h0),
                              *(jnp.asarray(p[k]) for k in keys))
    want = vjp((jnp.asarray(gy), jnp.asarray(gh)))
    leaves = [_leaf(xi), _leaf(h0)] + [_leaf(p[k]) for k in keys]
    y, h = S._mamba1_chunked(dict(zip(keys, leaves[2:])), leaves[0], cfg,
                             leaves[1], cfg.ssm_chunk)
    assert y.grad_fn is not None
    got = torch.autograd.grad((y, h), leaves,
                              (torch.from_numpy(gy), torch.from_numpy(gh)))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_r), atol=ATOL)
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(h_r), atol=ATOL)
    for name, mine, theirs in zip(["xi", "h0"] + keys, got, want):
        theirs = np.asarray(theirs)
        np.testing.assert_allclose(
            mine.numpy(), theirs, rtol=1e-4,
            atol=ATOL * max(1.0, float(np.abs(theirs).max())),
            err_msg=name)


@pytest.mark.parametrize("chunk,with_h0", [(7, True), (16, False), (64, True)])
def test_selective_scan_backward_equals_autograd_of_the_plain_scan(
        chunk, with_h0):
    """``scan_bwd`` at chunks shorter than S (and one longer) against
    autograd through the whole plain recurrence, h0 given or not."""
    b, s, di, n = 2, 30, 12, 4
    arrays = [_normal(40, b, s, di), np.abs(_normal(41, b, s, di)) * 0.3,
              _normal(42, b, s, n), _normal(43, b, s, n),
              -np.abs(_normal(44, di, n)) - 0.1]
    h0 = _normal(45, b, di, n) if with_h0 else None
    gy, gh = _normal(46, b, s, di), _normal(47, b, di, n)
    leaves = [_leaf(a) for a in arrays] + (
        [_leaf(h0)] if with_h0 else [None])
    y, h = selective_scan_ref(*leaves)
    want = torch.autograd.grad(
        (y, h), [t for t in leaves if t is not None],
        (torch.from_numpy(gy), torch.from_numpy(gh)))
    got = k8.scan_bwd(*(t.detach() if t is not None else None
                        for t in leaves), torch.from_numpy(gy),
                      torch.from_numpy(gh), chunk=chunk)
    got = [t for t in got if t is not None]
    assert len(got) == len(want)
    for mine, theirs in zip(got, want):
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-5,
                                   atol=1e-5)
    # the Function returns these through autograd
    leaves2 = [_leaf(a) for a in arrays] + (
        [_leaf(h0)] if with_h0 else [None])
    y2, h2 = k8.selective_scan(*leaves2)
    assert torch.equal(y2.detach(), y.detach())
    got2 = torch.autograd.grad(
        (y2, h2), [t for t in leaves2 if t is not None],
        (torch.from_numpy(gy), torch.from_numpy(gh)))
    for mine, theirs in zip(got2, want):
        np.testing.assert_allclose(mine.numpy(), theirs.numpy(), rtol=1e-5,
                                   atol=1e-5)


# ---------------------------------------------------------------------------
# the guard of the wrappers without a backward
# ---------------------------------------------------------------------------


def _off_host(requires_grad):
    """A tensor off the CPU (the meta device: no card here), as a CUDA
    tensor is to the guard."""
    return torch.empty(4, device="meta", requires_grad=requires_grad)


def test_refuse_grad_raises_naming_the_kernel():
    with pytest.raises(RuntimeError, match="decode_attention \\(K7\\)"):
        device.refuse_grad("decode_attention (K7)", _off_host(False),
                           _off_host(True))


@pytest.mark.parametrize("tensors", [
    "no_grad_mode", "nothing_requires_grad", "cpu_requires_grad", "none",
])
def test_refuse_grad_passes_where_no_gradient_is_dropped(tensors):
    if tensors == "no_grad_mode":
        with torch.no_grad():
            device.refuse_grad("group_matmul (K9)", _off_host(True))
    elif tensors == "nothing_requires_grad":
        device.refuse_grad("group_matmul (K9)", _off_host(False))
    elif tensors == "cpu_requires_grad":  # the plain version: autograd sees it
        device.refuse_grad("group_matmul (K9)",
                           torch.zeros(2, requires_grad=True))
    else:
        device.refuse_grad("ssm_scan (K8)", None, _off_host(False))


def test_every_wrapper_without_a_backward_calls_the_guard():
    """Each kernel's CUDA branch calls ``refuse_grad`` before it launches
    (K1-K5, K6's raw wrappers, K7, K9); K8 and ``flash_mha`` carry
    Functions instead."""
    import inspect

    from repro_torch.kernels.csr_spmv import kernel as k4
    from repro_torch.kernels.du_hazard import kernel as k2
    from repro_torch.kernels.fused_stream import kernel as k3
    from repro_torch.kernels.histogram import kernel as k5
    from repro_torch.kernels.moe_group_mm import kernel as k9
    from repro_torch.kernels.wave_exec import kernel as k1

    for fn, name in ((k1.wave_loop, "K1"), (k2.hazard_frontier_batch, "K2"),
                     (k3.fused_stream, "K3"), (k4.csr_spmv, "K4"),
                     (k5.histogram, "K5"), (attn._launch_flash, "K6"),
                     (attn._launch_decode, "K7"), (k9.group_matmul, "K9")):
        assert f"refuse_grad(\"" in inspect.getsource(fn), name
        assert f"({name})" in inspect.getsource(fn), name
