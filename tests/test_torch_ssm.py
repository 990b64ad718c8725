"""The port's Mamba-1 path (``repro_torch.kernels.ssm_scan``,
``repro_torch.models.ssm``) and its Mamba-2 (SSD) layer against the JAX
package's, on the CPU.

The selective scan's plain version is held against the Pallas kernel in
interpret mode at the reference tests' shapes with their tolerance
(``rtol = atol = 1e-4``, ``tests/kernels/test_kernels.py``); the Mamba-1
layer against the reference's chunked scan and recurrent step at the
bounds the reference holds those two to each other (``rtol=1e-4,
atol=1e-5``, ``tests/test_arch_smoke.py``): the kernel's association
``(dt·x)·B`` and the model's ``(dt·B)·x`` differ at rounding level. Inputs
are made with numpy from a seed; weights come from the reference's
``mamba_init`` through ``models/convert.py``. The Mamba-2 layer (plain
torch in both packages) is held at the same bound, and its chunked form
against its stepwise one at the reference's SSD bound (``SSD_TOL``).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.kernels.ssm_scan.ops import ssm_scan as pallas_ssm_scan
from repro.kernels.ssm_scan.ops import ssm_scan_batched as pallas_batched
from repro.kernels.ssm_scan.ops import ssm_scan_ref as ref_oracle
from repro.models import layers as ref_L
from repro.models import ssm as ref_S
from repro_torch.configs import base as configs
from repro_torch.kernels.ssm_scan import kernel as k8
from repro_torch.kernels.ssm_scan.ops import (
    selective_scan,
    selective_scan_ref,
    ssm_scan,
    ssm_scan_batched,
)
from repro_torch.models import convert, layers as L, ssm as S

KERNEL_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-4, atol=1e-5)


def _scan_inputs(seed, b, s, di, n):
    """xi, B, C ~ N(0, 0.25), dt = softplus(N(0, 1)), a_neg =
    -exp(0.3·N(0, 1)), as the reference's kernel test draws them."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    xi = f(b, s, di) * 0.5
    dt = np.log1p(np.exp(f(b, s, di))).astype(np.float32)
    bm, cm = f(b, s, n) * 0.5, f(b, s, n) * 0.5
    a_neg = -np.exp(f(di, n) * 0.3).astype(np.float32)
    return xi, dt, bm, cm, a_neg


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,di,n,chunk,bd", [(64, 64, 8, 16, 32),
                                             (128, 128, 16, 32, 128)])
def test_plain_ssm_scan_matches_pallas(s, di, n, chunk, bd):
    xi, dt, bm, cm, a_neg = (a[0] if a.ndim == 3 else a
                             for a in _scan_inputs(1, 1, s, di, n))
    want = pallas_ssm_scan(*_j(xi, dt, bm, cm, a_neg), chunk=chunk,
                           block_d=bd, interpret=True)
    before = k8.ssm_scan.launches
    got = ssm_scan(*_t(xi, dt, bm, cm, a_neg), chunk=chunk, block_d=bd)
    assert k8.ssm_scan.launches == before  # the plain version on the CPU
    assert got.shape == (s, di) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_oracle(*_j(xi, dt, bm, cm, a_neg))),
        **KERNEL_TOL)


def test_plain_ssm_scan_batched_matches_pallas():
    xi, dt, bm, cm, a_neg = _scan_inputs(2, 2, 32, 32, 8)
    want = pallas_batched(*_j(xi, dt, bm, cm, a_neg), chunk=16, block_d=32,
                          interpret=True)
    got = ssm_scan_batched(*_t(xi, dt, bm, cm, a_neg), chunk=16, block_d=32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **KERNEL_TOL)


def test_selective_scan_carries_the_state():
    """Two halves, the second from the first's final state, give the
    whole sequence's y and final state exactly (the same operations in
    the same order)."""
    xi, dt, bm, cm, a_neg = _t(*_scan_inputs(3, 2, 40, 24, 16))
    y, h = selective_scan(xi, dt, bm, cm, a_neg)
    y1, h1 = selective_scan(xi[:, :17], dt[:, :17], bm[:, :17], cm[:, :17],
                            a_neg)
    y2, h2 = selective_scan(xi[:, 17:], dt[:, 17:], bm[:, 17:], cm[:, 17:],
                            a_neg, h1)
    assert torch.equal(torch.cat([y1, y2], dim=1), y)
    assert torch.equal(h2, h) and h.dtype == torch.float32
    assert h.shape == (2, 24, 16)
    y0, h0 = selective_scan(xi[:, :0], dt[:, :0], bm[:, :0], cm[:, :0], a_neg,
                            h)
    assert y0.shape == (2, 0, 24) and torch.equal(h0, h)


@pytest.mark.parametrize("bad", ["dt", "bmat", "a_neg", "h0", "rank"])
def test_selective_scan_rejects_bad_shapes(bad):
    xi, dt, bm, cm, a_neg = _t(*_scan_inputs(4, 2, 8, 16, 4))
    h0 = torch.zeros(2, 16, 4)
    args = dict(xi=xi, dt=dt, bmat=bm, cmat=cm, a_neg=a_neg, h0=h0)
    args[bad if bad != "rank" else "xi"] = (
        xi[0] if bad == "rank" else args[bad][..., :-1])
    with pytest.raises(ValueError):
        selective_scan(**args)


def test_plain_scan_keeps_the_kernels_association():
    """``(dt·x)·B`` as the Pallas kernel (and the reference's oracle) has
    it: bit for bit on one step from zero, where the model's ``(dt·B)·x``
    may round differently."""
    xi, dt, bm, cm, a_neg = _scan_inputs(5, 1, 1, 64, 8)
    _, h = selective_scan_ref(*_t(xi, dt, bm, cm, a_neg))
    want = (dt[0, 0] * xi[0, 0])[:, None] * bm[0, 0][None, :]
    assert np.array_equal(h[0].numpy(), want)


# ---------------------------------------------------------------------------
# the Mamba-1 layer against the reference
# ---------------------------------------------------------------------------


def _cfgs(d_model=16, chunk=8):
    cfg_r = dataclasses.replace(ref_configs.get("falcon-mamba-7b").reduced(),
                                d_model=d_model, ssm_chunk=chunk)
    cfg = dataclasses.replace(configs.get("falcon-mamba-7b").reduced(),
                              d_model=d_model, ssm_chunk=chunk)
    return cfg_r, cfg


def _layer(cfg_r, seed=3):
    p_r = ref_S.mamba_init(jax.random.PRNGKey(seed), cfg_r, ref_L.FP32)
    return p_r, convert.from_reference(jax.tree.map(np.asarray, p_r),
                                       device="cpu")


def _xi(seed, b, s, di):
    return (np.random.default_rng(seed).standard_normal((b, s, di))
            * 0.5).astype(np.float32)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba1_chunked_matches_reference(with_state):
    cfg_r, cfg = _cfgs()
    p_r, p = _layer(cfg_r)
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    xi = _xi(6, 2, 32, di)
    h0 = (np.random.default_rng(7).standard_normal((2, di, n)).astype(
        np.float32) if with_state else np.zeros((2, di, n), np.float32))
    y_r, h_r = ref_S._mamba1_chunked(p_r, jnp.asarray(xi), cfg_r,
                                     jnp.asarray(h0), 8)
    y, h = S._mamba1_chunked(p, torch.from_numpy(xi), cfg,
                             torch.from_numpy(h0), 8)
    assert y.dtype == torch.float32 and h.shape == (2, di, n)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **LAYER_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **LAYER_TOL)


def test_mamba1_chunked_matches_stepwise():
    """The scan over the sequence equals the recurrent step applied
    position by position, the port's and the reference's."""
    cfg_r, cfg = _cfgs()
    p_r, p = _layer(cfg_r)
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    xi = _xi(8, 2, 32, di)
    y_chunk, h_chunk = S._mamba1_chunked(p, torch.from_numpy(xi), cfg,
                                         torch.zeros(2, di, n), 8)
    h, h_r = torch.zeros(2, di, n), jnp.zeros((2, di, n), jnp.float32)
    for t in range(32):
        y_t, h = S._mamba1_step(p, torch.from_numpy(xi[:, t]), h)
        y_r, h_r = ref_S._mamba1_step(p_r, jnp.asarray(xi[:, t]), h_r)
        np.testing.assert_allclose(y_chunk[:, t].numpy(), y_t.numpy(),
                                   **LAYER_TOL)
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_r), **LAYER_TOL)
    np.testing.assert_allclose(h_chunk.numpy(), h.numpy(), **LAYER_TOL)


def test_scan_takes_a_length_the_chunk_does_not_divide():
    """A deliberate deviation: at S = 20 with ``ssm_chunk`` 8 the
    reference's chunked scan fails on its reshape; the port's kernel
    walks every position and gives the stepwise result."""
    cfg_r, cfg = _cfgs()
    p_r, p = _layer(cfg_r)
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    xi = _xi(9, 2, 20, di)
    with pytest.raises(TypeError):
        ref_S._mamba1_chunked(p_r, jnp.asarray(xi), cfg_r,
                              jnp.zeros((2, di, n), jnp.float32), 8)
    y, h_final = S._mamba1_chunked(p, torch.from_numpy(xi), cfg,
                                   torch.zeros(2, di, n), 8)
    h = jnp.zeros((2, di, n), jnp.float32)
    for t in range(20):
        y_r, h = ref_S._mamba1_step(p_r, jnp.asarray(xi[:, t]), h)
        np.testing.assert_allclose(y[:, t].numpy(), np.asarray(y_r),
                                   **LAYER_TOL)
    np.testing.assert_allclose(h_final.numpy(), np.asarray(h), **LAYER_TOL)


@pytest.mark.parametrize("s,with_state", [(32, False), (32, True), (1, True),
                                          (1, False)])
def test_mamba_apply_matches_reference(s, with_state):
    cfg_r, cfg = _cfgs(d_model=16, chunk=8)
    p_r, p = _layer(cfg_r, seed=11)
    di, n, k = cfg.expand * cfg.d_model, cfg.ssm_state, cfg.d_conv
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    state_np = None
    if with_state:
        state_np = {"conv": rng.standard_normal((2, k - 1, di)).astype(
            np.float32), "h": rng.standard_normal((2, di, n)).astype(
            np.float32)}
    y_r, st_r = ref_S.mamba_apply(
        p_r, jnp.asarray(x), cfg_r,
        state=None if state_np is None
        else {kk: jnp.asarray(v) for kk, v in state_np.items()})
    y, st = S.mamba_apply(
        p, torch.from_numpy(x), cfg,
        state=None if state_np is None
        else {kk: torch.from_numpy(v.copy()) for kk, v in state_np.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **LAYER_TOL)
    for key in ("conv", "h"):
        assert st[key].shape == st_r[key].shape
        np.testing.assert_allclose(st[key].numpy(), np.asarray(st_r[key]),
                                   **LAYER_TOL)


@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 9, 6)).astype(np.float32)
    w = rng.standard_normal((4, 6)).astype(np.float32)
    b = rng.standard_normal(6).astype(np.float32)
    st = rng.standard_normal((2, 3, 6)).astype(np.float32) if with_state \
        else None
    want, want_st = ref_S._causal_conv(
        *_j(x, w, b), None if st is None else jnp.asarray(st))
    got, got_st = S._causal_conv(*_t(x, w, b),
                                 None if st is None else torch.from_numpy(st))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    assert np.array_equal(got_st.numpy(), np.asarray(want_st))


def test_mamba_init_matches_reference_structure():
    cfg_r, cfg = _cfgs(d_model=32)
    p_r = ref_S.mamba_init(jax.random.PRNGKey(0), cfg_r, ref_L.FP32)
    p = S.mamba_init(torch.Generator().manual_seed(0), cfg, L.FP32, "cpu")
    assert sorted(p) == sorted(p_r)
    for key, a in p_r.items():
        assert tuple(p[key].shape) == a.shape, key
        assert str(p[key].dtype).removeprefix("torch.") == str(a.dtype), key
    # the deterministic parts are the reference's
    for key in ("a_log", "conv_b", "dt_bias", "d_skip"):
        np.testing.assert_allclose(p[key].numpy(), np.asarray(p_r[key]),
                                   rtol=1e-7, atol=0)
    st = S.mamba_init_state(cfg, 3, device="cpu")
    st_r = ref_S.mamba_init_state(cfg_r, 3)
    for key in ("conv", "h"):
        assert st[key].shape == st_r[key].shape and not st[key].any()


# ---------------------------------------------------------------------------
# the Mamba-2 (SSD) layer against the reference
# ---------------------------------------------------------------------------

# the reference holds its chunked SSD form against its stepwise one at
# rtol 1e-3, atol 1e-4 (tests/test_arch_smoke.py): the chunk's decay
# matrices and the step's recurrence sum in different orders
SSD_TOL = dict(rtol=1e-3, atol=1e-4)


def _cfgs2(d_model=128, chunk=8):
    """zamba2's reduced Mamba-2 at d_model 128 (d_inner 256: 4 heads of
    64, state 8)."""
    cfg_r = dataclasses.replace(ref_configs.get("zamba2-7b").reduced(),
                                d_model=d_model, ssm_chunk=chunk)
    cfg = dataclasses.replace(configs.get("zamba2-7b").reduced(),
                              d_model=d_model, ssm_chunk=chunk)
    return cfg_r, cfg


def _ssd_inputs(seed, cfg, b, s, with_state):
    """x (the block input), xi (post-conv/silu) and h0 (zeros or N(0,
    1))."""
    di, n = cfg.expand * cfg.d_model, cfg.ssm_state
    nh = di // S.MAMBA2_HEAD
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
    xi = (rng.standard_normal((b, s, di)) * 0.5).astype(np.float32)
    h0 = (rng.standard_normal((b, nh, S.MAMBA2_HEAD, n)) if with_state
          else np.zeros((b, nh, S.MAMBA2_HEAD, n))).astype(np.float32)
    return x, xi, h0


def test_mamba2_init_matches_reference_structure():
    cfg_r, cfg = _cfgs2()
    p_r = ref_S.mamba_init(jax.random.PRNGKey(0), cfg_r, ref_L.FP32)
    p = S.mamba_init(torch.Generator().manual_seed(0), cfg, L.FP32, "cpu")
    assert sorted(p) == sorted(p_r)
    for key, a in p_r.items():
        assert tuple(p[key].shape) == a.shape, key
        assert str(p[key].dtype).removeprefix("torch.") == str(a.dtype), key
    for key in ("a_log", "conv_b", "dt_bias", "d_skip", "norm_scale"):
        np.testing.assert_array_equal(p[key].numpy(), np.asarray(p_r[key]))
    assert S.MAMBA2_HEAD == ref_S.MAMBA2_HEAD
    st = S.mamba_init_state(cfg, 3, device="cpu")
    st_r = ref_S.mamba_init_state(cfg_r, 3)
    for key in ("conv", "h"):
        assert st[key].shape == st_r[key].shape and not st[key].any()
    assert st["h"].shape == (3, 4, S.MAMBA2_HEAD, cfg.ssm_state)


@pytest.mark.parametrize("with_state", [False, True])
def test_mamba2_chunked_matches_reference(with_state):
    cfg_r, cfg = _cfgs2()
    p_r, p = _layer(cfg_r, seed=21)
    x, xi, h0 = _ssd_inputs(22, cfg, 2, 32, with_state)
    y_r, h_r = ref_S._mamba2_chunked(p_r, jnp.asarray(x), jnp.asarray(xi),
                                     cfg_r, jnp.asarray(h0), 8)
    y, h = S._mamba2_chunked(p, torch.from_numpy(x), torch.from_numpy(xi),
                             cfg, torch.from_numpy(h0), 8)
    assert y.dtype == torch.float32 and h.shape == h0.shape
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **LAYER_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **LAYER_TOL)


def test_mamba2_step_matches_reference():
    cfg_r, cfg = _cfgs2()
    p_r, p = _layer(cfg_r, seed=23)
    x, xi, h0 = _ssd_inputs(24, cfg, 2, 1, True)
    xh = xi[:, 0].reshape(2, -1, S.MAMBA2_HEAD)
    y_r, h_r = ref_S._mamba2_step(p_r, jnp.asarray(x[:, 0]), jnp.asarray(xh),
                                  jnp.asarray(h0), cfg.ssm_state)
    y, h = S._mamba2_step(p, torch.from_numpy(x[:, 0]), torch.from_numpy(xh),
                          torch.from_numpy(h0), cfg.ssm_state)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **LAYER_TOL)
    np.testing.assert_allclose(h.numpy(), np.asarray(h_r), **LAYER_TOL)


def test_mamba2_chunked_matches_its_own_steps():
    """The port's chunked SSD over 4 chunks of 8 equals its recurrent
    step applied position by position, at the reference's SSD_TOL."""
    cfg_r, cfg = _cfgs2()
    _, p = _layer(cfg_r, seed=25)
    x, xi, h0 = _ssd_inputs(26, cfg, 2, 32, True)
    y_chunk, h_chunk = S._mamba2_chunked(
        p, torch.from_numpy(x), torch.from_numpy(xi), cfg,
        torch.from_numpy(h0), 8)
    h = torch.from_numpy(h0)
    for t in range(32):
        xh = torch.from_numpy(xi[:, t]).reshape(2, -1, S.MAMBA2_HEAD)
        y_t, h = S._mamba2_step(p, torch.from_numpy(x[:, t]), xh, h,
                                cfg.ssm_state)
        np.testing.assert_allclose(y_chunk[:, t].numpy(),
                                   y_t.reshape(2, -1).numpy(), **SSD_TOL)
    np.testing.assert_allclose(h_chunk.numpy(), h.numpy(), **SSD_TOL)


@pytest.mark.parametrize("s,with_state", [(32, False), (32, True), (1, True),
                                          (1, False), (8, True)])
def test_mamba2_apply_matches_reference(s, with_state):
    """The whole block: B, C and the steps from the block input, the
    per-head skip repeated over its 64 channels, the gated norm before
    silu(z); S=8 is one chunk."""
    cfg_r, cfg = _cfgs2()
    p_r, p = _layer(cfg_r, seed=27)
    di, n, k = cfg.expand * cfg.d_model, cfg.ssm_state, cfg.d_conv
    nh = di // S.MAMBA2_HEAD
    rng = np.random.default_rng(28)
    x = rng.standard_normal((2, s, cfg.d_model)).astype(np.float32)
    state_np = None
    if with_state:
        state_np = {"conv": rng.standard_normal((2, k - 1, di)).astype(
            np.float32), "h": rng.standard_normal(
            (2, nh, S.MAMBA2_HEAD, n)).astype(np.float32)}
    y_r, st_r = ref_S.mamba_apply(
        p_r, jnp.asarray(x), cfg_r,
        state=None if state_np is None
        else {kk: jnp.asarray(v) for kk, v in state_np.items()})
    y, st = S.mamba_apply(
        p, torch.from_numpy(x), cfg,
        state=None if state_np is None
        else {kk: torch.from_numpy(v.copy()) for kk, v in state_np.items()})
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **LAYER_TOL)
    for key in ("conv", "h"):
        assert st[key].shape == st_r[key].shape
        np.testing.assert_allclose(st[key].numpy(), np.asarray(st_r[key]),
                                   **LAYER_TOL)


def test_mamba2_needs_the_chunk_to_divide_s():
    """At S=20 over chunks of 8 the reference fails on its reshape; the
    port raises ``ValueError`` naming the chunk. S below the chunk is one
    chunk of S, as in the reference."""
    cfg_r, cfg = _cfgs2()
    p_r, p = _layer(cfg_r, seed=29)
    x, xi, h0 = _ssd_inputs(30, cfg, 1, 20, False)
    with pytest.raises(TypeError):
        ref_S._mamba2_chunked(p_r, jnp.asarray(x), jnp.asarray(xi), cfg_r,
                              jnp.asarray(h0), 8)
    with pytest.raises(ValueError, match="chunk 8"):
        S._mamba2_chunked(p, torch.from_numpy(x), torch.from_numpy(xi), cfg,
                          torch.from_numpy(h0), 8)
    y, _ = S._mamba2_chunked(p, torch.from_numpy(x[:, :5]),
                             torch.from_numpy(xi[:, :5]), cfg,
                             torch.from_numpy(h0), 8)
    y_r, _ = ref_S._mamba2_chunked(p_r, jnp.asarray(x[:, :5]),
                                   jnp.asarray(xi[:, :5]), cfg_r,
                                   jnp.asarray(h0), 8)
    np.testing.assert_allclose(y.numpy(), np.asarray(y_r), **LAYER_TOL)
