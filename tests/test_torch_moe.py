"""The port's mixture-of-experts path (``repro_torch.kernels.moe_group_mm``,
``repro_torch.models.layers.moe_apply``) against the JAX package's, on
the CPU.

The grouped matmul's plain version is held against the Pallas kernel in
interpret mode at the reference test's shapes with its tolerance
(``atol=1e-5``, ``tests/kernels/test_kernels.py``); the dispatch's integer
outputs bit for bit; the dropless FFN and both MoE paths at ``atol=1e-4``
(float32 sums of a few dozen terms in another order). Routing is held
equal first, on inputs whose smallest top-k margin is stated, since a
near-tie could route a token differently in the two packages. Inputs are
made with numpy from a seed; weights come from the reference's
``moe_init`` through ``models/convert.py``.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.kernels.moe_group_mm.kernel import group_matmul as pallas_gmm
from repro.kernels.moe_group_mm.ops import monotonic_dispatch as ref_dispatch
from repro.kernels.moe_group_mm.ops import moe_ffn as ref_moe_ffn
from repro.kernels.moe_group_mm.ref import group_matmul_ref as ref_gmm
from repro.models import layers as ref_L
from repro_torch.configs import base as configs
from repro_torch.kernels.moe_group_mm import kernel as k9
from repro_torch.kernels.moe_group_mm.ops import (
    group_matmul,
    group_matmul_ref,
    monotonic_dispatch,
    moe_ffn,
    route,
)
from repro_torch.models import convert, layers as L

MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b"]
# the smallest gap between the k-th and (k+1)-th router probability that
# these inputs must have: far above the ~1e-7 the two packages' logits
# differ by, so both pick the same experts
MIN_MARGIN = 1e-4


def _f32(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


# ---------------------------------------------------------------------------
# the kernel's plain version and the dispatch
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("e,din,dout,bt,nb", [(4, 32, 48, 16, 8),
                                              (8, 16, 16, 8, 16)])
def test_plain_group_matmul_matches_pallas(e, din, dout, bt, nb):
    rng = np.random.default_rng(e + bt)
    x = _f32(rng, nb * bt, din)
    w = _f32(rng, e, din, dout, scale=0.1)
    be = rng.integers(0, e, nb).astype(np.int32)
    want = pallas_gmm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(be),
                      block_t=bt, interpret=True)
    before = k9.group_matmul.launches
    got = group_matmul(*(torch.from_numpy(a) for a in (x, w, be)), block_t=bt)
    assert k9.group_matmul.launches == before  # the plain version on the CPU
    assert got.shape == (nb * bt, dout) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(ref_gmm(jnp.asarray(x), jnp.asarray(w),
                                        jnp.asarray(be), block_t=bt)),
        atol=1e-5)


def test_group_matmul_checks_its_layout():
    x, w = torch.zeros(24, 4), torch.zeros(2, 4, 3)
    be = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="multiple of block_t"):
        group_matmul(x, w, be, block_t=16)
    with pytest.raises(ValueError, match="expert ids"):
        group_matmul(x, w, be[:2], block_t=8)
    with pytest.raises(ValueError, match="d_in"):
        group_matmul(x, torch.zeros(2, 5, 3), be, block_t=8)


def test_group_matmul_clips_ids_outside_the_experts():
    """Outside the contract (the dispatch clips its ids): the port clips
    an id below 0 or at or past E, as its kernel does; the reference's
    ``jnp.take`` wraps -1 to the last expert and fills rows past E with
    NaN."""
    rng = np.random.default_rng(23)
    x, w = _f32(rng, 24, 4), _f32(rng, 2, 4, 3)
    wide = np.array([-1, 1, 9], np.int32)
    got = group_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                           torch.from_numpy(wide), block_t=8)
    clipped = group_matmul_ref(torch.from_numpy(x), torch.from_numpy(w),
                               torch.tensor([0, 1, 1]), block_t=8)
    assert torch.equal(got, clipped)
    want = np.asarray(ref_gmm(jnp.asarray(x), jnp.asarray(w),
                              jnp.asarray(wide), block_t=8))
    np.testing.assert_allclose(want[:8], x[:8] @ w[1], rtol=1e-6)
    assert np.isnan(want[16:]).all()


@pytest.mark.parametrize("n,e,bt", [(50, 4, 8), (1024, 16, 128), (7, 8, 16),
                                    (96, 64, 16), (0, 4, 8)])
def test_monotonic_dispatch_is_bit_identical(n, e, bt):
    rng = np.random.default_rng(n + e)
    # every other expert empty, so groups of size 0 are in the stream
    ids = (rng.integers(0, max(e // 2, 1), n) * 2 % e).astype(np.int32)
    want = ref_dispatch(jnp.asarray(ids), e, bt)
    got = monotonic_dispatch(torch.from_numpy(ids), e, bt)
    assert len(got) == len(want) == 5
    for mine, theirs in zip(got, want):
        theirs = np.asarray(theirs)
        assert mine.dtype == torch.int32 and theirs.dtype == np.int32
        assert np.array_equal(mine.numpy(), theirs)


@pytest.mark.parametrize("gated", [True, False])
def test_moe_ffn_matches_reference(gated):
    rng = np.random.default_rng(14 + gated)
    t, dm, dff, e, k = 24, 16, 32, 4, 2
    x = _f32(rng, t, dm)
    logits = _f32(rng, t, e)
    wi, wo = _f32(rng, e, dm, dff, scale=0.1), _f32(rng, e, dff, dm, scale=0.1)
    wg = _f32(rng, e, dm, dff, scale=0.1) if gated else None
    want = ref_moe_ffn(*(None if a is None else jnp.asarray(a)
                         for a in (x, logits, wi, wg, wo)), top_k=k,
                       block_t=8)
    got = moe_ffn(*(None if a is None else torch.from_numpy(a)
                    for a in (x, logits, wi, wg, wo)), top_k=k, block_t=8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# the MoE layer: both paths against the reference
# ---------------------------------------------------------------------------


def _moe(name, seed):
    cfg_r = ref_configs.get(name).reduced()
    p_r = ref_L.moe_init(jax.random.PRNGKey(seed), cfg_r, ref_L.FP32)
    p = convert.from_reference(jax.tree.map(np.asarray, p_r), device="cpu")
    return cfg_r, p_r, configs.get(name).reduced(), p


def _check_routing(x, p_r, p, k):
    """Both packages pick the same experts, in the same order, on inputs
    whose smallest top-k margin is at least ``MIN_MARGIN``."""
    flat = x.reshape(-1, x.shape[-1])
    probs_r = jax.nn.softmax(jnp.asarray(flat) @ p_r["router"], axis=-1)
    _, top_r = jax.lax.top_k(probs_r, k)
    _, top = route(torch.from_numpy(flat) @ p["router"], k)
    assert np.array_equal(top.numpy(), np.asarray(top_r))
    srt = np.sort(np.asarray(probs_r), axis=-1)[:, ::-1]
    margin = float((srt[:, k - 1] - srt[:, k]).min())
    assert margin >= MIN_MARGIN, margin


@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_apply_matches_reference(name, use_kernel):
    cfg_r, p_r, cfg, p = _moe(name, 15)
    x = _f32(np.random.default_rng(16), 2, 12, cfg.d_model)
    _check_routing(x, p_r, p, cfg.top_k)
    want = ref_L.moe_apply(p_r, jnp.asarray(x), cfg_r, use_kernel=use_kernel)
    got = L.moe_apply(p, torch.from_numpy(x), cfg, use_kernel=use_kernel)
    assert got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_capacity_path_drops_tokens_as_the_reference(name):
    """At a capacity factor of 0.5 many assignments overflow: the dropped
    ones write the overflow row and get no gate, in both packages."""
    cfg_r, p_r, cfg, p = _moe(name, 17)
    x = _f32(np.random.default_rng(18), 2, 12, cfg.d_model)
    _check_routing(x, p_r, p, cfg.top_k)
    want = ref_L.moe_apply(p_r, jnp.asarray(x), cfg_r, capacity_factor=0.5)
    got = L.moe_apply(p, torch.from_numpy(x), cfg, capacity_factor=0.5)
    full = L.moe_apply(p, torch.from_numpy(x), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    assert not torch.allclose(got, full, atol=1e-3)  # something dropped


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_capacity_path_without_drops_equals_dropless(name):
    """With ``capacity_factor = E / k`` every expert has room for every
    token, so the capacity path computes the dropless path's function."""
    _, _, cfg, p = _moe(name, 19)
    x = torch.from_numpy(_f32(np.random.default_rng(20), 3, 8, cfg.d_model))
    roomy = L.moe_apply(p, x, cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    dropless = L.moe_apply(p, x, cfg, use_kernel=True)
    torch.testing.assert_close(roomy, dropless, atol=1e-5, rtol=1e-5)


def test_moe_ffn_activation_is_fixed_whatever_the_config():
    """A deviation of the reference's, kept: its dropless FFN uses SiLU
    for a gated expert and the tanh GELU otherwise, not ``cfg.act``."""
    _, _, cfg, p = _moe("phi3.5-moe-42b-a6.6b", 21)
    x = torch.from_numpy(_f32(np.random.default_rng(22), 2, 4, cfg.d_model))
    gelu_cfg = dataclasses.replace(cfg, act="gelu")
    assert torch.equal(L.moe_apply(p, x, gelu_cfg, use_kernel=True),
                       L.moe_apply(p, x, cfg, use_kernel=True))
    assert not torch.allclose(L.moe_apply(p, x, gelu_cfg),
                              L.moe_apply(p, x, cfg))


def test_moe_init_has_the_reference_structure():
    for name in MOE_ARCHS:
        cfg_r, p_r, cfg, _ = _moe(name, 0)
        mine = L.moe_init(torch.Generator().manual_seed(0), cfg, L.FP32, "cpu")
        want = jax.tree_util.tree_leaves_with_path(p_r)
        got = jax.tree_util.tree_leaves_with_path(convert.to_numpy(mine))
        assert [(q, a.shape, str(a.dtype)) for q, a in want] == [
            (q, a.shape, str(a.dtype)) for q, a in got]
