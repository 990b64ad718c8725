"""The port's training loss and its gradient against the JAX package's, on
the reduced config of every architecture, on the CPU.

Both packages compute with the same weights (the reference's
``init_params``, carried across by ``models/convert.py``) on the same
batch (numpy, seeded). The reference's ``jax.value_and_grad`` of
``transformer.loss_fn`` (its flash custom VJP, its scans, every layer
under ``jax.checkpoint``) against the port's ``loss_fn`` under
``torch.autograd.grad`` (K6's and K8's Functions running their plain
versions, every layer and CE chunk recomputed by ``layers.remat``). The
loss within 1e-5 relative; each leaf of the gradient within
``rtol=1e-3``, ``atol=1e-4 * max|g_ref|``: the two sum in other orders
through up to four layers and a softmax over the vocabulary. The archs
are split over this file and ``test_torch_train_loss_more.py`` so that
the workers share the reference's compile time.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as ref_configs
from repro.models import layers as ref_L
from repro.models import transformer as ref_T
from repro_torch import pytree
from repro_torch.configs import base as configs
from repro_torch.models import convert, transformer as T

B, S = 2, 48  # S: three Mamba chunks of 16, gemma3's window of 32 binding
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL_SHARE = 1e-3, 1e-4
ARCHS = ["qwen3-14b", "starcoder2-7b", "gemma3-4b", "falcon-mamba-7b",
         "phi3.5-moe-42b-a6.6b"]


@functools.cache
def _batch(name):
    cfg = configs.get(name).reduced()
    rng = np.random.default_rng(11)
    tokens = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    targets = np.concatenate([tokens[:, 1:], np.full((B, 1), 2, np.int32)],
                             axis=1)
    batch = {"tokens": tokens, "targets": targets}
    if cfg.frontend:
        batch["frontend"] = (rng.standard_normal(
            (B, cfg.frontend_len, cfg.d_model)) * 0.02).astype(np.float32)
    return batch


def check_loss_and_grads(name):
    cfg_r = ref_configs.get(name).reduced()
    cfg = configs.get(name).reduced()
    params_r = ref_T.init_params(jax.random.PRNGKey(0), cfg_r, ref_L.FP32)
    batch = _batch(name)
    loss_r, grads_r = jax.value_and_grad(
        lambda p: ref_T.loss_fn(p, {k: jnp.asarray(v)
                                    for k, v in batch.items()},
                                cfg_r, ref_L.FP32))(params_r)
    params = convert.from_reference(jax.tree.map(np.asarray, params_r),
                                    device="cpu")
    leaves = pytree.leaves(params)
    for p in leaves:
        p.requires_grad_()
    loss = T.loss_fn(params, {k: torch.from_numpy(v)
                              for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(loss, leaves)
    loss = loss.item()
    np.testing.assert_allclose(loss, float(loss_r), rtol=LOSS_RTOL)
    want = dict(pytree.items(jax.tree.map(np.asarray, grads_r)))
    got = [(path, g) for (path, _), g in zip(pytree.items(params), grads)]
    assert [p for p, _ in got] == sorted(want) == list(want)
    for path, g in got:
        theirs = want[path]
        assert g.shape == theirs.shape, path
        np.testing.assert_allclose(
            g.numpy(), theirs, rtol=GRAD_RTOL,
            atol=GRAD_ATOL_SHARE * float(np.abs(theirs).max()), err_msg=path)
    return loss


@pytest.mark.parametrize("name", ARCHS)
def test_loss_and_every_gradient_leaf_match_reference(name):
    loss = check_loss_and_grads(name)
    # random weights: about ln(V) = 5.55 at the reduced vocabulary of 256
    assert abs(loss - np.log(256)) < 3.0


def test_chunked_ce_needs_the_chunk_to_divide_s():
    """As the reference's ``s // c`` chunking: S=48 over chunks of 32
    fails (the reference on its reshape, the port with ``ValueError``);
    over chunks of 16 it equals the loss over one chunk of 48."""
    rng = np.random.default_rng(5)
    hidden = torch.from_numpy(rng.standard_normal((2, 48, 8)).astype(
        np.float32))
    targets = torch.from_numpy(rng.integers(0, 20, (2, 48)))
    w = torch.from_numpy(rng.standard_normal((8, 20)).astype(np.float32))
    with pytest.raises(ValueError, match="chunk 32"):
        T.chunked_ce(hidden, targets, w, chunk=32)
    with pytest.raises(TypeError):
        ref_T.chunked_ce(jnp.asarray(hidden.numpy()),
                         jnp.asarray(targets.numpy()), jnp.asarray(w.numpy()),
                         chunk=32)
    np.testing.assert_allclose(
        float(T.chunked_ce(hidden, targets, w, chunk=16)),
        float(T.chunked_ce(hidden, targets, w)), rtol=1e-6)
    np.testing.assert_allclose(
        float(T.chunked_ce(hidden, targets, w, chunk=16)),
        float(ref_T.chunked_ce(jnp.asarray(hidden.numpy()),
                               jnp.asarray(targets.numpy()),
                               jnp.asarray(w.numpy()), chunk=16)),
        rtol=1e-6)


def test_remat_recomputes_only_where_autograd_needs_it(monkeypatch):
    """Training checkpoints each layer and each CE chunk; a forward whose
    parameters need no gradient (serving) calls no checkpoint at all,
    even under grad mode, and gives the same hidden states."""
    from repro_torch.models import layers as L

    calls = []
    real = L.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(L, "checkpoint", counting)
    cfg = configs.get("zamba2-7b").reduced()
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch("zamba2-7b").items()}
    served = T.forward_hidden(params, batch["tokens"], cfg)
    assert calls == []
    for p in pytree.leaves(params):
        p.requires_grad_()
    hidden = T.forward_hidden(params, batch["tokens"], cfg)
    # every Mamba-2 layer and each of its chunks of 16; the shared block
    # is not recomputed, as in the reference
    assert len(calls) == cfg.n_layers * (1 + S // cfg.ssm_chunk)
    torch.testing.assert_close(hidden.detach(), served, rtol=0, atol=0)
    calls.clear()
    loss = T.loss_fn(params, batch, cfg)
    assert len(calls) == cfg.n_layers * (1 + S // cfg.ssm_chunk) + 1  # + CE
    calls.clear()
    loss.backward()
    # each layer's recompute checkpoints its chunks again (nested, as
    # jax.checkpoint inside jax.checkpoint)
    assert len(calls) == cfg.n_layers * (S // cfg.ssm_chunk)


# every forward loop that takes its layers through ``layer_views``: GQA
# and MLA stacks, a Mamba-1 stack, zamba2's segments, whisper's encoder
# and decoder, moonlight's dense and MoE stacks
UNBIND_ARCHS = ["qwen3-14b", "minicpm3-4b", "falcon-mamba-7b", "zamba2-7b",
                "whisper-tiny", "moonlight-16b-a3b"]
STACKS = ("dense_layers", "enc_layers", "layers")


def _loss_on_leaves(name):
    """A reduced config's parameters (seeded), its leaves requiring grad,
    and ``loss_fn`` over this file's batch."""
    cfg = configs.get(name).reduced()
    params = T.init_params(torch.Generator().manual_seed(0), cfg,
                           device="cpu")
    leaves = pytree.leaves(params)
    for p in leaves:
        p.requires_grad_()
    batch = {k: torch.from_numpy(v) for k, v in _batch(name).items()}
    return params, leaves, T.loss_fn(params, batch, cfg)


def _stacked(params, grads):
    """``(path, shape, grad)`` of every leaf of a layer stack."""
    return [(path, tuple(p.shape), g)
            for (path, p), g in zip(pytree.items(params), grads)
            if path.split("/")[0] in STACKS]


@pytest.mark.parametrize("name", UNBIND_ARCHS)
def test_backward_stacks_each_stacked_gradient_once(name):
    """The forward takes each stack's layers through one ``unbind``, so
    the backward gives each stacked leaf its gradient by one ``stack``
    (under ``UnbindBackward0``) and never a layer's ``select_backward``,
    which would zero-fill a gradient of the whole stack for each layer.
    A ``select_backward`` of the model's own (a position of the plain
    scan) takes no stack's shape at dim 0. moonlight's router bias only
    chooses experts, so it has no gradient and its unbind no backward."""
    from torch.profiler import ProfilerActivity, profile

    params, leaves, loss = _loss_on_leaves(name)
    with profile(activities=[ProfilerActivity.CPU],
                 record_shapes=True) as prof:
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    stacked = _stacked(params, grads)
    shapes = {shape for _, shape, _ in stacked}
    assert all(g is not None or path.endswith("router_bias")
               for path, _, g in stacked)
    events = prof.events()
    layer_selects = [e for e in events if e.name == "aten::select_backward"
                     and tuple(e.concrete_inputs[1]) in shapes
                     and e.concrete_inputs[2] == 0]
    stacks = [e for e in events if e.name == "aten::stack"
              and e.cpu_parent is not None
              and e.cpu_parent.name == "UnbindBackward0"]
    assert layer_selects == []
    assert len(stacks) == sum(g is not None for _, _, g in stacked) > 0


@pytest.mark.parametrize("name", UNBIND_ARCHS)
def test_unbound_views_give_the_per_index_views_gradients(name, monkeypatch):
    """Every gradient leaf through ``layer_views`` equals, bit for bit,
    the one through a view per layer (``layer_params(stack, i)``): each
    sums one layer's gradient into zeros, which is exact."""
    params, leaves, loss = _loss_on_leaves(name)
    got = torch.autograd.grad(loss, leaves, allow_unused=True)
    monkeypatch.setattr(T, "layer_views", lambda stacked, n: [
        T.layer_params(stacked, i) for i in range(n)])
    _, leaves, loss = _loss_on_leaves(name)
    want = torch.autograd.grad(loss, leaves, allow_unused=True)
    for (path, _), g, w in zip(pytree.items(params), got, want):
        assert (g is None) == (w is None), path
        assert g is None or torch.equal(g, w), path
