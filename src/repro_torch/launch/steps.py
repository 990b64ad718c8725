"""Step-function builders: train_step / prefill_step / serve_step.

The port of ``src/repro/launch/steps.py``; the functions run eagerly on
whatever device the params and tokens live on (the reference hands them
to ``jax.jit``). They take DTensor leaves as they take tensors: with a
mesh set (``shardctx.set_mesh_ctx``) each step runs under
``shardctx.replicating``, so the model's plain constants (positions,
zero states) count as replicated, and the activation sharding is the
launcher's (``transformer.set_activation_sharding``), as in the
reference. The train step's gradients come back as DTensors, some
``Partial``; ``adamw.apply_updates`` redistributes each to its
parameter's placements (the FSDP reduce-scatter) before the update.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch import pytree, tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed.fault import StateChanged
from repro_torch.models import layers as L
from repro_torch.models import shardctx
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig,
                    dt: L.Dtypes = L.FP32):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: the loss (``transformer.loss_fn``), its gradient in every
    parameter by ``torch.autograd.grad``, then one AdamW step
    (``adamw.apply_updates``, in place). ``metrics`` holds ``loss``,
    ``grad_norm`` and ``lr`` as 0-d tensors. The parameters require grad
    only while the loss and its gradient are computed. A fault in the
    update raises ``fault.StateChanged``: the parameters and moments may
    be partly updated."""
    def train_step(params, opt_state, batch):
        with tracing.span("train.step"):
            leaves = pytree.leaves(params)
            try:
                with torch.enable_grad(), shardctx.replicating():
                    for p in leaves:
                        p.requires_grad_(True)
                    with tracing.span("train.forward"):
                        loss = T.loss_fn(params, batch, cfg, dt)
                    with tracing.span("train.backward"):
                        grads = torch.autograd.grad(loss, leaves)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
            by_id = {id(p): g for p, g in zip(leaves, grads)}
            grads = pytree.map_leaves(lambda p: by_id[id(p)], params)
            try:
                with tracing.span("train.optimizer"):
                    params2, opt2, metrics = adamw.apply_updates(
                        params, grads, opt_state, opt_cfg
                    )
            except Exception as e:
                raise StateChanged("the AdamW update failed") from e
            metrics["loss"] = adamw.whole(loss.detach())
            return params2, opt2, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig, dt: L.Dtypes = L.FP32,
                      max_seq: Optional[int] = None):
    def prefill_step(params, batch):
        with shardctx.replicating():
            return T.prefill(
                params, batch["tokens"], cfg, dt,
                frontend=batch.get("frontend"), max_seq=max_seq,
            )

    return prefill_step


def make_serve_step(cfg: ArchConfig, dt: L.Dtypes = L.FP32):
    def serve_step(params, tokens, cache, lengths, enc_out=None):
        with tracing.span("serve.step"), shardctx.replicating():
            logits, new_cache = T.decode_step(
                params, tokens, cache, lengths, cfg, dt, enc_out=enc_out
            )
            return logits, new_cache, lengths + 1

    return serve_step
