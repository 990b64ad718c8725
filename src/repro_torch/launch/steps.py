"""Step-function builders: prefill_step / serve_step.

The port of ``src/repro/launch/steps.py`` for serving; the functions run
eagerly on whatever device the params and tokens live on (the reference
hands them to ``jax.jit``). ``make_train_step`` waits for training
(ROADMAP queue 1, item 13).
"""

from __future__ import annotations

from typing import Optional

from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import transformer as T


def make_prefill_step(cfg: ArchConfig, dt: L.Dtypes = L.FP32,
                      max_seq: Optional[int] = None):
    def prefill_step(params, batch):
        return T.prefill(
            params, batch["tokens"], cfg, dt,
            frontend=batch.get("frontend"), max_seq=max_seq,
        )

    return prefill_step


def make_serve_step(cfg: ArchConfig, dt: L.Dtypes = L.FP32):
    def serve_step(params, tokens, cache, lengths, enc_out=None):
        logits, new_cache = T.decode_step(
            params, tokens, cache, lengths, cfg, dt, enc_out=enc_out
        )
        return logits, new_cache, lengths + 1

    return serve_step
