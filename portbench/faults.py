"""Faults planted in the program under a cell, each a context manager that
patches the port's modules for as long as it is open. The tests drive a
whole run with each and see ``correct`` come out false; the calibration
reads the training cell's numbers under them on the chip.

- ``unchanged``: the step returns its state as it found it (serving: every
  Mamba layer's conv window and state; training: the weights and moments).
- ``half_batch``: half of the batch left out (serving: the rows of the
  second half take the mean of the first half's logits; training: the loss
  is the mean over the first half's rows).
- ``token_altered``: a token altered where it is produced (serving: at each
  step one row's greedy token, in turn, is the next id after its best;
  training: one token of every batch, as the loader makes it).
"""

from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def _patched(module, name, make):
    old = getattr(module, name)
    setattr(module, name, make(old))
    try:
        yield
    finally:
        setattr(module, name, old)


def unchanged(kind: str):
    if kind == "serve":
        from repro_torch.models import ssm

        def make(old):
            def mamba_apply(p, x, cfg, *, state=None):
                y, new = old(p, x, cfg, state=state)
                return y, (new if state is None else
                           {k: v.clone() for k, v in state.items()})
            return mamba_apply
        return _patched(ssm, "mamba_apply", make)
    from repro_torch.optim import adamw

    def make(old):
        def apply_updates(params, grads, state, cfg):
            zero = torch.zeros((), device=state["step"].device)
            return params, state, {"grad_norm": zero, "lr": zero}
        return apply_updates
    return _patched(adamw, "apply_updates", make)


def half_batch(kind: str):
    from repro_torch.models import transformer as T

    if kind == "serve":
        def make(old):
            def decode_step(params, tokens, cache, lengths, cfg, *a, **k):
                logits, cache = old(params, tokens, cache, lengths, cfg, *a,
                                    **k)
                h = logits.shape[0] // 2
                logits = logits.clone()
                logits[h:] = logits[:h].mean(0)
                return logits, cache
            return decode_step
        return _patched(T, "decode_step", make)

    def make(old):
        def loss_fn(params, batch, cfg, *a, **k):
            h = batch["tokens"].shape[0] // 2
            return old(params, {n: v[:h] for n, v in batch.items()}, cfg,
                       *a, **k)
        return loss_fn
    return _patched(T, "loss_fn", make)


def token_altered(kind: str):
    if kind == "serve":
        from repro_torch.models import transformer as T

        calls = {"n": 0}

        def make(old):
            def decode_step(params, tokens, cache, lengths, cfg, *a, **k):
                logits, cache = old(params, tokens, cache, lengths, cfg, *a,
                                    **k)
                calls["n"] += 1
                r = calls["n"] % logits.shape[0]  # the next token wins
                logits = logits.clone()
                logits[r, (logits[r].argmax() + 1) % logits.shape[1]] = \
                    logits[r].max() + 1
                return logits, cache
            return decode_step
        return _patched(T, "decode_step", make)
    from repro_torch.data import pipeline

    def make(old):
        def __next__(self):
            b = old(self)
            t = b["tokens"].copy()
            t[0, t.shape[1] // 2] = 3 + (int(t[0, t.shape[1] // 2]) + 1) % (
                self.cfg.vocab - 3)
            return dict(b, tokens=t)
        return __next__
    return _patched(pipeline.ShardedLoader, "__next__", make)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "token_altered": token_altered}
