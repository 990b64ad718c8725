"""The plain references against the port on the CPU at reduced sizes, and
whole runs of each cell there coming out correct."""

import math

import torch

import pb_cases
from pb_cases import DECODE, SIZES, TRAIN

from portbench import checks, harness
from portbench.reference import mamba1_lm, mla_lm


def _cfg(cell):
    import dataclasses

    from repro_torch.configs import base

    arch = harness.data("configs", harness.data("workloads", cell)["config"])
    return dataclasses.replace(base.get(arch["arch"]), **SIZES[cell])


def test_mamba1_reference_is_the_ports_forward():
    from repro_torch.models import transformer as T

    s = SIZES[DECODE]
    w = mamba1_lm.draw_weights(s, 7, "cpu")
    tokens = torch.randint(3, s["vocab"], (3, 40),
                           generator=torch.Generator().manual_seed(1))
    want = T.forward_hidden(w, tokens, _cfg(DECODE)) @ w["lm_head"]
    got = mamba1_lm.logits(w, tokens, s)
    assert torch.allclose(got, want, atol=1e-5, rtol=1e-5)
    tail = mamba1_lm.logits(w, tokens, s, first=30)
    assert torch.allclose(tail, got[:, 30:], atol=1e-6, rtol=0)


def test_mla_reference_loss_and_grads_are_the_ports():
    from repro_torch import pytree
    from repro_torch.models import transformer as T

    s = SIZES[TRAIN]
    w = mla_lm.draw_weights(s, 9, "cpu")
    g = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(3, s["vocab"], (2, 32), generator=g),
             "targets": torch.randint(3, s["vocab"], (2, 32), generator=g)}
    grads = {k: v for k, v in mla_lm.draw_weights(s, 9, "cpu").items()}
    loss = mla_lm.loss_and_grads(w, batch, s, grads)
    leaves = pytree.leaves(w)
    for p in leaves:
        p.requires_grad_(True)
    want = T.loss_fn(w, batch, _cfg(TRAIN))
    want_g = torch.autograd.grad(want, leaves)
    assert math.isclose(loss, want.item(), rel_tol=1e-6)
    for (name, a), b in zip(pytree.items(grads), want_g):
        assert torch.allclose(a, b, atol=1e-6, rtol=1e-4), name


def test_adamw_reference_is_the_ports():
    from repro_torch.optim import adamw

    s = SIZES[TRAIN]
    w = mla_lm.draw_weights(s, 3, "cpu")
    mine = mla_lm.draw_weights(s, 3, "cpu")
    zeros = lambda t: {k: zeros(v) if isinstance(v, dict)  # noqa: E731
                       else torch.zeros_like(v) for k, v in t.items()}
    m, v = zeros(mine), zeros(mine)
    opt = {"lr": 3e-4, "horizon": 100}
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=5, total_steps=100)
    state = adamw.init_state(w)
    for step in (1, 2):  # each side consumes gradients of its own
        grads = [mla_lm.draw_weights(s, 4 + step, "cpu") for _ in range(2)]
        mla_lm.adamw_step(mine, grads[0], m, v, step, opt)
        w, state, _ = adamw.apply_updates(w, grads[1], state, cfg)
    for (n, a), (_, b) in zip(checks.slices(mine), checks.slices(w)):
        assert torch.allclose(a, b, atol=1e-7, rtol=1e-5), n


def test_serve_cell_runs_correct_on_the_cpu():
    out = pb_cases.run(DECODE)
    assert out["correct"], out["checks"]
    assert out["checks"]["logit_gap"]["value"] <= 1e-4
    assert out["metrics"]["decode_tok_s"]["value"] > 0


def test_train_cell_runs_correct_on_the_cpu():
    out = pb_cases.run(TRAIN, seconds=1.0)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert out["metrics"]["train_tok_s"]["value"] > 0
