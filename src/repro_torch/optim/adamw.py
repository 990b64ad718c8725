"""AdamW with global-norm clipping and a warmup + cosine LR schedule.

The port of ``src/repro/optim/adamw.py``. The state is a dict congruent
with the parameters (``m``, ``v`` in float32) plus a 0-d int32 ``step``,
so a checkpoint of it has the reference's keys and types. The leaves are
walked in JAX's order, sorted dict keys (``repro_torch.pytree``), so
``global_norm`` sums the leaves' squares in the reference's order and
clips by the same scale.

One deliberate deviation: ``apply_updates`` updates the parameters and
moments **in place**, leaf by leaf, and consumes the gradients (their
storage holds the scaled gradient and then the step). The reference's
functional form makes about five temporaries the size of a leaf; at
qwen3-14b's 778 M-word embedding that is about 15 GB, which a full-width
run on one 80 GB card cannot spare. The in-place form keeps one
temporary a leaf and the reference's arithmetic order in each update
(``src/repro/optim/adamw.py:72-80``), so the results equal the
reference's within float32 rounding.

The leaves may be DTensors (a sharded state, ``distributed.partition``).
The moments are made with their parameter's placements; ``global_norm``
reduces each leaf over every rank (``whole``) and adds the leaves in
JAX's order; each gradient is redistributed to its parameter's
placements (from ``Partial``, the reduce-scatter) and the update runs on
the local shards, in place.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
from torch.distributed.tensor import DTensor

from repro_torch import pytree


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_ratio · lr`` at
    ``total_steps``: a float32 0-d tensor on ``step``'s device (an int
    gives the CPU)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = step / max(cfg.warmup_steps, 1)
    t = (step - cfg.warmup_steps) / max(cfg.total_steps - cfg.warmup_steps, 1)
    t = torch.clamp(t, 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def init_state(params) -> dict[str, Any]:
    """Zero moments in float32 beside each parameter (with its placements
    where it is a DTensor), and ``step`` 0."""
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = pytree.leaves(params)[0].device
    return {
        "m": pytree.map_leaves(zeros, params),
        "v": pytree.map_leaves(zeros, params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
    }


def whole(x):
    """``x`` as a plain tensor: a DTensor's full value (reduced or gathered
    over the ranks), anything else as it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


def global_norm(tree) -> torch.Tensor:
    """``sqrt(Σ_leaves Σ x²)`` in float32, the leaves in JAX's order, each
    leaf's sum over every rank."""
    return torch.sqrt(sum(whole(torch.sum(torch.square(x.float())))
                          for x in pytree.leaves(tree)))


def apply_updates(params, grads, state, cfg: AdamWConfig):
    """One AdamW step, in place. Returns ``(params, state, metrics)``:
    the same parameter and moment tensors, updated, a new ``step``, and
    ``{"grad_norm", "lr"}`` as 0-d tensors. ``grads`` are consumed."""
    old_step = state["step"]
    step = whole(old_step) + 1
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.clip_norm / (gnorm + 1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1c = 1 - cfg.b1 ** step.to(torch.float32)
    b2c = 1 - cfg.b2 ** step.to(torch.float32)
    for p, g, m, v in zip(*(pytree.leaves(t) for t in
                            (params, grads, state["m"], state["v"]))):
        if isinstance(p, DTensor):
            g = g.redistribute(p.device_mesh, p.placements)
            p, g, m, v = (x.to_local() for x in (p, g, m, v))
        _update(p, g, m, v, scale, lr, b1c, b2c, cfg)
    if isinstance(old_step, DTensor):
        step = DTensor.from_local(step, old_step.device_mesh,
                                  old_step.placements, run_check=False)
    new_state = {"m": state["m"], "v": state["v"], "step": step}
    return params, new_state, {"grad_norm": gnorm, "lr": lr}


@torch.no_grad()
def _update(p, g, m, v, scale, lr, b1c, b2c, cfg: AdamWConfig):
    """One leaf: the reference's ``upd`` with one temporary, each line
    the reference's operation in its order."""
    g = g.float().mul_(scale)  # g * scale
    tmp = g * (1 - cfg.b1)
    m.mul_(cfg.b1).add_(tmp)  # b1 m + (1 - b1) g
    torch.mul(g, 1 - cfg.b2, out=tmp).mul_(g)
    v.mul_(cfg.b2).add_(tmp)  # b2 v + (1 - b2) g g
    torch.div(v, b2c, out=tmp).sqrt_().add_(cfg.eps)  # sqrt(vhat) + eps
    delta = torch.div(m, b1c, out=g).div_(tmp)  # mhat / (...)
    pf = p if p.dtype == torch.float32 else p.float()
    delta.add_(torch.mul(pf, cfg.weight_decay, out=tmp))  # + wd p
    pf.sub_(delta.mul_(lr))  # p - lr delta
    if pf is not p:
        p.copy_(pf)
