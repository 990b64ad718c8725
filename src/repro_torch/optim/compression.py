"""Gradient compression: per-tensor int8 quantization with error feedback.

The port of ``src/repro/optim/compression.py``: the residual of each
step's quantization is carried and added to the next step's gradient, so
the compression is unbiased over time. ``torch.round`` rounds half to
even, as ``jnp.round`` does, and ``x / scale`` divides elementwise, so the
results equal the reference's bit for bit. The trees are nested dicts;
no mesh collective is modelled here (``distributed`` is ROADMAP item
13c).
"""

from __future__ import annotations

import torch

from repro_torch import pytree


def quantize_int8(x: torch.Tensor):
    """Per-tensor symmetric int8 quantization. Returns ``(q, scale)``."""
    amax = torch.max(torch.abs(x)) + 1e-12
    scale = amax / 127.0
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def ef_compress_grads(grads, errors):
    """Error-feedback compression of a gradient tree. Returns
    ``(quantized-dequantized grads, new error state)``, trees of ``grads``'
    structure."""
    def one(g, e):
        g32 = g.to(torch.float32) + e
        q, s = quantize_int8(g32)
        deq = dequantize_int8(q, s)
        return deq.to(g.dtype), g32 - deq

    pairs = pytree.map_leaves(one, grads, errors)  # (grad, error) leaves
    return (pytree.map_leaves(lambda o: o[0], pairs),
            pytree.map_leaves(lambda o: o[1], pairs))


def init_error_state(params):
    return pytree.map_leaves(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)
