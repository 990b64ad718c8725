"""Plain PyTorch references of the configurations the benchmark runs, and
the weights the benchmark draws for them.

Each module here is named by a configuration's ``reference`` key and
imports nothing of the program: only ``torch``, ``numpy`` and this
package. It lays out the weights as the program takes them (``leaves``),
draws them on the device from the seed (``draw_weights``, one generator
a leaf, so any leaf can be drawn again alone: ``draw_leaf``), and
computes what the cell's check compares, in float32 with TF32 off, or
with TF32 on (``tf32=True``) for the check's control.

This module holds what the references share: the generators, the RMS
norm, the rotary embedding and the products under a chosen precision.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for leaf ``index`` of the weights of
    ``seed``."""
    ss = np.random.SeedSequence([int(seed), 1000, int(index)])
    return int(ss.generate_state(1, dtype=np.uint64)[0] >> np.uint64(1))


def draw(spec: dict, shape, seed: int, index: int, device) -> torch.Tensor:
    """Leaf ``index`` in float32 on ``device``: one ``randn`` call from
    its own generator, then ``x·scale + base`` (``spec``'s ``scale``,
    default 1, and ``base``, a number or ``"log_arange"``: log(1..n)
    along the last dim)."""
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(leaf_seed(seed, index))
    x = torch.randn(tuple(shape), generator=g, device=dev,
                    dtype=torch.float32)
    x.mul_(spec.get("scale", 1.0))
    base = spec.get("base", 0.0)
    if base == "log_arange":
        x.add_(torch.log(torch.arange(1, shape[-1] + 1, device=dev,
                                      dtype=torch.float32)))
    elif base:
        x.add_(base)
    return x


def draw_tree(leaves: list, seed: int, device) -> dict:
    """The nested weight dict of ``leaves`` (``(path, shape, spec)``,
    ``path`` dotted)."""
    tree: dict = {}
    for i, (path, shape, spec) in enumerate(leaves):
        node = tree
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = draw(spec, shape, seed, i, device)
    return tree


def get(tree: dict, path: str):
    for k in path.split("."):
        tree = tree[k]
    return tree


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to TF32's 10 mantissa bits (to nearest, ties away),
    kept in float32: what the tensor cores do to a product's operands."""
    i = x.detach().float().contiguous().view(torch.int32)
    return ((i + 0x1000) & ~0x1FFF).view(torch.float32)


class _RoundTF32(torch.autograd.Function):
    """Rounded to TF32 both ways: the operand, and its gradient."""

    @staticmethod
    def forward(ctx, x):
        return round_tf32(x)

    @staticmethod
    def backward(ctx, g):
        return round_tf32(g)


def operand(x: torch.Tensor, tf32: bool) -> torch.Tensor:
    """A product's operand: rounded to TF32 on the CPU where ``tf32``
    (the card rounds it itself under ``precision(True)``)."""
    return _RoundTF32.apply(x) if tf32 and x.device.type == "cpu" else x


def mm(a, b, tf32: bool):
    return operand(a, tf32) @ operand(b, tf32)


@contextlib.contextmanager
def precision(tf32: bool):
    """cuBLAS's float32 products in TF32 where ``tf32``, else in full
    float32; restored after."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def rms_norm(x, scale, eps):
    """``x / sqrt(mean(x²) + eps) · (1 + scale)``, in float32."""
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * (1 + scale)


def rotary(x, positions, theta: float):
    """Rotate the pairs ``(i, i + half)`` of ``x``'s last dim by
    ``positions · theta^(-i / half)``; ``positions`` broadcasts against
    ``x`` without its last dim."""
    half = x.shape[-1] // 2
    inv = torch.exp(-np.log(np.float32(theta)).item()
                    * torch.arange(half, device=x.device, dtype=torch.float32)
                    / half)
    ang = positions[..., None].float() * inv
    c, s = torch.cos(ang), torch.sin(ang)
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * c - b * s, a * s + b * c], dim=-1)
