"""The grouped expert matmul (K9), on the card.

The port of the TPU kernel ``src/repro/kernels/moe_group_mm/kernel.py``
(``_gmm_kernel`` through ``group_matmul``), written by hand in CUDA C++
for ``sm_90a`` (``csrc/moe_group_mm.cu``; the design notes and the bound
are there):

    out[t] = x_sorted[t] @ w[block_expert[t // block_t]]

over ``(T_pad, d_in)`` rows sorted by expert and padded to whole row
blocks (``ops.monotonic_dispatch`` builds the layout), ``(E, d_in,
d_out)`` weights, float32 sums, ``out`` in x's dtype. Every row block is
computed, pad rows included, as the TPU kernel does; expert ids are
clipped to ``[0, E)``. ``block_t`` is any positive size.

On a CUDA tensor ``group_matmul`` launches the kernel (float32 in
3×TF32 on the tensor cores, float16 and bfloat16 natively), built from
source at first use (``repro_torch._build``), through
``repro_torch.device.launch``, and raises on any build or launch
failure. Only tensors on the CPU, which the tests pass, and ``meta``
tensors (the dry run's shapes without data) go to the plain version in
``ref.py``; the reference's ``interpret=`` has no counterpart, since the
device decides. ``group_matmul.launches`` counts
kernel launches; ``T_pad = 0`` returns an empty result without one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build, device
from repro_torch.kernels.moe_group_mm.ref import group_matmul_ref

_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("moe_group_mm")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.group_matmul_launch.argtypes = [i, p, p, p, p, i, i, i, i, i, p]
    lib.group_matmul_launch.restype = i
    lib.group_matmul_error_string.argtypes = [i]
    lib.group_matmul_error_string.restype = ctypes.c_char_p
    return lib


def group_matmul(x_sorted, w, block_expert, *, block_t: int = 128):
    """``(T_pad, d_in)`` rows, ``(E, d_in, d_out)`` weights and
    ``(>= T_pad // block_t,)`` expert ids → ``(T_pad, d_out)`` in x's
    dtype. ``T_pad`` must be a multiple of ``block_t``."""
    if x_sorted.dim() != 2 or w.dim() != 3 or block_expert.dim() != 1:
        raise ValueError("group_matmul: x_sorted must be (T_pad, d_in), w "
                         "(E, d_in, d_out) and block_expert 1-D")
    t_pad, d_in = x_sorted.shape
    n_experts, _, d_out = w.shape
    if w.shape[1] != d_in:
        raise ValueError(f"group_matmul: x has d_in={d_in}, w "
                         f"{tuple(w.shape)}")
    if block_t < 1 or t_pad % block_t:
        raise ValueError(f"group_matmul: T_pad={t_pad} is not a multiple of "
                         f"block_t={block_t}")
    n_blocks = t_pad // block_t
    if block_expert.shape[0] < n_blocks:
        raise ValueError(f"group_matmul: {block_expert.shape[0]} expert ids "
                         f"for {n_blocks} row blocks")
    devs = {x_sorted.device, w.device, block_expert.device}
    if len(devs) != 1:
        raise ValueError(f"group_matmul: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type in ("cpu", "meta"):
        return group_matmul_ref(x_sorted, w, block_expert, block_t=block_t)
    if dev.type != "cuda":
        raise ValueError(f"group_matmul: unsupported device {dev}")
    device.refuse_grad("group_matmul (K9)", x_sorted, w)
    if x_sorted.dtype not in _DTYPES or w.dtype != x_sorted.dtype:
        raise TypeError(f"group_matmul: x and w must share one of float32, "
                        f"float16, bfloat16 on the card, got {x_sorted.dtype} "
                        f"and {w.dtype}")
    if max(x_sorted.numel(), t_pad * d_out, d_in * d_out) > _INT32_MAX:
        raise ValueError("group_matmul: a row block's operands must hold "
                         "< 2**31 elements")
    out = torch.empty((t_pad, d_out), dtype=x_sorted.dtype, device=dev)
    if out.numel() == 0:
        return out
    if n_experts == 0:
        raise ValueError("group_matmul: no experts")
    x = x_sorted.contiguous()
    wc = w.contiguous()
    be = block_expert[:n_blocks].to(torch.int32).contiguous()
    rc = device.launch(
        dev, _lib().group_matmul_launch, _DTYPES[x.dtype], x.data_ptr(),
        wc.data_ptr(), be.data_ptr(), out.data_ptr(), t_pad, d_in, d_out,
        n_experts, block_t,
    )
    if rc != 0:
        raise RuntimeError("group_matmul kernel launch failed: "
                           + _lib().group_matmul_error_string(rc).decode())
    group_matmul.launches += 1
    return out


group_matmul.launches = 0
