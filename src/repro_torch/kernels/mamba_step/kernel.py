"""One Mamba-1 decode step of a layer (K10), on the card.

The port's own kernel: no TPU kernel computes the step (the reference's
``_mamba1_step`` in ``src/repro/models/ssm.py`` is plain JAX). Written by
hand in CUDA C++ for ``sm_90a`` (``csrc/mamba_step.cu``; the design notes
and the bound are there), two launches a call: the conv and the B/C/step
projections, then the state pass.

``mamba_step(xz, conv, h, conv_w, conv_b, w_bc, w_dt, dt_bias, a_log,
d_skip)`` takes a layer's input projection ``xz`` ``(B, 2 di)`` and its
cache slices, the conv window ``(B, K-1, di)`` and the state ``(B, di,
n)``, both overwritten in place with the new ones, and returns ``y * silu(z)``
``(B, di)`` for the output projection: what ``models.ssm.mamba_apply``
computes between its two products for S = 1 (``ref.mamba_step_ref``).

``takes`` says whether the kernel serves a step: every tensor a plain
(not distributed) float32 CUDA tensor, the state size n at most 16
(``MAX_STATE``), the conv width at most 4 (``MAX_CONV``), the window and
state contiguous, and no input requiring grad under grad mode. The model
calls ``mamba_step`` only then; everything else runs the model's plain step.

On a CUDA tensor ``mamba_step`` launches the kernel, built from source at
first use (``repro_torch._build``), through ``repro_torch.device.launch``,
and raises on any build or launch failure; only CPU tensors go to the plain
version. ``mamba_step.launches`` counts the kernel's launches, two a call.
"""

from __future__ import annotations

import ctypes
import functools

import torch
from torch.distributed.tensor import DTensor

from repro_torch import _build, device
from repro_torch.kernels.mamba_step.ref import mamba_step_ref

MAX_STATE = 16  # kMaxN in csrc/mamba_step.cu
MAX_CONV = 4  # kMaxK
CHUNK = 256  # channels a chunk of the projections' partial sums (kConvThreads)
MAX_ROWS = 65535 * 8  # the state pass's grid rows times its rows a block
PART_COLS = 2 * MAX_STATE + 1  # kCols: B, C and the step's projection
# the Mamba-1 parameters a step reads, in ``mamba_step``'s order
PARAMS = ("conv_w", "conv_b", "w_bc", "w_dt", "dt_bias", "a_log", "d_skip")
DEVICE_TYPES = ("cuda",)  # where ``takes`` admits a step


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("mamba_step")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.mamba_step_launch.argtypes = [p, ctypes.c_longlong, *[p] * 12,
                                      i, i, i, i, p]
    lib.mamba_step_launch.restype = i
    lib.mamba_step_error_string.argtypes = [i]
    lib.mamba_step_error_string.restype = ctypes.c_char_p
    return lib


def takes(xz, conv, h, *params) -> bool:
    """Whether the kernel serves this step: ``mamba_step``'s arguments, or
    the same with ``xz`` ``(B, 1, 2 di)`` as the model has it."""
    tensors = (xz, conv, h, *params)
    dev = xz.device
    if (dev.type not in DEVICE_TYPES
            or any(isinstance(t, DTensor) for t in tensors)):
        return False
    if any(t.device != dev or t.dtype != torch.float32 for t in tensors):
        return False
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return False
    return (h.dim() == 3 and 1 <= h.shape[-1] <= MAX_STATE
            and conv.dim() == 3 and 1 <= conv.shape[1] < MAX_CONV
            and xz.shape[0] <= MAX_ROWS
            and conv.is_contiguous() and h.is_contiguous())


def _check(xz, conv, h, conv_w, conv_b, w_bc, w_dt, dt_bias, a_log, d_skip):
    """Shapes; returns ``(B, di, n, K)``."""
    if h.dim() != 3 or conv.dim() != 3:
        raise ValueError("mamba_step: conv must be (B, K-1, di) and h "
                         "(B, di, n)")
    b, di, n = h.shape
    k = conv.shape[1] + 1
    want = {"xz": (xz, (b, 2 * di)), "conv": (conv, (b, k - 1, di)),
            "conv_w": (conv_w, (k, di)), "conv_b": (conv_b, (di,)),
            "w_bc": (w_bc, (di, 2 * n)), "w_dt": (w_dt, (di, 1)),
            "dt_bias": (dt_bias, (di,)), "a_log": (a_log, (di, n)),
            "d_skip": (d_skip, (di,))}
    for name, (t, shape) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"mamba_step: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
    return b, di, n, k


def mamba_step(xz, conv, h, conv_w, conv_b, w_bc, w_dt, dt_bias, a_log,
               d_skip):
    """xz ``(B, 2 di)``; conv ``(B, K-1, di)`` and h ``(B, di, n)``,
    overwritten with the new window and state; conv_w ``(K, di)``; conv_b,
    dt_bias, d_skip ``(di,)``; w_bc ``(di, 2n)``; w_dt ``(di, 1)``; a_log
    ``(di, n)`` → y ``(B, di)``, ``y * silu(z)`` of the step."""
    args = (xz, conv, h, conv_w, conv_b, w_bc, w_dt, dt_bias, a_log, d_skip)
    b, di, n, k = _check(*args)
    devs = {t.device for t in args}
    if len(devs) != 1:
        raise ValueError(f"mamba_step: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type == "cpu":
        return mamba_step_ref(*args)
    if dev.type != "cuda":
        raise ValueError(f"mamba_step: unsupported device {dev}")
    device.refuse_grad("mamba_step", *args)
    if any(t.dtype != torch.float32 for t in args):
        raise TypeError("mamba_step: every tensor must be float32 on the card")
    if not 1 <= n <= MAX_STATE or not 2 <= k <= MAX_CONV:
        raise ValueError(f"mamba_step: state size {n} outside [1, "
                         f"{MAX_STATE}] or conv width {k} outside [2, "
                         f"{MAX_CONV}] on the card")
    if not (conv.is_contiguous() and h.is_contiguous()):
        raise ValueError("mamba_step: conv and h are updated in place and "
                         "must be contiguous")
    if xz.stride(1) != 1:
        raise ValueError("mamba_step: xz's rows must be contiguous")
    if b > MAX_ROWS:
        raise ValueError(f"mamba_step: B={b} above {MAX_ROWS}")
    y = torch.empty((b, di), dtype=torch.float32, device=dev)
    if b == 0 or di == 0:
        return y
    xi = torch.empty((b, di), dtype=torch.float32, device=dev)
    part = torch.empty((-(-di // CHUNK), b, PART_COLS), dtype=torch.float32,
                       device=dev)
    w = [t.contiguous() for t in (conv_w, conv_b, w_bc, w_dt, dt_bias, a_log,
                                  d_skip)]
    rc = device.launch(
        dev, _lib().mamba_step_launch, xz.data_ptr(), xz.stride(0),
        conv.data_ptr(), h.data_ptr(), *(t.data_ptr() for t in w),
        xi.data_ptr(), part.data_ptr(), y.data_ptr(), b, di, n, k,
    )
    if rc != 0:
        raise RuntimeError("mamba_step kernel launch failed: "
                           + _lib().mamba_step_error_string(rc).decode())
    mamba_step.launches += 2
    return y


mamba_step.launches = 0
