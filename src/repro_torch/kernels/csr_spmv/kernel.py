"""SpMV over a block-padded ELL layout, on the card.

The port of the TPU kernel ``src/repro/kernels/csr_spmv/kernel.py``
(``_spmv_kernel`` through ``csr_spmv``), written by hand in CUDA C++ for
``sm_90a`` (``csrc/csr_spmv.cu``; the design notes and the bound are
there), four lanes a row reading 16-byte vectors where ``vector_loads``
allows and words otherwise:

    y[r] = Σ_w vals[r, w] · x[clip(cols[r, w], 0, M-1)]

in float32, added in column order ``w = 0 … W-1``, written in ``x``'s
dtype (float32 or float64 on the card). Values are converted to float32
and columns to int32, as the reference does.

On a CUDA tensor the wrapper launches the kernel, built from source at
first use (``repro_torch._build``), and raises on any build or launch
failure. Only a tensor on the CPU, which the tests pass, goes to the
plain version in ``ref.py``; the reference's ``interpret=`` has no
counterpart, since the device decides. ``csr_spmv.launches`` counts
kernel launches; ``N_pad = 0`` returns an empty result without one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build, device
from repro_torch.kernels.csr_spmv.ref import csr_spmv_ref

_INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("csr_spmv")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.csr_spmv_launch.argtypes = [p, p, p, p, ll, i, ll, i, p]
    lib.csr_spmv_launch.restype = i
    lib.csr_spmv_vector_loads.argtypes = [p, p, i, i]
    lib.csr_spmv_vector_loads.restype = i
    lib.csr_spmv_error_string.argtypes = [i]
    lib.csr_spmv_error_string.restype = ctypes.c_char_p
    return lib


def vector_loads(cols, vals, x) -> bool:
    """Whether a launch on these CUDA tensors (as ``csr_spmv`` passes
    them: int32 ``cols``, float32 ``vals``) reads ``cols`` and ``vals`` as
    16-byte vectors, as the built library decides: float32 ``x``, ``W`` a
    multiple of 4 and both arrays 16-byte aligned (a view that starts
    inside a vector, such as ``flat[1:]``, is not)."""
    return bool(_lib().csr_spmv_vector_loads(
        cols.data_ptr(), vals.data_ptr(), cols.shape[1], x.element_size()))


def csr_spmv(cols, vals, x, *, block_r: int = 128):
    """``(N_pad, W)`` padded columns (pads point at any column with value
    0), ``(N_pad, W)`` values and ``(M,)`` ``x`` → ``(N_pad,)`` in
    ``x``'s dtype. ``N_pad`` must be a multiple of ``block_r``, the
    layout's row block (``csr_to_ell``)."""
    if cols.dim() != 2 or vals.shape != cols.shape:
        raise ValueError("csr_spmv: cols and vals must be (N_pad, W) alike")
    if x.dim() != 1 or x.shape[0] < 1:
        raise ValueError("csr_spmv: x must be 1-D and non-empty")
    if cols.device != x.device or vals.device != x.device:
        raise ValueError("csr_spmv: cols, vals and x must lie on one device")
    n_pad, w = cols.shape
    if block_r < 1 or n_pad % block_r:
        raise ValueError(f"csr_spmv: N_pad={n_pad} is not a multiple of "
                         f"block_r={block_r}")
    dev = x.device
    if dev.type == "cpu":
        return csr_spmv_ref(cols, vals, x)
    if dev.type != "cuda":
        raise ValueError(f"csr_spmv: unsupported device {dev}")
    device.refuse_grad("csr_spmv (K4)", vals, x)
    if x.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"csr_spmv: x must be float32 or float64 on the "
                         f"card, got {x.dtype}")
    if w > _INT32_MAX:
        raise ValueError("csr_spmv: W must be < 2**31")
    y = torch.empty(n_pad, dtype=x.dtype, device=dev)
    if n_pad == 0:
        return y
    c = cols.to(torch.int32).contiguous()
    v = vals.to(torch.float32).contiguous()
    xs = x.contiguous()
    rc = device.launch(
        dev, _lib().csr_spmv_launch, c.data_ptr(), v.data_ptr(),
        xs.data_ptr(), y.data_ptr(), n_pad, w, xs.shape[0], xs.element_size(),
    )
    if rc != 0:
        raise RuntimeError(
            "csr_spmv kernel launch failed: "
            + _lib().csr_spmv_error_string(rc).decode()
        )
    csr_spmv.launches += 1
    return y


csr_spmv.launches = 0
