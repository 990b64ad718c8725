"""Histogram of int32 bin indices, on the card.

The port of the TPU kernel ``src/repro/kernels/histogram/kernel.py``
(``_hist_kernel`` through ``histogram``), written by hand in CUDA C++ for
``sm_90a`` (``csrc/histogram.cu``; the design notes and the bound are
there):

    out[b] = float32(|{ i : data[i] == b }|)        b in [0, n_bins)

Indices outside ``[0, n_bins)`` are dropped. Counts are integers,
rounded to float32 once, so the kernel equals its plain version bit for
bit at any size (the reference adds float32 ones, exact up to 2**24 per
bin).

On a CUDA tensor the wrapper launches the kernel, built from source at
first use (``repro_torch._build``), and raises on any build or launch
failure. Only a tensor on the CPU, which the tests pass, goes to the
plain version in ``ref.py``; the reference's ``interpret=`` has no
counterpart, since the device decides. ``histogram.launches`` counts
kernel launches; ``n_bins = 0`` returns an empty result without one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build, device
from repro_torch.kernels.histogram.ref import histogram_ref

MAX_SHARED_BINS = 56 * 1024  # kMaxSharedBins in csrc/histogram.cu
_INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("histogram")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.histogram_launch.argtypes = [p, ctypes.c_longlong, i, i, p, p, p]
    lib.histogram_launch.restype = i
    lib.histogram_error_string.argtypes = [i]
    lib.histogram_error_string.restype = ctypes.c_char_p
    return lib


def histogram(data, *, n_bins: int, block: int = 512):
    """``(N,)`` bin indices (cast to int32, as the reference does) →
    ``(n_bins,)`` float32 counts. ``block`` is the kernel's threads per
    block (a multiple of 32, at most 1024); it does not change the
    result."""
    if data.dim() != 1:
        raise ValueError("histogram: data must be 1-D")
    if not 0 <= n_bins <= _INT32_MAX:
        raise ValueError(f"histogram: n_bins must be in [0, 2**31), got "
                         f"{n_bins}")
    if block % 32 or not 32 <= block <= 1024:
        raise ValueError(f"histogram: block must be a multiple of 32 in "
                         f"[32, 1024], got {block}")
    dev = data.device
    if dev.type == "cpu":
        return histogram_ref(data, n_bins=n_bins)
    if dev.type != "cuda":
        raise ValueError(f"histogram: unsupported device {dev}")
    device.refuse_grad("histogram (K5)", data)
    if data.shape[0] > _INT32_MAX:
        raise ValueError("histogram: N must be < 2**31")
    out = torch.empty(n_bins, dtype=torch.float32, device=dev)
    if n_bins == 0:
        return out
    d = data.to(torch.int32).contiguous()
    counts = torch.empty(n_bins, dtype=torch.int64, device=dev)
    rc = device.launch(
        dev, _lib().histogram_launch, d.data_ptr(), d.shape[0], n_bins,
        block, counts.data_ptr(), out.data_ptr(),
    )
    if rc != 0:
        raise RuntimeError(
            "histogram kernel launch failed: "
            + _lib().histogram_error_string(rc).decode()
        )
    histogram.launches += 1
    return out


histogram.launches = 0
