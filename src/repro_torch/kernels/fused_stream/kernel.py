"""Fused producer/consumer stream with guarded store-to-load forwarding,
on the card.

The port of the TPU kernel ``src/repro/kernels/fused_stream/kernel.py``
(``_fused_kernel`` through ``fused_stream``), written by hand in CUDA
C++ for ``sm_90a`` (``csrc/fused_stream.cu``; the design notes and the
bound are there). For consumer ``j`` with address ``a_j`` and producer
frontier ``f_j`` (from du_hazard):

    youngest *valid* producer i in f_j-1 … f_j-lookback
        with addr_i == a_j                            -> src_val[i]  (hit)
    no such producer                                  -> memory[a_j] (miss)

Values move as whole 4- or 8-byte words, chosen by the dtype of
``src_val`` and ``memory`` (which must agree): float32 matches the TPU
kernel bit for bit, and float64 forwards a plan's values exactly (the
reference, without 64-bit JAX, forwards them as float32).
``src_valid=None`` means every producer landed.

On a CUDA tensor the wrapper launches the kernel, built from source at
first use (``repro_torch._build``), and raises on any build or launch
failure. Only a tensor on the CPU, which the tests pass, goes to the
plain version in ``ref.py``. ``fused_stream.launches`` counts kernel
launches; ``D = 0`` returns empty results without one.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build, device
from repro_torch.kernels.fused_stream.ref import fused_stream_ref

THREADS = 256  # consumers per block, kThreads in csrc/fused_stream.cu
_INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("fused_stream")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.fused_stream_launch.argtypes = [
        p, p, p, p, p, p, p, p, i, i, ctypes.c_longlong, i, i, p,
    ]
    lib.fused_stream_launch.restype = i
    lib.fused_stream_error_string.argtypes = [i]
    lib.fused_stream_error_string.restype = ctypes.c_char_p
    return lib


def _int32(t):
    """``t`` as a contiguous int32 tensor, copied only where it is not
    one."""
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    return t if t.is_contiguous() else t.contiguous()


def _check(src_addr, src_val, frontier, dst_addr, memory, src_valid,
           lookback) -> None:
    for name, t in (("src_addr", src_addr), ("src_val", src_val),
                    ("frontier", frontier), ("dst_addr", dst_addr),
                    ("memory", memory), ("src_valid", src_valid)):
        if t is None:
            continue
        if t.dim() != 1:
            raise ValueError(f"fused_stream: {name} must be 1-D")
        if t.device != memory.device:
            raise ValueError(f"fused_stream: {name} must lie on memory's "
                             "device")
    if src_val.shape != src_addr.shape or (
        src_valid is not None and src_valid.shape != src_addr.shape
    ):
        raise ValueError("fused_stream: src_val and src_valid must be (S,) "
                         "like src_addr")
    if frontier.shape != dst_addr.shape:
        raise ValueError("fused_stream: frontier must be (D,) like dst_addr")
    if src_val.dtype != memory.dtype or memory.element_size() not in (4, 8):
        raise ValueError("fused_stream: src_val and memory need one dtype "
                         "of 4 or 8 bytes")
    if memory.shape[0] < 1:
        raise ValueError("fused_stream: memory must be non-empty")
    if int(lookback) < 1:
        raise ValueError(f"fused_stream: lookback must be >= 1, got "
                         f"{lookback}")


def fused_stream(src_addr, src_val, frontier, dst_addr, memory,
                 src_valid=None, *, lookback: int = 1):
    """Returns ``(values, hits)`` for every consumer request: ``(D,)``
    values of ``memory``'s dtype and ``(D,)`` bool forwarded flags.

    ``src_addr``: ``(S,)`` monotonic producer addresses; ``src_val``:
    ``(S,)`` producer values; ``frontier``: ``(D,)`` per-consumer
    producer frontier; ``dst_addr``: ``(D,)`` consumer addresses;
    ``memory``: ``(M,)`` backing array (pre-producer state);
    ``src_valid``: optional ``(S,)`` §6 valid bits (1 = landed). With
    guarded producers pass a ``lookback`` covering the longest
    same-address run (``ops.min_lookback``).
    """
    _check(src_addr, src_val, frontier, dst_addr, memory, src_valid,
           lookback)
    dev = memory.device
    if dev.type == "cpu":
        return fused_stream_ref(src_addr, src_val, frontier, dst_addr,
                                memory, src_valid, lookback=int(lookback))
    if dev.type != "cuda":
        raise ValueError(f"fused_stream: unsupported device {dev}")
    device.refuse_grad("fused_stream (K3)", src_val, memory)
    s, d = src_addr.shape[0], dst_addr.shape[0]
    if max(s, d, int(lookback)) > _INT32_MAX:
        raise ValueError("fused_stream: S, D and lookback must be < 2**31")
    out = torch.empty(d, dtype=memory.dtype, device=dev)
    hits = torch.empty(d, dtype=torch.bool, device=dev)
    if d == 0:
        return out, hits
    # locals keep any converted copy alive until the launch is queued
    src, f, a = _int32(src_addr), _int32(frontier), _int32(dst_addr)
    vals, mem = src_val.contiguous(), memory.contiguous()
    valid = None if src_valid is None else _int32(src_valid)
    rc = device.launch(
        dev, _lib().fused_stream_launch, src.data_ptr(), vals.data_ptr(),
        None if valid is None else valid.data_ptr(), f.data_ptr(),
        a.data_ptr(), mem.data_ptr(), out.data_ptr(), hits.data_ptr(), s, d,
        mem.shape[0], int(lookback), mem.element_size(),
    )
    if rc != 0:
        raise RuntimeError(
            "fused_stream kernel launch failed: "
            + _lib().fused_stream_error_string(rc).decode()
        )
    fused_stream.launches += 1
    return out, hits


fused_stream.launches = 0
