"""DU hazard frontier merge on the card.

The port of the TPU kernel ``src/repro/kernels/du_hazard/kernel.py``
(``_hazard_kernel`` through ``hazard_frontier_batch``/
``hazard_frontier``), written by hand in CUDA C++ for ``sm_90a``
(``csrc/du_hazard.cu``; the design notes and the bound are there). For
each of ``K`` independent (src, dst) stream pairs and every consumer
lane, the number of producers that must commit first:

    frontier[k, j] = |{ i : src[k, i] <= dst[k, j] }|     (side="right")
    frontier[k, j] = |{ i : src[k, i] <  dst[k, j] }|     (side="left")

``side="right"`` is the hazard merge for RAW, WAR and WAW alike (each
waits for the equal-address producer); ``side="left"`` is the
strict-precedence variant. The kernel counts, for any ``src``; for a
non-decreasing row (the paper's §3.1 requirement) the count is the
minimal safe frontier. It takes no pads: a ``dst`` of ``INT32_MAX``
counts ``S`` under ``"right"``, where the TPU kernel, which padded ``src``
with ``INT32_MAX``, also counted its pad lanes.

On a CUDA tensor the wrapper launches the kernel, built from source at
first use (``repro_torch._build``), and raises on any build or launch
failure. Only a tensor on the CPU, which the tests pass, goes to the
plain version in ``ref.py``. ``hazard_frontier_batch.launches`` counts
kernel launches (``hazard_frontier`` is its ``K = 1`` row).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels.du_hazard.ref import SIDES, hazard_frontier_batch_ref

THREADS = 256  # dst lanes per block, kThreads in csrc/du_hazard.cu
_INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("du_hazard")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hazard_frontier_launch.argtypes = [p, p, p, i, i, i, i, p]
    lib.hazard_frontier_launch.restype = i
    lib.du_hazard_error_string.argtypes = [i]
    lib.du_hazard_error_string.restype = ctypes.c_char_p
    return lib


def hazard_frontier_batch(src_addr, dst_addr, *, side: str = "right"):
    """``K`` frontier merges in one launch: ``(K, S)`` src and ``(K, D)``
    dst addresses (cast to int32, as the reference does) → ``(K, D)``
    int32 frontiers."""
    if side not in SIDES:
        raise ValueError(f"side must be one of {SIDES}, got {side!r}")
    if src_addr.dim() != 2 or dst_addr.dim() != 2:
        raise ValueError("src_addr and dst_addr must be 2-D (K, S), (K, D)")
    if src_addr.shape[0] != dst_addr.shape[0]:
        raise ValueError("src_addr and dst_addr need the same row count K")
    if src_addr.device != dst_addr.device:
        raise ValueError("src_addr and dst_addr must lie on one device")
    dev = src_addr.device
    if dev.type == "cpu":
        return hazard_frontier_batch_ref(src_addr, dst_addr, side=side)
    if dev.type != "cuda":
        raise ValueError(f"hazard_frontier: unsupported device {dev}")
    k, s = src_addr.shape
    d = dst_addr.shape[1]
    if max(s, d) > _INT32_MAX or k > 65535:
        raise ValueError("hazard_frontier: S, D < 2**31 and K <= 65535")
    src = src_addr.to(torch.int32).contiguous()
    dst = dst_addr.to(torch.int32).contiguous()
    out = torch.empty((k, d), dtype=torch.int32, device=dev)
    if k == 0 or d == 0:
        return out
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().hazard_frontier_launch(
            src.data_ptr(), dst.data_ptr(), out.data_ptr(), k, s, d,
            int(side == "left"), stream,
        )
    if rc != 0:
        raise RuntimeError(
            "hazard_frontier kernel launch failed: "
            + _lib().du_hazard_error_string(rc).decode()
        )
    hazard_frontier_batch.launches += 1
    return out


hazard_frontier_batch.launches = 0


def hazard_frontier(src_addr, dst_addr, *, side: str = "right"):
    """Minimal safe src commit count per dst request — the ``K = 1`` row
    of ``hazard_frontier_batch`` (one kernel, two shapes): ``(S,)`` ×
    ``(D,)`` → ``(D,)`` int32. ``dst_addr`` may be in any order; only
    the source's monotonicity makes the count a frontier."""
    return hazard_frontier_batch(
        src_addr[None, :], dst_addr[None, :], side=side
    )[0]
