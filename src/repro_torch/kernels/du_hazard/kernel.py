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
strict-precedence variant. The kernel counts, for any ``src``: it
binary-searches a row that is non-decreasing (the paper's §3.1
requirement, for which the count is the minimal safe frontier) and
counts any other row word by word, the choice made per row on the card
(no host sync). It takes no pads: a ``dst`` of ``INT32_MAX`` counts
``S`` under ``"right"``, where the TPU kernel, which padded ``src`` with
``INT32_MAX``, also counted its pad lanes.

On a CUDA tensor the wrapper launches the kernel, built from source at
first use (``repro_torch._build``), and raises on any build or launch
failure. Only a tensor on the CPU, which the tests pass, goes to the
plain version in ``ref.py``. ``hazard_frontier_batch.launches`` counts
wrapper calls that reached the card (``hazard_frontier`` is its
``K = 1`` row), each one cooperative launch on the current stream: the
per-row check, a grid barrier, then the search.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build, device
from repro_torch.kernels.du_hazard.ref import SIDES, hazard_frontier_batch_ref

_INT32_MAX = 2**31 - 1


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("du_hazard")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hazard_frontier_launch.argtypes = [
        p, p, p, p, ctypes.c_longlong, i, i, i, i, i, p,
    ]
    lib.hazard_frontier_launch.restype = i
    lib.hazard_frontier_scratch_words.argtypes = [i, i]
    lib.hazard_frontier_scratch_words.restype = ctypes.c_longlong
    lib.hazard_frontier_max_grid.argtypes = [ctypes.POINTER(i)]
    lib.hazard_frontier_max_grid.restype = i
    lib.du_hazard_error_string.argtypes = [i]
    lib.du_hazard_error_string.restype = ctypes.c_char_p
    return lib


def _raise(rc: int, what: str):
    raise RuntimeError(f"hazard_frontier {what} failed: "
                       + _lib().du_hazard_error_string(rc).decode())


@functools.cache
def _max_grid(index: int) -> int:
    """The co-resident limit of the kernel's blocks on device ``index``,
    the largest grid its cooperative launch accepts (asked once)."""
    out = ctypes.c_int(0)
    with torch.cuda.device(index):
        rc = _lib().hazard_frontier_max_grid(ctypes.byref(out))
    if rc != 0:
        _raise(rc, "occupancy query")
    return out.value


@functools.lru_cache(maxsize=1024)
def scratch_words(k: int, s: int) -> int:
    """int32 words of scratch a launch over ``k`` rows of ``s`` src words
    needs, as the source's layout has it (asked of the built library, once
    per shape)."""
    return _lib().hazard_frontier_scratch_words(k, s)


def _int32(t):
    if t.dtype != torch.int32:
        t = t.to(torch.int32)
    return t if t.is_contiguous() else t.contiguous()


def hazard_frontier_batch(src_addr, dst_addr, *, side: str = "right"):
    """``K`` frontier merges in one launch: ``(K, S)`` src and ``(K, D)``
    dst addresses (cast to int32, as the reference does) → ``(K, D)``
    int32 frontiers. On the card the result is a view into one buffer
    that also holds the kernel's scratch after the frontiers, so whatever
    reads the whole storage (``torch.save``, ``untyped_storage()``) sees
    those words too; ``.clone()`` drops them."""
    if side not in SIDES:
        raise ValueError(f"side must be one of {SIDES}, got {side!r}")
    if src_addr.dim() != 2 or dst_addr.dim() != 2:
        raise ValueError("src_addr and dst_addr must be 2-D (K, S), (K, D)")
    k, s = src_addr.shape
    if k != dst_addr.shape[0]:
        raise ValueError("src_addr and dst_addr need the same row count K")
    dev = src_addr.device
    if dst_addr.device != dev:
        raise ValueError("src_addr and dst_addr must lie on one device")
    if dev.type == "cpu":
        return hazard_frontier_batch_ref(src_addr, dst_addr, side=side)
    if dev.type != "cuda":
        raise ValueError(f"hazard_frontier: unsupported device {dev}")
    device.refuse_grad("hazard_frontier (K2)", src_addr, dst_addr)
    d = dst_addr.shape[1]
    if max(s, d) > _INT32_MAX or k > 65535:
        raise ValueError("hazard_frontier: S, D < 2**31 and K <= 65535")
    src, dst = _int32(src_addr), _int32(dst_addr)
    if k == 0 or d == 0:
        return dst.new_empty((k, d))
    # one allocation: the frontiers, then the kernel's scratch (16-byte
    # aligned), which the returned view keeps alive with it
    at = (k * d + 3) & ~3
    words = scratch_words(k, s)
    buf = dst.new_empty(at + words)
    rc = device.launch(
        dev, _lib().hazard_frontier_launch, src.data_ptr(), dst.data_ptr(),
        buf.data_ptr(), buf.data_ptr() + 4 * at, words, k, s, d,
        int(side == "left"), _max_grid(dev.index),
    )
    if rc != 0:
        _raise(rc, "kernel launch")
    hazard_frontier_batch.launches += 1
    return buf.as_strided((k, d), (d, 1))


hazard_frontier_batch.launches = 0


def hazard_frontier(src_addr, dst_addr, *, side: str = "right"):
    """Minimal safe src commit count per dst request — the ``K = 1`` row
    of ``hazard_frontier_batch`` (one kernel, two shapes): ``(S,)`` ×
    ``(D,)`` → ``(D,)`` int32. ``dst_addr`` may be in any order; only
    the source's monotonicity makes the count a frontier."""
    return hazard_frontier_batch(
        src_addr[None, :], dst_addr[None, :], side=side
    )[0]
