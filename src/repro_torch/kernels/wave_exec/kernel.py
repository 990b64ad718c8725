"""Wave steps as gather-before-scatter over a flat image on the card.

The port of the TPU kernel ``src/repro/kernels/wave_exec/kernel.py``
(``_wave_kernel`` through ``wave_step``/``wave_loop``), written by hand
in CUDA C++ for ``sm_90a`` (``csrc/wave_exec.cu``; the design notes on
ordering, coherence and the bound are there). A step is a batch of
conflict-free waves (WavePlan contract 5):

    vals[i] = mem[clip(addr[i], 0, M-1)]        (gather, pre-step image)
    mem[addr[i]] = sval[i]   where write[i]     (scatter, write lanes only)

The image is an ``(M,)`` int64 tensor — the float64 image
``.view(torch.int64)`` — so the kernel moves bit patterns and every bit
survives. ``wave_loop`` runs a segment of ``S`` equal-width steps as one
cooperative launch and **updates ``mem`` in place** (the image can be
large; the reference's functional update would double it).

On a CUDA tensor the wrapper launches the kernel, built from source at
first use (``repro_torch._build``), and raises on any build or launch
failure. Only a tensor on the CPU, which the tests pass, goes to the
plain version in ``ref.py``. ``wave_loop.launches`` counts kernel
launches.

``grid_sync`` launches the kernel's barriers alone (two per step, no
memory traffic) at a given grid: it measures what the barriers of a
``wave_loop`` launch cost, and counts no launch of ``wave_loop``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build
from repro_torch.kernels.wave_exec.ref import wave_loop_ref

THREADS = 256  # threads per block, kThreads in csrc/wave_exec.cu


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wave_exec")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.wave_loop_max_grid.argtypes = [ctypes.POINTER(i)]
    lib.wave_loop_launch.argtypes = [
        p, ctypes.c_longlong, p, p, p, p, i, i, i, p,
    ]
    lib.grid_sync_launch.argtypes = [i, i, p]
    for fn in (lib.wave_loop_max_grid, lib.wave_loop_launch,
               lib.grid_sync_launch):
        fn.restype = i
    lib.wave_exec_error_string.argtypes = [i]
    lib.wave_exec_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: " + _lib().wave_exec_error_string(rc).decode()
        )


@functools.cache
def _max_grid(device_index: int) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _raise_on(_lib().wave_loop_max_grid(ctypes.byref(out)),
                  "wave_loop occupancy query")
    return out.value


def launch_grid(w: int, device) -> int:
    """Blocks of a ``wave_loop`` launch ``w`` lanes wide on CUDA
    ``device``: one per ``THREADS`` lanes, capped at the co-resident
    limit (asked of the driver once per device)."""
    dev = torch.device(device)
    cap = _max_grid(dev.index if dev.index is not None
                    else torch.cuda.current_device())
    return max(1, min(cap, -(-w // THREADS)))


def _check(mem, addrs, writes, svals) -> None:
    if mem.dtype != torch.int64 or mem.dim() != 1 or mem.shape[0] < 1:
        raise ValueError("mem must be a non-empty (M,) int64 tensor")
    if addrs.dim() != 2 or addrs.dtype != torch.int32:
        raise ValueError("addrs must be an (S, W) int32 tensor")
    if writes.shape != addrs.shape or writes.dtype != torch.bool:
        raise ValueError("writes must be an (S, W) bool tensor like addrs")
    if svals.shape != addrs.shape or svals.dtype != torch.int64:
        raise ValueError("svals must be an (S, W) int64 tensor like addrs")
    for t in (addrs, writes, svals):
        if t.device != mem.device:
            raise ValueError("all tables must lie on mem's device")
    if not all(t.is_contiguous() for t in (mem, addrs, writes, svals)):
        raise ValueError("wave_loop takes contiguous tensors")


def wave_loop(mem, addrs, writes, svals):
    """Run ``S`` equal-width steps; returns ``(mem, vals)``.

    ``mem``: ``(M,)`` int64 image, updated in place. ``addrs``: ``(S,
    W)`` int32 flat addresses; ``writes``: ``(S, W)`` bool write lanes;
    ``svals``: ``(S, W)`` int64 store bit patterns. ``vals``: ``(S, W)``
    int64, each lane's word from the pre-step image. Caller contract:
    no two write lanes of one step share an address; loads may alias
    anything.
    """
    _check(mem, addrs, writes, svals)
    if mem.device.type == "cpu":
        return wave_loop_ref(mem, addrs, writes, svals)
    if mem.device.type != "cuda":
        raise ValueError(f"wave_loop: unsupported device {mem.device}")
    s_steps, w = addrs.shape
    vals = torch.empty((s_steps, w), dtype=torch.int64, device=mem.device)
    if s_steps == 0 or w == 0:
        return mem, vals
    grid = launch_grid(w, mem.device)
    with torch.cuda.device(mem.device):
        stream = torch.cuda.current_stream(mem.device).cuda_stream
        rc = _lib().wave_loop_launch(
            mem.data_ptr(), mem.shape[0], addrs.data_ptr(),
            writes.data_ptr(), svals.data_ptr(), vals.data_ptr(),
            s_steps, w, grid, stream,
        )
    _raise_on(rc, "wave_loop kernel launch")
    wave_loop.launches += 1
    return mem, vals


wave_loop.launches = 0


def wave_step(mem, addr, write, sval):
    """One step of width ``W`` (``(W,)`` tables): ``wave_loop`` with
    ``S = 1``. Returns ``(mem, vals)`` with ``vals`` of shape ``(W,)``."""
    mem, vals = wave_loop(
        mem, addr.reshape(1, -1), write.reshape(1, -1), sval.reshape(1, -1),
    )
    return mem, vals.reshape(-1)


def grid_sync(grid: int, s_steps: int, device="cuda") -> None:
    """Launch ``s_steps`` steps of ``wave_loop``'s two grid barriers, with
    no memory traffic, on ``grid`` blocks on CUDA ``device`` (asynchronous,
    like a ``wave_loop`` launch)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"grid_sync runs on a CUDA device, not {dev}")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _lib().grid_sync_launch(grid, s_steps, stream)
    _raise_on(rc, "grid_sync kernel launch")
