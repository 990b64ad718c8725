"""Wave steps as gather-before-scatter over a flat image on the card.

The port of the TPU kernel ``src/repro/kernels/wave_exec/kernel.py``
(``_wave_kernel`` through ``wave_step``/``wave_loop``), written by hand
in CUDA C++ for ``sm_90a`` (``csrc/wave_exec.cu``; the design notes on
both paths, ordering, coherence and the bound are there). A step is a
batch of conflict-free waves (WavePlan contract 5):

    vals[i] = mem[clip(addr[i], 0, M-1)]        (gather, pre-step image)
    mem[addr[i]] = sval[i]   where write[i]     (scatter, write lanes only)

The image is an ``(M,)`` int64 tensor — the float64 image
``.view(torch.int64)`` — so the kernel moves bit patterns and every bit
survives. ``wave_loop`` runs a segment of ``S`` equal-width steps as one
launch and **updates ``mem`` in place** (the image can be large; the
reference's functional update would double it).

Each launch takes one of two paths, picked by ``choose_path`` from ``M``,
``W`` and the card's limits (asked of the CUDA runtime once per device):
``"resident"`` keeps the image in one thread block's shared memory where
the image and the lanes fit one block, ``"wide"`` leaves it in device
memory under a cooperative grid.

On a CUDA tensor the wrapper launches the kernel, built from source at
first use (``repro_torch._build``), and raises on any build, launch or
occupancy-query failure. Only a tensor on the CPU, which the tests pass,
goes to the plain version in ``ref.py``. ``wave_loop.launches`` counts
kernel launches, ``wave_loop.wide_launches`` those of them on the wide
path.

``grid_sync`` and ``resident_sync`` launch each path's barriers alone
(two per step, no memory traffic): they measure what the barriers of a
``wave_loop`` launch cost, and count no launch of ``wave_loop``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch import _build
from repro_torch.device import launch, refuse_grad
from repro_torch.kernels.wave_exec.ref import wave_loop_ref

THREADS = 256  # wide path: threads per block, kThreads in csrc/wave_exec.cu
WIDE_LANES = 4  # wide path: lanes a thread a pass on wide launches
WIDE_MIN_GRID = 64  # wide path: 4 lanes a thread only from this many blocks
RESIDENT_THREADS = 512  # resident path: most threads a block
RESIDENT_LANES = (1, 2, 4, 8)  # resident path: lanes a thread it is built for


class Path(NamedTuple):
    """How one ``wave_loop`` launch runs: ``kind`` ``"resident"`` (one
    block) or ``"wide"`` (``blocks`` cooperative blocks), of ``threads``
    threads, ``lanes`` lanes a thread."""

    kind: str
    blocks: int
    threads: int
    lanes: int


class Limits(NamedTuple):
    """The card's limits that ``choose_path`` reads: the int64 words one
    block's shared memory holds, and the wide path's co-resident grid."""

    words_per_block: int
    max_grid: int


def resident_path(w: int) -> Path:
    """The resident path for ``w`` lanes: each thread takes the fewest
    lanes of ``RESIDENT_LANES`` that cover ``w`` at ``RESIDENT_THREADS``
    threads, and the block the fewest whole warps that do. ``w`` must fit
    (``RESIDENT_THREADS`` x 8)."""
    lanes = next(k for k in RESIDENT_LANES if k * RESIDENT_THREADS >= w)
    threads = max(32, -(-w // (lanes * 32)) * 32)
    return Path("resident", 1, threads, lanes)


def wide_path(w: int, max_grid: int) -> Path:
    """The wide path for ``w`` lanes, capped at the co-resident grid: one
    block per ``THREADS`` x ``WIDE_LANES`` lanes (16-byte table loads)
    where that still makes ``WIDE_MIN_GRID`` blocks or more, else one
    block per ``THREADS`` lanes, one a thread, so that a narrow launch
    keeps its blocks (and the SMs that fetch its random words)."""
    if -(-w // (THREADS * WIDE_LANES)) >= WIDE_MIN_GRID:
        lanes = WIDE_LANES
    else:
        lanes = 1
    grid = max(1, min(max_grid, -(-w // (THREADS * lanes))))
    return Path("wide", grid, THREADS, lanes)


def choose_path(m: int, w: int, limits: Limits) -> Path:
    """The path of a launch over an ``m``-word image, ``w`` lanes wide:
    resident where the image fits one block's shared memory and the
    lanes its threads (``RESIDENT_THREADS`` x 8), else wide."""
    if m <= limits.words_per_block and (
            w <= RESIDENT_THREADS * RESIDENT_LANES[-1]):
        return resident_path(w)
    return wide_path(w, limits.max_grid)


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("wave_exec")
    p, i = ctypes.c_void_p, ctypes.c_int
    ip = ctypes.POINTER(i)
    lib.wave_loop_max_grid.argtypes = [ip]
    lib.wave_resident_words.argtypes = [ip]
    lib.wave_loop_launch.argtypes = [
        p, ctypes.c_longlong, p, p, p, p, i, i, i, i, p,
    ]
    lib.wave_resident_launch.argtypes = [p, i, p, p, p, p, i, i, i, i, p]
    lib.grid_sync_launch.argtypes = [i, i, p]
    lib.resident_sync_launch.argtypes = [i, i, p]
    for fn in (lib.wave_loop_max_grid, lib.wave_resident_words,
               lib.wave_loop_launch, lib.wave_resident_launch,
               lib.grid_sync_launch, lib.resident_sync_launch):
        fn.restype = i
    lib.wave_exec_error_string.argtypes = [i]
    lib.wave_exec_error_string.restype = ctypes.c_char_p
    return lib


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(
            f"{what} failed: " + _lib().wave_exec_error_string(rc).decode()
        )


def _index(dev) -> int:
    dev = torch.device(dev)
    return dev.index if dev.index is not None else torch.cuda.current_device()


@functools.cache
def limits(device_index: int) -> Limits:
    """The card's ``Limits``, asked of the CUDA runtime once per device (the
    shared-memory opt-in limit, set on the resident kernels then; the
    cooperative grid's occupancy)."""
    grid, words = ctypes.c_int(0), ctypes.c_int(0)
    with torch.cuda.device(device_index):
        _raise_on(_lib().wave_loop_max_grid(ctypes.byref(grid)),
                  "wave_loop occupancy query")
        _raise_on(_lib().wave_resident_words(ctypes.byref(words)),
                  "wave_loop shared-memory query")
    return Limits(words.value, grid.value)


def launch_path(m: int, w: int, device) -> Path:
    """The path ``wave_loop`` takes for ``m`` words and ``w`` lanes on
    CUDA ``device``."""
    return choose_path(m, w, limits(_index(device)))


def launch_grid(w: int, device) -> int:
    """Blocks of a wide-path launch ``w`` lanes wide on CUDA ``device``
    (``wide_path``'s grid)."""
    return wide_path(w, limits(_index(device)).max_grid).blocks


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
    refuse_grad("wave_loop (K1)", mem, svals)
    return run_path(mem, addrs, writes, svals,
                    launch_path(mem.shape[0], addrs.shape[1], mem.device))


wave_loop.launches = 0
wave_loop.wide_launches = 0


def run_path(mem, addrs, writes, svals, path: Path):
    """``wave_loop`` on CUDA tensors (checked by the caller) along
    ``path``: ``launch_path``'s choice, or another that fits (the card
    tests force each path)."""
    s_steps, w = addrs.shape
    vals = torch.empty((s_steps, w), dtype=torch.int64, device=mem.device)
    if s_steps == 0 or w == 0:
        return mem, vals
    m = mem.shape[0]
    limits(mem.device.index)  # sets the resident kernels' shared memory
    if path.kind == "resident":
        if m > 2**31 - 1:
            raise ValueError("wave_loop: the resident path takes M < 2**31")
        rc = launch(
            mem.device, _lib().wave_resident_launch, mem.data_ptr(), m,
            addrs.data_ptr(), writes.data_ptr(), svals.data_ptr(),
            vals.data_ptr(), s_steps, w, path.threads, path.lanes,
        )
    else:
        rc = launch(
            mem.device, _lib().wave_loop_launch, mem.data_ptr(), m,
            addrs.data_ptr(), writes.data_ptr(), svals.data_ptr(),
            vals.data_ptr(), s_steps, w, path.blocks, path.lanes,
        )
    _raise_on(rc, f"wave_loop kernel launch ({path.kind} path)")
    wave_loop.launches += 1
    wave_loop.wide_launches += path.kind == "wide"
    return mem, vals


def wave_step(mem, addr, write, sval):
    """One step of width ``W`` (``(W,)`` tables): ``wave_loop`` with
    ``S = 1``. Returns ``(mem, vals)`` with ``vals`` of shape ``(W,)``."""
    mem, vals = wave_loop(
        mem, addr.reshape(1, -1), write.reshape(1, -1), sval.reshape(1, -1),
    )
    return mem, vals.reshape(-1)


def _cuda(dev, what: str) -> torch.device:
    dev = torch.device(dev)
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on a CUDA device, not {dev}")
    return torch.device("cuda", _index(dev))


def grid_sync(grid: int, s_steps: int, device="cuda") -> None:
    """Launch ``s_steps`` steps of the wide path's two grid barriers,
    with no memory traffic, on ``grid`` blocks on CUDA ``device``
    (asynchronous, like a ``wave_loop`` launch)."""
    dev = _cuda(device, "grid_sync")
    _raise_on(launch(dev, _lib().grid_sync_launch, grid, s_steps),
              "grid_sync kernel launch")


def resident_sync(threads: int, s_steps: int, device="cuda") -> None:
    """Launch ``s_steps`` steps of the resident path's two block barriers,
    with no memory traffic, on one block of ``threads`` threads on CUDA
    ``device`` (asynchronous)."""
    dev = _cuda(device, "resident_sync")
    _raise_on(launch(dev, _lib().resident_sync_launch, threads, s_steps),
              "resident_sync kernel launch")
