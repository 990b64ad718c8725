"""Wave-execution backend: drive a ``WavePlan`` through the CUDA kernel.

The port of ``kernels/wave_exec/ops.py`` in the JAX package. ``run_plan``
is the hardware half of the DESIGN.md §2 split: the plan (from
``core/executor.build_wave_plan``) carries the batched-step partition,
flat addresses, op tables and captured CU operand streams. Execution is
two-phase:

    resolve — the shared ``executor.drive_plan`` driver runs over a
              host-side image: op-table closures produce each step's
              store values and §6 valid bits from the gathers of
              *strictly earlier* steps (WavePlan contract 5), every
              gather/guard/value is pinned request-exact against the
              oracle reference streams, and the per-step
              (addr, write, sval) tables are recorded,
    device  — the recorded tables are padded to power-of-two lane
              buckets and packed into one table each for the whole
              plan (``pack_steps``), uploaded once; each segment of
              equal width runs as **one** launch
              of the ``wave_loop`` kernel on views of them, chaining the
              flat int64 image on the card. Final arrays are unpacked from the device image; under
              ``check=True`` the per-step device gathers and the final
              image are checked bit-exact against the resolve phase.

The kernel takes its sizes at run time, so the reference's power-of-two
padding of each segment's step count (which bounded its compile count)
is dropped; ``n_segments`` is the number of kernel launches of the device
phase. Pad lanes target a scratch word past the image and never write.

``device`` is ``"cuda"`` by default: the kernel runs on the card, and a
missing card raises ``RuntimeError`` — nothing switches to the CPU by
itself. ``device="cpu"``, which only the tests pass, runs the kernel's
plain torch version (``ref.py``) on the same tables.

``run_sequential`` executes the same plan one request per step — the
paper's non-fused baseline on identical hardware (a single bucket-8
segment of ``n_requests`` steps).

Cross-PE FIFO edges (DESIGN.md §11) need no support here: the plan
encodes each edge as circular pseudo-memory slots inside ``mem_size``,
so pushes and pops flow through the ordinary scatter/gather path.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.core import executor as execlib
from repro_torch.device import resolve_device
from repro_torch.kernels.wave_exec.kernel import wave_loop

__all__ = ["run_plan", "run_sequential", "WaveExecResult", "resolve_device"]

_MIN_BUCKET = 8


@dataclasses.dataclass
class WaveExecResult:
    """Final arrays + execution profile of one backend run."""

    arrays: dict[str, np.ndarray]
    stats: execlib.WaveStats
    n_steps: int  # executed gather→scatter steps (pad steps excluded)
    elapsed: float  # seconds: resolve + device phases
    complete: bool  # False when max_steps truncated the run
    resolve_s: float = 0.0  # host resolution (op tables + checks)
    device_s: float = 0.0  # upload + segment launches, synchronized
    n_segments: int = 0  # wave_loop kernel launches
    # (steps, lanes) of each launch, in order; the image is mem_size + 1
    segments: list = dataclasses.field(default_factory=list)


def _bucket(n: int) -> int:
    b = _MIN_BUCKET
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class StepTables:
    """Every step's (addr, write, sval) rows of one plan, each padded to
    its lane bucket and packed back to back: segment k (steps ``s0`` to
    ``s1`` of equal width) is the ``(s1 - s0, width)`` block at
    ``offsets[k]``. Pad lanes target the scratch word and never write."""

    addrs: np.ndarray  # int32, all rows concatenated
    writes: np.ndarray  # bool
    svals: np.ndarray  # float64
    widths: list  # each step's lane bucket
    segments: list  # (first step, end step) of each run of equal width
    offsets: list  # each segment's first element in the packed rows


def pack_steps(steps, scratch: int) -> StepTables:
    """Pack the recorded ``(addr, write, sval)`` of each step into one
    table each, allocated once and padded by its fill (the device phase
    uploads each table once per plan and launches on views of it). Each
    row goes in by a slice assignment: on the plans' rows, mostly whole
    buckets, that is cheaper than building index or mask arrays."""
    widths = [_bucket(len(a)) for a, _, _ in steps]
    segments: list[tuple[int, int]] = []
    for s, wd in enumerate(widths):
        if segments and widths[segments[-1][0]] == wd:
            segments[-1] = (segments[-1][0], s + 1)
        else:
            segments.append((s, s + 1))
    row_at = np.concatenate([[0], np.cumsum(widths, dtype=np.int64)])
    total = int(row_at[-1])
    addrs = np.full(total, scratch, dtype=np.int32)
    writes = np.zeros(total, dtype=bool)
    svals = np.zeros(total, dtype=np.float64)
    for (a, w, v), at in zip(steps, row_at.tolist()):
        addrs[at:at + len(a)] = a
        writes[at:at + len(a)] = w
        svals[at:at + len(a)] = v
    return StepTables(addrs, writes, svals, widths, segments,
                      [int(row_at[s0]) for s0, _ in segments])


def _run(
    plan: execlib.WavePlan,
    arrays: dict[str, np.ndarray],
    step_of: Optional[np.ndarray],
    n_steps: Optional[int],
    *,
    device,
    compute: str,
    check: bool,
    max_steps: Optional[int],
) -> WaveExecResult:
    if compute not in ("host", "torch"):
        raise ValueError(f"unknown compute {compute!r}")
    dev = resolve_device(device, "wave backend")
    assert plan.mem_size < 2**31 - 1, "flat image exceeds int32 addressing"
    # flat f64 image plus the scratch word pad lanes target
    scratch = plan.mem_size
    mem_f64 = np.zeros(plan.mem_size + 1, dtype=np.float64)
    mem_f64[:plan.mem_size] = execlib.flat_image(plan, arrays)[
        :plan.mem_size
    ]

    # --- resolve phase: op-table compute + checks over a host image ------
    # records the per-step memory traffic the device phase will replay
    host_mem = mem_f64.copy()
    rec: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []

    def mem_step(flat_addr, write, sval):
        got = host_mem[flat_addr]  # fancy indexing copies: pre-step state
        host_mem[flat_addr[write]] = sval[write]
        rec.append((flat_addr, write, sval, got))
        return got

    t0 = time.perf_counter()
    steps, complete = execlib.drive_plan(
        plan, mem_step, frozen=arrays, step_of=step_of, n_steps=n_steps,
        lib="np" if compute == "host" else "torch", device=dev, check=check,
        max_steps=max_steps,
    )
    t_resolve = time.perf_counter() - t0

    # --- device phase: segments of equal-width steps, one launch each ----
    t0 = time.perf_counter()
    tables = pack_steps([r[:3] for r in rec], scratch)
    mem_dev = torch.from_numpy(mem_f64.view(np.int64)).to(dev)
    addrs, writes, svals = (
        torch.from_numpy(t).to(dev)
        for t in (tables.addrs, tables.writes, tables.svals.view(np.int64))
    )
    segments = tables.segments
    seg_vals = []
    for (s0, s1), at in zip(segments, tables.offsets):
        shape = (s1 - s0, tables.widths[s0])
        n = shape[0] * shape[1]
        _, vals = wave_loop(
            mem_dev, addrs[at:at + n].view(shape),
            writes[at:at + n].view(shape), svals[at:at + n].view(shape),
        )
        seg_vals.append(vals)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    t_device = time.perf_counter() - t0

    if check:
        for (s0, s1), vals in zip(segments, seg_vals):
            vals_h = vals.cpu().numpy()
            for j in range(s1 - s0):
                a, _, _, got = rec[s0 + j]
                np.testing.assert_array_equal(
                    vals_h[j, :len(a)], got.view(np.int64),
                    err_msg="device gather diverged from resolve phase",
                )
    mem_out = mem_dev.cpu().numpy().view(np.float64)
    if check:
        np.testing.assert_array_equal(
            mem_out[:plan.mem_size].view(np.int64),
            host_mem[:plan.mem_size].view(np.int64),
            err_msg="device image diverged from resolve phase",
        )
    out = execlib.unpack_image(plan, mem_out, arrays)
    return WaveExecResult(
        arrays=out, stats=plan.stats, n_steps=steps,
        elapsed=t_resolve + t_device, complete=complete,
        resolve_s=t_resolve, device_s=t_device, n_segments=len(segments),
        segments=[(s1 - s0, tables.widths[s0]) for s0, s1 in segments],
    )


def run_plan(
    plan: execlib.WavePlan,
    arrays: dict[str, np.ndarray],
    *,
    device="cuda",
    compute: str = "host",
    check: bool = True,
    max_steps: Optional[int] = None,
) -> WaveExecResult:
    """Execute a WavePlan step-parallel through the wave kernel.

    ``compute="host"`` (default) evaluates the op-table closures in
    numpy — elementwise identical to the oracle, so final arrays are
    bit-exact. ``compute="torch"`` runs the same closures in float64
    torch on ``device``: bit-exact on ``+ - * min max`` and the
    compares, within rounding on ``tanh``/``exp``/``//``/``%`` (pair
    those with ``check=False``).
    ``check`` pins every gather, store value and §6 valid bit
    request-exact against the plan's oracle reference streams during
    the resolve phase, then the device gathers and final image
    bit-exact against the resolve phase — leave on except when timing.
    ``device`` is where the image lives and the kernel runs (module
    docstring): ``"cuda"`` by default, ``"cpu"`` for tests only.
    """
    return _run(
        plan, arrays, None, None,
        device=device, compute=compute, check=check, max_steps=max_steps,
    )


def run_sequential(
    plan: execlib.WavePlan,
    arrays: dict[str, np.ndarray],
    *,
    device="cuda",
    compute: str = "host",
    check: bool = False,
    max_steps: Optional[int] = None,
) -> WaveExecResult:
    """Execute the plan one request per step, in program order — the
    sequential (non-fused) baseline on the same hardware path (one
    bucket-width-8 segment of ``n_requests`` steps through the same
    ``wave_loop`` kernel). ``max_steps`` truncates for timing
    measurement (the result's ``complete`` flag records it; truncated
    arrays are partial)."""
    n = plan.n_requests
    return _run(
        plan, arrays, np.arange(n, dtype=np.int64), n,
        device=device, compute=compute, check=check, max_steps=max_steps,
    )
