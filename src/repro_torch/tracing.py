"""Spans and launch counters inside the port, on the device trace's clock.

``span(name)`` marks a named part of the program's work::

    with tracing.span("mamba.scan"):
        ...

Recording is off unless a caller opens ``recording()``. Off, ``span``
checks one module-level name and returns one shared object that does
nothing: it allocates nothing, calls nothing in torch and touches no
device, so a span costs a function call and a ``with`` (and a CUDA graph
captured around spans records no more than without them).

On, each span closes into a ``Span(name, parent, thread, start_ns,
end_ns, step)``:

- times are epoch nanoseconds, the clock of ``torch.profiler``'s events
  (``_KinetoEvent.start_ns()``; a ``FunctionEvent``'s µs count from
  ``kineto_results.trace_start_ns()``): ``perf_counter_ns()`` plus one
  offset to ``time_ns()``, taken when recording starts;
- ``parent`` is the innermost span open on the same thread. A thread
  with none open takes the open outermost span of any thread: autograd
  runs a step's backward on its device thread while the caller waits
  inside the step, so spans entered there (``layers.remat``'s recompute)
  belong to that step;
- ``step`` is the outermost span's index, which every span of that step
  shares.

While a ``torch.profiler`` is active, each recorded span also opens
``torch.profiler.record_function(name)``, so it sits in the trace's
timeline beside the operations its host interval launched.

Counters: ``launch_counts()`` reads the ``.launches`` attribute of the
ten kernel wrappers, K1-K10; the recorder keeps each counter's change
over every outermost span (the counters that moved).

The recorder holds at most ``LIMIT`` closed or open spans between two
``take()`` calls and counts the spans it had to drop.

Taps: ``tap(name, value)`` hands a value the program computed (a
tensor, as it is) to the callable that an open ``tapping()`` block gave
for ``name``; outside one it checks one module-level name and does
nothing. The MoE layers tap their routing (``"moe.route"``: each token's
experts), which a check compares with a reference's choice.
"""

from __future__ import annotations

import contextlib
import importlib
import sys
import threading
import time
from typing import NamedTuple, Optional

# the spans a recorder holds between two take() calls: a 51 s window of
# 258-span decode steps is about 50 000
LIMIT = 1 << 18

# the kernel wrappers whose ``.launches`` ``launch_counts`` reads, by id
COUNTERS = {
    "K1": ("repro_torch.kernels.wave_exec.kernel", "wave_loop"),
    "K2": ("repro_torch.kernels.du_hazard.kernel", "hazard_frontier_batch"),
    "K3": ("repro_torch.kernels.fused_stream.kernel", "fused_stream"),
    "K4": ("repro_torch.kernels.csr_spmv.kernel", "csr_spmv"),
    "K5": ("repro_torch.kernels.histogram.kernel", "histogram"),
    "K6": ("repro_torch.kernels.attention.kernel", "flash_attention"),
    "K7": ("repro_torch.kernels.attention.kernel", "decode_attention"),
    "K8": ("repro_torch.kernels.ssm_scan.kernel", "ssm_scan"),
    "K9": ("repro_torch.kernels.moe_group_mm.kernel", "group_matmul"),
    "K10": ("repro_torch.kernels.mamba_step.kernel", "mamba_step"),
}


class Span(NamedTuple):
    name: str
    parent: Optional[int]  # a span's index, None for an outermost one
    thread: int  # threading.get_ident() of the thread that entered it
    start_ns: int
    end_ns: Optional[int]  # None while it is open
    step: int  # the index of its outermost span


def launch_counts() -> dict:
    """Each kernel wrapper's launch counter, by id (``COUNTERS``)."""
    return {k: getattr(importlib.import_module(mod), fn).launches
            for k, (mod, fn) in COUNTERS.items()}


def _clock_offset_ns() -> int:
    """``time_ns()`` less ``perf_counter_ns()``, from the read of five
    whose two ``perf_counter_ns()`` around it lie closest: a thread
    switched out between the reads would shift every span of a
    recording."""
    reads = []
    for _ in range(5):
        a = time.perf_counter_ns()
        t = time.time_ns()
        b = time.perf_counter_ns()
        reads.append((b - a, t - (a + b) // 2))
    return min(reads)[1]


class _Stack(threading.local):
    def __init__(self):
        self.open = []  # indices of the spans open on this thread


class Recorder:
    """Where the spans of one ``recording()`` block go."""

    def __init__(self):
        self.limit = LIMIT
        self.offset_ns = _clock_offset_ns()
        self.dropped = 0
        self._rows = {}  # index -> [name, parent, thread, start, end, step]
        self._counts = {}  # outermost span's index -> counters that moved
        self._next = 0
        self._root = None  # the open outermost span's index
        self._root_counts = None
        self._stack = _Stack()
        self._lock = threading.Lock()

    def now_ns(self) -> int:
        return time.perf_counter_ns() + self.offset_ns

    def take(self) -> dict:
        """The spans recorded since the last ``take``, in the order they
        were entered, each counter's change over each outermost span
        (``{step: {id: n}}``), and how many spans were dropped; the
        buffer is cleared. A span still open comes with ``end_ns`` None
        and is not recorded again when it closes."""
        with self._lock:
            rows, counts, dropped = self._rows, self._counts, self.dropped
            self._rows, self._counts, self.dropped = {}, {}, 0
        return {"spans": [Span(*r) for _, r in sorted(rows.items())],
                "counts": counts, "dropped": dropped}

    def _open(self, name: str):
        stack = self._stack.open
        with self._lock:
            if len(self._rows) >= self.limit:
                self.dropped += 1
                return None, None
            i = self._next
            self._next += 1
            is_root = not stack and self._root is None
            if is_root:
                self._root = i
                parent = None
            else:
                parent = stack[-1] if stack else self._root
            row = [name, parent, threading.get_ident(), 0, None, self._root]
            self._rows[i] = row
        stack.append(i)
        if is_root:
            self._root_counts = launch_counts()
        return i, row

    def _close(self, i: int, row: list, end_ns: int):
        row[4] = end_ns
        self._stack.open.pop()
        if i == self._root:
            before, self._root_counts = self._root_counts, None
            moved = {k: n - before[k] for k, n in launch_counts().items()
                     if n != before[k]}
            with self._lock:
                self._root = None
                self._counts[i] = moved


class _NoSpan:
    """What ``span`` returns while recording is off."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()
_active: Optional[Recorder] = None  # the recorder of the open recording()


class _Span:
    __slots__ = ("rec", "name", "index", "row", "annotation")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self):
        self.index, self.row = self.rec._open(self.name)
        self.annotation = None
        if self.row is None:
            return self
        prof = sys.modules.get("torch.autograd.profiler")
        if prof is not None and prof._is_profiler_enabled:
            self.annotation = prof.record_function(self.name)
            self.annotation.__enter__()
        self.row[3] = self.rec.now_ns()
        return self

    def __exit__(self, *exc):
        if self.row is None:
            return False
        end = self.rec.now_ns()
        if self.annotation is not None:
            self.annotation.__exit__(*exc)
        self.rec._close(self.index, self.row, end)
        return False


def span(name: str):
    """A context manager marking ``name``'s work; records it only inside
    ``recording()``."""
    rec = _active
    if rec is None:
        return _NO_SPAN
    return _Span(rec, name)


@contextlib.contextmanager
def recording():
    """Turn recording on for the block; yields the ``Recorder``, whose
    ``take()`` gives the spans. One block at a time in a process."""
    global _active
    if _active is not None:
        raise RuntimeError("tracing.recording() is open already")
    rec = Recorder()
    _active = rec
    try:
        yield rec
    finally:
        _active = None


_sinks: Optional[dict] = None  # name -> callable, while tapping() is open


def tap(name: str, value) -> None:
    """Hand ``value`` to the callable the open ``tapping()`` block gave
    for ``name``; nothing otherwise."""
    sinks = _sinks
    if sinks is not None and name in sinks:
        sinks[name](value)


@contextlib.contextmanager
def tapping(sinks: dict):
    """Hand each value tapped under a name of ``sinks`` to that name's
    callable, in the order tapped, for the block. One block at a time in
    a process."""
    global _sinks
    if _sinks is not None:
        raise RuntimeError("tracing.tapping() is open already")
    _sinks = dict(sinks)
    try:
        yield
    finally:
        _sinks = None
