"""The program's own spans (``repro_torch.tracing``) in a traced run.

A kind that runs its window inside ``tracing.recording()`` reads two things
from the spans it takes:

- ``per_step``: the host's seconds under each span name in each step (an
  outermost span and what nests in it), and the change of the kernels'
  launch counters over each outermost span;
- ``device_seconds``: the device time each span name launched in the
  profiled sub-window, by one rule. A device operation belongs to a span
  name when the host call that launched it starts inside an occurrence of
  that span's host interval, on any thread. ``launched_ops`` links each
  kernel, copy or fill to its launching call through the profiler's
  correlation id, so the kernels that autograd's device thread launches
  while the caller waits inside ``train.backward`` fall under that span;
  the span's own ``record_function`` annotation, whose device time counts
  only what its thread launched, would miss them.

Span times are epoch nanoseconds, the profiler's clock: ``occurrences``
places them on a trace's µs with the trace's start.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def launched_ops(events) -> list:
    """``(name, launch_us, start_us, end_us)`` for each device operation in
    a stopped profiler's ``events()`` (kernels, copies, fills; the
    annotations left out), sorted by start. ``launch_us`` is the start of
    the CUDA API call (``cudaLaunchKernel``,
    ``cuLaunchKernel``, ``cudaMemcpyAsync``, ...) that carries the
    operation's correlation id, on whichever thread made it; None where
    the trace lacks that call."""
    from torch.autograd import DeviceType

    calls, ops = {}, []
    for e in events:
        if e.device_type == DeviceType.CUDA:
            if not getattr(e, "is_user_annotation", False):
                ops.append(e)
        elif e.name.startswith("cu"):
            calls[e.id] = e.time_range.start
    out = [(e.name, calls.get(e.id), e.time_range.start, e.time_range.end)
           for e in ops]
    out.sort(key=lambda r: r[2])
    return out


def occurrences(spans, trace_start_ns: int) -> list:
    """``(name, start_us, end_us)`` of each closed span, on the µs of the
    trace that started at ``trace_start_ns``."""
    return [(s.name, (s.start_ns - trace_start_ns) * 1e-3,
             (s.end_ns - trace_start_ns) * 1e-3)
            for s in spans if s.end_ns is not None]


def device_seconds(ops, spans) -> dict:
    """For each span name of ``spans`` (``(name, start_us, end_us)``), the
    device seconds of the operations of ``ops`` (``launched_ops``) whose
    launch starts inside one of its occurrences; each operation counts
    once a name, under every name whose occurrence holds its launch."""
    by_name = defaultdict(list)
    for name, s, e in spans:
        by_name[name].append((s, e))
    out = {}
    for name, ivs in by_name.items():
        merged = []
        for s, e in sorted(ivs):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        starts = [s for s, _ in merged]
        total = 0.0
        for _, t, s, e in ops:
            if t is None:
                continue
            k = bisect.bisect_right(starts, t) - 1
            if k >= 0 and t <= merged[k][1]:
                total += e - s
        out[name] = total * 1e-6
    return out


def per_step(taken: dict, skip=()) -> dict:
    """From ``Recorder.take()``: ``host_s``, each span name's host seconds
    in each step that holds it (its occurrences in the step summed), and
    ``counts``, each outermost span name's counter changes in each of its
    occurrences. A step whose outermost span overlaps an interval of
    ``skip`` (``(start_ns, end_ns)``, such as the profiled sub-window) is
    left out; so is a span still open."""
    spans = taken["spans"]
    roots = {i: s for i, s in enumerate(spans) if s.parent is None}
    index = {s.step: i for i, s in roots.items()}  # a root's own step id

    def kept(step):
        root = roots.get(index.get(step))
        return root is not None and root.end_ns is not None and not any(
            root.start_ns < b and a < root.end_ns for a, b in skip)

    host = defaultdict(lambda: defaultdict(float))  # name -> step -> s
    for s in spans:
        if s.end_ns is not None and kept(s.step):
            host[s.name][s.step] += (s.end_ns - s.start_ns) * 1e-9
    counts = defaultdict(list)
    for s in roots.values():
        if kept(s.step):
            counts[s.name].append(taken["counts"].get(s.step, {}))
    return {"host_s": {n: list(v.values()) for n, v in host.items()},
            "counts": dict(counts)}
