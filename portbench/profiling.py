"""A traced sub-window: ``torch.profiler`` over some steps of a run, and
what the readers take from it.

``Trace.collect``, after the window, keeps the device's operations
(kernels, copies, fills; the profiler's own annotations left out) as
``(name, start_us, end_us)``, the host's operations likewise, the device
time of the kernels launched inside each named ``record_function`` span,
and the sub-window's wall time (host clock, from a synchronise before its
first step to one after its last). Busy time is the union of the device
operations' intervals.
"""

from __future__ import annotations

import time
from collections import defaultdict

import torch


class Trace:
    def __init__(self, device, spans=()):
        self.device = device
        self.spans = tuple(spans)
        self.prof = None

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize(self.device)
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self.t0 = time.perf_counter()

    def stop(self, steps: int):
        """End the sub-window after ``steps`` steps; its events are read
        later (``collect``), outside the measured window."""
        torch.cuda.synchronize(self.device)
        self.wall = time.perf_counter() - self.t0
        self.steps = steps
        self.prof.__exit__(None, None, None)

    @property
    def running(self) -> bool:
        return self.prof is not None and not hasattr(self, "wall")

    def collect(self) -> dict:
        from torch.autograd import DeviceType

        device_ops, host_ops, span_us = [], [], defaultdict(float)
        for e in self.prof.events():
            annotation = getattr(e, "is_user_annotation", False)
            r = (e.name, e.time_range.start, e.time_range.end)
            if e.device_type == DeviceType.CUDA:
                if not annotation:
                    device_ops.append(r)
            else:
                host_ops.append(r)
                if annotation and e.name in self.spans:
                    span_us[e.name] += e.device_time_total
        self.prof = None
        device_ops.sort(key=lambda r: r[1])
        return {"steps": self.steps, "window_s": self.wall,
                "device_ops": device_ops, "host_ops": host_ops,
                "span_device_s": {k: v * 1e-6 for k, v in span_us.items()},
                "busy_s": busy_us(device_ops) * 1e-6}


def busy_us(ops) -> float:
    """The union of the intervals of ``ops``, sorted by start, in µs."""
    total, end = 0.0, float("-inf")
    for _, s, e in ops:
        if e > end:
            total += e - max(s, end)
            end = e
    return total


def kernel_seconds(profile: dict, contains: str) -> float:
    """The device seconds of the operations whose name holds ``contains``."""
    return sum(e - s for n, s, e in profile["device_ops"]
               if contains in n) * 1e-6


def top_ops(profile: dict, k: int = 10) -> list:
    """``[name, seconds]`` of the ``k`` device operations that took the
    most time in all, by name."""
    by = defaultdict(float)
    for n, s, e in profile["device_ops"]:
        by[n] += (e - s) * 1e-6
    ranked = sorted(by.items(), key=lambda x: -x[1])[:k]
    return [[n[:120], t] for n, t in ranked]


def _host_at(profile: dict, t_us: float) -> str:
    """What the host ran at ``t_us``: the outermost span and the innermost
    operation (CUDA runtime calls left out) that held that time."""
    around = [(n, s, e) for n, s, e in profile["host_ops"]
              if s <= t_us <= e and not n.startswith("cuda")]
    if not around:
        return "host: no traced operation"
    outer = min(around, key=lambda r: r[1])
    inner = max(around, key=lambda r: r[1])
    return outer[0] if outer is inner else f"{outer[0]} / {inner[0]}"


def idle_gaps(profile: dict, k: int = 10) -> list:
    """``[label, seconds]`` of the ``k`` longest spans in which the device
    ran nothing, each labelled by what the host ran at its middle."""
    gaps, end = [], None
    for _, s, e in profile["device_ops"]:
        if end is not None and s > end:
            gaps.append((s - end, end, s))
        end = e if end is None else max(end, e)
    gaps.sort(reverse=True)
    return [[_host_at(profile, (a + b) / 2)[:120], g * 1e-6]
            for g, a, b in gaps[:k]]
