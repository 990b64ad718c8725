"""step_enqueue_ms.decode (ms): the host's time inside one call of the
serve step, no synchronise around it: the median over the traced run's
steps outside the profiler's sub-window. Where it exceeds the device's
time a step, the host sets the pace."""

import statistics


def read(rec):
    xs = rec.get("step_enqueue_s") or []
    return statistics.median(xs) * 1e3 if xs else None
