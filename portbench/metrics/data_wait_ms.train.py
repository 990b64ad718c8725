"""data_wait_ms.train (ms): the host's time inside the program's
``train.data`` span (``FaultTolerantLoop.run``'s ``next`` of the loader,
a re-fetch after a restore included) a step, the median over the steps
outside the profiled ones (``spans.per_step``)."""

import statistics


def read(rec):
    xs = ((rec.get("program") or {}).get("host_s") or {}).get("train.data")
    return statistics.median(xs) * 1e3 if xs else None
