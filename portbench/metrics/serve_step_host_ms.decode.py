"""serve_step_host_ms.decode (ms): the host's time inside the program's
``serve.step`` span, the median over the steps outside the profiled
sub-window (``spans.per_step``). The program's twin of
``step_enqueue_ms.decode``, which the harness takes around the call."""

import statistics


def read(rec):
    xs = ((rec.get("program") or {}).get("host_s") or {}).get("serve.step")
    return statistics.median(xs) * 1e3 if xs else None
