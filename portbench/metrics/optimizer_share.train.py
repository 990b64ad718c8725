"""optimizer_share.train (%): the device time of the kernels launched
inside ``optim.adamw.apply_updates`` (a ``record_function`` span the
harness puts around that call in the traced run), a step, over the median
step time of the traced run's steps outside the profiled ones."""

import statistics

SPAN = "adamw.apply_updates"


def read(rec):
    prof = rec.get("profile")
    steps = rec.get("step_s") or []
    if not prof or not prof["steps"] or not steps:
        return None
    span = prof["span_device_s"].get(SPAN)
    if not span:
        return None
    return 100 * span / prof["steps"] / statistics.median(steps)
