"""device_idle.train (%): the share of a training step's time in which no
device operation runs: one less the device time a step in the traced
sub-window (the union of its operations' intervals) over the median step
time of the same run's steps outside it."""

import statistics


def read(rec):
    prof = rec.get("profile")
    steps = rec.get("step_s") or []
    if not prof or not prof["steps"] or not steps:
        return None
    step = statistics.median(steps)
    return 100 * (1 - prof["busy_s"] / prof["steps"] / step)
