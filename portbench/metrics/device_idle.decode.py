"""device_idle.decode (%): the share of a decode step's time in which no
device operation runs: one less the device time a step in the traced
sub-window (the union of its operations' intervals) over the mean step
time of the same run's steps outside it. The profiler's callbacks slow
the host, so the sub-window's own wall time would overstate the idle
share of a host-bound step (the result's ``device`` keeps it)."""


def read(rec):
    prof = rec.get("profile")
    step = rec.get("steady_step_s")
    if not prof or not prof["steps"] or not step:
        return None
    return 100 * (1 - prof["busy_s"] / prof["steps"] / step)
