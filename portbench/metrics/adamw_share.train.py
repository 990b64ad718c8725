"""adamw_share.train (%): the device time a training step launched under
the program's ``train.optimizer`` span (``adamw.apply_updates``), over the
median step time of the run's steps outside the profiled ones: the
program's twin of ``optimizer_share.train``, which reads a span the
harness puts around the same call (``spans.device_seconds``)."""

import statistics

NAME = "train.optimizer"


def read(rec):
    prof = rec.get("profile")
    steps = rec.get("step_s") or []
    got = (prof or {}).get("program_device_s") or {}
    if not prof or not prof["steps"] or not steps or NAME not in got:
        return None
    return 100 * got[NAME] / prof["steps"] / statistics.median(steps)
