"""forward_share.train (%): the device time a training step launched under
the program's ``train.forward`` span (the loss, ``transformer.loss_fn``:
the forward under ``layers.remat``), over the median step time of the
run's steps outside the profiled ones. A device operation counts when its
launch starts inside the span, on any thread (``spans.device_seconds``)."""

import statistics

NAME = "train.forward"


def read(rec):
    prof = rec.get("profile")
    steps = rec.get("step_s") or []
    got = (prof or {}).get("program_device_s") or {}
    if not prof or not prof["steps"] or not steps or NAME not in got:
        return None
    return 100 * got[NAME] / prof["steps"] / statistics.median(steps)
