"""mfu.train (%): a training step's model FLOPs (``cost.mla_train_flops``:
6·N·T over the weights that enter a product, the tied head once, plus the
attention's forward and backward over the causal pairs; no recompute) over
the median step time of the traced run's steps outside the profiled ones,
against the data sheet's float32 rate."""

import statistics

from portbench import cost


def read(rec):
    peak = cost.peaks(rec["device_kind"])
    steps = rec.get("step_s") or []
    if not peak or not steps:
        return None
    tr = rec["cell"]["traffic"]
    flops = cost.mla_train_flops(rec["sizes"], int(tr["batch"]),
                                 int(tr["seq_len"]))
    return 100 * flops / statistics.median(steps) / peak["f32_flops_per_s"]
