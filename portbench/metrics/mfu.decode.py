"""mfu.decode (%): a decode step's FLOPs (``cost.mamba1_decode_flops``: 2
a weight that enters a product a row, and the state update) over the
mean step time outside the profiled sub-window, against the data sheet's
float32 rate (the configuration computes in float32 with TF32 off)."""

from portbench import cost


def read(rec):
    peak = cost.peaks(rec["device_kind"])
    step = rec.get("steady_step_s")
    if not peak or not step:
        return None
    flops = cost.mamba1_decode_flops(rec["sizes"], rec["batch"])
    return 100 * flops / step / peak["f32_flops_per_s"]
