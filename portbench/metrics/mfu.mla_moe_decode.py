"""mfu.mla_moe_decode (%): a decode step's FLOPs over the mean step time
outside the profiled sub-window, against the data sheet's float32 rate
(the configuration computes in float32 with TF32 off). The FLOPs
(``cost_mla_moe.decode_flops``): 2 a weight a row multiplies (attention,
the dense MLPs, the router, the ``top_k`` routed and the shared experts,
the head) and the latent attention over the mean positions of the cell's
batches."""

from portbench import cost, cost_mla_moe


def read(rec):
    peak = cost.peaks(rec["device_kind"])
    step = rec.get("steady_step_s")
    if not peak or not step:
        return None
    flops = cost_mla_moe.decode_flops(rec["sizes"], rec["batch"],
                                      rec["cell"]["traffic"]["batches"])
    return 100 * flops / step / peak["f32_flops_per_s"]
