"""hbm_share.mla_moe_decode (%): the bytes bound of a decode step
(``cost_mla_moe.decode_bytes``: every weight read once, every expert
included, and the latent cache over the mean positions of the cell's
batches, at the data sheet's HBM rate) over the mean step time outside the
profiled sub-window."""

from portbench import cost, cost_mla_moe


def read(rec):
    peak = cost.peaks(rec["device_kind"])
    step = rec.get("steady_step_s")
    if not peak or not step:
        return None
    words = cost_mla_moe.decode_bytes(rec["sizes"], rec["batch"],
                                      rec["cell"]["traffic"]["batches"])
    return 100 * words / peak["hbm_bytes_per_s"] / step
