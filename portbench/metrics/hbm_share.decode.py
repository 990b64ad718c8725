"""hbm_share.decode (%): the bytes bound of a decode step
(``cost.mamba1_decode_bytes`` at the data sheet's HBM rate) over the mean
step time outside the profiled sub-window."""

from portbench import cost


def read(rec):
    peak = cost.peaks(rec["device_kind"])
    step = rec.get("steady_step_s")
    if not peak or not step:
        return None
    bound = cost.mamba1_decode_bytes(rec["sizes"], rec["batch"]) / \
        peak["hbm_bytes_per_s"]
    return 100 * bound / step
