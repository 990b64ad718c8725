"""k6_roofline.train (%): K6's share of its bound at the cell's shapes:
the larger of its FLOPs at the data sheet's 3xTF32 rate (a third of
TF32's: K6 computes each float32 product as three TF32 ones) and its
bytes at the HBM rate (``cost.k6_train_work``: the forward and the
recomputed forward, 2·dk + 2·dv a causal pair and head), over the device
time of the kernels named ``flash_kernel`` in the traced steps."""

from portbench import cost
from portbench.profiling import kernel_seconds


def read(rec):
    prof = rec.get("profile")
    peak = cost.peaks(rec["device_kind"])
    if not prof or not prof["steps"] or not peak:
        return None
    took = kernel_seconds(prof, "flash_kernel")
    if not took:
        return None
    tr = rec["cell"]["traffic"]
    work = cost.k6_train_work(rec["sizes"], int(tr["batch"]),
                              int(tr["seq_len"]))
    bound = max(work["flops"] / peak["three_tf32_flops_per_s"],
                work["bytes"] / peak["hbm_bytes_per_s"])
    return 100 * bound * prof["steps"] / took
