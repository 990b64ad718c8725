"""k9_roofline.decode (%): K9's share of its bound in a decode step of an
MLA stack with MoE layers: the larger of its FLOPs at the data sheet's
3xTF32 rate (a third of TF32's: K9 computes each float32 product as three
TF32 ones) and its bytes at the HBM rate (``cost_mla_moe.k9_decode_work``:
three grouped products a MoE layer over the batch's routed rows, every
expert's weights read once), over the device time of the kernels named
``gmm_tf32_kernel`` or ``group_matmul_kernel`` in the traced steps. None
where no K9 kernel ran."""

from portbench import cost, cost_mla_moe
from portbench.profiling import kernel_seconds

NAMES = ("gmm_tf32_kernel", "group_matmul_kernel")


def read(rec):
    prof = rec.get("profile")
    peak = cost.peaks(rec["device_kind"])
    if not prof or not prof["steps"] or not peak:
        return None
    took = sum(kernel_seconds(prof, n) for n in NAMES)
    if not took:
        return None
    work = cost_mla_moe.k9_decode_work(rec["sizes"], rec["batch"])
    bound = max(work["flops"] / peak["three_tf32_flops_per_s"],
                work["bytes"] / peak["hbm_bytes_per_s"])
    return 100 * bound * prof["steps"] / took
