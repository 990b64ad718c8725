"""kernels_per_step.decode (count): the device operations a decode step
launches, from torch.profiler over the traced sub-window."""


def read(rec):
    prof = rec.get("profile")
    if not prof or not prof["steps"]:
        return None
    return len(prof["device_ops"]) / prof["steps"]
