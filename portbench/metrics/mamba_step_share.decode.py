"""mamba_step_share.decode (%): the device time a decode step launched
under the program's ``mamba.scan`` and ``decode.state_write`` spans (the
conv, the Mamba-1 recurrence and its skip and gate, and the state written
back into the cache: what a fused step kernel would replace), over the
mean step time outside the profiled sub-window. A device operation counts
when its launch starts inside one of the spans (``spans.device_seconds``)."""

NAMES = ("mamba.scan", "decode.state_write")


def read(rec):
    prof = rec.get("profile")
    step = rec.get("steady_step_s")
    got = (prof or {}).get("program_device_s") or {}
    if not prof or not prof["steps"] or not step or NAMES[0] not in got:
        return None
    return 100 * sum(got.get(n, 0.0) for n in NAMES) / prof["steps"] / step
