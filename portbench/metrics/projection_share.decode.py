"""projection_share.decode (%): the device time a decode step launched
under the program's ``mamba.in_proj``, ``mamba.out_proj`` and
``decode.head`` spans (cuBLAS's products of every layer and the head),
over the mean step time outside the profiled sub-window
(``spans.device_seconds``)."""

NAMES = ("mamba.in_proj", "mamba.out_proj", "decode.head")


def read(rec):
    prof = rec.get("profile")
    step = rec.get("steady_step_s")
    got = (prof or {}).get("program_device_s") or {}
    if not prof or not prof["steps"] or not step or NAMES[0] not in got:
        return None
    return 100 * sum(got.get(n, 0.0) for n in NAMES) / prof["steps"] / step
