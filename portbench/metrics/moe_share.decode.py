"""moe_share.decode (%): the device time a decode step launched under the
program's ``moe.route``, ``moe.experts`` and ``moe.shared`` spans
(``layers.moe_apply``: the router and routing; dispatch, K9's three
grouped products and the combine; the shared experts), over the mean step
time outside the profiled sub-window. A device operation counts when its
launch starts inside one of the spans (``spans.device_seconds``)."""

NAMES = ("moe.experts", "moe.route", "moe.shared")


def read(rec):
    prof = rec.get("profile")
    step = rec.get("steady_step_s")
    got = (prof or {}).get("program_device_s") or {}
    if not prof or not prof["steps"] or not step or NAMES[0] not in got:
        return None
    return 100 * sum(got.get(n, 0.0) for n in NAMES) / prof["steps"] / step
