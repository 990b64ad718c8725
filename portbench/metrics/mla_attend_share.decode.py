"""mla_attend_share.decode (%): the device time a decode step launched
under the program's ``mla.attend`` span (``layers.mla_apply``'s cached
branch: the query through ``W_uk``, the latent scores, the softmax, the
context and ``W_uv``), over the mean step time outside the profiled
sub-window (``spans.device_seconds``)."""

NAME = "mla.attend"


def read(rec):
    prof = rec.get("profile")
    step = rec.get("steady_step_s")
    got = (prof or {}).get("program_device_s") or {}
    if not prof or not prof["steps"] or not step or NAME not in got:
        return None
    return 100 * got[NAME] / prof["steps"] / step
