"""peak_gb.train (GB): ``torch.cuda.max_memory_allocated()`` over the
window, in 1e9 bytes."""


def read(rec):
    peak = rec.get("peak_window_bytes")
    return peak / 1e9 if peak else None
