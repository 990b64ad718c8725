"""Dropless mixture-of-experts FFN over a monotonic dispatch stream, on
the grouped expert matmul kernel (K9): ``monotonic_dispatch``,
``moe_ffn`` and ``group_matmul`` (``ops.py``); the plain torch version
in ``ref.py``."""
