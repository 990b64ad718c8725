"""Fused producer/consumer stream with guarded store-to-load forwarding
(paper §5.5, §6 → DESIGN.md §2) on a CUDA kernel: ``fused_stream``,
``fused_raw_loops`` and ``min_lookback`` (``ops.py``); the plain torch
version in ``ref.py``."""
