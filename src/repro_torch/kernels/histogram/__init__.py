"""Histogram of int32 bin indices (the substrate of hist+add) on a CUDA
kernel: ``histogram`` and ``hist_add`` (``ops.py``); the plain torch
version in ``ref.py``."""
