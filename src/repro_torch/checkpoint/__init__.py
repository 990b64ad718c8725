"""Atomic checkpoints in the reference's layout (``manager``); host code."""
