"""Attention on two CUDA kernels: blocked causal flash attention (K6,
the prefill) and single-token decode attention against a KV cache (K7),
``ops.py``; the plain torch versions in ``ref.py``."""
