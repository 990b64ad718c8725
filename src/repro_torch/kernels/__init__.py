"""Hand-written Hopper kernels of the port, one directory per ported
TPU kernel, each with ``kernel.py`` (the wrapper), ``ref.py`` (its plain
torch version), ``ops.py`` (its driver) and ``csrc/`` (the CUDA source)."""
