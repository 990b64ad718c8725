"""Hand-written Hopper kernels of the port, one directory per ported
TPU kernel, each with ``kernel.py`` (the wrapper), ``ref.py`` (its plain
torch version), ``ops.py`` (its driver) and ``csrc/`` (the CUDA source);
``dynloop/`` holds the numpy oracles of the speculative and streaming
programs, and no kernel."""
