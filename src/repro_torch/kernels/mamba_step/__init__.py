"""One Mamba-1 decode step of a layer on a CUDA kernel (K10):
``mamba_step`` and ``takes`` (``kernel.py``); the plain torch version in
``ref.py``."""
