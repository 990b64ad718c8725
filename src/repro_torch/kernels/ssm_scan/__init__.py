"""The Mamba-1 selective scan on a CUDA kernel (K8): ``ssm_scan``,
``selective_scan`` and ``ssm_scan_batched`` (``ops.py``); the plain
torch versions in ``ref.py``."""
