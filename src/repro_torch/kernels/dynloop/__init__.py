"""Load-dependent-trip kernel oracles (`ref.py`).

Pure-numpy references for the loss-of-decoupling kernels in
``repro_torch.core.programs`` (``spmv_ldtrip``, ``bfs_front``,
``chase_sum``) — an independent second oracle next to
``loopir.interpret`` for the speculative-AGU workloads (DESIGN.md §10).
"""
