"""DU hazard frontier merge (paper §5 → DESIGN.md §2) on a CUDA kernel:
``hazard_frontier``, ``hazard_frontier_batch`` and ``wave_partition``
(``ops.py``); the plain torch versions in ``ref.py``."""
