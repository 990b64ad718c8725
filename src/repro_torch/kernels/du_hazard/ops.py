"""Public wrappers of the du_hazard kernel.

``hazard_frontier`` / ``hazard_frontier_batch`` — the CUDA kernel on a
CUDA tensor, its plain torch version on a CPU tensor (``kernel.py``).
``hazard_frontier_ref`` / ``hazard_frontier_batch_ref`` — the plain
versions. ``wave_partition`` — given per-pair frontiers, the earliest
wave in which all of a consumer's producers have committed: a clamped
gather, which needs no kernel of its own.
"""

import torch

from repro_torch.kernels.du_hazard.kernel import (
    hazard_frontier,
    hazard_frontier_batch,
)
from repro_torch.kernels.du_hazard.ref import (
    hazard_frontier_batch_ref,
    hazard_frontier_ref,
)

__all__ = [
    "hazard_frontier",
    "hazard_frontier_batch",
    "hazard_frontier_ref",
    "hazard_frontier_batch_ref",
    "wave_partition",
]


def wave_partition(frontiers, src_waves):
    """The wave of each dst: 1 + the wave of its last required producer
    (``src_waves[frontiers - 1]``, the index clipped into range), or 0
    when it needs none. The stall condition of the DU becomes an index
    computation (DESIGN.md §2, "stalling → partitioning")."""
    if src_waves.shape[0] == 0:  # no producers: every frontier is 0
        return torch.zeros(frontiers.shape, dtype=src_waves.dtype,
                           device=frontiers.device)
    last = (frontiers.long() - 1).clamp(0, src_waves.shape[0] - 1)
    return torch.where(frontiers > 0, src_waves[last], -1) + 1
