"""Plain torch version of the hazard frontier kernel
(``csrc/du_hazard.cu``).

Same signature and result as ``kernel.hazard_frontier_batch``: per row
``k`` and consumer lane ``j``, the count of ``src[k, i] <= dst[k, j]``
(``side="right"``) or ``<`` (``side="left"``), as int32. A count, not a
search: for a non-decreasing row it equals ``searchsorted``, and it is
defined for any row. The compare matrix is built over chunks of ``dst``
so memory stays bounded. The tests run it on the CPU against the JAX
package's kernel; on the card it is what the CUDA kernel is compared
with.
"""

from __future__ import annotations

import torch

SIDES = ("right", "left")
_CHUNK_ELEMS = 1 << 26  # compare-matrix elements per chunk (64 MB of bool)


def hazard_frontier_batch_ref(src_addr, dst_addr, side: str = "right"):
    """``(K, S)`` × ``(K, D)`` int32 → ``(K, D)`` int32 counts."""
    assert side in SIDES, side
    k, s = src_addr.shape
    d = dst_addr.shape[1]
    src = src_addr.to(torch.int32)
    dst = dst_addr.to(torch.int32)
    out = torch.zeros((k, d), dtype=torch.int32, device=src.device)
    if k == 0 or s == 0:
        return out
    step = max(1, _CHUNK_ELEMS // (k * s))
    for j0 in range(0, d, step):
        blk = dst[:, j0:j0 + step, None]
        below = (src[:, None, :] < blk) if side == "left" else (
            src[:, None, :] <= blk
        )
        out[:, j0:j0 + step] = below.sum(dim=2, dtype=torch.int32)
    return out


def hazard_frontier_ref(src_addr, dst_addr, side: str = "right"):
    """The ``K = 1`` row of ``hazard_frontier_batch_ref``: ``(S,)`` ×
    ``(D,)`` → ``(D,)``."""
    return hazard_frontier_batch_ref(
        src_addr[None, :], dst_addr[None, :], side=side
    )[0]
