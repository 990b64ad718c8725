"""Public wrappers of the fused_stream kernel: end-to-end fused
producer/consumer execution (the RAWloop pattern of paper Fig. 1, fully
vectorized), generalized to §6 guarded producer streams through
per-request valid bits and a bounded same-address lookback."""

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.du_hazard.kernel import hazard_frontier
from repro_torch.kernels.fused_stream.kernel import fused_stream
from repro_torch.kernels.fused_stream.ref import fused_stream_ref

__all__ = [
    "fused_stream", "fused_stream_ref", "fused_raw_loops", "min_lookback",
]


def min_lookback(src_addr) -> int:
    """Smallest exact ``lookback`` for a monotonic producer stream (numpy
    array or tensor): the longest run of equal addresses (a §6-invalid
    entry can hide at most run-length - 1 younger siblings; the scan
    must reach past them)."""
    if torch.is_tensor(src_addr):
        if src_addr.numel() == 0:
            return 1
        _, counts = torch.unique_consecutive(src_addr, return_counts=True)
        return int(counts.max())
    a = np.asarray(src_addr)
    if len(a) == 0:
        return 1
    starts = np.flatnonzero(np.diff(a) != 0)
    bounds = np.concatenate([[-1], starts, [len(a) - 1]])
    return int(np.diff(bounds).max())


def fused_raw_loops(
    src_addr, src_val, dst_addr, memory, src_valid=None, *,
    lookback=None, device="cuda",
):
    """The complete Fig. 1 pipeline: producer loop storing A[f(i)],
    consumer loop loading A[g(j)], fused. Frontier merge (du_hazard) +
    forwarding (fused_stream) = consumer values with zero stalls and no
    sequentialization — assuming monotonic f(i), exactly the paper's
    requirement. Consumers see the producer's final *landed* effect on
    overlapping addresses (guard-failed producers forward nothing —
    pass their §6 valid bits as ``src_valid``); untouched addresses
    come from memory.

    Inputs are numpy arrays or tensors; they are moved to ``device``
    (``"cuda"`` by default, which raises ``RuntimeError`` without a
    card; ``"cpu"`` runs the plain versions, for tests). Returns
    ``(values, hits)`` tensors on that device.

    ``lookback=None`` picks the exact depth: 1 for all-valid producers
    (the youngest entry below the frontier is the run's youngest), the
    longest same-address run otherwise — a valid producer hidden
    behind younger invalid siblings must stay reachable."""
    dev = resolve_device(device, "fused_raw_loops")
    src_addr, src_val, dst_addr, memory = (
        torch.as_tensor(x, device=dev)
        for x in (src_addr, src_val, dst_addr, memory)
    )
    if src_valid is not None:
        src_valid = torch.as_tensor(src_valid, device=dev)
    if lookback is None:
        lookback = 1 if src_valid is None else min_lookback(src_addr)
    frontier = hazard_frontier(src_addr, dst_addr)
    return fused_stream(
        src_addr, src_val, frontier, dst_addr, memory, src_valid,
        lookback=lookback,
    )
