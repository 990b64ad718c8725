"""Plain torch version of the forwarding kernel
(``csrc/fused_stream.cu``).

Same signature and result as ``kernel.fused_stream``: the youngest
*valid* producer among the ``lookback`` entries just below the
consumer's frontier with a matching address forwards its value;
otherwise the value is read from memory. Candidate and memory indices
clip into range, as ``jnp.take(mode="clip")`` does in the reference.
The tests run it on the CPU against the JAX package's kernel; on the
card it is what the CUDA kernel is compared with.
"""

from __future__ import annotations

import torch


def fused_stream_ref(src_addr, src_val, frontier, dst_addr, memory,
                     src_valid=None, lookback: int = 1):
    """Returns ``(values, hits)``: ``(D,)`` of ``src_val``'s dtype and
    ``(D,)`` bool."""
    f = frontier.to(torch.int32).long()
    a = dst_addr.to(torch.int32)
    src = src_addr.to(torch.int32)
    s = src.shape[0]
    found = torch.zeros(a.shape, dtype=torch.bool, device=a.device)
    val = torch.zeros(a.shape, dtype=src_val.dtype, device=a.device)
    if s > 0:
        ok_bits = (
            torch.ones(s, dtype=torch.bool, device=a.device)
            if src_valid is None else src_valid.to(torch.int32) == 1
        )
        for lb in range(lookback):
            idx = f - 1 - lb
            c = idx.clamp(0, s - 1)
            match = (idx >= 0) & (src[c] == a) & ok_bits[c]
            val = torch.where(match & ~found, src_val[c], val)
            found = found | match
    mem_val = memory[a.long().clamp(0, memory.shape[0] - 1)]
    return torch.where(found, val, mem_val), found
