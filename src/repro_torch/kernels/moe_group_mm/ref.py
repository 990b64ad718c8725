"""Plain version of the grouped expert matmul kernel
(``csrc/moe_group_mm.cu``).

``group_matmul_ref`` is the kernel's function in plain torch, as the
reference's oracle computes it: each ``block_t`` row block's expert
weights gathered, then one batched product in float32, cast to ``x``'s
dtype. Expert ids are clipped to ``[0, E)``, as the kernel clips them.
The tests run it on the CPU against the JAX package's kernel; on the
card it is what the CUDA kernel is compared with (cuBLAS sums in another
order, so the two agree to a tolerance).
"""

from __future__ import annotations

import torch


def group_matmul_ref(x_sorted, w, block_expert, *, block_t: int = 128):
    """``(T_pad, d_in)`` rows, ``(E, d_in, d_out)`` weights and the
    expert of each row block → ``(T_pad, d_out)`` in ``x``'s dtype."""
    t_pad, d_in = x_sorted.shape
    n_blocks = t_pad // block_t
    xb = x_sorted.reshape(n_blocks, block_t, d_in).float()
    experts = block_expert[:n_blocks].long().clamp(0, w.shape[0] - 1)
    wb = w[experts].float()  # (n_blocks, d_in, d_out)
    out = torch.bmm(xb, wb)
    return out.reshape(t_pad, -1).to(x_sorted.dtype)
