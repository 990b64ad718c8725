"""Plain versions for the ELL SpMV kernel (``csrc/csr_spmv.cu``).

``csr_spmv_ref`` is the kernel's function in plain torch: gather ``x``
at the clipped columns, round to float32, and add the products column by
column (``w = 0 … W-1``) into a float32 accumulator that starts at 0 —
the kernel's order, so the two agree bit for bit. The result is in
``x``'s dtype. The tests run it on the CPU against the JAX package's
kernel (whose sum order XLA picks, so they agree to a tolerance); on the
card it is what the CUDA kernel is compared with.

``csr_to_ell`` is the host layout pass, in numpy: the same arrays as the
JAX package's loop over rows, built without a Python loop.
"""

from __future__ import annotations

import numpy as np
import torch


def csr_spmv_ref(cols, vals, x):
    """``(N_pad, W)`` columns and values, ``(M,)`` ``x`` → ``(N_pad,)``
    in ``x``'s dtype; columns outside ``[0, M)`` read the nearest end."""
    c = cols.to(torch.int64).clamp(0, x.shape[0] - 1)
    g = x[c].to(torch.float32)
    v = vals.to(torch.float32)
    acc = torch.zeros(cols.shape[0], dtype=torch.float32, device=x.device)
    for w in range(cols.shape[1]):
        acc = acc + v[:, w] * g[:, w]
    return acc.to(x.dtype)


def csr_to_ell(row_ptr: np.ndarray, col_idx: np.ndarray, values: np.ndarray,
               n_rows: int, block_r: int = 128):
    """Host-side CSR -> padded ELL conversion: ``(N_pad, W)`` int32
    columns and float32 values, ``W = max(1, longest row)``, rows padded
    up to a multiple of ``block_r``, pads column 0 and value 0."""
    width = max(1, int(np.max(row_ptr[1:] - row_ptr[:-1])))
    n_pad = -(-n_rows // block_r) * block_r
    cols = np.zeros((n_pad, width), dtype=np.int32)
    vals = np.zeros((n_pad, width), dtype=np.float32)
    starts = np.asarray(row_ptr[:n_rows], dtype=np.int64)
    lens = np.asarray(row_ptr[1:n_rows + 1], dtype=np.int64) - starts
    row = np.repeat(np.arange(n_rows), lens)
    pos = np.arange(len(row)) - np.repeat(np.cumsum(lens) - lens, lens)
    src = np.repeat(starts, lens) + pos
    cols[row, pos] = col_idx[src]
    vals[row, pos] = values[src]
    return cols, vals
