"""Plain torch version of the histogram kernel (``csrc/histogram.cu``).

Same function as ``kernel.histogram``: indices outside ``[0, n_bins)``
are dropped, the rest counted in integers (``torch.bincount``) and the
counts rounded to float32 once. So it equals the CUDA kernel bit for bit
at any size, and the JAX package's kernel and oracle wherever a bin
holds at most 2**24 (above that those two add 1.0 in float32 and round
differently from each other). The tests run it on the CPU against the
JAX package's kernel; on the card it is what the CUDA kernel is compared
with.
"""

from __future__ import annotations

import torch


def histogram_ref(data, *, n_bins: int):
    """``(N,)`` bin indices (cast to int32, as the reference does) →
    ``(n_bins,)`` float32 counts."""
    d = data.to(torch.int32)
    d = d[(d >= 0) & (d < n_bins)]
    return torch.bincount(d, minlength=n_bins).to(torch.float32)
