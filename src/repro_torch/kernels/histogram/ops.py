"""Public histogram wrappers (hist+add benchmark: two fused histograms
plus the addition loop, all waves in one pass)."""

import torch

from repro_torch.device import resolve_device
from repro_torch.kernels.histogram.kernel import histogram
from repro_torch.kernels.histogram.ref import histogram_ref

__all__ = ["histogram", "histogram_ref", "hist_add"]


def hist_add(d1, d2, *, n_bins, device="cuda"):
    """The full hist+add benchmark, dynamically fused: both histograms
    and the addition execute as one fused program (the FUS2 pipeline of
    paper Table 1). Returns ``(n_bins,)`` float32 on ``device``.

    ``d1`` and ``d2`` are numpy arrays or tensors, moved to ``device``.
    ``"cuda"`` (the default) launches the kernel twice and raises
    ``RuntimeError`` without a card; ``"cpu"`` runs the plain version,
    for tests. The reference's ``interpret=`` and ``use_kernel=`` have
    no counterpart: the device decides, and nothing on the card runs the
    plain version."""
    dev = resolve_device(device, "hist_add")
    h1 = histogram(torch.as_tensor(d1, device=dev), n_bins=n_bins)
    h2 = histogram(torch.as_tensor(d2, device=dev), n_bins=n_bins)
    return h1 + h2
