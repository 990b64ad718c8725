"""Where the port's entry points run: on the card unless the caller
asks for the CPU.

``resolve_device`` is shared by every entry point that takes a
``device=`` keyword. ``"cuda"`` is the default everywhere and raises
``RuntimeError`` when no card is present: nothing switches to the CPU by
itself. ``"cpu"`` runs the kernels' plain torch versions and is meant for
tests.
"""

from __future__ import annotations

import torch


def resolve_device(device, what: str = "repro_torch") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a
    CUDA device when no card is present (never falls back to the CPU),
    and ``ValueError`` for any device other than CUDA or the CPU.
    ``what`` names the caller in the message."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}: device 'cuda' requested but no CUDA device is "
                "available (device='cpu' runs the plain torch version and "
                "is meant for tests)"
            )
    elif dev.type != "cpu":
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev
