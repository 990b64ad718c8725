"""Where the port's entry points run: on the card unless the caller
asks for the CPU.

``resolve_device`` is shared by every entry point that takes a
``device=`` keyword. ``"cuda"`` is the default everywhere and raises
``RuntimeError`` when no card is present: nothing switches to the CPU by
itself. ``"cpu"`` runs the kernels' plain torch versions and is meant for
tests; ``"meta"`` runs them on shapes alone, for the dry run's account
(``launch/dryrun.py``). ``refuse_grad`` is the one guard every kernel wrapper without a
backward calls before it launches.
"""

from __future__ import annotations

import functools

import torch


def resolve_device(device, what: str = "repro_torch") -> torch.device:
    """``device`` as a ``torch.device``; raises ``RuntimeError`` for a
    CUDA device when no card is present (never falls back to the CPU),
    and ``ValueError`` for any device other than CUDA, the CPU or meta.
    ``what`` names the caller in the message."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"{what}: device 'cuda' requested but no CUDA device is "
                "available (device='cpu' runs the plain torch version and "
                "is meant for tests)"
            )
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"{what}: unsupported device {dev}")
    return dev


def launch(dev: torch.device, fn, *args):
    """``fn(*args, stream)`` with CUDA device ``dev`` current and
    ``stream`` the raw handle of its current stream: how a wrapper calls a
    kernel's C launcher through ctypes. The handle is what
    ``torch.cuda.current_stream(dev).cuda_stream`` gives, read without
    building a ``Stream`` object (the call Triton's launcher makes), and
    the device is switched only where another one is current; both keep
    the host's cost of a small launch down. The handle comes from
    ``torch._C._cuda_getCurrentRawStream``, a private torch API that a
    torch release may rename."""
    if dev.index == torch.cuda.current_device():
        return fn(*args, raw_stream(dev))
    with torch.cuda.device(dev):
        return fn(*args, raw_stream(dev))


def raw_stream(dev: torch.device) -> int:
    """The raw handle of CUDA device ``dev``'s current stream, the one
    ``launch`` passes (``torch._C._cuda_getCurrentRawStream``)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)


@functools.cache
def sm_count(index: int) -> int:
    """The SM count of CUDA device ``index``, asked once: K6 picks its
    tile and K7 its splits from it."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def refuse_grad(what: str, *tensors) -> None:
    """Raise ``RuntimeError`` naming kernel ``what`` when grad mode is on
    and a tensor off the CPU requires grad: a kernel that launches
    through ``ctypes`` is invisible to autograd, so its output would carry
    no ``grad_fn`` and every parameter before it would silently get no
    gradient. K6 and K8 have autograd Functions (``models.flash.flash_mha``,
    ``kernels.ssm_scan.selective_scan``); every other wrapper calls this
    before it launches. CPU tensors go to the plain versions, which
    autograd sees through."""
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad and t.device.type != "cpu"
            for t in tensors):
        raise RuntimeError(
            f"{what}: the kernel has no backward, and an input requires "
            f"grad; run it under torch.no_grad() (training reaches K6 and "
            f"K8 only, through their autograd Functions)")
