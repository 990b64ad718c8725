"""The Mamba-1 selective scan (K8), on the card.

The port of the TPU kernel ``src/repro/kernels/ssm_scan/kernel.py``
(``_scan_kernel`` through ``ssm_scan``), written by hand in CUDA C++ for
``sm_90a`` (``csrc/ssm_scan.cu``; the design notes and the bound are
there). Two entries:

- ``ssm_scan``, the reference's per-sample signature: xi, dt ``(S, di)``,
  B, C ``(S, n)``, a_neg ``(di, n)`` → y ``(S, di)``, from a zero state;
- ``selective_scan``, the model's: batched ``(B, S, di)`` inputs and an
  initial state ``h0`` ``(B, di, n)`` (zeros when None) → ``(y,
  h_final)``, called by ``models.ssm._mamba1_chunked``.

Sizes are run-time: S need not divide by ``chunk`` nor di by
``block_d`` (the reference asserts both); ``chunk`` and ``block_d`` are
kept for the reference's signature and change nothing. The state size n
must be at most 16 on the card (``MAX_STATE``; Mamba-1's is 16).

On a CUDA tensor each entry launches the kernel, built from source at
first use (``repro_torch._build``), through
``repro_torch.device.launch``, and raises on any build or launch
failure. Only tensors on the CPU, which the tests pass, and on ``meta``
(the dry run's account) go to the plain versions in ``ref.py``. ``ssm_scan.launches`` counts the kernel's
launches through either entry; S = 0 returns without one.

``selective_scan`` is differentiable: where grad mode is on and an input
requires grad it runs ``_Scan``, an autograd Function whose forward is
the kernel (the plain version on the CPU) and whose backward recomputes
through the plain version (``scan_bwd``) in chunks of ``BWD_CHUNK``
positions, as the reference's ``jax.checkpoint`` of each chunk does
(``src/repro/models/ssm.py:135``): first the state at each chunk's start,
by one forward a chunk (the kernel on the card, so one launch for each
chunk but the last; none where S fits one chunk), then, from the last
chunk back, the chunk's plain recurrence under ``enable_grad`` and
``torch.autograd.grad`` with the cotangents of its outputs and of its end
state. That is autograd of the plain version the tests hold against the
reference, not a hand-derived formula, and its graph holds one chunk, not
the ``(B, S, di, n)`` states. It gives gradients for xi, dt, B, C, a_neg
and h0.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch import _build, device
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

MAX_STATE = 16  # kMaxN in csrc/ssm_scan.cu
BWD_CHUNK = 128  # positions a chunk of the backward (the reference's ssm_chunk)
_DTYPES = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssm_scan")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.ssm_scan_launch.argtypes = [i, p, p, p, p, p, p, p, p, i, i, i, i, p]
    lib.ssm_scan_launch.restype = i
    lib.ssm_scan_error_string.argtypes = [i]
    lib.ssm_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(xi, dt, bmat, cmat, a_neg, h0):
    """Shapes and devices of the batched entry; returns the device."""
    if xi.dim() != 3 or dt.shape != xi.shape:
        raise ValueError("selective_scan: xi and dt must be (B, S, di) alike")
    b, s, di = xi.shape
    if a_neg.dim() != 2 or a_neg.shape[0] != di:
        raise ValueError(f"selective_scan: a_neg must be ({di}, n), got "
                         f"{tuple(a_neg.shape)}")
    n = a_neg.shape[1]
    if bmat.shape != (b, s, n) or cmat.shape != (b, s, n):
        raise ValueError(f"selective_scan: B and C must be ({b}, {s}, {n})")
    if h0 is not None and h0.shape != (b, di, n):
        raise ValueError(f"selective_scan: h0 must be ({b}, {di}, {n})")
    tensors = [xi, dt, bmat, cmat, a_neg] + ([] if h0 is None else [h0])
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"selective_scan: tensors on several devices {devs}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda", "meta"):  # meta: the dry run's
        raise ValueError(f"selective_scan: unsupported device {dev}")
    return dev


def _launch(xi, dt, bmat, cmat, a_neg, h0):
    b, s, di = xi.shape
    n = a_neg.shape[1]
    if xi.dtype not in _DTYPES:
        raise TypeError(f"selective_scan: xi must be float32, float16 or "
                        f"bfloat16 on the card, got {xi.dtype}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan: state size {n} outside "
                         f"[1, {MAX_STATE}] on the card")
    if xi.numel() >= 2**31:
        raise ValueError("selective_scan: xi must hold < 2**31 elements")
    y = torch.empty_like(xi, memory_format=torch.contiguous_format)
    if b == 0 or di == 0 or s == 0:
        h = (torch.zeros((b, di, n), dtype=torch.float32, device=xi.device)
             if h0 is None else h0.float().clone())
        return y, h
    h_out = torch.empty((b, di, n), dtype=torch.float32, device=xi.device)
    x = xi.contiguous()
    d, bm, cm, a = (t.float().contiguous() for t in (dt, bmat, cmat, a_neg))
    h_in = None if h0 is None else h0.float().contiguous()
    rc = device.launch(
        xi.device, _lib().ssm_scan_launch, _DTYPES[x.dtype], x.data_ptr(),
        d.data_ptr(), bm.data_ptr(), cm.data_ptr(), a.data_ptr(),
        None if h_in is None else h_in.data_ptr(), y.data_ptr(),
        h_out.data_ptr(), b, s, di, n,
    )
    if rc != 0:
        raise RuntimeError("ssm_scan kernel launch failed: "
                           + _lib().ssm_scan_error_string(rc).decode())
    ssm_scan.launches += 1
    return y, h_out


def selective_scan(xi, dt, bmat, cmat, a_neg, h0=None):
    """xi, dt ``(B, S, di)``; bmat, cmat ``(B, S, n)``; a_neg ``(di, n)``;
    h0 ``(B, di, n)`` or None (zeros) → ``(y (B, S, di) in xi's dtype,
    h_final (B, di, n) float32)``; differentiable in every input."""
    _check(xi, dt, bmat, cmat, a_neg, h0)
    inputs = (xi, dt, bmat, cmat, a_neg, h0)
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad for t in inputs):
        return _Scan.apply(*inputs)
    return _forward(*inputs)


def _forward(xi, dt, bmat, cmat, a_neg, h0):
    if xi.device.type != "cuda":  # the CPU, or meta (shapes only)
        return selective_scan_ref(xi, dt, bmat, cmat, a_neg, h0)
    return _launch(xi, dt, bmat, cmat, a_neg, h0)


class _Scan(torch.autograd.Function):
    """K8 forward (the plain version on the CPU), chunked recompute
    backward (``scan_bwd``)."""

    @staticmethod
    def forward(ctx, xi, dt, bmat, cmat, a_neg, h0):
        ctx.save_for_backward(xi, dt, bmat, cmat, a_neg, h0)
        return _forward(xi, dt, bmat, cmat, a_neg, h0)

    @staticmethod
    def backward(ctx, gy, gh):
        return scan_bwd(*ctx.saved_tensors, gy, gh)


def scan_bwd(xi, dt, bmat, cmat, a_neg, h0, gy, gh, chunk=BWD_CHUNK):
    """Gradients of ``selective_scan`` for ``(xi, dt, bmat, cmat, a_neg,
    h0)`` (None for an absent h0) at the cotangents ``gy`` of y and ``gh``
    of h_final (either may be None): each chunk's start state from the
    forward (K8 on the card), then the plain recurrence recomputed chunk
    by chunk from the last, each chunk differentiated by autograd."""
    b, s, di = xi.shape
    n = a_neg.shape[1]
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=xi.device)
         if h0 is None else h0.detach().float())
    starts = [h]
    with torch.no_grad():
        for c0 in range(0, s - chunk, chunk):
            _, h = _forward(*(t[:, c0:c0 + chunk].detach() for t in
                              (xi, dt, bmat, cmat)), a_neg.detach(), h)
            starts.append(h)
    grads = [torch.zeros_like(t) for t in (xi, dt, bmat, cmat)]
    g_a = torch.zeros_like(a_neg)
    g_h = (torch.zeros((b, di, n), dtype=torch.float32, device=xi.device)
           if gh is None else gh.float())
    for c0, h_start in zip(reversed(range(0, s, chunk)), reversed(starts)):
        with torch.enable_grad():
            part = [t[:, c0:c0 + chunk].detach().requires_grad_()
                    for t in (xi, dt, bmat, cmat)]
            a = a_neg.detach().requires_grad_()
            h_in = h_start.requires_grad_()
            y, h_end = selective_scan_ref(*part, a, h_in)
            outs, cots = [h_end], [g_h]
            if gy is not None:
                outs.append(y)
                cots.append(gy[:, c0:c0 + chunk])
            *g_part, g_a_c, g_h = torch.autograd.grad(
                outs, part + [a, h_in], cots, allow_unused=True)
        for acc, g in zip(grads, g_part):
            if g is not None:
                acc[:, c0:c0 + chunk] = g
        g_a += g_a_c
    g_h0 = None if h0 is None else g_h.to(h0.dtype)
    return (*grads, g_a, g_h0)


def ssm_scan(xi, dt, bmat, cmat, a_neg, *, chunk: int = 128,
             block_d: int = 512):
    """The reference's signature: one sample, xi/dt ``(S, di)``,
    bmat/cmat ``(S, n)``, a_neg ``(di, n)`` → y ``(S, di)`` in xi's
    dtype, from a zero state."""
    if chunk < 1 or block_d < 1:
        raise ValueError(f"ssm_scan: chunk and block_d must be positive, "
                         f"got {chunk}, {block_d}")
    if xi.dim() != 2:
        raise ValueError("ssm_scan: xi must be (S, di)")
    y, _ = selective_scan(xi[None], dt[None], bmat[None], cmat[None], a_neg)
    return y[0]


ssm_scan.launches = 0
