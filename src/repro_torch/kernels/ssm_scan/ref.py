"""Plain versions of the Mamba-1 selective-scan kernel (``csrc/ssm_scan.cu``).

``selective_scan_ref`` is the kernel's function in plain torch, batched,
with an initial state: for every batch row ``b``, channel ``d`` and state
``j``, from ``h = h0`` (zeros when ``h0`` is None),

    h[t] = exp(a_neg · dt[t]) · h[t-1] + (dt[t] · x[t]) · B[t]
    y[t] = Σ_j C[t, j] · h[t, ·, j]

in float32, ``y`` in ``xi``'s dtype, and it returns ``(y, h_final)``. It
keeps the TPU kernel's association ``(dt·x)·B``
(``src/repro/kernels/ssm_scan/kernel.py``); the model's chunked scan in
the reference computes ``(dt·B)·x``, which differs at rounding level.

``ssm_scan_ref`` is the reference's per-sample oracle, ``(S, di)`` in,
``y`` out, from a zero state. The tests run both on the CPU against the
JAX package; on the card they are what the CUDA kernel is compared with.
The sum over the state and the exponential are torch's, so kernel and
plain version agree to a tolerance, not bit for bit.
"""

from __future__ import annotations

import torch


def selective_scan_ref(xi, dt, bmat, cmat, a_neg, h0=None):
    """xi, dt ``(B, S, di)``; bmat, cmat ``(B, S, n)``; a_neg ``(di, n)``;
    h0 ``(B, di, n)`` or None → ``(y (B, S, di) in xi's dtype,
    h_final (B, di, n) float32)``."""
    b, s, di = xi.shape
    n = a_neg.shape[1]
    h = (torch.zeros((b, di, n), dtype=torch.float32, device=xi.device)
         if h0 is None else h0.float())
    x, d, bm, cm = (t.float() for t in (xi, dt, bmat, cmat))
    a = a_neg.float()
    ys = []
    for t in range(s):
        a_t = torch.exp(a[None] * d[:, t, :, None])
        bx_t = (d[:, t] * x[:, t])[:, :, None] * bm[:, t, None, :]
        h = a_t * h + bx_t
        ys.append((h * cm[:, t, None, :]).sum(-1))
    y = (torch.stack(ys, dim=1) if ys
         else torch.zeros((b, 0, di), dtype=torch.float32, device=xi.device))
    return y.to(xi.dtype), h


def ssm_scan_ref(xi, dt, bmat, cmat, a_neg):
    """The reference's oracle: one sample, xi/dt ``(S, di)``, bmat/cmat
    ``(S, n)`` → y ``(S, di)`` in xi's dtype, from a zero state."""
    y, _ = selective_scan_ref(xi[None], dt[None], bmat[None], cmat[None],
                              a_neg)
    return y[0]
