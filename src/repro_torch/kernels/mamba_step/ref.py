"""Plain version of the Mamba-1 decode-step kernel (``csrc/mamba_step.cu``).

``mamba_step_ref`` is the kernel's function in plain torch: one recurrent
step of a layer, from the input projection ``xz = [x | z]`` ``(B, 2 di)``
through the gate, with the conv window ``(B, K-1, di)`` and the state
``(B, di, n)`` updated in place, as ``models.ssm.mamba_apply`` computes them
for S = 1 (its conv, ``_mamba1_step``, the skip and ``* silu(z)``), in
float32:

    xi  = silu(sum_i win[:, i] * conv_w[i] + conv_b),  win = [window, x]
    B, C = (xi @ w_bc)[:, :n], [:, n:];  dt = softplus(xi @ w_dt + dt_bias)
    h   = exp(-exp(a_log) * dt) * h + (dt * B) * xi
    y   = (sum_j h[..., j] * C[:, j] + d_skip * xi) * silu(z)

The tests run it on the CPU against the model's step; on the card it is
what the kernel is compared with. The projections' sums and the
exponentials are torch's, so kernel and plain version agree to a
tolerance, not bit for bit.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def mamba_step_ref(xz, conv, h, conv_w, conv_b, w_bc, w_dt, dt_bias, a_log,
                   d_skip):
    """xz ``(B, 2 di)``; conv ``(B, K-1, di)`` and h ``(B, di, n)``,
    overwritten with the new window and state; conv_w ``(K, di)``; conv_b,
    dt_bias, d_skip ``(di,)``; w_bc ``(di, 2n)``; w_dt ``(di, 1)``; a_log
    ``(di, n)`` → y ``(B, di)``."""
    di, n = h.shape[1], h.shape[2]
    x, z = xz[:, :di], xz[:, di:]
    win = torch.cat([conv, x[:, None, :]], dim=1)
    xi = F.silu(sum(win[:, i] * conv_w[i] for i in range(win.shape[1]))
                + conv_b)
    conv.copy_(win[:, 1:])
    bc = xi @ w_bc
    dt = F.softplus(xi @ w_dt + dt_bias)
    a = torch.exp(-torch.exp(a_log)[None] * dt[..., None])
    h_new = a * h + (dt[..., None] * bc[:, None, :n]) * xi[..., None]
    h.copy_(h_new)
    y = torch.einsum("bdn,bn->bd", h_new, bc[:, n:]) + xi * d_skip
    return y * F.silu(z)
