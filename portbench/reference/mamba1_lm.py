"""A Mamba-1 language model (falcon-mamba-7b's stack, with the port's
departures listed in its configuration file), in plain PyTorch, over
whole sequences.

Each layer: ``x + out_proj((scan(silu(conv(x_in))) + D·u) · silu(z))``
of the layer's RMS-normed input, ``(x_in, z)`` its input projection; the
scan ``h_t = exp(Δ_t A) h_{t-1} + Δ_t B_t u_t``, ``y_t = C_t·h_t``, with
``A = -exp(a_log)``, ``B``, ``C`` projected from ``u``, and ``Δ =
softplus(u·w_dt + dt_bias)``, one step size a position broadcast over the
channels with a bias of each. The scan walks the positions one by one
(blocks of positions precompute the decays and inputs), from a zero
state. Then the final RMS norm and the untied head.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from portbench.reference import draw_tree, mm, operand, precision, rms_norm

SCAN_BLOCK = 64  # positions whose decays and inputs are made at once


def leaves(s: dict) -> list:
    """``(path, shape, spec)`` of every weight, in the program's layout:
    the layer weights stacked over a leading layer axis."""
    L, d, n, k = s["n_layers"], s["d_model"], s["ssm_state"], s["d_conv"]
    di, v = s["expand"] * d, s["vocab"]
    small = {"scale": 0.1}
    return [
        ("embed", (v, d), {"scale": 0.02}),
        ("final_norm", (d,), small),
        ("lm_head", (d, v), {"scale": d ** -0.5}),
        ("layers.attn_norm", (L, d), small),
        ("layers.ssm.w_in", (L, d, 2 * di), {"scale": d ** -0.5}),
        ("layers.ssm.conv_w", (L, k, di), {"scale": 0.5}),
        ("layers.ssm.conv_b", (L, di), small),
        ("layers.ssm.w_out", (L, di, d), {"scale": di ** -0.5}),
        ("layers.ssm.a_log", (L, di, n), {"scale": 0.1, "base": "log_arange"}),
        ("layers.ssm.w_bc", (L, di, 2 * n), {"scale": di ** -0.5}),
        ("layers.ssm.w_dt", (L, di, 1), {"scale": di ** -0.5}),
        ("layers.ssm.dt_bias", (L, di), small),
        ("layers.ssm.d_skip", (L, di), {"scale": 0.1, "base": 1.0}),
    ]


def draw_weights(s: dict, seed: int, device) -> dict:
    return draw_tree(leaves(s), seed, device)


def _layer(w: dict, i: int, x, s: dict, tf32: bool):
    p = {k: v[i] for k, v in w["layers"]["ssm"].items()}
    b, t, d = x.shape
    di, n, k = s["expand"] * d, s["ssm_state"], s["d_conv"]
    u_z = mm(rms_norm(x, w["layers"]["attn_norm"][i], s["norm_eps"]),
             p["w_in"], tf32)
    u, z = u_z[..., :di], u_z[..., di:]
    padded = torch.cat([u.new_zeros(b, k - 1, di), u], dim=1)
    conv = p["conv_b"] + sum(padded[:, j:j + t] * p["conv_w"][j]
                             for j in range(k))
    u = F.silu(conv)
    bc = mm(u, p["w_bc"], tf32)
    bmat, cmat = bc[..., :n], bc[..., n:]
    dt = F.softplus(mm(u, p["w_dt"], tf32) + p["dt_bias"])  # (b, t, di)
    a = -torch.exp(p["a_log"])  # (di, n)
    h = x.new_zeros(b, di, n)
    y = torch.empty_like(u)
    c_op = operand(cmat, tf32)
    for t0 in range(0, t, SCAN_BLOCK):
        t1 = min(t0 + SCAN_BLOCK, t)
        decay = torch.exp(dt[:, t0:t1, :, None] * a)
        inp = (dt[:, t0:t1] * u[:, t0:t1])[..., None] * bmat[:, t0:t1, None, :]
        for j in range(t1 - t0):
            h = torch.addcmul(inp[:, j], decay[:, j], h)
            y[:, t0 + j] = torch.bmm(operand(h, tf32),
                                     c_op[:, t0 + j, :, None])[..., 0]
    y = y + u * p["d_skip"]
    return x + mm(y * F.silu(z), p["w_out"], tf32)


def logits(w: dict, tokens: torch.Tensor, s: dict, *, first: int = 0,
           tf32: bool = False) -> torch.Tensor:
    """The logits ``(k, S - first, vocab)`` at positions ``first..S-1`` of
    token ids ``tokens`` ``(k, S)``, each from the positions up to it."""
    with precision(tf32):
        x = w["embed"][tokens.long()]
        for i in range(s["n_layers"]):
            x = _layer(w, i, x, s, tf32)
        x = rms_norm(x[:, first:], w["final_norm"], s["norm_eps"])
        return mm(x, w["lm_head"], tf32)
