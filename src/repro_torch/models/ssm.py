"""Mamba-1 blocks: the selective scan over a sequence on K8, and the
recurrent decode step.

The port of the Mamba-1 half of ``src/repro/models/ssm.py``. Parameters
are a dict with the reference's key names and shapes. Over a sequence
(S > 1), ``_mamba1_chunked`` computes the input projections, B, C and
the step sizes for the whole sequence and runs the scan as one call of
``kernels.ssm_scan.selective_scan``: one launch of K8 per layer on the
card, its plain version on the CPU. The reference instead loops over
chunks of ``ssm_chunk`` positions in ``lax.scan`` (the chunk is the RAW
frontier of DESIGN.md §3.3, the state stored by one chunk and loaded by
the next); the kernel walks all positions itself, so the port takes any
S, where the reference needs S to divide by the chunk. Decode (S = 1) is
the O(1) recurrent step on the carried ``(conv window, h state)``.

The Mamba-2 (SSD) form that zamba2-7b's hybrid stack uses has no kernel
and is not ported yet: it raises ``NotImplementedError`` naming ROADMAP
queue 1, item 12b.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_scan.kernel import selective_scan
from repro_torch.models.layers import Dtypes, _init


def _require_mamba1(cfg: ArchConfig) -> None:
    if cfg.ssm != "mamba1":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.ssm} (SSD) block of zamba2's hybrid stack "
            "is not ported yet (ROADMAP queue 1, item 12b); the port runs "
            "Mamba-1")


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def mamba_init(generator, cfg: ArchConfig, dt: Dtypes, device):
    """Mamba-1 parameters; ``a_log`` is the deterministic S4D-real init
    ``log(1..n)`` for every channel, not a draw."""
    _require_mamba1(cfg)
    d = cfg.d_model
    di = cfg.expand * d
    n = cfg.ssm_state
    f32 = dict(dtype=torch.float32, device=device)
    a_log = torch.log(torch.arange(1, n + 1, **f32)).expand(di, n)
    return {
        "w_in": _init(generator, (d, 2 * di), d ** -0.5, dt.param, device),
        "conv_w": _init(generator, (cfg.d_conv, di), 0.5, dt.param, device),
        "conv_b": torch.zeros(di, dtype=dt.param, device=device),
        "w_out": _init(generator, (di, d), di ** -0.5, dt.param, device),
        "a_log": a_log.contiguous(),
        "w_bc": _init(generator, (di, 2 * n), di ** -0.5, dt.param, device),
        "w_dt": _init(generator, (di, 1), di ** -0.5, dt.param, device),
        "dt_bias": torch.zeros(di, **f32),
        "d_skip": torch.ones(di, **f32),
    }


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------


def _causal_conv(x, w, b, state=None):
    """x ``(B, S, di)``; w ``(K, di)``; state ``(B, K-1, di)`` carried for
    decode. Returns ``(out, new_state)``, the new state being the last
    K-1 inputs."""
    k = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    out = sum(xp[:, i:i + s, :] * w[i].to(x.dtype) for i in range(k))
    return out + b.to(x.dtype), xp[:, -(k - 1):, :]


# ---------------------------------------------------------------------------
# mamba1: the scan over a sequence (K8) and the recurrent step
# ---------------------------------------------------------------------------


def _projections(p, xi, n):
    """B, C ``(..., n)`` and the step sizes ``(..., di)``, float32."""
    bc = xi @ p["w_bc"].to(xi.dtype)
    bmat, cmat = bc[..., :n].float(), bc[..., n:].float()
    dt_ = F.softplus((xi @ p["w_dt"].to(xi.dtype)).float() + p["dt_bias"])
    return bmat, cmat, dt_


def _mamba1_chunked(p, xi, cfg: ArchConfig, h0, chunk: int):
    """xi ``(B, S, di)`` post-conv/silu, h0 ``(B, di, n)`` → ``(y (B, S,
    di) float32, h_final)``. ``chunk`` is the reference's scan chunk; the
    kernel needs none, so it changes nothing here."""
    del chunk
    bmat, cmat, dt_ = _projections(p, xi, cfg.ssm_state)
    a_neg = -torch.exp(p["a_log"])
    return selective_scan(xi.float(), dt_, bmat, cmat, a_neg, h0)


def _mamba1_step(p, xi_t, h):
    """One recurrent step: xi_t ``(B, di)``, h ``(B, di, n)`` → ``(y (B,
    di), h_new)``."""
    bmat, cmat, dt_ = _projections(p, xi_t, h.shape[-1])
    a = torch.exp(-torch.exp(p["a_log"])[None] * dt_[..., None])
    bx = (dt_[..., None] * bmat[:, None, :]) * xi_t.float()[..., None]
    h_new = a * h + bx
    y = torch.einsum("bdn,bn->bd", h_new, cmat)
    return y, h_new


# ---------------------------------------------------------------------------
# public block API
# ---------------------------------------------------------------------------


def mamba_apply(p, x, cfg: ArchConfig, *, state=None):
    """x ``(B, S, d)``. ``state``: None for a prompt from a zero state,
    else a dict with ``conv`` ``(B, K-1, di)`` and ``h`` ``(B, di, n)``.
    Returns ``(y, new_state)``."""
    _require_mamba1(cfg)
    b, s, d = x.shape
    di = cfg.expand * d
    n = cfg.ssm_state

    xz = x @ p["w_in"].to(x.dtype)
    xi, z = xz[..., :di], xz[..., di:]
    conv_state = None if state is None else state["conv"]
    xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)
    xi = F.silu(xi)

    h0 = (torch.zeros((b, di, n), dtype=torch.float32, device=x.device)
          if state is None else state["h"])
    if s == 1:
        y, new_h = _mamba1_step(p, xi[:, 0], h0)
        y = y[:, None, :]
    else:
        y, new_h = _mamba1_chunked(p, xi, cfg, h0, cfg.ssm_chunk)
    y = y + xi.float() * p["d_skip"][None, None, :]
    y = (y.to(x.dtype) * F.silu(z)) @ p["w_out"].to(x.dtype)
    return y, {"conv": new_conv, "h": new_h}


def mamba_init_state(cfg: ArchConfig, batch: int, *, device,
                     dtype=torch.float32):
    """The zeroed decode state: ``conv`` ``(batch, K-1, di)`` in
    ``dtype`` and ``h`` ``(batch, di, n)`` float32."""
    _require_mamba1(cfg)
    di = cfg.expand * cfg.d_model
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                         device=device),
    }
