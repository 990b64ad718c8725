"""Mamba-1 and Mamba-2 blocks: the selective scan over a sequence on K8
(Mamba-1), the SSD form in plain torch (Mamba-2), and the recurrent
decode steps. On DTensors the scan runs on local shards, batch and
channels kept (``_scan_sharded``).

The port of ``src/repro/models/ssm.py``. Parameters are a dict with the
reference's key names and shapes. Over a sequence (S > 1), Mamba-1's
``_mamba1_chunked`` computes the input projections, B, C and
the step sizes for the whole sequence and runs the scan as one call of
``kernels.ssm_scan.selective_scan``: one launch of K8 per layer on the
card, its plain version on the CPU. The reference instead loops over
chunks of ``ssm_chunk`` positions in ``lax.scan`` (the chunk is the RAW
frontier of DESIGN.md §3.3, the state stored by one chunk and loaded by
the next); the kernel walks all positions itself, so the port takes any
S, where the reference needs S to divide by the chunk. Decode (S = 1) is
the O(1) recurrent step on the carried ``(conv window, h state)``.

Mamba-2 (SSD, zamba2-7b's hybrid stack) has a scalar decay per head of
``MAMBA2_HEAD`` channels. Over a sequence, ``_mamba2_chunked`` is the
reference's quadratic-in-chunk form: per chunk, per-head ``(C, C)`` decay
matrices for the positions inside it and the carried ``(nh, 64, n)`` state
for those before, the log-decays clamped at -30 as in the reference. The
reference runs it under JAX with no Pallas kernel, so it is plain torch on
the card too (einsums over whole tensors, no loop over heads). As in the
reference, S must divide by the chunk where it exceeds it: the port raises
``ValueError`` naming the chunk where the reference fails on a reshape.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard

from repro_torch import tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.ssm_scan.kernel import selective_scan
from repro_torch.models import shardctx
from repro_torch.models.layers import Dtypes, _init, remat, rms_norm

MAMBA2_HEAD = 64  # channels a Mamba-2 head (src/repro/models/ssm.py:27)


# ---------------------------------------------------------------------------
# parameter init
# ---------------------------------------------------------------------------


def mamba_init(generator, cfg: ArchConfig, dt: Dtypes, device):
    """Mamba-1 parameters, ``a_log`` the deterministic S4D-real init
    ``log(1..n)`` for every channel; or Mamba-2's, one decay, step bias
    and skip a head, B, C and the steps projected from the block input."""
    d = cfg.d_model
    di = cfg.expand * d
    n = cfg.ssm_state
    f32 = dict(dtype=torch.float32, device=device)
    p = {
        "w_in": _init(generator, (d, 2 * di), d ** -0.5, dt.param, device),
        "conv_w": _init(generator, (cfg.d_conv, di), 0.5, dt.param, device),
        "conv_b": torch.zeros(di, dtype=dt.param, device=device),
        "w_out": _init(generator, (di, d), di ** -0.5, dt.param, device),
    }
    if cfg.ssm == "mamba1":
        a_log = torch.log(torch.arange(1, n + 1, **f32)).expand(di, n)
        p.update({
            "a_log": a_log.contiguous(),
            "w_bc": _init(generator, (di, 2 * n), di ** -0.5, dt.param,
                          device),
            "w_dt": _init(generator, (di, 1), di ** -0.5, dt.param, device),
            "dt_bias": torch.zeros(di, **f32),
            "d_skip": torch.ones(di, **f32),
        })
    else:
        nh = di // MAMBA2_HEAD
        p.update({
            "a_log": torch.zeros(nh, **f32),
            "w_bc": _init(generator, (d, 2 * n), d ** -0.5, dt.param, device),
            "w_dt": _init(generator, (d, nh), d ** -0.5, dt.param, device),
            "dt_bias": torch.zeros(nh, **f32),
            "d_skip": torch.ones(nh, **f32),
            "norm_scale": torch.zeros(di, dtype=dt.param, device=device),
        })
    return p


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
    if shardctx.any_dtensor(xi, h0):
        return _scan_sharded(xi.float(), dt_, bmat, cmat, a_neg, h0)
    return selective_scan(xi.float(), dt_, bmat, cmat, a_neg, h0)


def _scan_sharded(xi, dt_, bmat, cmat, a_neg, h0):
    """``selective_scan`` on DTensors, on local shards: the batch and
    channel shards of ``xi`` are kept (any sequence shard is gathered: the
    scan runs along it); B and C follow the batch shards and are read
    whole by each channel shard, ``a_neg`` and ``h0`` follow the channel
    shards."""
    mesh = shardctx.mesh_of(xi, h0)
    xp = shardctx.keep(xi.placements, (0, 2))
    pt = shardctx.PARTIAL
    bp = shardctx.follow(xp, {0: Shard(0)})
    bg = shardctx.follow(xp, {0: Shard(0), 2: pt})
    ap = shardctx.follow(xp, {2: Shard(0)})
    ag = shardctx.follow(xp, {0: pt, 2: Shard(0)})
    hp = shardctx.follow(xp, {0: Shard(0), 2: Shard(1)})
    y, h = selective_scan(
        shardctx.local(xi, mesh, xp), shardctx.local(dt_, mesh, xp),
        shardctx.local(bmat, mesh, bp, bg), shardctx.local(cmat, mesh, bp, bg),
        shardctx.local(a_neg, mesh, ap, ag), shardctx.local(h0, mesh, hp))
    return (shardctx.wrap(y, mesh, xp, xi.shape),
            shardctx.wrap(h, mesh, hp, h0.shape))


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
# mamba2 (SSD): quadratic in the chunk, per-head (C, C) decay matrices
# ---------------------------------------------------------------------------


def _bc_dt(p, xr, n):
    """Mamba-2's B, C ``(..., n)`` and step sizes ``(..., nh)``, float32,
    projected from the block input ``xr``."""
    bc = xr @ p["w_bc"].to(xr.dtype)
    dt_ = F.softplus((xr @ p["w_dt"].to(xr.dtype)).float() + p["dt_bias"])
    return bc[..., :n].float(), bc[..., n:].float(), dt_


def _mamba2_chunked(p, x_resid, xi, cfg: ArchConfig, h0, chunk: int):
    """x_resid ``(B, S, d)``, the block input B, C and the steps are
    projected from; xi ``(B, S, di)`` post-conv/silu; h0 ``(B, nh, 64,
    n)``. Returns ``(y (B, S, di) float32, h_final)``."""
    s = xi.shape[1]
    n = cfg.ssm_state
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"_mamba2_chunked: S={s} is not a multiple of the "
                         f"chunk {c} (cfg.ssm_chunk), as the reference's "
                         f"chunked form needs")
    h, ys = h0, []
    for c0 in range(0, s, c):
        # recomputed in the backward, as the reference's jax.checkpoint of
        # each chunk (src/repro/models/ssm.py:218)
        h, y = remat(_ssd_chunk, p, x_resid[:, c0:c0 + c], xi[:, c0:c0 + c],
                     h, n)
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _ssd_chunk(p, xr, xi, h, n):
    """One SSD chunk: block input xr ``(B, C, d)``, xi ``(B, C, di)``,
    carried state h ``(B, nh, 64, n)`` → ``(h_new, y (B, C, di))``."""
    b, c, di = xi.shape
    nh, hd = di // MAMBA2_HEAD, MAMBA2_HEAD
    a_neg = -torch.exp(p["a_log"])  # (nh,)
    tri = torch.tril(torch.ones(c, c, dtype=torch.bool, device=xi.device))
    bmat, cmat, dt_ = _bc_dt(p, xr, n)  # dt_ (B, C, nh)
    xf = shardctx.reshape(xi, b, c, nh, hd).float()
    logcum = torch.cumsum(a_neg * dt_, dim=1)  # (B, C, nh), <= 0
    # inside the chunk: y[t] = sum_{j<=t} exp(lc_t - lc_j) (C_t.B_j) dt_j
    # x_j; exp of the masked upper triangle may be inf, so it is replaced
    # (where), never multiplied by the mask
    ldiff = torch.clamp(logcum[:, :, None, :] - logcum[:, None, :, :],
                        min=-30.0)  # (B, C, C, nh): t rows, j columns
    w = torch.where(tri[None, :, :, None], torch.exp(ldiff), 0.0)
    scores = torch.einsum("btn,bjn->btj", cmat, bmat)
    wmat = w * scores[..., None] * dt_[:, None, :, :]
    y_intra = torch.einsum("btjh,bjhp->bthp", wmat, xf)
    # the carried state's contribution
    decay_t = torch.exp(torch.clamp(logcum, min=-30.0))
    y_inter = torch.einsum("btn,bhpn,bth->bthp", cmat, h, decay_t)
    # h' = decay_C h + sum_j exp(lc_C - lc_j) dt_j x_j B_j
    decay_last = torch.exp(torch.clamp(logcum[:, -1:, :] - logcum,
                                       min=-30.0)) * dt_
    h_new = (torch.exp(torch.clamp(logcum[:, -1], min=-30.0))[:, :, None, None]
             * h + torch.einsum("bjh,bjhp,bjn->bhpn", decay_last, xf, bmat))
    return h_new, shardctx.reshape(y_intra + y_inter, b, c, di)


def _mamba2_step(p, xr_t, xh_t, h, n):
    """One recurrent step: xr_t ``(B, d)``, xh_t ``(B, nh, 64)``, h ``(B,
    nh, 64, n)`` → ``(y (B, nh, 64), h_new)``."""
    bmat, cmat, dt_ = _bc_dt(p, xr_t, n)  # dt_ (B, nh)
    a = torch.exp(-torch.exp(p["a_log"])[None] * dt_)
    bx = torch.einsum("bh,bhp,bn->bhpn", dt_, xh_t.float(), bmat)
    h_new = a[..., None, None] * h + bx
    y = torch.einsum("bhpn,bn->bhp", h_new, cmat)
    return y, h_new


# ---------------------------------------------------------------------------
# public block API
# ---------------------------------------------------------------------------


def mamba_apply(p, x, cfg: ArchConfig, *, state=None):
    """x ``(B, S, d)``. ``state``: None for a prompt from a zero state,
    else a dict with ``conv`` ``(B, K-1, di)`` and ``h`` (``(B, di, n)``
    for Mamba-1, ``(B, nh, 64, n)`` for Mamba-2). Returns ``(y,
    new_state)``."""
    b, s, d = x.shape
    di = cfg.expand * d
    n = cfg.ssm_state

    with tracing.span("mamba.in_proj"):
        xz = x @ p["w_in"].to(x.dtype)
    xi, z = xz[..., :di], xz[..., di:]
    conv_state = None if state is None else state["conv"]
    # from the conv through the gate: what a fused step or scan replaces
    with tracing.span("mamba.scan"):
        xi, new_conv = _causal_conv(xi, p["conv_w"], p["conv_b"], conv_state)
        xi = F.silu(xi)

        if cfg.ssm == "mamba1":
            h0 = (torch.zeros((b, di, n), dtype=torch.float32,
                              device=x.device)
                  if state is None else state["h"])
            if s == 1:
                y, new_h = _mamba1_step(p, xi[:, 0], h0)
                y = y[:, None, :]
            else:
                y, new_h = _mamba1_chunked(p, xi, cfg, h0, cfg.ssm_chunk)
            y = y + xi.float() * p["d_skip"][None, None, :]
        else:
            nh = di // MAMBA2_HEAD
            h0 = (torch.zeros((b, nh, MAMBA2_HEAD, n), dtype=torch.float32,
                              device=x.device)
                  if state is None else state["h"])
            if s == 1:
                y, new_h = _mamba2_step(
                    p, x[:, 0], shardctx.reshape(xi[:, 0], b, nh, MAMBA2_HEAD),
                    h0, n)
                y = shardctx.reshape(y, b, 1, di)
            else:
                y, new_h = _mamba2_chunked(p, x, xi, cfg, h0, cfg.ssm_chunk)
            d_skip = p["d_skip"].repeat_interleave(MAMBA2_HEAD)
            y = y + d_skip[None, None, :] * xi.float()
            # the gated norm, before silu(z)
            y = rms_norm(y.to(x.dtype), p["norm_scale"], cfg.norm_eps).float()
        y = y.to(x.dtype) * F.silu(z)
    with tracing.span("mamba.out_proj"):
        y = y @ p["w_out"].to(x.dtype)
    return y, {"conv": new_conv, "h": new_h}


def mamba_init_state(cfg: ArchConfig, batch: int, *, device,
                     dtype=torch.float32):
    """The zeroed decode state: ``conv`` ``(batch, K-1, di)`` in
    ``dtype`` and ``h`` float32, ``(batch, di, n)`` for Mamba-1 and
    ``(batch, nh, 64, n)`` for Mamba-2."""
    di = cfg.expand * cfg.d_model
    n = cfg.ssm_state
    h = ((batch, di, n) if cfg.ssm == "mamba1"
         else (batch, di // MAMBA2_HEAD, MAMBA2_HEAD, n))
    return {
        "conv": torch.zeros((batch, cfg.d_conv - 1, di), dtype=dtype,
                            device=device),
        "h": torch.zeros(h, dtype=torch.float32, device=device),
    }
