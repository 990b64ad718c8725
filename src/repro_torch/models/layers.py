"""Layer library, the parts the serving path runs: norms, RoPE, GQA and
MLP parameters, MLPs and mixture-of-experts FFNs.

Plain functions on tensors, as in the reference
(``src/repro/models/layers.py``): every layer is ``init(generator, cfg,
dt, device) -> params dict`` with the reference's key names and shapes,
and ``apply(params, x, ...) -> y``. Random weights come from an explicit
``torch.Generator`` on the device they are made on, so they differ from
the reference's ``jax.random`` draws; ``models/convert.py`` carries the
reference's own weights across, bit for bit, for the tests.

MoE (``moe_init``, ``moe_apply``) has both of the reference's paths, the
capacity path in plain torch and the dropless one on the grouped matmul
kernel K9. MLA and the cross/encoder attention of ``gqa_apply`` are not
ported yet: their functions raise ``NotImplementedError`` naming the
ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.moe_group_mm.ops import moe_ffn, route


@dataclasses.dataclass(frozen=True)
class Dtypes:
    param: torch.dtype = torch.bfloat16
    compute: torch.dtype = torch.bfloat16
    accum: torch.dtype = torch.float32


FP32 = Dtypes(torch.float32, torch.float32, torch.float32)
BF16 = Dtypes()


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------


def rms_norm(x, scale, eps):
    """``x · rsqrt(mean(x²) + eps) · (1 + scale)`` in float32, back in
    x's dtype (scales are zero-initialised)."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return ((xf * torch.rsqrt(var + eps)) * (1.0 + scale.float())).to(x.dtype)


@functools.lru_cache(maxsize=None)
def _log_theta(theta) -> float:
    """log θ in float32, as a Python scalar: computed once per θ on the
    host, so the frequencies are made on x's device with no
    host-to-device copy."""
    return torch.log(torch.tensor(theta, dtype=torch.float32)).item()


def rope(x, positions, theta, dims: Optional[int] = None):
    """Rotary embedding over the last ``dims`` features (default all), in
    the half-split layout: features ``[:half]`` and ``[half:d]`` rotate
    as pairs at frequencies ``exp(-log θ · i / half)``."""
    d = dims or x.shape[-1]
    half = d // 2
    freqs = torch.exp(
        -_log_theta(theta)
        * torch.arange(0, half, dtype=torch.float32, device=x.device) / half
    )
    ang = positions[..., None].float() * freqs  # (..., S, half)
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x[..., :half], x[..., half:d]
    rotated = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    if d < x.shape[-1]:
        rotated = torch.cat([rotated, x[..., d:]], dim=-1)
    return rotated.to(x.dtype)


def _init(generator, shape, scale, dtype, device):
    """Normal(0, 1) · scale, drawn in float32 on ``device`` from
    ``generator`` (which must live there), then cast to ``dtype``."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    w.normal_(0.0, 1.0, generator=generator).mul_(scale)
    return w.to(dtype)


# ---------------------------------------------------------------------------
# GQA attention
# ---------------------------------------------------------------------------


def gqa_init(generator, cfg: ArchConfig, dt: Dtypes, device):
    d, hd = cfg.d_model, cfg.resolved_head_dim
    nh, nk = cfg.n_heads, cfg.n_kv_heads
    s = d ** -0.5
    p = {
        "wq": _init(generator, (d, nh * hd), s, dt.param, device),
        "wk": _init(generator, (d, nk * hd), s, dt.param, device),
        "wv": _init(generator, (d, nk * hd), s, dt.param, device),
        "wo": _init(generator, (nh * hd, d), (nh * hd) ** -0.5, dt.param,
                    device),
    }
    if cfg.qk_norm:
        p["q_norm"] = torch.zeros(hd, dtype=dt.param, device=device)
        p["k_norm"] = torch.zeros(hd, dtype=dt.param, device=device)
    return p


def gqa_apply(*args, **kwargs):
    """Cross and encoder attention (whisper) are not ported yet."""
    raise NotImplementedError(
        "gqa_apply (cross/encoder attention, whisper) is not ported yet "
        "(ROADMAP queue 1, item 12d)")


def mla_init(*args, **kwargs):
    raise NotImplementedError(
        "MLA (minicpm3) is not ported yet (ROADMAP queue 1, item 12d)")


mla_apply = mla_init


# ---------------------------------------------------------------------------
# MLPs and MoE
# ---------------------------------------------------------------------------


def mlp_init(generator, cfg: ArchConfig, dt: Dtypes, device,
             d_ff: Optional[int] = None):
    d, ff = cfg.d_model, d_ff or cfg.d_ff
    p = {
        "w_in": _init(generator, (d, ff), d ** -0.5, dt.param, device),
        "w_out": _init(generator, (ff, d), ff ** -0.5, dt.param, device),
    }
    if cfg.gated:
        p["w_gate"] = _init(generator, (d, ff), d ** -0.5, dt.param, device)
    return p


def _gelu_tanh(x):
    # jax.nn.gelu defaults to the tanh approximation; torch's to the exact
    return F.gelu(x, approximate="tanh")


def _act(name):
    return {"silu": F.silu, "gelu": _gelu_tanh}[name]


def mlp_apply(p, x, cfg: ArchConfig):
    h = x @ p["w_in"].to(x.dtype)
    if cfg.gated:
        h = _act(cfg.act)(x @ p["w_gate"].to(x.dtype)) * h
    else:
        h = _act(cfg.act)(h)
    return h @ p["w_out"].to(x.dtype)


def moe_init(generator, cfg: ArchConfig, dt: Dtypes, device):
    d, ff, e = cfg.d_model, cfg.moe_d_ff or cfg.d_ff, cfg.n_experts
    p = {
        "router": _init(generator, (d, e), d ** -0.5, torch.float32, device),
        "w_in": _init(generator, (e, d, ff), d ** -0.5, dt.param, device),
        "w_out": _init(generator, (e, ff, d), ff ** -0.5, dt.param, device),
    }
    if cfg.gated:
        p["w_gate"] = _init(generator, (e, d, ff), d ** -0.5, dt.param,
                            device)
    if cfg.n_shared_experts:
        p["shared"] = mlp_init(generator, cfg, dt, device,
                               d_ff=ff * cfg.n_shared_experts)
    return p


def capacity_slots(flat_e, n_experts: int, cap: int):
    """The capacity path's dispatch of the assignment stream ``flat_e``
    ``(T·k,)``: each assignment's place in its expert's buffer is the
    running count of that expert so far; it is kept below ``cap`` and
    then goes to row ``expert · cap + place``, else to the overflow row
    ``n_experts · cap``. Returns ``(slot, keep)``."""
    onehot = F.one_hot(flat_e.long(), n_experts)  # (T·k, E)
    pos = ((torch.cumsum(onehot, dim=0) - 1) * onehot).sum(dim=-1)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return slot, keep


def moe_apply(p, x, cfg: ArchConfig, *, use_kernel: bool = False,
              capacity_factor: float = 1.25):
    """MoE FFN over ``x`` ``(B, S, d)``, by one of the reference's two
    algorithms (``use_kernel`` chooses the algorithm, as there):

    - the capacity path (default): each assignment's place in its
      expert's buffer is the running count of that expert over the
      assignment stream (the vectorised frontier merge of the paper), and
      assignments at or past ``cap = max(1, int(capacity_factor · T · k /
      E))`` drop: they write the overflow row ``E · cap``, which is cut
      off, and their gate is 0. Plain torch; the reference's groups per
      data shard are one group on one card (no mesh, so ``shardctx`` has
      no counterpart here);
    - ``use_kernel=True``: the dropless ``moe_ffn`` over the monotonic
      dispatch, whose three grouped products launch K9 on the card. Its
      activations are fixed (SiLU gated, tanh GELU otherwise), as in the
      reference, whatever ``cfg.act`` says.

    The shared experts (``n_shared_experts``, moonshot) are added on both
    paths."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    t = flat.shape[0]
    e, k = cfg.n_experts, cfg.top_k
    logits = (flat @ p["router"].float()).float()
    if use_kernel:
        out = moe_ffn(flat, logits, p["w_in"], p.get("w_gate"), p["w_out"],
                      top_k=k)
    else:
        top_p, top_e = route(logits, k)
        cap = max(1, int(capacity_factor * t * k / e))
        slot, keep = capacity_slots(top_e.reshape(t * k), e, cap)
        tok = torch.arange(t * k, device=x.device) // k
        buf = torch.zeros((e * cap + 1, d), dtype=flat.dtype, device=x.device)
        buf[slot] = flat[tok]  # several drops share the overflow row
        xe = buf[:e * cap].reshape(e, cap, d)
        h = torch.einsum("ecd,edf->ecf", xe, p["w_in"].to(flat.dtype))
        if cfg.gated:
            gt = torch.einsum("ecd,edf->ecf", xe, p["w_gate"].to(flat.dtype))
            h = _act(cfg.act)(gt) * h
        else:
            h = _act(cfg.act)(h)
        ye = torch.einsum("ecf,efd->ecd", h, p["w_out"].to(flat.dtype))
        gates = (top_p.reshape(t * k) * keep).to(flat.dtype)
        ya = ye.reshape(e * cap, d)[torch.clamp(slot, max=e * cap - 1)]
        out = torch.zeros((t, d), dtype=flat.dtype, device=x.device)
        out.index_add_(0, tok, ya * gates[:, None])
    if cfg.n_shared_experts:
        out = out + mlp_apply(p["shared"], flat, cfg)
    return out.reshape(b, s, d)
