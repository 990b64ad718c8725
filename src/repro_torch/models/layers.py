"""Layer library, the parts the serving path runs: norms, RoPE, GQA
attention (self, encoder and cross), MLA attention, MLPs and
mixture-of-experts FFNs.

Plain functions on tensors, as in the reference
(``src/repro/models/layers.py``): every layer is ``init(generator, cfg,
dt, device) -> params dict`` with the reference's key names and shapes,
and ``apply(params, x, ...) -> y``. Random weights come from an explicit
``torch.Generator`` on the device they are made on, so they differ from
the reference's ``jax.random`` draws; ``models/convert.py`` carries the
reference's own weights across, bit for bit, for the tests.

``gqa_apply`` is the reference's general GQA layer (whisper's encoder,
its decoder's cross attention, and the cached branch that no path calls);
the decoders' own full-sequence attention is ``transformer._gqa_train``.
``mla_apply`` is minicpm3's multi-head latent attention: the prefill
expands the latent to per-head K (96 wide) and V (64 wide) for the flash
kernel K6, the decode step attends in latent space, absorbed, in plain
torch as the reference does (it has no kernel there).

MoE (``moe_init``, ``moe_apply``) has both of the reference's paths, the
capacity path in plain torch, grouped by data shard under a mesh, and
the dropless one on the grouped matmul kernel K9.
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.distributed.tensor import Shard
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.kernels.attention.ref import NEG_INF
from repro_torch.kernels.moe_group_mm.ops import moe_ffn, route
from repro_torch.models import shardctx
from repro_torch.models.flash import flash_mha


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


def _requires_grad(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.requires_grad
    return isinstance(x, dict) and any(map(_requires_grad, x.values()))


def remat(fn, *args):
    """``fn(*args)``, its activations recomputed in the backward instead of
    saved (``torch.utils.checkpoint``, non-reentrant) where autograd will
    need them: grad mode on and a tensor among ``args`` (or in a dict of
    parameters among them) requiring grad. That is the reference's
    ``jax.checkpoint(..., policy=nothing_saveable)`` around each layer
    body, each Mamba-2 chunk and each cross-entropy chunk. Anywhere else
    (serving) it is the plain call: the checkpoint machinery costs host
    time a call, and its first use imports ``torch._dynamo``, seconds.
    ``fn`` draws no random numbers, so no RNG state is kept."""
    if not (torch.is_grad_enabled() and any(map(_requires_grad, args))):
        return fn(*args)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


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


def _sdpa(q, k, v, mask):
    """``(B, S, H, D)`` attention over ``(B, S_kv, H, D)`` keys and values
    under a boolean ``mask`` broadcast to ``(B, H, S, S_kv)``, scores and
    softmax in float32: the reference's plain attention."""
    scale = q.shape[-1] ** -0.5
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def _write_rows(cache, rows, at):
    """``cache[b, at[b]:at[b] + S] = rows[b]`` in place, for ``cache``
    ``(B, S_max, ...)`` and ``rows`` ``(B, S, ...)``; a start past
    ``S_max - S`` is clamped, as ``lax.dynamic_update_slice`` clamps it."""
    b, s = rows.shape[:2]
    start = torch.clamp(at.long(), 0, cache.shape[1] - s)
    idx = start[:, None] + torch.arange(s, device=cache.device)
    cache[torch.arange(b, device=cache.device)[:, None], idx] = rows.to(
        cache.dtype)


def gqa_apply(p, x, cfg: ArchConfig, *, positions, causal: bool = True,
              window: int = 0, kv_cache=None, cache_len=None, kv_source=None,
              use_rope: bool = True, eps: float = 1e-6):
    """The reference's GQA layer (``src/repro/models/layers.py:103``) on
    ``x`` ``(B, S, d)``, one of four branches:

    - cross attention: K/V from ``kv_source`` ``(B, S_enc, d)`` (whisper's
      encoder output), every key visible, no RoPE;
    - ``causal=False``: every key visible (whisper's encoder);
    - causal, no cache: keys at positions ``<=`` the query's (and inside
      ``window`` where > 0); whisper's decoder serves its cross layer so,
      one token over itself, when no encoder output is given;
    - ``kv_cache=(k, v)`` ``(B, S_max, nk, hd)``: the new K/V are written
      at ``cache_len`` in place (the reference returns a new cache) and
      every query attends to the keys at or before the first query's
      position. No path of either package calls this branch; it runs
      ``_sdpa``, the reference's plain attention. Returns ``(y, (k, v))``.

    The first three run blocked flash attention (``flash_mha``: the
    kernel K6 on the card, its plain loop on the CPU), causal in the
    third. Its mask counts positions by index, so there ``positions``
    must count up by one along S in every row (as every caller's do:
    ``arange(S)``, or one position a row)."""
    b, s, _ = x.shape
    hd = cfg.resolved_head_dim
    nh, nk = cfg.n_heads, cfg.n_kv_heads
    q = shardctx.reshape(x @ p["wq"].to(x.dtype), b, s, nh, hd)
    src = kv_source if kv_source is not None else x
    k = shardctx.reshape(src @ p["wk"].to(x.dtype), b, src.shape[1], nk, hd)
    v = shardctx.reshape(src @ p["wv"].to(x.dtype), b, src.shape[1], nk, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], eps)
        k = rms_norm(k, p["k_norm"], eps)
    if use_rope and kv_source is None:
        q = rope(q, positions[:, :, None], cfg.rope_theta)
        k = rope(k, positions[:, :, None], cfg.rope_theta)

    if kv_cache is None:
        out = flash_mha(q, k, v, causal=causal and kv_source is None,
                        window=window if causal and kv_source is None else 0)
        return shardctx.reshape(out, b, s, nh * hd) @ p["wo"].to(x.dtype)

    ck, cv = kv_cache
    _write_rows(ck, k, cache_len)
    _write_rows(cv, v, cache_len)
    rep = nh // nk
    k, v = ck.repeat_interleave(rep, dim=2), cv.repeat_interleave(rep, dim=2)
    k_pos = torch.arange(ck.shape[1], device=x.device)[None, :]
    mask = (k_pos <= positions[:, :1])[:, None, None, :]  # the frontier
    if window:
        mask = mask & (k_pos[:, None, None, :]
                       > positions[:, None, :, None] - window)
    out = _sdpa(q, k, v, mask)
    return out.reshape(b, s, nh * hd) @ p["wo"].to(x.dtype), (ck, cv)


# ---------------------------------------------------------------------------
# MLA attention (minicpm3)
# ---------------------------------------------------------------------------


def mla_init(generator, cfg: ArchConfig, dt: Dtypes, device):
    d = cfg.d_model
    r_q, r_kv = cfg.q_lora_rank, cfg.kv_lora_rank
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    nh = cfg.n_heads
    s = d ** -0.5
    return {
        "wq_a": _init(generator, (d, r_q), s, dt.param, device),
        "wq_b": _init(generator, (r_q, nh * (dn + dr)), r_q ** -0.5,
                      dt.param, device),
        "wkv_a": _init(generator, (d, r_kv + dr), s, dt.param, device),
        "wkv_b": _init(generator, (r_kv, nh * (dn + dv)), r_kv ** -0.5,
                       dt.param, device),
        "wo": _init(generator, (nh * dv, d), (nh * dv) ** -0.5, dt.param,
                    device),
        "q_a_norm": torch.zeros(r_q, dtype=dt.param, device=device),
        "kv_a_norm": torch.zeros(r_kv, dtype=dt.param, device=device),
    }


def mla_apply(p, x, cfg: ArchConfig, *, positions, kv_cache=None,
              cache_len=None, eps: float = 1e-6):
    """Multi-head latent attention (``src/repro/models/layers.py:195``) on
    ``x`` ``(B, S, d)``. Queries go through a rank-``q_lora_rank``
    bottleneck; keys and values come from one normed latent of
    ``kv_lora_rank`` and a rotary key of ``qk_rope_dim`` shared by every
    head. Scale ``(qk_nope_dim + qk_rope_dim)**-0.5``.

    - No cache (prefill): the latent is expanded to per-head K (``dn +
      dr`` wide) and V (``dv`` wide) and attended causally by
      ``flash_mha`` (K6 on the card, one launch; its V head dim differs
      from q's and k's).
    - ``kv_cache=(latent (B, S_max, r_kv), k_rope (B, S_max, dr))``
      (decode): the new rows are written at ``cache_len`` in place (the
      reference returns a new cache), and the queries attend in latent
      space, ``W_uk`` absorbed into q and ``W_uv`` into the output, to
      the keys at or before the first query's position: plain torch, as
      in the reference. Returns ``(y, (latent, k_rope))``."""
    b, s, _ = x.shape
    nh = cfg.n_heads
    dn, dr, dv = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.v_head_dim
    r_kv = cfg.kv_lora_rank

    q_lat = rms_norm(x @ p["wq_a"].to(x.dtype), p["q_a_norm"], eps)
    q = shardctx.reshape(q_lat @ p["wq_b"].to(x.dtype), b, s, nh, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = rope(q_rope, positions[:, :, None], cfg.rope_theta)

    kv_a = x @ p["wkv_a"].to(x.dtype)
    latent = rms_norm(kv_a[..., :r_kv], p["kv_a_norm"], eps)
    k_rope = rope(kv_a[..., r_kv:][:, :, None, :], positions[:, :, None],
                  cfg.rope_theta)[:, :, 0, :]

    if kv_cache is not None:
        c_lat, c_kr = kv_cache
        if shardctx.any_dtensor(c_lat) and s == 1:
            shardctx.write_row(c_lat, latent[:, 0], cache_len)
            shardctx.write_row(c_kr, k_rope[:, 0], cache_len)
        else:
            _write_rows(c_lat, latent, cache_len)
            _write_rows(c_kr, k_rope, cache_len)
        latent, k_rope = c_lat, c_kr

    s_kv = latent.shape[1]
    wkv_b = shardctx.reshape(p["wkv_b"].to(x.dtype), r_kv, nh, dn + dv)
    w_uk, w_uv = wkv_b[..., :dn], wkv_b[..., dn:]  # (r, nh, dn), (r, nh, dv)

    if kv_cache is None:
        k_nope = torch.einsum("bkr,rhd->bkhd", latent, w_uk)
        v_full = torch.einsum("bkr,rhd->bkhd", latent, w_uv)
        k_full = torch.cat(
            [k_nope, k_rope[:, :, None, :].expand(b, s_kv, nh, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        spec = shardctx.attn_spec(nh, b)
        if spec is not None:
            q_full = shardctx.constrain(q_full, *spec)
            k_full = shardctx.constrain(k_full, *spec)
            v_full = shardctx.constrain(v_full, *spec)
        out = flash_mha(q_full, k_full, v_full, causal=True)
        if spec is not None:
            out = shardctx.constrain(out, *spec)
        return shardctx.reshape(out, b, s, nh * dv) @ p["wo"].to(x.dtype)

    q_abs = torch.einsum("bshd,rhd->bshr", q_nope, w_uk)  # (b, s, nh, r)
    scores = torch.einsum("bshr,bkr->bhsk", q_abs.float(), latent.float())
    scores = scores + torch.einsum("bshd,bkd->bhsk", q_rope.float(),
                                   k_rope.float())
    scores = scores * ((dn + dr) ** -0.5)
    k_pos = torch.arange(s_kv, device=x.device)[None, :]
    mask = (k_pos <= positions[:, :1])[:, None, None, :]
    w = torch.softmax(torch.where(mask, scores, NEG_INF), dim=-1).to(x.dtype)
    ctx_lat = torch.einsum("bhsk,bkr->bshr", w, latent)  # (b, s, nh, r)
    out = torch.einsum("bshr,rhd->bshd", ctx_lat, w_uv)  # W_uv absorbed
    y = out.reshape(b, s, nh * dv) @ p["wo"].to(x.dtype)
    return y, kv_cache


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
    """The capacity path's dispatch of the assignment streams ``flat_e``
    ``(..., T·k)`` (one a group): each assignment's place in its expert's
    buffer is the running count of that expert so far in its stream; it
    is kept below ``cap`` and then goes to row ``expert · cap + place``,
    else to the overflow row ``n_experts · cap``. Returns ``(slot,
    keep)``."""
    onehot = F.one_hot(flat_e.long(), n_experts)  # (..., T·k, E)
    pos = ((torch.cumsum(onehot, dim=-2) - 1) * onehot).sum(dim=-1)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos,
                       torch.full_like(pos, n_experts * cap))
    return slot, keep


def _dispatch(flat, logits, cfg: ArchConfig, g: int, capacity_factor):
    """The capacity path's dispatch over ``g`` groups of consecutive
    tokens: ``(xe (g, E, cap, d), slot, gates (g, Tg·k), tok (Tg·k,))``,
    ``tok`` each assignment's token in its group."""
    t, d = flat.shape
    e, k = cfg.n_experts, cfg.top_k
    tg = t // g
    cap = max(1, int(capacity_factor * tg * k / e))
    top_p, top_e = route(logits, k)
    slot, keep = capacity_slots(top_e.reshape(g, tg * k), e, cap)
    tok = torch.arange(tg * k, device=flat.device) // k
    gi = torch.arange(g, device=flat.device)[:, None]
    buf = torch.zeros((g, e * cap + 1, d), dtype=flat.dtype,
                      device=flat.device)
    buf[gi, slot] = flat.reshape(g, tg, d)[:, tok]  # drops share a row
    gates = (top_p.reshape(g, tg * k) * keep).to(flat.dtype)
    return buf[:, :e * cap].reshape(g, e, cap, d), slot, gates, tok


def _experts(p, xe, cfg: ArchConfig):
    """Every expert's FFN over its buffer, ``(g, E, cap, d)``."""
    h = torch.einsum("gecd,edf->gecf", xe, p["w_in"].to(xe.dtype))
    if cfg.gated:
        gt = torch.einsum("gecd,edf->gecf", xe, p["w_gate"].to(xe.dtype))
        h = _act(cfg.act)(gt) * h
    else:
        h = _act(cfg.act)(h)
    return torch.einsum("gecf,efd->gecd", h, p["w_out"].to(xe.dtype))


def _combine(ye, slot, gates, tok, k: int):
    """Each token's gated sum of its kept assignments' expert outputs,
    ``(g · Tg, d)``, for ``k`` assignments a token."""
    g, e, cap, d = ye.shape
    gi = torch.arange(g, device=ye.device)[:, None]
    ya = ye.reshape(g, e * cap, d)[gi, torch.clamp(slot, max=e * cap - 1)]
    out = torch.zeros((g, slot.shape[1] // k, d), dtype=ye.dtype,
                      device=ye.device)
    out.index_add_(1, tok, ya * gates[..., None])
    return out.reshape(-1, d)


def moe_apply(p, x, cfg: ArchConfig, *, use_kernel: bool = False,
              capacity_factor: float = 1.25):
    """MoE FFN over ``x`` ``(B, S, d)``, by one of the reference's two
    algorithms (``use_kernel`` chooses the algorithm, as there):

    - the capacity path (default): the tokens are split into groups, one
      a data shard (``shardctx.axis_size(dp_axes())``, one group without
      a mesh or where it does not divide the tokens), and each group is
      dispatched into its own expert buffers: each assignment's place in
      its expert's buffer is the running count of that expert over the
      group's assignment stream (the vectorised frontier merge of the
      paper), and assignments at or past ``cap = max(1,
      int(capacity_factor · T_group · k / E))`` drop: they write the
      overflow row ``E · cap``, which is cut off, and their gate is 0.
      Plain torch. On DTensors the dispatch and the combine run on each
      rank's own group (``shardctx.local``) and the expert products on
      DTensors, as the reference's vmap over groups leaves them to XLA;
    - ``use_kernel=True``: the dropless ``moe_ffn`` over the monotonic
      dispatch, whose three grouped products launch K9 on the card. Its
      activations are fixed (SiLU gated, tanh GELU otherwise), as in the
      reference, whatever ``cfg.act`` says. On DTensors K9 runs on each
      rank's tokens against the whole experts.

    The shared experts (``n_shared_experts``, moonshot) are added on both
    paths."""
    b, s, d = x.shape
    flat = x.reshape(b * s, d)
    t = flat.shape[0]
    logits = (flat @ p["router"].float()).float()
    if use_kernel and shardctx.any_dtensor(flat):
        out = _dropless_sharded(p, flat, logits, cfg)
    elif use_kernel:
        out = moe_ffn(flat, logits, p["w_in"], p.get("w_gate"), p["w_out"],
                      top_k=cfg.top_k)
    else:
        g = max(shardctx.axis_size(shardctx.dp_axes()), 1)
        if t % g:
            g = 1
        if shardctx.any_dtensor(flat):
            out = _capacity_sharded(p, flat, logits, cfg, g, capacity_factor)
        else:
            xe, slot, gates, tok = _dispatch(flat, logits, cfg, g,
                                             capacity_factor)
            out = _combine(_experts(p, xe, cfg), slot, gates, tok,
                           cfg.top_k)
    if cfg.n_shared_experts:
        out = out + mlp_apply(p["shared"], flat, cfg)
    return out.reshape(b, s, d)


def _dropless_sharded(p, flat, logits, cfg: ArchConfig):
    """The dropless path on DTensors: each token's output depends on its
    own routing alone, so K9 runs on each rank's tokens (sharded over the
    data axes where they divide them) against the whole experts."""
    mesh = shardctx.mesh_of(flat, logits)
    dp = shardctx.dp_axes()
    n_dp = math.prod(mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)
                     if n in dp)
    xp = tuple(Shard(0) if n in dp and flat.shape[0] % n_dp == 0
               else shardctx.REPLICATE for n in mesh.mesh_dim_names)
    rep = [shardctx.REPLICATE] * mesh.ndim
    w = {k: shardctx.local(p[k], mesh, rep) for k in ("w_in", "w_out")}
    gate = p.get("w_gate")
    out = moe_ffn(shardctx.local(flat, mesh, xp),
                  shardctx.local(logits, mesh, xp), w["w_in"],
                  None if gate is None else shardctx.local(gate, mesh, rep),
                  w["w_out"], top_k=cfg.top_k)
    return shardctx.wrap(out, mesh, xp, tuple(flat.shape))


def _capacity_sharded(p, flat, logits, cfg: ArchConfig, g: int,
                      capacity_factor):
    """The capacity path on DTensors: with ``g`` groups, each rank's
    tokens are its data shard's group (sharded over the data axes, pod
    outermost, as the reference's groups are ordered), dispatched and
    combined locally; the expert buffers ``(g, E, cap, d)`` go through the
    expert products as DTensors."""
    mesh = shardctx.mesh_of(flat, logits)
    dp = shardctx.dp_axes()
    xp = tuple(Shard(0) if g > 1 and n in dp else shardctx.REPLICATE
               for n in mesh.mesh_dim_names)
    xe, slot, gates, tok = _dispatch(shardctx.local(flat, mesh, xp),
                                     shardctx.local(logits, mesh, xp),
                                     cfg, 1, capacity_factor)
    ye = _experts(p, shardctx.wrap(xe, mesh, xp, (g,) + tuple(xe.shape[1:])),
                  cfg)
    out = _combine(shardctx.local(ye, mesh, xp), slot, gates, tok,
                   cfg.top_k)
    return shardctx.wrap(out, mesh, xp, tuple(flat.shape))
