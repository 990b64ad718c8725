"""Model assembly, the serving subset.

The port of the reference's model API (``src/repro/models/transformer.py``)
for the decoders without MLA, an encoder, a sliding window or a hybrid
stack: the dense GQA ones (qwen3-14b, starcoder2-7b, internvl2-76b's
backbone), the mixture-of-experts ones (phi3.5-moe, moonshot) and the
pure Mamba-1 one (falcon-mamba-7b):

  init_params(generator, cfg, dt, device=)     -> params (layer-stacked)
  forward_hidden(params, tokens, cfg, dt)      -> final-normed hidden states
  prefill(params, tokens, cfg, dt, ...)        -> (last-token logits, cache)
  decode_step(params, tokens, cache, lengths, cfg, dt) -> (logits, cache)
  init_cache(cfg, batch, max_seq, dt, device=) -> cache

Parameters are a dict with the reference's key names and shapes, layer
weights stacked over a leading layer axis (``layers.attn.wq`` is
``(L, d, nh·hd)``), so ``models/convert.py`` carries the reference's
weights across leaf by leaf. The layers run as a Python loop over views
of the stacks (the reference's ``lax.scan``; its remat and activation
sharding do nothing on one card and have no counterpart here).

Full-sequence attention goes through ``flash.flash_mha``, which launches
the flash attention kernel K6 on the card; the decode step's attention
goes through ``kernels.attention.decode_attention_gqa``, the decode
kernel K7, one launch per layer per step. A Mamba-1 layer's scan over a
sequence launches the selective-scan kernel K8 once (``models.ssm``); its
decode step is the plain recurrence. MoE layers take the reference's
capacity path, in plain torch, as the reference's serving does; the
grouped matmul kernel K9 runs on the dropless path
(``layers.moe_apply(use_kernel=True)``). On the CPU every kernel runs its
plain version.

Other configurations raise ``NotImplementedError`` naming their ROADMAP
item (``check_supported``).
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.kernels.attention.kernel import decode_attention_gqa
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.flash import flash_mha

Dtypes = L.Dtypes


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``NotImplementedError`` unless ``cfg`` is a GQA decoder
    (dense or MoE) without a sliding window, or a pure Mamba-1 stack: the
    families the port serves."""
    if cfg.shared_attn_every or cfg.ssm not in (None, "mamba1"):
        what, item = "the Mamba-2 hybrid stack (zamba2)", "12b"
    elif cfg.ssm is not None:
        return
    elif cfg.attn_type != "gqa":
        what, item = f"{cfg.attn_type} attention", "12d"
    elif cfg.enc_dec:
        what, item = "the encoder-decoder stack", "12d"
    elif cfg.sliding_window:
        what, item = "sliding-window attention and its ring cache", "12d"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {what} is not ported yet (ROADMAP queue 1, item "
        f"{item}); the port serves GQA decoders (dense or MoE) and Mamba-1")


def layer_params(stacked, i: int):
    """Layer ``i``'s parameters: views into the layer-stacked dict."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(generator, cfg: ArchConfig, dt: Dtypes, device):
    """One layer: a Mamba-1 block for an SSM stack, else attention and an
    MLP (``"moe"`` in place of ``"mlp"`` for an MoE config)."""
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dt.param, device=device)
    if cfg.ssm is not None:
        return {"attn_norm": zeros(),
                "ssm": S.mamba_init(generator, cfg, dt, device)}
    p = {
        "attn_norm": zeros(),
        "attn": L.gqa_init(generator, cfg, dt, device),
        "mlp_norm": zeros(),
    }
    if cfg.is_moe:
        p["moe"] = L.moe_init(generator, cfg, dt, device)
    else:
        p["mlp"] = L.mlp_init(generator, cfg, dt, device)
    return p


def _stack_into(stacked, i, layer):
    for k, v in layer.items():
        if isinstance(v, dict):
            _stack_into(stacked[k], i, v)
        else:
            stacked[k][i].copy_(v)


def _empty_stack(layer, n):
    return {k: _empty_stack(v, n) if isinstance(v, dict)
            else v.new_empty((n,) + tuple(v.shape)) for k, v in layer.items()}


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dt: Dtypes = L.FP32, *, device="cuda"):
    """Random parameters drawn from ``generator``, which must live on
    ``device``. The layers are drawn one at a time into preallocated
    stacks, so beside the model only one layer's weights exist at once
    (qwen3-14b in float32 is 59.07 GB, falcon-mamba-7b 28.02 GB)."""
    dev = resolve_device(device, "init_params")
    check_supported(cfg)
    if generator.device.type != dev.type:
        raise ValueError(f"init_params: the generator lives on "
                         f"{generator.device}, the parameters on {dev}")
    params = {
        "embed": L._init(generator, (cfg.vocab, cfg.d_model), 0.02,
                         dt.param, dev),
        "final_norm": torch.zeros(cfg.d_model, dtype=dt.param, device=dev),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = L._init(generator, (cfg.d_model, cfg.vocab),
                                    cfg.d_model ** -0.5, dt.param, dev)
    layer = _layer_init(generator, cfg, dt, dev)
    stacked = _empty_stack(layer, cfg.n_layers)
    _stack_into(stacked, 0, layer)
    del layer
    for i in range(1, cfg.n_layers):
        _stack_into(stacked, i, _layer_init(generator, cfg, dt, dev))
    params["layers"] = stacked
    return params


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------


def _ffn(p, h, cfg: ArchConfig):
    """The layer's MLP, or its MoE on the capacity path as the reference
    serves it."""
    if cfg.is_moe:
        return L.moe_apply(p["moe"], h, cfg)
    return L.mlp_apply(p["mlp"], h, cfg)


def _attn_mlp_block(p, x, cfg: ArchConfig, *, positions, inference=False):
    """Pre-norm attention + MLP/MoE."""
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    x = x + _gqa_train(p["attn"], h, cfg, positions, inference)
    h = L.rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    return x + _ffn(p, h, cfg)


def _qkv(p, h, cfg: ArchConfig, positions):
    """q ``(B, S, nh, hd)`` and k, v ``(B, S, nk, hd)``: projected, q and
    k normed over the head dim (``qk_norm``) and then rotated."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q = (h @ p["wq"].to(h.dtype)).reshape(b, s, cfg.n_heads, hd)
    k = (h @ p["wk"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    v = (h @ p["wv"].to(h.dtype)).reshape(b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.rope(q, positions[:, :, None], cfg.rope_theta)
    k = L.rope(k, positions[:, :, None], cfg.rope_theta)
    return q, k, v


def _gqa_train(p, h, cfg: ArchConfig, positions, inference=False):
    """Full-sequence causal GQA through blocked flash attention (K6 on
    the card). The reference's per-layer sliding window
    (``_window_schedule``) comes with item 12d: ``check_supported``
    rejects every windowed configuration, so here it is always 0."""
    b, s, _ = h.shape
    q, k, v = _qkv(p, h, cfg, positions)
    out = flash_mha(q, k, v, causal=True, skip_masked_blocks=inference)
    hd = cfg.resolved_head_dim
    return out.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(h.dtype)


# ---------------------------------------------------------------------------
# forward (the prefill trunk)
# ---------------------------------------------------------------------------


def _embed(params, tokens, cfg: ArchConfig, dt: Dtypes, frontend=None):
    x = params["embed"][tokens.long()].to(dt.compute)
    if cfg.frontend == "vision" and frontend is not None:
        # VLM stub: precomputed patch embeddings occupy the first
        # frontend_len positions of the sequence
        f = frontend.to(dt.compute)
        x = torch.cat([f, x[:, f.shape[1]:, :]], dim=1)
    return x


def forward_hidden(params, tokens, cfg: ArchConfig, dt: Dtypes = L.FP32, *,
                   frontend=None, inference=False):
    """Token ids ``(B, S)`` -> final-normed hidden states ``(B, S, d)``."""
    check_supported(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, dt, frontend)
    if cfg.ssm is not None:
        x = _scan_ssm(params["layers"], x, cfg)
    else:
        positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
        x = _scan_attn(params["layers"], x, cfg, positions, inference)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _scan_attn(stacked, x, cfg: ArchConfig, positions, inference=False):
    for i in range(cfg.n_layers):
        x = _attn_mlp_block(layer_params(stacked, i), x, cfg,
                            positions=positions, inference=inference)
    return x


def _scan_ssm(stacked, x, cfg: ArchConfig):
    """Pre-norm Mamba-1 layers over the whole sequence from zero states:
    one K8 launch per layer on the card."""
    for i in range(cfg.n_layers):
        lp = layer_params(stacked, i)
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        y, _ = S.mamba_apply(lp["ssm"], h, cfg)
        x = x + y
    return x


def _w_out(params, cfg: ArchConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# serving: cache init, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dt: Dtypes = L.FP32, *, device="cuda"):
    """The zeroed decode cache: ``{"kv": (k, v)}``, each ``(L, batch,
    max_seq, nk, hd)``, or for a Mamba-1 stack ``{"ssm": {"conv": (L,
    batch, K-1, di), "h": (L, batch, di, n)}}``, both float32 as in the
    reference (which sizes no KV cache for it)."""
    dev = resolve_device(device, "init_cache")
    check_supported(cfg)
    if cfg.ssm is not None:
        st = S.mamba_init_state(cfg, cfg.n_layers * batch, device=dev)
        return {"ssm": {k: v.reshape((cfg.n_layers, batch) + v.shape[1:])
                        for k, v in st.items()}}
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv_heads,
             cfg.resolved_head_dim)
    return {"kv": (torch.zeros(shape, dtype=dt.compute, device=dev),
                   torch.zeros(shape, dtype=dt.compute, device=dev))}


def _decode_gqa(p, x, cfg, cache_kv, lengths, *, positions_t):
    """One-token GQA against a KV cache ``(k, v)``, each ``(B, C, nk,
    hd)``. ``lengths`` ``(B,)`` is the number of committed positions (the
    monotonic RAW frontier of DESIGN.md §3.2). The new K/V are written at
    ``lengths % C`` in place (append), then the decode kernel attends
    over the first ``min(lengths + 1, C)`` entries (attend): the
    frontier alone masks, as in the reference."""
    b = x.shape[0]
    hd = cfg.resolved_head_dim
    q, k, v = _qkv(p, x, cfg, positions_t)
    ck, cv = cache_kv
    cap = ck.shape[1]
    slot = lengths % cap
    rows = torch.arange(b, device=x.device)
    ck[rows, slot] = k[:, 0].to(ck.dtype)
    cv[rows, slot] = v[:, 0].to(cv.dtype)
    frontier = torch.clamp(lengths + 1, max=cap)
    out = decode_attention_gqa(q[:, 0], ck, cv, frontier, sm_scale=hd ** -0.5)
    y = out.reshape(b, 1, cfg.n_heads * hd).to(x.dtype) @ p["wo"].to(x.dtype)
    return y, (ck, cv)


def decode_step(params, tokens, cache, lengths, cfg: ArchConfig,
                dt: Dtypes = L.FP32, *, enc_out=None):
    """One decoding step for the whole batch: tokens ``(B, 1)``, lengths
    ``(B,)`` (unused by a Mamba-1 stack, whose state carries the
    position). Returns ``(logits (B, V), cache)``; the cache is updated
    in place (the reference returns a new one) and returned."""
    check_supported(cfg)
    if enc_out is not None:
        raise NotImplementedError("decode_step: cross attention is not "
                                  "ported yet (ROADMAP queue 1, item 12d)")
    x = params["embed"][tokens.long()].to(dt.compute)
    if cfg.ssm is not None:
        x = _ssm_decode(params, x, cache, cfg)
    else:
        x = _dense_decode(params, x, cache, lengths, cfg, lengths[:, None])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, 0].float() @ _w_out(params, cfg).float()
    return logits, cache


def _dense_decode(params, x, cache, lengths, cfg, positions_t):
    """The uniform ``"kv"`` stack, one layer at a time."""
    ck, cv = cache["kv"]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        a, _ = _decode_gqa(lp["attn"], h, cfg, (ck[i], cv[i]), lengths,
                           positions_t=positions_t)
        y = x + a
        h = L.rms_norm(y, lp["mlp_norm"], cfg.norm_eps)
        x = y + _ffn(lp, h, cfg)
    return x


def _ssm_decode(params, x, cache, cfg):
    """The Mamba-1 stack, one recurrent step a layer; each layer's conv
    window and state are overwritten in place with the new ones."""
    conv, hs = cache["ssm"]["conv"], cache["ssm"]["h"]
    for i in range(cfg.n_layers):
        lp = layer_params(params["layers"], i)
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        y, st = S.mamba_apply(lp["ssm"], h, cfg,
                              state={"conv": conv[i], "h": hs[i]})
        conv[i].copy_(st["conv"])
        hs[i].copy_(st["h"])
        x = x + y
    return x


def prefill(params, tokens, cfg: ArchConfig, dt: Dtypes = L.FP32, *,
            frontend=None, max_seq: Optional[int] = None):
    """Full-sequence forward: the last token's logits ``(B, V)``, and a
    cache of ``max_seq`` (default S) positions. As in the reference, the
    cache is a fresh ``init_cache``, not filled by the forward pass
    (ROADMAP queue 3)."""
    b, s = tokens.shape
    hidden = forward_hidden(params, tokens, cfg, dt, frontend=frontend,
                            inference=True)
    logits = hidden[:, -1].float() @ _w_out(params, cfg).float()
    cache = init_cache(cfg, b, max_seq or s, dt, device=tokens.device)
    return logits, cache
