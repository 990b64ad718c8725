"""Model assembly, the serving subset.

The port of the reference's model API (``src/repro/models/transformer.py``)
for the decoders without MLA or an encoder: the dense GQA ones
(qwen3-14b, starcoder2-7b, internvl2-76b's backbone, and gemma3-4b with
its sliding-window layers), the mixture-of-experts ones (phi3.5-moe,
moonshot), the pure Mamba-1 one (falcon-mamba-7b) and the Mamba-2 hybrid
(zamba2-7b):

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
sharding do nothing on one card and have no counterpart here). gemma3's
local and global layers and zamba2's segments run in the same loop.

Full-sequence attention goes through ``flash.flash_mha``, which launches
the flash attention kernel K6 on the card; the decode step's attention
goes through ``kernels.attention.decode_attention_gqa``, the decode
kernel K7, one launch per layer per step. gemma3's local layers pass
their window to K6 and keep a ring of ``min(window, max_seq)`` positions
for K7. A Mamba-1 layer's scan over a sequence launches the
selective-scan kernel K8 once (``models.ssm``); its decode step is the
plain recurrence. A Mamba-2 layer is plain torch both ways (the reference
has no kernel for it); zamba2's one shared attention block runs after
every ``shared_attn_every`` of them, on K6 and K7 like a dense layer,
with a KV cache for each of its applications. MoE layers take the reference's
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
    (dense, sliding-window or MoE), a Mamba-1 stack or the Mamba-2
    hybrid: the families the port serves."""
    if cfg.ssm is not None:
        return
    if cfg.attn_type != "gqa":
        what = f"{cfg.attn_type} attention"
    elif cfg.enc_dec:
        what = "the encoder-decoder stack"
    else:
        return
    raise NotImplementedError(
        f"{cfg.name}: {what} is not ported yet (ROADMAP queue 1, item "
        f"12d); the port serves GQA decoders (dense, sliding-window or "
        f"MoE), Mamba-1 and the Mamba-2 hybrid")


def layer_params(stacked, i: int):
    """Layer ``i``'s parameters: views into the layer-stacked dict."""
    return {k: layer_params(v, i) if isinstance(v, dict) else v[i]
            for k, v in stacked.items()}


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(generator, cfg: ArchConfig, dt: Dtypes, device, kind: str):
    """One layer: a Mamba block (``kind="ssm"``), or attention and an MLP
    (``"attn"``; ``"moe"`` in place of ``"mlp"`` for an MoE config)."""
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dt.param, device=device)
    if kind == "ssm":
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
    (qwen3-14b in float32 is 59.07 GB, falcon-mamba-7b 28.02 GB).
    zamba2's shared attention block is drawn once, after the layers."""
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
    kind = "ssm" if cfg.ssm is not None else "attn"
    layer = _layer_init(generator, cfg, dt, dev, kind)
    stacked = _empty_stack(layer, cfg.n_layers)
    _stack_into(stacked, 0, layer)
    del layer
    for i in range(1, cfg.n_layers):
        _stack_into(stacked, i, _layer_init(generator, cfg, dt, dev, kind))
    params["layers"] = stacked
    if cfg.shared_attn_every:
        params["shared_attn"] = _layer_init(generator, cfg, dt, dev, "attn")
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


def _attn_mlp_block(p, x, cfg: ArchConfig, *, positions, window=0,
                    inference=False):
    """Pre-norm attention + MLP/MoE; ``window`` is the layer's sliding
    window (0 = full attention)."""
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    x = x + _gqa_train(p["attn"], h, cfg, positions, window, inference)
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


def _gqa_train(p, h, cfg: ArchConfig, positions, window=0, inference=False):
    """Full-sequence causal GQA through blocked flash attention (K6 on
    the card), masked to ``window`` keys where it is > 0."""
    b, s, _ = h.shape
    q, k, v = _qkv(p, h, cfg, positions)
    out = flash_mha(q, k, v, causal=True, window=window,
                    skip_masked_blocks=inference)
    hd = cfg.resolved_head_dim
    return out.reshape(b, s, cfg.n_heads * hd) @ p["wo"].to(h.dtype)


def _window_schedule(cfg: ArchConfig) -> list[int]:
    """Each layer's window, 0 for global attention: gemma3's every
    ``(local_global_ratio + 1)``-th layer is global, the others local at
    ``sliding_window``; every other config's are all 0."""
    if cfg.sliding_window and cfg.local_global_ratio:
        period = cfg.local_global_ratio + 1
        return [0 if (i + 1) % period == 0 else cfg.sliding_window
                for i in range(cfg.n_layers)]
    return [0] * cfg.n_layers


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
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    if cfg.shared_attn_every:
        x = _hybrid_forward(params, x, cfg, positions, inference)
    elif cfg.ssm is not None:
        x = _scan_ssm(params["layers"], x, cfg, range(cfg.n_layers))
    else:
        x = _scan_attn(params["layers"], x, cfg, positions, inference)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _scan_attn(stacked, x, cfg: ArchConfig, positions, inference=False):
    for i, window in enumerate(_window_schedule(cfg)):
        x = _attn_mlp_block(layer_params(stacked, i), x, cfg,
                            positions=positions, window=window,
                            inference=inference)
    return x


def _scan_ssm(stacked, x, cfg: ArchConfig, layers):
    """Pre-norm Mamba layers ``layers`` over the whole sequence from zero
    states: one K8 launch per Mamba-1 layer on the card."""
    for i in layers:
        lp = layer_params(stacked, i)
        h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
        y, _ = S.mamba_apply(lp["ssm"], h, cfg)
        x = x + y
    return x


def _segments(cfg: ArchConfig):
    """zamba2's Mamba layers, as ranges: ``n_layers // shared_attn_every``
    segments of ``shared_attn_every``, each followed by the shared block,
    then the remainder (empty where none)."""
    every = cfg.shared_attn_every
    n_seg = cfg.n_layers // every
    return ([range(i * every, (i + 1) * every) for i in range(n_seg)],
            range(n_seg * every, cfg.n_layers))


def _hybrid_forward(params, x, cfg: ArchConfig, positions, inference=False):
    """zamba2: each segment of Mamba-2 layers, then the one shared
    attention + MLP block at full attention (one K6 launch each), then
    the remaining layers."""
    segments, rest = _segments(cfg)
    for seg in segments:
        x = _scan_ssm(params["layers"], x, cfg, seg)
        x = _attn_mlp_block(params["shared_attn"], x, cfg,
                            positions=positions, inference=inference)
    return _scan_ssm(params["layers"], x, cfg, rest)


def _w_out(params, cfg: ArchConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


# ---------------------------------------------------------------------------
# serving: cache init, prefill, decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ArchConfig, batch: int, max_seq: int,
               dt: Dtypes = L.FP32, *, device="cuda"):
    """The zeroed decode cache, as the reference's:

    - ``{"kv": (k, v)}``, each ``(L, batch, max_seq, nk, hd)``;
    - gemma3: ``{"local_kv": ..., "global_kv": ...}``, the local layers'
      rings of ``min(window, max_seq)`` positions and the global layers'
      ``max_seq``, each ``(layers, batch, positions, nk, hd)``;
    - a Mamba stack: ``{"ssm": {"conv": (L, batch, K-1, di), "h": (L,
      batch, di, n)}}`` (Mamba-1; Mamba-2's ``h`` is ``(L, batch, nh, 64,
      n)``), float32; zamba2 adds ``"shared_kv"``, ``(applications,
      batch, max_seq, nk, hd)`` each.
    """
    dev = resolve_device(device, "init_cache")
    check_supported(cfg)

    def kv(n, positions):
        shape = (n, batch, positions, cfg.n_kv_heads, cfg.resolved_head_dim)
        return (torch.zeros(shape, dtype=dt.compute, device=dev),
                torch.zeros(shape, dtype=dt.compute, device=dev))

    if cfg.ssm is not None:
        st = S.mamba_init_state(cfg, cfg.n_layers * batch, device=dev)
        cache = {"ssm": {k: v.reshape((cfg.n_layers, batch) + v.shape[1:])
                         for k, v in st.items()}}
        if cfg.shared_attn_every:
            cache["shared_kv"] = kv(cfg.n_layers // cfg.shared_attn_every,
                                    max_seq)
        return cache
    if cfg.sliding_window and cfg.local_global_ratio:
        n_global = _window_schedule(cfg).count(0)
        return {"local_kv": kv(cfg.n_layers - n_global,
                               min(cfg.sliding_window, max_seq)),
                "global_kv": kv(n_global, max_seq)}
    return {"kv": kv(cfg.n_layers, max_seq)}


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
    if cfg.shared_attn_every:
        x = _hybrid_decode(params, x, cache, lengths, cfg, lengths[:, None])
    elif cfg.ssm is not None:
        x = _ssm_decode(params, x, cache, cfg, range(cfg.n_layers))
    else:
        x = _dense_decode(params, x, cache, lengths, cfg, lengths[:, None])
    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = x[:, 0].float() @ _w_out(params, cfg).float()
    return logits, cache


def _attn_mlp_decode(p, x, cfg, cache_kv, lengths, positions_t):
    """One pre-norm attention + MLP/MoE layer's step against its KV cache
    (updated in place)."""
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    a, _ = _decode_gqa(p["attn"], h, cfg, cache_kv, lengths,
                       positions_t=positions_t)
    y = x + a
    h = L.rms_norm(y, p["mlp_norm"], cfg.norm_eps)
    return y + _ffn(p, h, cfg)


def _dense_decode(params, x, cache, lengths, cfg, positions_t):
    """The attention stack, one layer at a time: the uniform ``"kv"``
    cache, or gemma3's interleaved local layers (each on its ring) and
    global layers."""
    if "kv" in cache:
        caches = [(cache["kv"], i) for i in range(cfg.n_layers)]
    else:
        caches, n_local = [], 0
        for i, window in enumerate(_window_schedule(cfg)):
            caches.append((cache["local_kv"], n_local) if window else
                          (cache["global_kv"], i - n_local))
            n_local += bool(window)
    for i, ((ck, cv), j) in enumerate(caches):
        x = _attn_mlp_decode(layer_params(params["layers"], i), x, cfg,
                             (ck[j], cv[j]), lengths, positions_t)
    return x


def _hybrid_decode(params, x, cache, lengths, cfg, positions_t):
    """zamba2: each segment's Mamba-2 steps, then the shared block
    against the KV cache of that application (one K7 launch), then the
    remaining layers; states and caches updated in place."""
    sk, sv = cache["shared_kv"]
    segments, rest = _segments(cfg)
    for app, seg in enumerate(segments):
        x = _ssm_decode(params, x, cache, cfg, seg)
        x = _attn_mlp_decode(params["shared_attn"], x, cfg,
                             (sk[app], sv[app]), lengths, positions_t)
    return _ssm_decode(params, x, cache, cfg, rest)


def _ssm_decode(params, x, cache, cfg, layers):
    """Mamba layers ``layers``, one recurrent step each; each layer's
    conv window and state are overwritten in place with the new ones."""
    conv, hs = cache["ssm"]["conv"], cache["ssm"]["h"]
    for i in layers:
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
