"""Model assembly: serving and the training loss.

The port of the reference's model API (``src/repro/models/transformer.py``)
for all ten configurations: the dense GQA decoders (qwen3-14b,
starcoder2-7b, internvl2-76b's backbone, and gemma3-4b with its
sliding-window layers), the mixture-of-experts ones (phi3.5-moe,
moonshot), the MLA decoder (minicpm3-4b), the encoder-decoder
(whisper-tiny), the pure Mamba-1 one (falcon-mamba-7b) and the Mamba-2
hybrid (zamba2-7b):

  init_params(generator, cfg, dt, device=)     -> params (layer-stacked)
  forward_hidden(params, tokens, cfg, dt)      -> final-normed hidden states
  prefill(params, tokens, cfg, dt, ...)        -> (last-token logits, cache)
  decode_step(params, tokens, cache, lengths, cfg, dt) -> (logits, cache)
  init_cache(cfg, batch, max_seq, dt, device=) -> cache
  loss_fn(params, batch, cfg, dt)              -> mean next-token loss
  chunked_ce(hidden, targets, w_out)           -> the same, from the hidden
  layer_plan(cfg)                              -> the decoder's layers

Parameters are a dict with the reference's key names and shapes, layer
weights stacked over a leading layer axis (``layers.attn.wq`` is
``(L, d, nh·hd)``), so ``models/convert.py`` carries the reference's
weights across leaf by leaf. ``layer_plan`` decides, once per config, the
decoder's layers in run order: each one's parameter stack and index, its
kind (attention, Mamba, or zamba2's shared block), its sliding window and
its slot of the decode cache. ``init_params`` and ``init_cache`` size the
stacks and the cache from it; the forward and the decode step are each one
loop over it, with one body per kind (``_layer_forward``,
``_layer_decode``). The forward takes the layers from one
``torch.unbind`` of each stack (``layer_views``, the reference's
``lax.scan``), so that the backward stacks each weight's gradient once. On
DTensors (a mesh set by ``shardctx.set_mesh_ctx``),
``set_activation_sharding`` redistributes each layer's output, and the
attention layers constrain q, k, v and the output to
``shardctx.attn_spec``, as the reference's do; without a mesh both are
no-ops. Under grad mode each layer body, each whisper encoder layer and
each cross-entropy chunk is recomputed in the backward (``layers.remat``),
where the reference wraps them in ``jax.checkpoint(...,
nothing_saveable)``; zamba2's shared block is not, as in the reference.

Training differentiates through K6 and K8 by their autograd Functions
(``flash.flash_mha``, ``ssm_scan.selective_scan``); MoE layers train on
the capacity path, plain torch, so no K9 is on it.

Full-sequence attention goes through ``flash.flash_mha``, which launches
the flash attention kernel K6 on the card; the decode step's attention
goes through ``kernels.attention.decode_attention_gqa``, the decode
kernel K7, one launch per layer per step. gemma3's local layers pass
their window to K6 and keep a ring of ``min(window, max_seq)`` positions
for K7. A Mamba-1 layer's scan over a sequence launches the
selective-scan kernel K8 once (``models.ssm``); its decode step is the
plain recurrence. A Mamba-2 layer is plain torch both ways (the reference
has no kernel for it); zamba2's one shared attention block runs after
each segment of them, on K6 and K7 like a dense layer, with a KV cache
for each of its applications. MoE layers take the reference's
capacity path, in plain torch, as the reference's serving does; the
grouped matmul kernel K9 runs on the dropless path
(``layers.moe_apply(use_kernel=True)``).

minicpm3's MLA layers prefill on K6 with a value head dim of their own
(q, k 96, v 64) and decode in latent space in plain torch over the
``"mla"`` cache of latent and rotary-key rows (the reference has no
kernel there). moonlight (a config of the port's own) has MLA without a
query LoRA, leading layers with a dense MLP (their own stack,
``dense_layers``, before ``layers``), and MoE layers that its
config serves on the dropless path (``moe_dropless``: K9, no token
dropped) with a sigmoid router. whisper's encoder runs non-causal
``layers.gqa_apply`` on K6 over the stub frame embeddings (``frontend``,
``(B, 1500, 384)``); each decoder layer adds cross attention to the
encoder output (K6), and its decode step recomputes that cross attention
from ``enc_out`` every step (``_cross_decode``). Without ``enc_out`` (``serve_batch`` passes
none, as the reference's does) the cross layer attends one token to
itself; the ``"cross_kv"`` cache is allocated and never read, as in the
reference. On the CPU every kernel runs its plain version.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from repro_torch import pytree, tracing
from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.distributed import partition
from repro_torch.kernels.attention.kernel import decode_attention_gqa
from repro_torch.models import layers as L
from repro_torch.models import shardctx
from repro_torch.models import ssm as S
from repro_torch.models.flash import flash_mha

Dtypes = L.Dtypes

# Optional spec (``partition.P``) applied to layer-boundary activations
# through ``shardctx.constrain``. Set by the launchers (launch/dryrun.py):
# batch-over-data + sequence-over-model (Megatron sequence parallelism)
# keeps the per-layer saved residuals 16x smaller on the production mesh.
ACTIVATION_SHARDING = None


def set_activation_sharding(spec):
    global ACTIVATION_SHARDING
    ACTIVATION_SHARDING = spec


def _constrain(x):
    if ACTIVATION_SHARDING is not None:
        return shardctx.constrain(x, *ACTIVATION_SHARDING)
    return x


def check_supported(cfg: ArchConfig) -> None:
    """Raise ``ValueError`` unless ``cfg`` is a Mamba stack or has GQA or
    MLA attention: the attention types the reference has code for."""
    if cfg.ssm is None and cfg.attn_type not in ("gqa", "mla"):
        raise ValueError(
            f"{cfg.name}: attn_type {cfg.attn_type!r} without an SSM; the "
            f"models (both packages) have GQA and MLA attention and Mamba "
            f"layers only")


def layer_params(stacked, i: int):
    """Layer ``i``'s parameters: views into the layer-stacked dict (on
    DTensors, each gathered over the data axes: ``shardctx.gather_fsdp``)."""
    return {k: layer_params(v, i) if isinstance(v, dict)
            else shardctx.gather_fsdp(v[i]) for k, v in stacked.items()}


def layer_views(stacked, n: int) -> list:
    """The ``n`` layers' parameters of a layer-stacked dict, as
    ``layer_params`` gives them one at a time, from one ``torch.unbind``
    of each leaf: under autograd each leaf's gradient is then one
    ``stack`` of its layers' gradients, where a view per layer
    (``v[i]``) zero-fills a gradient of the whole stack for each layer
    and sums them. Not yet gathered: the forward loops gather each layer
    as they reach it (``_whole_layer``)."""
    unbound = pytree.map_leaves(lambda v: torch.unbind(v, 0), stacked)
    return [pytree.map_leaves(lambda vs: vs[i], unbound) for i in range(n)]


def _whole_layer(p):
    """One layer's parameters, each gathered over the data axes on
    DTensors: zamba2's unstacked shared block, or a layer of
    ``layer_views``."""
    return {k: _whole_layer(v) if isinstance(v, dict)
            else shardctx.gather_fsdp(v) for k, v in p.items()}


# ---------------------------------------------------------------------------
# the layer plan
# ---------------------------------------------------------------------------


class Layer(NamedTuple):
    """One decoder layer: its parameters ``params[stack][index]``
    (``index`` None: zamba2's one unstacked shared block), its ``kind``
    (``"attn"``, ``"ssm"``, or ``"shared"`` for that block), its sliding
    ``window`` (0: global attention), and its decode cache, row ``slot``
    of each leaf of ``cache[cache]``."""
    stack: str
    index: Optional[int]
    kind: str
    window: int
    cache: str
    slot: int


@functools.cache
def layer_plan(cfg: ArchConfig) -> tuple[Layer, ...]:
    """The decoder's layers in run order (whisper's encoder is apart:
    ``_encode``):

    - a Mamba stack: each layer of ``layers`` on its ``"ssm"`` slot, and
      zamba2's shared block after every ``shared_attn_every`` of them, on
      one ``"shared_kv"`` slot for each application;
    - gemma3: every ``(local_global_ratio + 1)``-th layer global, on
      ``"global_kv"``, the others local at ``sliding_window``, each on its
      ring of ``"local_kv"``;
    - else attention on ``"mla"`` (MLA's latent cache) or ``"kv"``, an MoE
      config's ``n_dense_layers`` leading dense layers (``dense_layers``)
      first."""
    if cfg.ssm is not None:
        plan, every = [], cfg.shared_attn_every
        for i in range(cfg.n_layers):
            plan.append(Layer("layers", i, "ssm", 0, "ssm", i))
            if every and (i + 1) % every == 0:
                plan.append(Layer("shared_attn", None, "shared", 0,
                                  "shared_kv", (i + 1) // every - 1))
        return tuple(plan)
    period = (cfg.local_global_ratio + 1
              if cfg.sliding_window and cfg.local_global_ratio else 0)
    plan, n_local = [], 0
    n_dense = cfg.n_dense_layers
    for i in range(cfg.n_layers):
        stack, index = (("dense_layers", i) if i < n_dense
                        else ("layers", i - n_dense))
        if period and (i + 1) % period:
            cache, slot, window = "local_kv", n_local, cfg.sliding_window
            n_local += 1
        elif period:
            cache, slot, window = "global_kv", i - n_local, 0
        else:
            cache, slot, window = ("mla" if cfg.attn_type == "mla" else "kv",
                                   i, 0)
        plan.append(Layer(stack, index, "attn", window, cache, slot))
    return tuple(plan)


def _layer_weights(params, layer: Layer):
    """``layer``'s parameters, each gathered over the data axes on
    DTensors."""
    if layer.index is None:
        return _whole_layer(params[layer.stack])
    return layer_params(params[layer.stack], layer.index)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def _layer_init(generator, cfg: ArchConfig, dt: Dtypes, device, kind: str):
    """One layer: a Mamba block (``kind="ssm"``), or attention (GQA or
    MLA) and an MLP (``"attn"``; ``"moe"`` in place of ``"mlp"`` for an
    MoE config, but in a leading dense layer, ``"dense"``), with cross
    attention to the encoder between them (``"cross"``, whisper's
    decoder)."""
    zeros = lambda: torch.zeros(cfg.d_model, dtype=dt.param, device=device)
    if kind == "ssm":
        return {"attn_norm": zeros(),
                "ssm": S.mamba_init(generator, cfg, dt, device)}
    init = L.mla_init if cfg.attn_type == "mla" else L.gqa_init
    p = {"attn_norm": zeros(), "attn": init(generator, cfg, dt, device)}
    if kind == "cross":
        p["cross_norm"] = zeros()
        p["cross"] = L.gqa_init(generator, cfg, dt, device)
    p["mlp_norm"] = zeros()
    if cfg.is_moe and kind != "dense":
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


def _draw_stack(generator, cfg: ArchConfig, dt: Dtypes, dev, kind: str,
                n: int):
    """``n`` layers of ``kind`` drawn one at a time into preallocated
    stacks, so beside them only one layer's weights exist at once."""
    layer = _layer_init(generator, cfg, dt, dev, kind)
    stacked = _empty_stack(layer, n)
    _stack_into(stacked, 0, layer)
    del layer
    for i in range(1, n):
        _stack_into(stacked, i, _layer_init(generator, cfg, dt, dev, kind))
    return stacked


def init_params(generator: torch.Generator, cfg: ArchConfig,
                dt: Dtypes = L.FP32, *, device="cuda"):
    """Random parameters drawn from ``generator``, which must live on
    ``device``, in the reference's structure. The layers are drawn one at
    a time into preallocated stacks (qwen3-14b in float32 is 59.07 GB,
    falcon-mamba-7b 28.02 GB). whisper's encoder layers (``enc_layers``,
    self attention and MLP) and decoder layers (``layers``, with cross
    attention) are two stacks, and ``enc_norm`` ends the encoder. The
    stacks of ``layer_plan`` are drawn in its order: an MoE config's
    leading dense layers (``dense_layers``) before ``layers``. zamba2's
    shared attention block is drawn once, after the layers."""
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
    if cfg.enc_dec:
        params["enc_layers"] = _draw_stack(generator, cfg, dt, dev, "attn",
                                           cfg.n_enc_layers)
    counts = collections.Counter(layer.stack for layer in layer_plan(cfg))
    kinds = {"dense_layers": "dense",
             "layers": ("cross" if cfg.enc_dec
                        else "ssm" if cfg.ssm is not None else "attn")}
    for stack, kind in kinds.items():
        if counts[stack]:
            params[stack] = _draw_stack(generator, cfg, dt, dev, kind,
                                        counts[stack])
    if cfg.enc_dec:
        params["enc_norm"] = torch.zeros(cfg.d_model, dtype=dt.param,
                                         device=dev)
    if cfg.shared_attn_every:
        params["shared_attn"] = _layer_init(generator, cfg, dt, dev, "attn")
    return params


# ---------------------------------------------------------------------------
# layer bodies
# ---------------------------------------------------------------------------


def _ffn(p, h, cfg: ArchConfig):
    """The layer's MLP, or its MoE: on the capacity path as the reference
    serves it, or dropless on K9 where the config says so
    (``moe_dropless``)."""
    if "moe" in p:
        return L.moe_apply(p["moe"], h, cfg, use_kernel=cfg.moe_dropless)
    return L.mlp_apply(p["mlp"], h, cfg)


def _attn_mlp_block(p, x, cfg: ArchConfig, *, positions, window=0,
                    enc_out=None):
    """Pre-norm attention (GQA or MLA), then cross attention to
    ``enc_out`` where it is given (whisper's decoder), then the MLP/MoE;
    ``window`` is the layer's sliding window (0 = full attention)."""
    h = _norm(x, p["attn_norm"], cfg)
    if cfg.attn_type == "mla":  # K6 over the latent expanded to K, V
        a = L.mla_apply(p["attn"], h, cfg, positions=positions,
                        eps=cfg.norm_eps)
    else:
        a = _gqa_train(p["attn"], h, cfg, positions, window)
    x = x + shardctx.gather_seq_grad(a)
    if enc_out is not None:
        h = _norm(x, p["cross_norm"], cfg)
        x = x + shardctx.gather_seq_grad(L.gqa_apply(
            p["cross"], h, cfg, positions=positions, kv_source=enc_out,
            use_rope=False, eps=cfg.norm_eps))
    h = _norm(x, p["mlp_norm"], cfg)
    return x + shardctx.gather_seq_grad(_ffn(p, h, cfg))


def _norm(x, scale, cfg: ArchConfig):
    """A layer's pre-norm, then the sequence gathered where the layer
    boundary sharded it (``shardctx.gather_seq``): the all-gather of
    sequence parallelism, which XLA inserts for the reference. The
    branch's output is added back with its gradient gathered the same way
    (``shardctx.gather_seq_grad``)."""
    return shardctx.gather_seq(L.rms_norm(x, scale, cfg.norm_eps))


def _qkv(p, h, cfg: ArchConfig, positions):
    """q ``(B, S, nh, hd)`` and k, v ``(B, S, nk, hd)``: projected, q and
    k normed over the head dim (``qk_norm``) and then rotated."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q = shardctx.reshape(h @ p["wq"].to(h.dtype), b, s, cfg.n_heads, hd)
    k = shardctx.reshape(h @ p["wk"].to(h.dtype), b, s, cfg.n_kv_heads, hd)
    v = shardctx.reshape(h @ p["wv"].to(h.dtype), b, s, cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = L.rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = L.rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = L.rope(q, positions[:, :, None], cfg.rope_theta)
    k = L.rope(k, positions[:, :, None], cfg.rope_theta)
    return q, k, v


def _gqa_train(p, h, cfg: ArchConfig, positions, window=0):
    """Full-sequence causal GQA through blocked flash attention (K6 on
    the card), masked to ``window`` keys where it is > 0."""
    b, s, _ = h.shape
    q, k, v = _qkv(p, h, cfg, positions)
    # heads over the model axis (or model folded into batch) keeps the
    # flash loops collective-free; the reference opts MoE archs and
    # internvl2 out (cfg.attn_shard_constraint), measured slower there
    use_c = cfg.attn_shard_constraint and not cfg.is_moe
    spec = shardctx.attn_spec(cfg.n_heads, b) if use_c else None
    if spec is not None:
        q = shardctx.constrain(q, *spec)
        kspec = shardctx.attn_spec(cfg.n_kv_heads, b)
        if kspec is not None:
            k = shardctx.constrain(k, *kspec)
            v = shardctx.constrain(v, *kspec)
    out = flash_mha(q, k, v, causal=True, window=window)
    if spec is not None:
        out = shardctx.constrain(out, *spec)
    hd = cfg.resolved_head_dim
    out = shardctx.reshape(out, b, s, cfg.n_heads * hd)
    return out @ p["wo"].to(h.dtype)


# ---------------------------------------------------------------------------
# forward (the prefill trunk)
# ---------------------------------------------------------------------------


def _lookup(embed, tokens):
    """The embedding rows of ``tokens``. A DTensor table is gathered whole
    first (FSDP's gather before use) and read through ``F.embedding``,
    which follows the tokens' batch shards; DTensor's lookups on a table
    sharded over two mesh dims fail in some torch releases."""
    if shardctx.any_dtensor(embed):
        whole = embed.redistribute(embed.device_mesh,
                                   [shardctx.REPLICATE] * embed.device_mesh.ndim)
        return torch.nn.functional.embedding(tokens.long(), whole)
    return embed[tokens.long()]


def _embed(params, tokens, cfg: ArchConfig, dt: Dtypes, frontend=None):
    x = _lookup(params["embed"], tokens).to(dt.compute)
    if cfg.frontend == "vision" and frontend is not None:
        # VLM stub: precomputed patch embeddings occupy the first
        # frontend_len positions of the sequence
        f = frontend.to(dt.compute)
        x = torch.cat([f, x[:, f.shape[1]:, :]], dim=1)
    return x


def forward_hidden(params, tokens, cfg: ArchConfig, dt: Dtypes = L.FP32, *,
                   frontend=None):
    """Token ids ``(B, S)`` -> final-normed hidden states ``(B, S, d)``.
    whisper's decoder attends to the encoder's output over ``frontend``,
    the stub frame embeddings ``(B, frontend_len, d)``, which it needs."""
    check_supported(cfg)
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, dt, frontend)
    positions = torch.arange(s, device=x.device)[None, :].expand(b, s)
    enc_out = None
    if cfg.enc_dec:
        if frontend is None:
            raise ValueError(f"{cfg.name}: the encoder-decoder needs the "
                             f"frame embeddings (frontend)")
        enc_out = _encode(params, frontend, cfg, dt)
    plan = layer_plan(cfg)
    views = {stack: layer_views(params[stack], n)
             for stack, n in collections.Counter(
                 layer.stack for layer in plan
                 if layer.index is not None).items()}
    for layer in plan:
        lp = (params[layer.stack] if layer.index is None
              else views[layer.stack][layer.index])
        x = _layer_forward(layer, _whole_layer(lp), x, cfg, positions,
                           enc_out)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


def _layer_forward(layer: Layer, lp, x, cfg: ArchConfig, positions,
                   enc_out=None):
    """One layer of the plan over the whole sequence, ``lp`` its
    parameters: a Mamba layer (one K8 launch for Mamba-1 on the card) or
    an attention layer at its window, each recomputed in the backward and
    its output constrained (``_constrain``); zamba2's shared block at full
    attention, neither, as in the reference."""
    if layer.kind == "shared":
        return _attn_mlp_block(lp, x, cfg, positions=positions)
    if layer.kind == "ssm":
        return _constrain(L.remat(_ssm_layer, lp, x, cfg))
    return _constrain(L.remat(
        lambda lp, x: _attn_mlp_block(lp, x, cfg, positions=positions,
                                      window=layer.window, enc_out=enc_out),
        lp, x))


def _ssm_layer(lp, x, cfg: ArchConfig):
    h = _norm(x, lp["attn_norm"], cfg)
    y, _ = S.mamba_apply(lp["ssm"], h, cfg)
    return x + shardctx.gather_seq_grad(y)


def _encode(params, frames, cfg: ArchConfig, dt: Dtypes = L.FP32):
    """whisper's encoder over stub frame embeddings ``(B, F, d)``: pre-norm
    non-causal attention without RoPE (one K6 launch a layer on the card)
    and an MLP per layer, then ``enc_norm``."""
    x = frames.to(dt.compute)
    b, f, _ = x.shape
    positions = torch.arange(f, device=x.device)[None, :].expand(b, f)
    for lp in layer_views(params["enc_layers"], cfg.n_enc_layers):
        x = L.remat(_enc_layer, _whole_layer(lp), x, positions, cfg)
    return L.rms_norm(x, params["enc_norm"], cfg.norm_eps)


def _enc_layer(lp, x, positions, cfg: ArchConfig):
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    y = x + L.gqa_apply(lp["attn"], h, cfg, positions=positions,
                        causal=False, use_rope=False, eps=cfg.norm_eps)
    h = L.rms_norm(y, lp["mlp_norm"], cfg.norm_eps)
    return y + L.mlp_apply(lp["mlp"], h, cfg)


def _w_out(params, cfg: ArchConfig):
    return shardctx.gather_fsdp(params["embed"].T if cfg.tie_embeddings
                                else params["lm_head"])


# ---------------------------------------------------------------------------
# loss: chunked cross-entropy (logits never materialized at (B, S, V))
# ---------------------------------------------------------------------------


def _ce_chunk(h, t, w_out):
    """Summed ``logsumexp - gold logit`` over one chunk ``h`` ``(B, c,
    d)`` of targets ``t`` ``(B, c)``, logits in float32."""
    logits = h.float() @ w_out.float()  # (B, c, V)
    if _vocab_sharded(logits):
        return torch.sum(_logsumexp(logits) - _gold_sharded(logits, t))
    lse = torch.logsumexp(logits, dim=-1)
    gold = shardctx.settle(torch.gather(logits, -1, t[..., None].long()))
    return torch.sum(lse - gold[..., 0])


def _vocab_sharded(logits) -> bool:
    """Whether a mesh dim of more than one device shards ``logits``' last
    (vocabulary) dim."""
    return isinstance(logits, DTensor) and any(
        pl == Shard(logits.ndim - 1) and logits.device_mesh.size(i) > 1
        for i, pl in enumerate(logits.placements))


def _logsumexp(logits):
    """``logsumexp`` over a sharded vocabulary, as a max and a sum that
    DTensor reduces across the shards (``m + log Σ exp(x - m)``, m the
    row's max, held constant): DTensor's ``logsumexp`` would gather whole
    rows of logits on every device first."""
    m = logits.detach().amax(dim=-1, keepdim=True)
    return (m + torch.log(torch.sum(torch.exp(logits - m), dim=-1,
                                    keepdim=True)))[..., 0]


def _gold_sharded(logits, t):
    """Each target's logit from logits whose vocabulary is sharded: each
    rank reads the targets inside its own shard (0 elsewhere), and the
    parts are summed over the vocabulary's mesh dims (``Partial``);
    DTensor's own gather would build whole rows of logits in the
    backward."""
    mesh = logits.device_mesh
    v = logits.ndim - 1
    lp = shardctx.keep(logits.placements, (0, v))
    off, n = partition.shard_range(logits.shape[v], mesh, lp, v)
    idx = shardctx.local(t, mesh, shardctx.follow(lp, {0: Shard(0)}))
    idx = idx.long() - off
    inside = (idx >= 0) & (idx < n)
    g = torch.gather(shardctx.local(logits, mesh, lp), -1,
                     torch.clamp(idx, 0, n - 1)[..., None])[..., 0]
    out = shardctx.follow(lp, {0: Shard(0), v: shardctx.PARTIAL})
    return shardctx.wrap(g * inside, mesh, out, t.shape)


def chunked_ce(hidden, targets, w_out, *, chunk: int = 512):
    """Mean cross-entropy of ``hidden`` ``(B, S, d)`` against ``targets``
    ``(B, S)`` under the head ``w_out`` ``(d, V)``, over chunks of
    ``min(chunk, S)`` positions, each recomputed in the backward (the
    reference's ``chunked_ce``, ``src/repro/models/transformer.py:317``):
    a chunk's ``(B, c, V)`` logits exist only while it runs. As there, S
    must be a multiple of the chunk (the reference fails on its reshape;
    this raises ``ValueError``)."""
    b, s, d = hidden.shape
    c = min(chunk, s)
    if s % c:
        raise ValueError(f"chunked_ce: S={s} is not a multiple of the chunk "
                         f"{c}, as the reference's chunking needs")
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, s, c):
        total = total + L.remat(_ce_chunk, hidden[:, c0:c0 + c],
                                targets[:, c0:c0 + c], w_out)
    return total / (b * s)


def loss_fn(params, batch, cfg: ArchConfig, dt: Dtypes = L.FP32):
    """The mean next-token loss of ``batch`` (``tokens``, ``targets``
    ``(B, S)``; ``frontend`` where the config has one): the forward's
    final hidden states through ``chunked_ce`` under the head (``embed.T``
    when the embeddings are tied)."""
    hidden = forward_hidden(params, batch["tokens"], cfg, dt,
                            frontend=batch.get("frontend"))
    return chunked_ce(shardctx.gather_seq(hidden), batch["targets"],
                      _w_out(params, cfg))


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
      batch, max_seq, nk, hd)`` each;
    - MLA: ``{"mla": (latent (L, batch, max_seq, kv_lora_rank), k_rope
      (L, batch, max_seq, qk_rope_dim))}``;
    - whisper: ``"kv"`` and ``"cross_kv"``, ``(L, batch, frontend_len,
      nk, hd)`` each, which no step reads (``_cross_decode`` recomputes
      the cross K/V from ``enc_out``), as in the reference.

    Under a mesh (``shardctx.set_mesh_ctx`` with a ``DeviceMesh``) the
    leaves are DTensors under ``partition.cache_specs``.
    """
    dev = resolve_device(device, "init_cache")
    check_supported(cfg)
    mesh = shardctx.mesh()
    if isinstance(mesh, DeviceMesh):
        # sharded as the decode cache it feeds, each rank allocating its
        # own shard (the reference's prefill out_shardings)
        meta = _cache(cfg, batch, max_seq, dt, torch.device("meta"))
        specs = partition.validate_divisibility(
            partition.cache_specs(meta, mesh), meta, mesh)
        return partition.map_specs(
            lambda sp, m: partition.zeros(m.shape, sp, mesh, m.dtype, dev),
            specs, meta)
    return _cache(cfg, batch, max_seq, dt, dev)


def _cache(cfg: ArchConfig, batch: int, max_seq: int, dt: Dtypes, dev):
    """``init_cache``'s cache, unsharded: each key's leading axis holds
    that key's slots of ``layer_plan``."""
    n = collections.Counter(layer.cache for layer in layer_plan(cfg))

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt.compute, device=dev)

    def kv(n, positions):
        shape = (n, batch, positions, cfg.n_kv_heads, cfg.resolved_head_dim)
        return zeros(*shape), zeros(*shape)

    if cfg.ssm is not None:
        st = S.mamba_init_state(cfg, n["ssm"] * batch, device=dev)
        cache = {"ssm": {k: v.reshape((n["ssm"], batch) + v.shape[1:])
                         for k, v in st.items()}}
        if cfg.shared_attn_every:
            cache["shared_kv"] = kv(n["shared_kv"], max_seq)
        return cache
    if cfg.sliding_window and cfg.local_global_ratio:
        return {"local_kv": kv(n["local_kv"],
                               min(cfg.sliding_window, max_seq)),
                "global_kv": kv(n["global_kv"], max_seq)}
    if cfg.attn_type == "mla":
        return {"mla": (zeros(n["mla"], batch, max_seq, cfg.kv_lora_rank),
                        zeros(n["mla"], batch, max_seq, cfg.qk_rope_dim))}
    cache = {"kv": kv(n["kv"], max_seq)}
    if cfg.enc_dec:
        cache["cross_kv"] = kv(n["kv"], cfg.frontend_len)
    return cache


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
    frontier = torch.clamp(lengths + 1, max=cap)
    if shardctx.any_dtensor(ck):
        shardctx.write_row(ck, k[:, 0], slot)
        shardctx.write_row(cv, v[:, 0], slot)
        out = _decode_attention_sharded(q[:, 0], ck, cv, frontier, hd ** -0.5)
    else:
        rows = torch.arange(b, device=x.device)
        ck[rows, slot] = k[:, 0].to(ck.dtype)
        cv[rows, slot] = v[:, 0].to(cv.dtype)
        out = decode_attention_gqa(q[:, 0], ck, cv, frontier,
                                   sm_scale=hd ** -0.5)
    y = out.reshape(b, 1, cfg.n_heads * hd).to(x.dtype) @ p["wo"].to(x.dtype)
    return y, (ck, cv)


def _decode_attention_sharded(q, ck, cv, frontier, sm_scale):
    """K7 on DTensor caches, on local shards: the caches' batch and kv-head
    shards are kept (a sequence or head-dim shard is gathered), q and the
    frontier follow them."""
    mesh = ck.device_mesh
    cp = shardctx.keep(ck.placements, (0, 2))
    qp = shardctx.follow(cp, {0: Shard(0), 2: Shard(1)})
    lp = shardctx.follow(cp, {0: Shard(0)})
    out = decode_attention_gqa(
        shardctx.local(q, mesh, qp), shardctx.local(ck, mesh, cp),
        shardctx.local(cv, mesh, cp), shardctx.local(frontier, mesh, lp),
        sm_scale=sm_scale)
    return shardctx.wrap(out, mesh, qp, q.shape)


def decode_step(params, tokens, cache, lengths, cfg: ArchConfig,
                dt: Dtypes = L.FP32, *, enc_out=None):
    """One decoding step for the whole batch: tokens ``(B, 1)``, lengths
    ``(B,)`` (unused by a Mamba-1 stack, whose state carries the
    position). Returns ``(logits (B, V), cache)``; the cache is updated
    in place (the reference returns a new one) and returned. ``enc_out``
    ``(B, S_enc, d)``, whisper's encoder output, feeds its decoder's cross
    attention; without it that layer attends the token to itself, as in
    the reference (``serve_batch`` gives none). Other models ignore it."""
    check_supported(cfg)
    x = _lookup(params["embed"], tokens).to(dt.compute)
    positions_t = lengths[:, None]
    for layer in layer_plan(cfg):
        x = _layer_decode(layer, _layer_weights(params, layer), x, cfg,
                          cache, lengths, positions_t, enc_out)
    with tracing.span("decode.head"):
        x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
        logits = x[:, 0].float() @ _w_out(params, cfg).float()
    return logits, cache


def _layer_decode(layer: Layer, lp, x, cfg: ArchConfig, cache, lengths,
                  positions_t, enc_out=None):
    """One layer of the plan, one token, ``lp`` its parameters: its slot
    of the cache (row ``layer.slot`` of each leaf of
    ``cache[layer.cache]``) is updated in place."""
    leaf, slot = cache[layer.cache], layer.slot
    if layer.kind == "ssm":
        return _ssm_decode(lp, x, cfg, {k: v[slot] for k, v in leaf.items()})
    k, v = leaf
    return _attn_mlp_decode(lp, x, cfg, (k[slot], v[slot]), lengths,
                            positions_t, enc_out)


def _attn_mlp_decode(p, x, cfg, cache_kv, lengths, positions_t,
                     enc_out=None):
    """One pre-norm attention + MLP/MoE layer's step against its cache
    (updated in place): GQA against its K/V (``_decode_gqa``), or MLA
    writing its latent and rotary-key rows at ``lengths`` and attending in
    latent space (``layers.mla_apply``, plain torch). whisper's decoder
    layers add their cross attention between the two: to ``enc_out``
    (``_cross_decode``), or without it to the token itself, as the
    reference does."""
    h = L.rms_norm(x, p["attn_norm"], cfg.norm_eps)
    if cfg.attn_type == "mla":
        a, _ = L.mla_apply(p["attn"], h, cfg, positions=positions_t,
                           kv_cache=cache_kv, cache_len=lengths,
                           eps=cfg.norm_eps)
    else:
        a, _ = _decode_gqa(p["attn"], h, cfg, cache_kv, lengths,
                           positions_t=positions_t)
    y = x + a
    if cfg.enc_dec:
        h = L.rms_norm(y, p["cross_norm"], cfg.norm_eps)
        y = y + (L.gqa_apply(p["cross"], h, cfg, positions=positions_t,
                             use_rope=False, eps=cfg.norm_eps)
                 if enc_out is None else _cross_decode(p, h, cfg, enc_out))
    h = L.rms_norm(y, p["mlp_norm"], cfg.norm_eps)
    return y + _ffn(p, h, cfg)


def _cross_decode(p, h, cfg, enc_out):
    """Cross attention of one token to the whole encoder output, its K/V
    recomputed from ``enc_out`` (K6 at S=1 over S_enc on the card)."""
    return L.gqa_apply(
        p["cross"], h, cfg,
        positions=torch.zeros(h.shape[0], 1, dtype=torch.int32,
                              device=h.device),
        kv_source=enc_out, use_rope=False, eps=cfg.norm_eps)


def _ssm_decode(lp, x, cfg, state):
    """A Mamba layer's recurrent step; its conv window and state
    (``state``'s ``"conv"`` and ``"h"``) are overwritten in place with the
    new ones. Where K10 ran the step it wrote them in place already, and
    the copies are of a tensor onto itself, which torch returns from
    without a launch."""
    h = L.rms_norm(x, lp["attn_norm"], cfg.norm_eps)
    y, st = S.mamba_apply(lp["ssm"], h, cfg, state=state)
    with tracing.span("decode.state_write"):
        state["conv"].copy_(st["conv"])
        state["h"].copy_(st["h"])
    return x + y


def prefill(params, tokens, cfg: ArchConfig, dt: Dtypes = L.FP32, *,
            frontend=None, max_seq: Optional[int] = None):
    """Full-sequence forward: the last token's logits ``(B, V)``, and a
    cache of ``max_seq`` (default S) positions. As in the reference, the
    cache is a fresh ``init_cache``, not filled by the forward pass
    (ROADMAP queue 3)."""
    b, s = tokens.shape
    hidden = forward_hidden(params, tokens, cfg, dt, frontend=frontend)
    logits = hidden[:, -1].float() @ _w_out(params, cfg).float()
    cache = init_cache(cfg, b, max_seq or s, dt, device=tokens.device)
    return logits, cache
