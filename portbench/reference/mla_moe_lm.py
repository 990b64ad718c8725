"""A DeepSeek-V3-style language model at Moonlight-16B-A3B's sizes (MLA
without a query LoRA, leading dense layers, then mixture-of-experts
layers with a sigmoid router and shared experts; the port's departures
listed in its configuration file), in plain PyTorch, over whole
sequences with no cache and no batching of experts.

Each layer, pre-norm:

- attention: ``q = h·W_q``, ``n_heads`` heads of ``qk_nope_dim`` plus
  ``qk_rope_dim`` features, the latter rotated; ``kv_a = h·W_kv_a``, the
  latent ``RMSNorm(kv_a[:kv_lora_rank])`` and one rotary key
  ``RoPE(kv_a[kv_lora_rank:])`` that every head shares; ``W_kv_b`` maps
  the latent to each head's key (``qk_nope_dim``) and value
  (``v_head_dim``); causal softmax at scale ``(qk_nope_dim +
  qk_rope_dim)^-0.5``; ``W_o``. The keys and values are expanded per
  head, not absorbed;
- the first ``n_dense_layers``: a SiLU-gated MLP of ``d_ff``;
- the others: ``s = sigmoid(h·W_r)`` in float32, the experts the
  ``top_k`` largest of ``s + b`` (``b`` the correction bias), the gates
  their ``s`` divided by their sum, times ``routed_scale``; the output is
  ``Σ gate · expert(h)`` over the chosen experts, each a SiLU-gated MLP
  of ``moe_d_ff``, plus the shared experts, one SiLU-gated MLP of
  ``n_shared_experts · moe_d_ff``. The experts are computed one at a
  time, each over the tokens that chose it: no dispatch buffer, no
  padding, no capacity, so no token is dropped.

Then the final RMS norm and the untied head.

A top-k choice is not continuous: where two experts' scores lie within
rounding of each other, two float32 computations of the same model may
choose differently, and the token then takes another path through every
later layer. ``logits`` can therefore take another computation's choices
(``routes``) and follow them wherever they lie within ``tie`` of its own
(``moe``), keeping its own choice everywhere else.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import (draw_tree, mm, operand, precision,
                                 rms_norm, rotary)


def leaves(s: dict) -> list:
    """``(path, shape, spec)`` of every weight, in the program's layout:
    the leading dense layers stacked under ``dense_layers``, the MoE
    layers under ``layers``."""
    nd = s["n_dense_layers"]
    nm = s["n_layers"] - nd
    d, nh, v = s["d_model"], s["n_heads"], s["vocab"]
    dn, dr, dv = s["qk_nope_dim"], s["qk_rope_dim"], s["v_head_dim"]
    rkv, ff = s["kv_lora_rank"], s["d_ff"]
    e, mff = s["n_experts"], s["moe_d_ff"]
    sff = s["n_shared_experts"] * mff
    small = {"scale": 0.1}
    fan = lambda n: {"scale": n ** -0.5}  # noqa: E731

    def attn(stack, n):
        return [
            (f"{stack}.attn_norm", (n, d), small),
            (f"{stack}.attn.wq", (n, d, nh * (dn + dr)), fan(d)),
            (f"{stack}.attn.wkv_a", (n, d, rkv + dr), fan(d)),
            (f"{stack}.attn.wkv_b", (n, rkv, nh * (dn + dv)), fan(rkv)),
            (f"{stack}.attn.wo", (n, nh * dv, d), fan(nh * dv)),
            (f"{stack}.attn.kv_a_norm", (n, rkv), small),
            (f"{stack}.mlp_norm", (n, d), small),
        ]

    out = [
        ("embed", (v, d), {"scale": 0.02}),
        ("final_norm", (d,), small),
        ("lm_head", (d, v), fan(d)),
    ]
    if nd:
        out += attn("dense_layers", nd) + [
            ("dense_layers.mlp.w_in", (nd, d, ff), fan(d)),
            ("dense_layers.mlp.w_out", (nd, ff, d), fan(ff)),
            ("dense_layers.mlp.w_gate", (nd, d, ff), fan(d)),
        ]
    return out + attn("layers", nm) + [
        ("layers.moe.router", (nm, d, e), fan(d)),
        ("layers.moe.router_bias", (nm, e), small),
        ("layers.moe.w_in", (nm, e, d, mff), fan(d)),
        ("layers.moe.w_out", (nm, e, mff, d), fan(mff)),
        ("layers.moe.w_gate", (nm, e, d, mff), fan(d)),
        ("layers.moe.shared.w_in", (nm, d, sff), fan(d)),
        ("layers.moe.shared.w_out", (nm, sff, d), fan(sff)),
        ("layers.moe.shared.w_gate", (nm, d, sff), fan(d)),
    ]


def draw_weights(s: dict, seed: int, device) -> dict:
    return draw_tree(leaves(s), seed, device)


def _swiglu(x, w_in, w_gate, w_out, tf32: bool):
    return mm(F.silu(mm(x, w_gate, tf32)) * mm(x, w_in, tf32), w_out, tf32)


def attention(a: dict, h, positions, s: dict, tf32: bool):
    """MLA over ``h`` ``(b, S, d)``, the weights ``a`` of one layer."""
    b, t, _ = h.shape
    nh, eps, theta = s["n_heads"], s["norm_eps"], s["rope_theta"]
    dn, dr, dv = s["qk_nope_dim"], s["qk_rope_dim"], s["v_head_dim"]
    rkv = s["kv_lora_rank"]
    q = mm(h, a["wq"], tf32).view(b, t, nh, dn + dr)
    q_nope = q[..., :dn]
    q_rope = rotary(q[..., dn:], positions[:, :, None], theta)
    kv = mm(h, a["wkv_a"], tf32)
    latent = rms_norm(kv[..., :rkv], a["kv_a_norm"], eps)
    k_rope = rotary(kv[..., rkv:], positions, theta)
    up = a["wkv_b"].view(rkv, nh, dn + dv)
    k_nope = mm(latent, up[..., :dn].reshape(rkv, nh * dn), tf32)
    v = mm(latent, up[..., dn:].reshape(rkv, nh * dv), tf32)
    o = lambda x: operand(x, tf32)  # noqa: E731
    sc = (torch.einsum("bqhd,bkhd->bhqk", o(q_nope),
                       o(k_nope.view(b, t, nh, dn)))
          + torch.einsum("bqhd,bkd->bhqk", o(q_rope), o(k_rope)))
    future = torch.ones(t, t, dtype=torch.bool, device=h.device).triu(1)
    p = torch.softmax((sc * (dn + dr) ** -0.5).masked_fill(future, -math.inf),
                      dim=-1)
    att = torch.einsum("bhqk,bkhd->bqhd", o(p), o(v.view(b, t, nh, dv)))
    return mm(att.reshape(b, t, nh * dv), a["wo"], tf32)


def moe(m: dict, h, s: dict, tf32: bool, theirs=None, tie: float = 0.0):
    """The routed experts and the shared ones over ``h`` ``(b, S, d)``,
    the weights ``m`` of one layer; returns the output, each token's
    experts ``(b, S, top_k)`` and, with ``theirs``, each token's slack.

    ``theirs`` ``(b, S, top_k)``, another computation's experts for the
    same tokens, are taken in place of this one's top-k for each token
    where every one of them scores (``s + b``) within ``tie`` of this
    one's ``top_k``-th best: a choice that rounding alone can turn. A
    token's slack is how far below that best their worst lies (0 or less
    where they chose as this one does)."""
    b, t, d = h.shape
    x = h.reshape(b * t, d)
    score = torch.sigmoid(mm(x, m["router"], tf32).float())
    biased = score + m["router_bias"]
    best, top = torch.topk(biased, s["top_k"], dim=-1)
    slack = None
    if theirs is not None:
        theirs = theirs.reshape(b * t, -1).long()
        slack = (best[:, -1:] - biased.gather(-1, theirs)).amax(-1)
        top = torch.where((slack <= tie)[:, None], theirs, top)
        slack = slack.view(b, t)
    gate = score.gather(-1, top)
    gate = gate / gate.sum(-1, keepdim=True) * s["routed_scale"]
    out = _swiglu(x, m["shared"]["w_in"], m["shared"]["w_gate"],
                  m["shared"]["w_out"], tf32)
    for e in range(s["n_experts"]):
        tok, j = torch.nonzero(top == e, as_tuple=True)
        if tok.numel():
            y = _swiglu(x[tok], m["w_in"][e], m["w_gate"][e], m["w_out"][e],
                        tf32)
            out.index_add_(0, tok, y * gate[tok, j, None])
    return out.view(b, t, d), top.view(b, t, -1), slack


def _layer_weights(stack: dict, i: int) -> dict:
    return {k: _layer_weights(v, i) if isinstance(v, dict) else v[i]
            for k, v in stack.items()}


def logits(w: dict, tokens: torch.Tensor, s: dict, *, first: int = 0,
           tf32: bool = False, routes=None, tie: float = 0.0,
           chosen=None) -> torch.Tensor:
    """The logits ``(k, S - first, vocab)`` at positions ``first..S-1`` of
    token ids ``tokens`` ``(k, S)``, each from the positions up to it.

    ``routes`` ``(k, S, n_moe, top_k)``: the experts another computation
    chose in each MoE layer, taken where they lie within ``tie`` of this
    one's choice (``moe``). ``chosen``, a list, receives for each MoE
    layer the experts this computation used, ``(k, S, top_k)``, and with
    ``routes`` the slack of theirs, ``(k, S)``."""
    eps = s["norm_eps"]
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    stacks = [("dense_layers", i) for i in range(s["n_dense_layers"])]
    stacks += [("layers", i)
               for i in range(s["n_layers"] - s["n_dense_layers"])]
    with precision(tf32):
        x = w["embed"][tokens.long()]
        for name, i in stacks:
            p = _layer_weights(w[name], i)
            x = x + attention(p["attn"], rms_norm(x, p["attn_norm"], eps),
                              positions, s, tf32)
            h = rms_norm(x, p["mlp_norm"], eps)
            if "moe" in p:
                y, top, slack = moe(
                    p["moe"], h, s, tf32,
                    None if routes is None else routes[:, :, i], tie)
                x = x + y
                if chosen is not None:
                    chosen.append((top, slack))
            else:
                x = x + _swiglu(h, p["mlp"]["w_in"], p["mlp"]["w_gate"],
                                p["mlp"]["w_out"], tf32)
        x = rms_norm(x[:, first:], w["final_norm"], eps)
        return mm(x, w["lm_head"], tf32)
