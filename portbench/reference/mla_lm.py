"""A multi-head latent attention (MLA) language model (minicpm3-4b's
stack, with the port's departures listed in its configuration file), its
training loss, the loss's gradients and AdamW, in plain PyTorch.

Each layer, pre-norm: queries through a rank-``q_lora_rank`` bottleneck
(RMS-normed), keys and values from one RMS-normed latent of
``kv_lora_rank`` and a rotary key of ``qk_rope_dim`` that every head
shares; causal softmax attention at scale ``(qk_nope_dim +
qk_rope_dim)^-0.5``; then a SiLU-gated MLP. The head is the embedding's
transpose (tied). The loss is the mean next-token cross-entropy.

The gradients come layer by layer: a forward without autograd keeps each
layer's input, then each layer is run again under autograd from its input
and differentiated, top first, so the activations of one layer exist at a
time (the heads' attention in groups, so its ``(S, S)`` probabilities
exist for a group at a time). AdamW follows the port's settings (decoupled
weight decay on every leaf, global-norm clipping, warmup then cosine).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from portbench.reference import (draw_tree, mm, operand, precision,
                                 rms_norm, rotary)

HEAD_GROUP = 10  # heads whose attention probabilities exist at once
CE_CHUNK = 512  # positions whose logits exist at once


def leaves(s: dict) -> list:
    L, d, nh = s["n_layers"], s["d_model"], s["n_heads"]
    dn, dr, dv = s["qk_nope_dim"], s["qk_rope_dim"], s["v_head_dim"]
    rq, rkv, ff = s["q_lora_rank"], s["kv_lora_rank"], s["d_ff"]
    small = {"scale": 0.1}
    fan = lambda n: {"scale": n ** -0.5}  # noqa: E731
    return [
        ("embed", (s["vocab"], d), {"scale": 0.02}),
        ("final_norm", (d,), small),
        ("layers.attn_norm", (L, d), small),
        ("layers.attn.wq_a", (L, d, rq), fan(d)),
        ("layers.attn.wq_b", (L, rq, nh * (dn + dr)), fan(rq)),
        ("layers.attn.wkv_a", (L, d, rkv + dr), fan(d)),
        ("layers.attn.wkv_b", (L, rkv, nh * (dn + dv)), fan(rkv)),
        ("layers.attn.wo", (L, nh * dv, d), fan(nh * dv)),
        ("layers.attn.q_a_norm", (L, rq), small),
        ("layers.attn.kv_a_norm", (L, rkv), small),
        ("layers.mlp_norm", (L, d), small),
        ("layers.mlp.w_in", (L, d, ff), fan(d)),
        ("layers.mlp.w_out", (L, ff, d), fan(ff)),
        ("layers.mlp.w_gate", (L, d, ff), fan(d)),
    ]


def draw_weights(s: dict, seed: int, device) -> dict:
    return draw_tree(leaves(s), seed, device)


def _attention(q_nope, q_rope, k_nope, k_rope, v, s: dict, tf32: bool):
    """Causal attention, ``(b, S, nh, dv)``; the heads in groups."""
    b, t, nh, _ = q_nope.shape
    scale = (s["qk_nope_dim"] + s["qk_rope_dim"]) ** -0.5
    future = torch.ones(t, t, dtype=torch.bool, device=v.device).triu(1)
    o = lambda x: operand(x, tf32)  # noqa: E731
    kr = o(k_rope)
    outs = []
    for h0 in range(0, nh, HEAD_GROUP):
        g = slice(h0, min(h0 + HEAD_GROUP, nh))
        sc = (torch.einsum("bqhd,bkhd->bhqk", o(q_nope[:, :, g]),
                           o(k_nope[:, :, g]))
              + torch.einsum("bqhd,bkd->bhqk", o(q_rope[:, :, g]), kr))
        p = torch.softmax((sc * scale).masked_fill(future, -math.inf), dim=-1)
        outs.append(torch.einsum("bhqk,bkhd->bqhd", o(p), o(v[:, :, g])))
    return torch.cat(outs, dim=2)


def layer(p: dict, x, positions, s: dict, tf32: bool):
    """One layer on ``x`` ``(b, S, d)``; ``p`` holds the layer's own
    weights (``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``)."""
    b, t, d = x.shape
    nh, eps = s["n_heads"], s["norm_eps"]
    dn, dr, dv = s["qk_nope_dim"], s["qk_rope_dim"], s["v_head_dim"]
    rkv, theta = s["kv_lora_rank"], s["rope_theta"]
    a = p["attn"]
    h = rms_norm(x, p["attn_norm"], eps)
    q_lat = rms_norm(mm(h, a["wq_a"], tf32), a["q_a_norm"], eps)
    q = mm(q_lat, a["wq_b"], tf32).view(b, t, nh, dn + dr)
    q_nope = q[..., :dn]
    q_rope = rotary(q[..., dn:], positions[:, :, None], theta)
    kv = mm(h, a["wkv_a"], tf32)
    latent = rms_norm(kv[..., :rkv], a["kv_a_norm"], eps)
    k_rope = rotary(kv[..., rkv:], positions, theta)
    up = a["wkv_b"].view(rkv, nh, dn + dv)
    k_nope = mm(latent, up[..., :dn].reshape(rkv, nh * dn), tf32)
    v = mm(latent, up[..., dn:].reshape(rkv, nh * dv), tf32)
    att = _attention(q_nope, q_rope, k_nope.view(b, t, nh, dn), k_rope,
                     v.view(b, t, nh, dv), s, tf32)
    x = x + mm(att.reshape(b, t, nh * dv), a["wo"], tf32)
    m = p["mlp"]
    h = rms_norm(x, p["mlp_norm"], eps)
    gated = F.silu(mm(h, m["w_gate"], tf32)) * mm(h, m["w_in"], tf32)
    return x + mm(gated, m["w_out"], tf32)


def _layer_weights(w: dict, i: int, grad: bool) -> dict:
    def pick(node):
        if isinstance(node, dict):
            return {k: pick(v) for k, v in node.items()}
        leaf = node[i].detach()
        return leaf.requires_grad_() if grad else leaf
    return pick(w["layers"])


def _collect(grads: dict, lw: dict, i: int):
    for k, v in lw.items():
        if isinstance(v, dict):
            _collect(grads[k], v, i)
        else:
            grads[k][i].copy_(v.grad)


def loss_and_grads(w: dict, batch: dict, s: dict, grads: dict, *,
                   tf32: bool = False) -> float:
    """The mean next-token loss of ``batch`` (``tokens``, ``targets``
    ``(b, S)`` on the device) under weights ``w``; the gradient of every
    leaf is written into ``grads`` (a tree like ``w``)."""
    tokens, targets = batch["tokens"].long(), batch["targets"].long()
    b, t = tokens.shape
    positions = torch.arange(t, device=tokens.device)[None].expand(b, t)
    with precision(tf32):
        with torch.no_grad():
            inputs = []
            x = w["embed"][tokens]
            for i in range(s["n_layers"]):
                inputs.append(x)
                x = layer(_layer_weights(w, i, False), x, positions, s, tf32)
        # the final norm and the tied head, by chunks of positions
        top = x.detach().requires_grad_()
        fnorm = w["final_norm"].detach().requires_grad_()
        head = w["embed"].detach().requires_grad_()
        hid = rms_norm(top, fnorm, s["norm_eps"])
        hid_leaf = hid.detach().requires_grad_()
        total = 0.0
        for c0 in range(0, t, CE_CHUNK):
            lg = mm(hid_leaf[:, c0:c0 + CE_CHUNK], head.t(), tf32)
            gold = lg.gather(-1, targets[:, c0:c0 + CE_CHUNK, None])[..., 0]
            part = (torch.logsumexp(lg, -1) - gold).sum() / (b * t)
            part.backward()
            total += float(part.detach())
        hid.backward(hid_leaf.grad)
        grads["final_norm"].copy_(fnorm.grad)
        grads["embed"].copy_(head.grad)
        g = top.grad
        del top, hid, hid_leaf, head
        for i in reversed(range(s["n_layers"])):
            xi = inputs.pop().requires_grad_()
            lw = _layer_weights(w, i, True)
            layer(lw, xi, positions, s, tf32).backward(g)
            _collect(grads["layers"], lw, i)
            g = xi.grad
        grads["embed"].index_add_(0, tokens.reshape(-1),
                                  g.reshape(-1, g.shape[-1]))
    return total


def leaves_of(tree: dict) -> list:
    """The tensors of ``tree`` in a fixed order (sorted keys)."""
    out = []
    for k in sorted(tree):
        v = tree[k]
        out.extend(leaves_of(v) if isinstance(v, dict) else [v])
    return out


def lr_at(opt: dict, step: int) -> float:
    """Linear warmup over ``max(horizon // 20, 5)`` steps, then cosine to
    a tenth of ``lr`` at ``horizon``: the port's schedule as
    ``launch.train.run`` sets it."""
    lr, horizon = opt["lr"], opt["horizon"]
    warm = max(horizon // 20, 5)
    if step < warm:
        return lr * step / warm
    frac = min(max((step - warm) / max(horizon - warm, 1), 0.0), 1.0)
    return lr * (0.1 + 0.9 * 0.5 * (1 + math.cos(math.pi * frac)))


ADAMW = {"b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
         "clip_norm": 1.0}


@torch.no_grad()
def adamw_step(w: dict, grads: dict, m: dict, v: dict, step: int,
               opt: dict) -> float:
    """One AdamW step on every leaf, in place; ``step`` counts from 1.
    The gradients are clipped to a global norm of ``clip_norm`` first
    (left scaled in ``grads``). Returns the clipping scale."""
    c = ADAMW
    gs = leaves_of(grads)
    norm = math.sqrt(sum(float(torch.sum(g * g)) for g in gs))
    scale = min(1.0, c["clip_norm"] / (norm + 1e-9))
    lr = lr_at(opt, step)
    b1c, b2c = 1 - c["b1"] ** step, 1 - c["b2"] ** step
    for leaf in zip(leaves_of(w), gs, leaves_of(m), leaves_of(v)):
        # a stacked leaf a layer at a time: the temporaries stay small
        parts = zip(*leaf) if leaf[0].dim() >= 3 else [leaf]
        for p, g, mm_, vv in parts:
            g.mul_(scale)
            mm_.mul_(c["b1"]).add_(g, alpha=1 - c["b1"])
            vv.mul_(c["b2"]).addcmul_(g, g, value=1 - c["b2"])
            upd = (mm_ / b1c) / ((vv / b2c).sqrt_().add_(c["eps"]))
            upd.add_(p, alpha=c["weight_decay"])
            p.sub_(upd, alpha=lr)
    return scale
