"""Blocked (flash-style) attention with its backward by block recomputation.

``flash_mha`` is the port of the reference's ``flash_mha``
(``src/repro/models/flash.py``): q ``(B, S, H, D)`` over k
``(B, S_kv, Hk, D)`` and v ``(B, S_kv, Hk, Dv)`` (``Dv`` differs from
``D`` in MLA's prefill), query head ``h`` on kv head ``h // (H // Hk)``,
scale ``D**-0.5``, online softmax in float32. On a CUDA tensor it
launches the flash attention kernel K6
(``kernels/attention/csrc/attention.cu``, the twin of the TPU kernel the
reference's docstring names); on the CPU it runs the plain blocked loop
(``kernels/attention/ref.flash_gqa_ref``). ``window > 0`` (gemma3's
sliding window) masks keys ``j <= i - window`` on either.

Where autograd needs it (grad mode on, an input requiring grad),
``flash_mha`` runs ``_Flash``, the port of the reference's custom VJP: the
forward (K6 on the card, the plain loop on the CPU) keeps only
``(q, k, v, out, lse)``, ``lse`` ``(B, Hk, H // Hk, S)`` the rows'
log-sum-exp, and ``flash_bwd`` recomputes the probabilities blockwise
from them (``D_i = rowsum(dO·O)``, ``p = exp(s - lse)``), accumulating
dq, dk and dv in float32, as ``_flash_bwd`` does
(``src/repro/models/flash.py:122``). The reference's backward is JAX
outside any Pallas kernel, so its port is plain torch, the same code on
both devices. Two deviations from it: the blocks need not divide S or
S_kv (the ragged tails are sliced, as the forward's are), and blocks
that every mask hides are skipped (their probabilities are exactly 0,
so they add exactly 0).

Without grad (serving), ``flash_mha`` calls the kernel directly and no
``lse`` is written.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import flash_attention_gqa
from repro_torch.kernels.attention.ref import NEG_INF, window_mask

__all__ = ["NEG_INF", "flash_mha", "flash_bwd", "attention_ref"]


def flash_mha(q, k, v, *, causal: bool = True, window: int = 0,
              q_block: int = 512, kv_block: int = 512,
              skip_masked_blocks: bool = True):
    """``(B, S, H, Dv)`` attention; ``skip_masked_blocks`` is kept for the
    reference's signature (the card kernel always stops at the causal
    diagonal, and the skipped blocks add exactly zero)."""
    del skip_masked_blocks
    window = int(window)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, bool(causal), window, q_block,
                            kv_block)
    return flash_attention_gqa(q, k, v, causal=causal, window=window,
                               q_block=q_block, kv_block=kv_block)


class _Flash(torch.autograd.Function):
    """The reference's ``_flash`` custom VJP: residuals ``(q, k, v, out,
    lse)``, the backward recomputed blockwise (``flash_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_block, kv_block):
        out, lse = flash_attention_gqa(q, k, v, causal=causal, window=window,
                                       q_block=q_block, kv_block=kv_block,
                                       return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_block, kv_block)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, out, lse, g, *ctx.args)
        return dq, dk, dv, None, None, None, None


def flash_bwd(q, k, v, out, lse, g, causal=True, window=0, q_block=512,
              kv_block=512):
    """The gradients ``(dq, dk, dv)`` of ``flash_mha`` at the output's
    cotangent ``g`` ``(B, S, H, Dv)``, from the forward's residuals: per q
    block, ``D_i = rowsum(dO·O)``; per kv block, ``p = exp(s - lse)``,
    ``dv += pᵀ dO``, ``ds = p (dO Vᵀ - D)``, ``dq += ds K``, ``dk += dsᵀ q``
    (q pre-scaled), and ``dq`` scaled once more at the end; float32
    throughout, each result in its input's dtype."""
    b, s, h, d = q.shape
    s_kv, hk = k.shape[1], k.shape[2]
    dv_ = v.shape[3]
    rep = h // hk
    scale = d ** -0.5
    qb, kb = min(q_block, s), min(kv_block, s_kv)
    dev = q.device
    qr = q.reshape(b, s, hk, rep, d).float() * scale
    kr, vr = k.float(), v.float()
    do = g.reshape(b, s, hk, rep, dv_).float()
    o = out.reshape(b, s, hk, rep, dv_).float()
    dq = torch.empty(b, s, hk, rep, d, device=dev)
    dk = torch.zeros(b, s_kv, hk, d, device=dev)
    dv = torch.zeros(b, s_kv, hk, dv_, device=dev)
    # every row keeps a key its masks leave visible (as K6's window skip
    # asks), so a block every mask hides has p = exp(-1e30 - lse) = 0
    skip = not window or s < s_kv + window
    for q0 in range(0, s, qb):
        qblk, doblk = qr[:, q0:q0 + qb], do[:, q0:q0 + qb]
        n_q = qblk.shape[1]
        lblk = lse[..., q0:q0 + n_q].float()  # (b, hk, rep, n_q)
        dmat = torch.einsum("bqhrd,bqhrd->bhrq", doblk, o[:, q0:q0 + n_q])
        q_pos = torch.arange(q0, q0 + n_q, device=dev)
        dq_blk = torch.zeros(b, n_q, hk, rep, d, device=dev)
        for k0 in range(0, s_kv, kb):
            n_k = min(kb, s_kv - k0)
            if skip and causal and k0 > q0 + n_q - 1:
                break  # every key of this block and after is in the future
            if skip and window and k0 + n_k - 1 <= q0 - window:
                continue  # wholly left of every row's window
            kblk, vblk = kr[:, k0:k0 + n_k], vr[:, k0:k0 + n_k]
            sc = torch.einsum("bqhrd,bkhd->bhrqk", qblk, kblk)
            k_pos = torch.arange(k0, k0 + n_k, device=dev)
            sc = torch.where(window_mask(q_pos, k_pos, causal, window), sc,
                             NEG_INF)
            p = torch.exp(sc - lblk[..., None])  # (b, hk, rep, n_q, n_k)
            dv[:, k0:k0 + n_k] += torch.einsum("bhrqk,bqhrd->bkhd", p, doblk)
            dp = torch.einsum("bqhrd,bkhd->bhrqk", doblk, vblk)
            ds = p * (dp - dmat[..., None])
            dq_blk += torch.einsum("bhrqk,bkhd->bqhrd", ds, kblk)
            dk[:, k0:k0 + n_k] += torch.einsum("bhrqk,bqhrd->bkhd", ds, qblk)
        dq[:, q0:q0 + n_q] = dq_blk * scale
    return (dq.reshape(b, s, h, d).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def attention_ref(q, k, v, *, causal=True, window=0):
    """Direct O(S²)-memory oracle for ``flash_mha``; autograd
    differentiates it as it stands."""
    b, s, h, d = q.shape
    hk = k.shape[2]
    rep = h // hk
    qr = q.reshape(b, s, hk, rep, d).float() * (d ** -0.5)
    sc = torch.einsum("bqhrd,bkhd->bhrqk", qr, k.float())
    q_pos = torch.arange(s, device=q.device)
    k_pos = torch.arange(k.shape[1], device=q.device)
    sc = torch.where(window_mask(q_pos, k_pos, causal, window), sc, NEG_INF)
    p = torch.softmax(sc, dim=-1)
    o = torch.einsum("bhrqk,bkhd->bhrqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, s, h, v.shape[3]).to(q.dtype)
