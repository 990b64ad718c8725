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

On DTensors (a mesh, ``models.shardctx``), ``flash_mha`` runs the kernel
on local shards (``_flash_sharded``): batch and head shards are kept,
anything else (a sequence shard, a partial sum) is gathered first, and
each rank's query heads meet their own kv heads through
``flash_mha_local``, which takes the shards' global head offsets. The
kernel's inputs stay plain tensors, so ``_Flash`` is unchanged.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Shard

from repro_torch.kernels.attention.kernel import flash_attention_gqa
from repro_torch.models import shardctx
from repro_torch.kernels.attention.ref import NEG_INF, window_mask

__all__ = ["NEG_INF", "flash_mha", "flash_mha_local", "flash_bwd",
           "attention_ref"]


def flash_mha(q, k, v, *, causal: bool = True, window: int = 0,
              q_block: int = 512, kv_block: int = 512):
    """``(B, S, H, Dv)`` attention."""
    window = int(window)
    if shardctx.any_dtensor(q, k, v):
        return _flash_sharded(q, k, v, causal=causal, window=window,
                              q_block=q_block, kv_block=kv_block)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k, v)):
        return _Flash.apply(q, k, v, bool(causal), window, q_block,
                            kv_block)
    return flash_attention_gqa(q, k, v, causal=causal, window=window,
                               q_block=q_block, kv_block=kv_block)


def flash_mha_local(q, k, v, *, rep: int, q_head_offset: int = 0,
                    kv_head_offset: int = 0, **kw):
    """``flash_mha`` on one rank's shards: q holds the query heads from
    global head ``q_head_offset`` on, k and v the kv heads from
    ``kv_head_offset`` on, and globally query head ``h`` reads kv head
    ``h // rep``. The kv heads these query heads read are cut out of k
    and v; where the local grouping would pair a query head with another
    kv head than its global one (the query shard does not cover whole
    groups, or lies inside one), k and v get one head per query head."""
    hl = q.shape[2]
    want = [(q_head_offset + j) // rep - kv_head_offset for j in range(hl)]
    lo, hi = want[0], want[-1] + 1
    if lo < 0 or hi > k.shape[2]:
        raise ValueError(
            f"flash_mha_local: query heads {q_head_offset}..."
            f"{q_head_offset + hl - 1} read kv heads outside the local "
            f"{kv_head_offset}...{kv_head_offset + k.shape[2] - 1}")
    k, v = k[:, :, lo:hi], v[:, :, lo:hi]
    nk = hi - lo
    if hl % nk or any(w - lo != j // (hl // nk) for j, w in enumerate(want)):
        idx = torch.tensor([w - lo for w in want], device=k.device)
        k, v = k.index_select(2, idx), v.index_select(2, idx)
    return flash_mha(q, k, v, **kw)


def _flash_sharded(q, k, v, **kw):
    """``flash_mha`` on DTensors, by local shards: q keeps its batch and
    head shards (``shardctx.keep``); k and v follow q's batch shards and,
    on a mesh dim where q's heads are sharded, keep a head shard of their
    own or are read whole (their gradient then partial)."""
    mesh = shardctx.mesh_of(q, k, v)
    qp = shardctx.keep(q.placements if isinstance(q, DTensor)
                       else [shardctx.REPLICATE] * mesh.ndim, (0, 2))
    kp_in = (k.placements if isinstance(k, DTensor)
             else [shardctx.REPLICATE] * mesh.ndim)
    kp, kg = [], []
    for pq, pk in zip(qp, kp_in):
        if pq == Shard(2) and pk != Shard(2):
            kp.append(shardctx.REPLICATE)
            kg.append(shardctx.PARTIAL)
        else:
            kp.append(pq)
            kg.append(pq)
    _flash_sharded.calls += 1
    h, hk = q.shape[2], k.shape[2]
    q_off, _ = shardctx.shard_range(h, mesh, qp, 2)
    k_off, _ = shardctx.shard_range(hk, mesh, kp, 2)
    out = flash_mha_local(
        shardctx.local(q, mesh, qp), shardctx.local(k, mesh, kp, kg),
        shardctx.local(v, mesh, kp, kg), rep=h // hk, q_head_offset=q_off,
        kv_head_offset=k_off, **kw)
    return shardctx.wrap(out, mesh, qp, tuple(q.shape[:3]) + (v.shape[3],))


_flash_sharded.calls = 0  # calls on DTensors (each runs K6 on local shards)


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
