"""Plain torch versions of the attention kernels (``csrc/attention.cu``).

For the reference's kernel signatures, ``flash_attention_ref`` and
``decode_attention_ref`` are the JAX package's oracles
(``src/repro/kernels/attention/ref.py``): full scores, one softmax. For
the model's layout, ``flash_gqa_ref`` is ``flash_mha``'s blocked loop
(``src/repro/models/flash.py``, every block pair computed and masked, as
its ``CAUSAL_BLOCKS = "full"``) and ``decode_gqa_ref`` is the decode
attention of ``transformer._decode_gqa``. All compute in float32 and
return the input's type. The tests run them on the CPU against the JAX
package; on the card they are what the CUDA kernels are compared with.

Masked scores are ``NEG_INF = -1e30``, as in the reference, so a row with
nothing committed (``lengths = 0``) averages the whole cache uniformly.
"""

from __future__ import annotations

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, sm_scale=1.0):
    """``(BH, S, d)`` attention over ``(BH, S_kv, d)`` keys and values."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * sm_scale
    if causal:
        ql, kl = q.shape[1], k.shape[1]
        mask = (torch.arange(ql, device=q.device)[:, None]
                >= torch.arange(kl, device=q.device)[None, :])
        s = torch.where(mask[None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v.float()).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, lengths, *, sm_scale=1.0):
    """``(BH, 1, d)`` queries against ``(BH, S_max, d)`` caches, masked at
    ``pos < lengths[bh]``."""
    s = torch.einsum("bqd,bkd->bqk", q.float(), k_cache.float()) * sm_scale
    pos = torch.arange(k_cache.shape[1], device=q.device)
    mask = pos[None, None, :] < lengths.to(q.device)[:, None, None]
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqk,bkd->bqd", p, v_cache.float()).to(q.dtype)


def window_mask(q_pos, k_pos, causal, window):
    """``(len(q_pos), len(k_pos))`` bool: causal (``q >= k``) where asked,
    and inside the sliding window (``k > q - window``) where
    ``window > 0``."""
    mask = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool,
                      device=q_pos.device)
    if causal:
        mask = q_pos[:, None] >= k_pos[None, :]
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    return mask


def flash_gqa_ref(q, k, v, *, causal=True, window=0, q_block=512,
                  kv_block=512, return_lse=False):
    """``flash_mha``'s blocked online softmax: q ``(B, S, H, D)``, k
    ``(B, S_kv, Hk, D)`` and v ``(B, S_kv, Hk, Dv)`` (the output is
    ``(B, S, H, Dv)``), query head ``h`` on kv head ``h // (H // Hk)``,
    scale ``D**-0.5``. The last block of either axis may be ragged (the
    reference asserts that the blocks divide S and S_kv). With
    ``return_lse`` it returns ``(out, lse)``, ``lse`` ``(B, Hk, H // Hk,
    S)`` float32, ``m + log(max(l, 1e-30))`` a row, as the reference's
    ``_flash_fwd_impl`` (``src/repro/models/flash.py:68``)."""
    b, s, h, d = q.shape
    s_kv, hk = k.shape[1], k.shape[2]
    dv = v.shape[3]
    rep = h // hk
    qb, kb = min(q_block, s), min(kv_block, s_kv)
    dev = q.device
    qr = q.reshape(b, s, hk, rep, d).float() * (d ** -0.5)
    kr, vr = k.float(), v.float()
    out = torch.empty(b, s, h, dv, dtype=q.dtype, device=dev)
    lse = torch.empty(b, hk, rep, s, device=dev) if return_lse else None
    for q0 in range(0, s, qb):
        qblk = qr[:, q0:q0 + qb]
        n_q = qblk.shape[1]
        q_pos = torch.arange(q0, q0 + n_q, device=dev)
        acc = torch.zeros(b, hk, rep, n_q, dv, device=dev)
        m = torch.full((b, hk, rep, n_q), NEG_INF, device=dev)
        l = torch.zeros(b, hk, rep, n_q, device=dev)
        for k0 in range(0, s_kv, kb):
            kblk, vblk = kr[:, k0:k0 + kb], vr[:, k0:k0 + kb]
            sc = torch.einsum("bqhrd,bkhd->bhrqk", qblk, kblk)
            k_pos = torch.arange(k0, k0 + kblk.shape[1], device=dev)
            msk = window_mask(q_pos, k_pos, causal, window)
            sc = torch.where(msk, sc, NEG_INF)
            m_new = torch.maximum(m, sc.amax(dim=-1))
            p = torch.exp(sc - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhrqk,bkhd->bhrqd", p, vblk)
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]
        out[:, q0:q0 + n_q] = o.permute(0, 3, 1, 2, 4).reshape(
            b, n_q, h, dv).to(q.dtype)
        if return_lse:
            lse[..., q0:q0 + n_q] = m + torch.log(torch.clamp(l, min=1e-30))
    return (out, lse) if return_lse else out


def decode_gqa_ref(q, k_cache, v_cache, lengths, *, sm_scale):
    """One query per head, q ``(B, H, D)``, against caches
    ``(B, C, Hk, D)`` masked at ``pos < lengths[b]``: ``(B, H, D)``."""
    b, h, d = q.shape
    cap, hk = k_cache.shape[1], k_cache.shape[2]
    qr = q.reshape(b, hk, h // hk, d).float() * sm_scale
    sc = torch.einsum("bhrd,bchd->bhrc", qr, k_cache.float())
    pos = torch.arange(cap, device=q.device)
    mask = pos[None, :] < lengths.to(q.device)[:, None]
    sc = torch.where(mask[:, None, None, :], sc, NEG_INF)
    w = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhrc,bchd->bhrd", w, v_cache.float())
    return out.reshape(b, h, d).to(q.dtype)
