"""Blocked (flash-style) attention, the forward only.

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

The reference's custom VJP (its backward by block recomputation) is
training work and waits for ROADMAP queue 1, item 13; the reference has
no backward Pallas kernel.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.attention.kernel import flash_attention_gqa
from repro_torch.kernels.attention.ref import NEG_INF, window_mask

__all__ = ["NEG_INF", "flash_mha", "attention_ref"]


def flash_mha(q, k, v, *, causal: bool = True, window: int = 0,
              q_block: int = 512, kv_block: int = 512,
              skip_masked_blocks: bool = True):
    """``(B, S, H, Dv)`` attention; ``skip_masked_blocks`` is kept for the
    reference's signature (the card kernel always stops at the causal
    diagonal, and the skipped blocks add exactly zero)."""
    del skip_masked_blocks
    return flash_attention_gqa(q, k, v, causal=causal, window=int(window),
                               q_block=q_block, kv_block=kv_block)


def attention_ref(q, k, v, *, causal=True, window=0):
    """Direct O(S²)-memory oracle for ``flash_mha``."""
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
