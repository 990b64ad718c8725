"""The operations and bytes that the cells' work needs, from a
configuration's sizes alone (the ``sizes`` of ``configs/<config>.json``),
and the table of the chip's peaks (``peaks.json``).

Decode (Mamba-1 stacks): copies of the arithmetic of the smoke script's
``_decode_bound_ms`` (bytes) and a FLOP count of the same step. Training
(MLA stacks): 6·N·T over the weights that enter a product, plus the
attention's products over the causal pairs; the kernel K6's work at the
cell's shapes. Every count is of what the algorithm needs, not of what a
kernel happens to do (whole diagonal blocks, recomputation).
"""

from __future__ import annotations

import json
from pathlib import Path

F32 = 4  # bytes a word

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())


def peaks(device_kind: str):
    """The data sheet's peaks for ``device_kind`` (the name
    ``torch.cuda.get_device_name`` gives), or None for a chip the table
    does not hold."""
    return PEAKS["chips"].get(device_kind)


# ---------------------------------------------------------------------------
# Mamba-1 decode
# ---------------------------------------------------------------------------


def mamba1_layer_params(s: dict) -> dict:
    """Words of one Mamba-1 layer, by leaf, as the port lays them out."""
    d, di, n, k = s["d_model"], s["expand"] * s["d_model"], s["ssm_state"], \
        s["d_conv"]
    return {"attn_norm": d, "w_in": d * 2 * di, "conv_w": k * di,
            "conv_b": di, "w_out": di * d, "a_log": di * n,
            "w_bc": di * 2 * n, "w_dt": di, "dt_bias": di, "d_skip": di}


def mamba1_decode_flops(s: dict, batch: int) -> int:
    """FLOPs of one decode step over ``batch`` rows: 2 for each weight
    that enters a product (``w_in``, the conv taps, ``w_bc``, ``w_dt``,
    ``w_out``, the head; not the embedding, a gather) a row, and the
    state update's 7 a state word a row: the decay's exponent
    ``-exp(a_log)·dt``, ``dt·B``, its product with x, ``a·h``, the sum
    with it, the product with C and the sum over the state. Elementwise
    work on ``d`` or ``d_inner`` words a row (norms, SiLU, the skip) is
    left out: under 0.1% of the total."""
    lp = mamba1_layer_params(s)
    di, n = s["expand"] * s["d_model"], s["ssm_state"]
    matmul = sum(lp[k] for k in ("w_in", "conv_w", "w_bc", "w_dt", "w_out"))
    head = s["d_model"] * s["vocab"]
    state = 7 * di * n
    return batch * (2 * (s["n_layers"] * matmul + head)
                    + s["n_layers"] * state)


def mamba1_param_words(s: dict) -> int:
    emb = s["vocab"] * s["d_model"]
    head = 0 if s.get("tie_embeddings") else emb
    return (emb + head + s["d_model"]
            + s["n_layers"] * sum(mamba1_layer_params(s).values()))


def mamba1_decode_bytes(s: dict, batch: int) -> int:
    """Bytes one decode step must move: every weight read once, but of
    an untied embedding only the ``batch`` rows gathered; each layer's
    conv window and state read and written."""
    words = mamba1_param_words(s)
    if not s.get("tie_embeddings"):
        words -= (s["vocab"] - batch) * s["d_model"]
    di = s["expand"] * s["d_model"]
    state = (s["d_conv"] - 1) * di + di * s["ssm_state"]
    return F32 * (words + 2 * s["n_layers"] * batch * state)


# ---------------------------------------------------------------------------
# MLA training
# ---------------------------------------------------------------------------


def mla_layer_matmul_words(s: dict) -> int:
    d, nh = s["d_model"], s["n_heads"]
    dn, dr, dv = s["qk_nope_dim"], s["qk_rope_dim"], s["v_head_dim"]
    rq, rkv = s["q_lora_rank"], s["kv_lora_rank"]
    attn = (d * rq + rq * nh * (dn + dr) + d * (rkv + dr)
            + rkv * nh * (dn + dv) + nh * dv * d)
    return attn + 3 * d * s["d_ff"]


def mla_matmul_params(s: dict) -> int:
    """N, the weights that enter a product: each layer's projections and
    its gated MLP, and the head (the tied embedding once, as the head;
    the input lookup is a gather)."""
    head = s["vocab"] * s["d_model"]
    return s["n_layers"] * mla_layer_matmul_words(s) + head


def causal_pairs(seq: int) -> int:
    return seq * (seq + 1) // 2


def mla_attention_pair_flops(s: dict) -> int:
    """One causal pair and head of MLA's attention forward: Q·K over
    ``qk_nope_dim + qk_rope_dim`` and P·V over ``v_head_dim``."""
    return 2 * (s["qk_nope_dim"] + s["qk_rope_dim"]) + 2 * s["v_head_dim"]


def mla_train_flops(s: dict, batch: int, seq: int) -> int:
    """Model FLOPs of one training step: 6·N·T, plus the attention's
    forward and backward, 3 times its forward products a causal pair
    and head. Recomputation is not counted."""
    t = batch * seq
    pairs = s["n_layers"] * s["n_heads"] * batch * causal_pairs(seq)
    return (6 * mla_matmul_params(s) * t
            + 3 * mla_attention_pair_flops(s) * pairs)


def k6_train_work(s: dict, batch: int, seq: int) -> dict:
    """K6's work in one training step of an MLA stack: two launches a
    layer (the forward, and the forward again in the layer's recomputed
    backward), each over the causal pairs of every head; the bytes each
    launch must move: q, k, v read, the output and each row's
    log-sum-exp written."""
    dk = s["qk_nope_dim"] + s["qk_rope_dim"]
    dv = s["v_head_dim"]
    launches = 2 * s["n_layers"]
    rows = batch * seq * s["n_heads"]
    return {
        "launches": launches,
        "flops": launches * batch * s["n_heads"] * causal_pairs(seq)
        * mla_attention_pair_flops(s),
        "bytes": launches * F32 * rows * (2 * dk + 2 * dv + 1),
    }
