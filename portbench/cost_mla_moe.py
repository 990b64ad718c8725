"""The operations and bytes of a decode step of an MLA stack with leading
dense layers and mixture-of-experts layers (``reference/mla_moe_lm.py``'s
model), from a configuration's sizes and the cell's traffic alone.

Every count is of what the algorithm needs, not of what a kernel happens
to do: the decode attends in latent space (``W_uk`` absorbed into the
query, ``W_uv`` into the output) over the positions a row holds, not
over the whole cache a batch allocates; each routed token is computed by
its ``top_k`` experts, with no pad rows; every weight is read once, of the
untied embedding only the rows gathered.
"""

from __future__ import annotations

from portbench.cost import F32


def mean_positions(batches: list) -> float:
    """The mean number of cached positions a decode step attends, over
    the steps of ``batches`` (``[prompt_len, new_tokens]`` each, one
    position a step): step ``j`` of a batch attends ``j + 1``."""
    steps = [p + n for p, n in batches]
    return sum(k * (k + 1) / 2 for k in steps) / sum(steps)


def attn_words(s: dict) -> int:
    """Weights of one MLA layer's products (no query LoRA, or one)."""
    d, nh = s["d_model"], s["n_heads"]
    dn, dr, dv = s["qk_nope_dim"], s["qk_rope_dim"], s["v_head_dim"]
    rq, rkv = s["q_lora_rank"], s["kv_lora_rank"]
    q = d * rq + rq * nh * (dn + dr) if rq else d * nh * (dn + dr)
    return q + d * (rkv + dr) + rkv * nh * (dn + dv) + nh * dv * d


def expert_words(s: dict) -> int:
    """One routed expert's weights (SiLU-gated: three products)."""
    return 3 * s["d_model"] * s["moe_d_ff"]


def moe_layers(s: dict) -> int:
    return s["n_layers"] - s["n_dense_layers"]


def active_matmul_words(s: dict) -> int:
    """The weights one token's step multiplies: every layer's attention
    products, the dense layers' MLPs, each MoE layer's router, its
    ``top_k`` experts and its shared experts, and the head."""
    d = s["d_model"]
    moe = (d * s["n_experts"] + s["top_k"] * expert_words(s)
           + s["n_shared_experts"] * expert_words(s))
    return (s["n_layers"] * attn_words(s)
            + s["n_dense_layers"] * 3 * d * s["d_ff"]
            + moe_layers(s) * moe + d * s["vocab"])


def param_words(s: dict) -> int:
    """Every weight: the products', the norms', the router's bias, the
    embedding and the untied head."""
    d, e, rkv = s["d_model"], s["n_experts"], s["kv_lora_rank"]
    norms = s["n_layers"] * (2 * d + rkv)
    moe = (d * e + e + e * expert_words(s)
           + s["n_shared_experts"] * expert_words(s))
    return (s["n_layers"] * attn_words(s) + norms
            + s["n_dense_layers"] * 3 * d * s["d_ff"]
            + moe_layers(s) * moe + 2 * s["vocab"] * d + d)


def latent_attention_flops(s: dict, positions: float) -> float:
    """One row's absorbed latent attention in one layer over
    ``positions`` cached positions: the query through ``W_uk``, the
    scores over latent and rotary key, the context over the latent, the
    context through ``W_uv``."""
    nh, rkv = s["n_heads"], s["kv_lora_rank"]
    dn, dr, dv = s["qk_nope_dim"], s["qk_rope_dim"], s["v_head_dim"]
    return 2 * nh * (dn * rkv + positions * (rkv + dr) + positions * rkv
                     + rkv * dv)


def decode_flops(s: dict, batch: int, batches: list) -> float:
    """FLOPs of one decode step over ``batch`` rows, at the mean
    positions of the traffic's steps: 2 a weight a row multiplies
    (``active_matmul_words``) and the latent attention. Norms, SiLU,
    softmax, routing and the gated sum are left out: under 1%."""
    p = mean_positions(batches)
    return batch * (2 * active_matmul_words(s)
                    + s["n_layers"] * latent_attention_flops(s, p))


def decode_bytes(s: dict, batch: int, batches: list) -> float:
    """Bytes one decode step must move: every weight read once (every
    expert: at the cell's batch each one is chosen), of the untied
    embedding only the ``batch`` rows gathered; each layer's latent and
    rotary-key rows read over the mean positions and one row written."""
    words = param_words(s) - (s["vocab"] - batch) * s["d_model"]
    row = s["kv_lora_rank"] + s["qk_rope_dim"]
    cache = s["n_layers"] * batch * row * (mean_positions(batches) + 1)
    return F32 * (words + cache)


def k9_decode_work(s: dict, batch: int) -> dict:
    """K9's work in one decode step: three grouped products a MoE layer
    (``w_in``, ``w_gate``, ``w_out``) over the ``batch · top_k`` routed
    rows. Bytes: every expert's weights read once, each product's rows
    read and written once (x twice, into ``w_in`` and ``w_gate``; the two
    ``moe_d_ff`` outputs; the gated rows into ``w_out`` and its
    output)."""
    d, ff = s["d_model"], s["moe_d_ff"]
    rows = batch * s["top_k"]
    n = moe_layers(s)
    return {
        "launches": 3 * n,
        "flops": n * 3 * 2 * rows * d * ff,
        "bytes": F32 * n * (s["n_experts"] * expert_words(s)
                            + rows * 3 * (d + ff)),
    }
