"""The FLOP and byte counts against hand counts at reduced sizes, and
against the program's own parameter count at full size."""

import pb_cases  # noqa: F401  (the import path)

from portbench import cost, harness
from portbench.reference import mamba1_lm, mla_lm

MAMBA = {"n_layers": 2, "d_model": 8, "expand": 2, "ssm_state": 4,
         "d_conv": 4, "vocab": 32, "tie_embeddings": False}
MLA = {"n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 2,
       "d_ff": 16, "vocab": 32, "q_lora_rank": 4, "kv_lora_rank": 4,
       "qk_nope_dim": 2, "qk_rope_dim": 2, "v_head_dim": 3,
       "tie_embeddings": True}


def test_mamba1_decode_counts_by_hand():
    # a layer: w_in 8x32, conv 4x16, w_bc 16x8, w_dt 16x1, w_out 16x8
    per_layer = 256 + 64 + 128 + 16 + 128
    head = 8 * 32
    state = 7 * 16 * 4
    assert cost.mamba1_decode_flops(MAMBA, 3) == 3 * (
        2 * (2 * per_layer + head) + 2 * state)
    layer_words = 8 + 256 + 64 + 16 + 128 + 64 + 128 + 16 + 16 + 16
    words = 32 * 8 + 8 * 32 + 8 + 2 * layer_words
    assert cost.mamba1_param_words(MAMBA) == words
    # all but 29 embedding rows read; conv window 3x16 and state 16x4
    # read and written a layer and row
    assert cost.mamba1_decode_bytes(MAMBA, 3) == 4 * (
        words - 29 * 8 + 2 * 2 * 3 * (3 * 16 + 16 * 4))


def test_mamba1_words_are_the_reference_layout():
    leaves = mamba1_lm.leaves(dict(MAMBA, norm_eps=1e-6))
    total = 0
    for _, shape, _ in leaves:
        n = 1
        for s in shape:
            n *= s
        total += n
    assert total == cost.mamba1_param_words(MAMBA)


def test_mla_train_counts_by_hand():
    # a layer: wq_a 8x4, wq_b 4x(2*4), wkv_a 8x(4+2), wkv_b 4x(2*5),
    # wo 6x8, the MLP 3x8x16
    per_layer = 32 + 32 + 48 + 40 + 48 + 384
    n = 2 * per_layer + 32 * 8
    assert cost.mla_matmul_params(MLA) == n
    pairs = 5 * 6 // 2
    attn = 2 * 2 * 3 * pairs * (2 * 4 + 2 * 3)  # layers, heads, batch
    assert cost.mla_train_flops(MLA, 3, 5) == 6 * n * 15 + 3 * attn
    k6 = cost.k6_train_work(MLA, 3, 5)
    assert k6["launches"] == 4
    assert k6["flops"] == 4 * 3 * 2 * pairs * (2 * 4 + 2 * 3)
    assert k6["bytes"] == 4 * 4 * (3 * 5 * 2) * (2 * 4 + 2 * 3 + 1)


def test_full_size_counts_against_the_program():
    from repro_torch.configs import base

    s = harness.data("configs", "minicpm3-4b")["sizes"]
    # the program counts the same matrices (no norms; the tied head once)
    assert cost.mla_matmul_params(s) == base.get("minicpm3-4b").n_params()
    assert 4.07e9 < cost.mla_matmul_params(s) < 4.08e9
    assert 110.0e12 < cost.mla_train_flops(s, 2, 2048) < 110.2e12
    words = sum(1 for _ in mla_lm.leaves(s))
    assert words == 14
    f = harness.data("configs", "falcon-mamba-7b")["sizes"]
    assert 7.00e9 < cost.mamba1_param_words(f) < 7.01e9  # 28.02 GB
