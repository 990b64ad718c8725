"""moonlight-16b-a3b [moe]: DeepSeek-V3's block at Moonlight's sizes. MLA
without a query LoRA, one leading dense layer, then 26 layers of 64
sigmoid-routed experts (top-6, a correction bias, normalised gates times
2.446) and 2 shared ones, served dropless. The port's own config; the
reference's moonshot-v1-16b-a3b is a GQA stand-in.
[hf:moonshotai/Moonlight-16B-A3B config.json]"""
from repro_torch.configs.base import PortArchConfig, register

CONFIG = register(PortArchConfig(
    name="moonlight-16b-a3b", family="moe",
    n_layers=27, d_model=2048, n_heads=16, n_kv_heads=16,
    d_ff=11264, vocab=163840,
    attn_type="mla", rope_theta=5e4, q_lora_rank=0, kv_lora_rank=512,
    qk_nope_dim=128, qk_rope_dim=64, v_head_dim=128,
    n_experts=64, top_k=6, moe_d_ff=1408, n_shared_experts=2,
    gated=True, act="silu", norm_eps=1e-5, max_seq=8192,
    n_dense_layers=1, router_score="sigmoid", router_bias=True,
    routed_scale=2.446, moe_dropless=True,
))
