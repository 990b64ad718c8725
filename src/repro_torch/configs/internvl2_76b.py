"""internvl2-76b [vlm]: InternViT frontend (stub) + InternLM2 backbone.
[arXiv:2404.16821; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    attn_type="gqa", rope_theta=1e6, gated=True, act="silu",
    frontend="vision", frontend_len=256,
    # §Perf D1: at d_model=8192 the boundary<->attention reshard costs
    # 5x more collective than attention replication saves — measured
    # 92s (off) vs 494s (on) on train_4k/16x16
    attn_shard_constraint=False,
))
