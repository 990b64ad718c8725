"""zamba2-7b [hybrid]: Mamba-2 backbone with a shared attention block
applied periodically. [arXiv:2411.15242; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000, head_dim=112,
    attn_type="gqa", ssm="mamba2", ssm_state=64, d_conv=4, expand=2,
    shared_attn_every=6,
    gated=True, act="silu",
))
