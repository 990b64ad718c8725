"""gemma3-4b [dense]: 5:1 local(sliding-window):global attention, 128k
context, qk-norm, huge vocab. [hf:google/gemma-3-*-pt; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-4b", family="dense",
    n_layers=34, d_model=2560, n_heads=8, n_kv_heads=4,
    d_ff=10240, vocab=262144, head_dim=256,
    attn_type="gqa", qk_norm=True, rope_theta=1e6,
    sliding_window=1024, local_global_ratio=5,
    gated=True, act="gelu", tie_embeddings=True,
))
