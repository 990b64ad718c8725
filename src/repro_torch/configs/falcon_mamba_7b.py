"""falcon-mamba-7b [ssm]: pure Mamba-1, attention-free.
[arXiv:2410.05355; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=65024,
    attn_type="none", ssm="mamba1", ssm_state=16, d_conv=4, expand=2,
    gated=False,
))
