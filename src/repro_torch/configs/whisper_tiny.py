"""whisper-tiny [audio]: enc-dec transformer; conv audio frontend is a
STUB (input_specs provides precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865, head_dim=64,
    attn_type="gqa", rope_theta=1e4, gated=False, act="gelu",
    enc_dec=True, n_enc_layers=4,
    frontend="audio", frontend_len=1500,
    tie_embeddings=True,
))
