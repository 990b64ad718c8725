"""Shared by the benchmark's CPU tests: the import path and the reduced
sizes and traffic that stand in for each cell's on the CPU."""

import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

DECODE = "falcon-mamba-7b.decode-b512"
TRAIN = "minicpm3-4b.train-b2s2048"

SIZES = {
    DECODE: {"n_layers": 2, "d_model": 64, "expand": 2, "ssm_state": 8,
             "d_conv": 4, "vocab": 256, "tie_embeddings": False,
             "norm_eps": 1e-5},
    TRAIN: {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
            "d_ff": 128, "vocab": 256, "q_lora_rank": 32, "kv_lora_rank": 16,
            "qk_nope_dim": 8, "qk_rope_dim": 16, "v_head_dim": 8,
            "rope_theta": 10000.0, "tie_embeddings": True, "norm_eps": 1e-5},
}
TRAFFIC = {
    DECODE: {"batch": 16, "batches": [[4, 8], [12, 24], [8, 16]]},
    TRAIN: {"seq_len": 64, "mean_doc_len": 16},
}


# the control's test needs depth: the float32 reference and its TF32 copy
# part as rounding grows through the layers, so at SIZES they barely do
CONTROL_SIZES = {
    DECODE: dict(SIZES[DECODE], n_layers=32, d_model=128, ssm_state=16,
                 vocab=4096),
    TRAIN: dict(SIZES[TRAIN], n_layers=4, d_model=256, d_ff=512, vocab=4096,
                q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16,
                qk_rope_dim=16, v_head_dim=16),
}
CONTROL_TRAFFIC = {
    DECODE: {"batch": 16, "batches": [[32, 96], [16, 128], [24, 64]]},
    TRAIN: {"seq_len": 128, "mean_doc_len": 64},
}


def run(cell, seed=2**31 + 17, seconds=0.5, *, sizes=None, traffic=None,
        **kw):
    """One run of ``cell`` on the CPU at its reduced sizes."""
    import torch

    from portbench import harness

    torch.manual_seed(0)
    return harness.run_cell(cell, seed, seconds, False, device="cpu",
                            sizes=sizes or SIZES[cell],
                            traffic=traffic or TRAFFIC[cell], **kw)
