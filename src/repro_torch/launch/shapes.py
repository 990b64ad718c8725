"""Assigned input-shape set (one per arch × shape cell).

The port of ``src/repro/launch/shapes.py``: the same ``ShapeSpec`` table
and ``applicable`` rule. Host code: no torch.
"""

from __future__ import annotations

import dataclasses

from repro_torch.configs.base import ArchConfig


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524_288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: ShapeSpec) -> tuple[bool, str]:
    """(runnable, reason-if-skipped). long_500k needs sub-quadratic
    attention: run for SSM/hybrid/sliding-window archs, skip for pure
    full-attention (DESIGN.md §Arch-applicability)."""
    if shape.name == "long_500k" and not cfg.supports_long_context:
        return False, "SKIP(full-attn)"
    return True, ""


def cells(configs: list[ArchConfig]):
    for cfg in configs:
        for shape in SHAPES.values():
            yield cfg, shape, applicable(cfg, shape)
