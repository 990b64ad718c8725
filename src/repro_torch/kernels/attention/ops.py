"""Public attention wrappers used by the model stack.

On the card the CUDA kernels (K6 flash attention, K7 decode attention)
are the path; on the CPU, which the tests use, the same entry points run
their plain torch versions. The model calls the GQA-layout entries
(``flash_attention_gqa`` from ``models.flash.flash_mha``,
``decode_attention_gqa`` from ``transformer._decode_gqa``).
"""

from repro_torch.kernels.attention.kernel import (
    decode_attention,
    decode_attention_gqa,
    flash_attention,
    flash_attention_gqa,
)
from repro_torch.kernels.attention.ref import (
    decode_attention_ref,
    decode_gqa_ref,
    flash_attention_ref,
    flash_gqa_ref,
)

__all__ = [
    "flash_attention",
    "flash_attention_ref",
    "decode_attention",
    "decode_attention_ref",
    "flash_attention_gqa",
    "flash_gqa_ref",
    "decode_attention_gqa",
    "decode_gqa_ref",
]
