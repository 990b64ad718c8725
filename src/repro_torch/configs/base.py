"""Architecture configuration system.

One frozen dataclass describes every assigned architecture; the model
factory (models/transformer.py) builds the right block stack from it.
``reduced()`` produces the CPU smoke-test variant of the same family.

``ArchConfig`` is a copy of the JAX package's ``repro/configs/base.py``
(which imports no JAX, but the port imports nothing of that package):
the fields, ``reduced()``, ``n_params()`` and ``n_active_params()`` are
the reference's, and the tests hold them equal for every architecture
the reference has. ``PortArchConfig`` adds the port's own fields, for
configurations the reference does not have (moonlight-16b-a3b); on an
``ArchConfig`` each reads its default, the reference's behaviour.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | moe | ssm | hybrid | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None  # default d_model // n_heads
    # --- attention variants ---
    attn_type: str = "gqa"  # gqa | mla | none
    qk_norm: bool = False
    rope_theta: float = 1e4
    sliding_window: int = 0  # >0: local attention window
    local_global_ratio: int = 0  # N local layers per 1 global (gemma3: 5)
    # --- MLA (minicpm3) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    # --- FFN ---
    gated: bool = True  # SwiGLU vs plain MLP
    act: str = "silu"
    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0  # per-expert hidden (d_ff used for dense layers)
    n_shared_experts: int = 0
    # --- SSM ---
    ssm: Optional[str] = None  # mamba1 | mamba2
    ssm_state: int = 0
    d_conv: int = 4
    expand: int = 2
    ssm_chunk: int = 128  # chunked-scan length (DESIGN.md §3.3)
    # --- hybrid (zamba2): one shared attention block every N ssm layers ---
    shared_attn_every: int = 0
    # --- encoder/decoder (whisper) ---
    enc_dec: bool = False
    n_enc_layers: int = 0
    # --- modality frontend stub ---
    frontend: Optional[str] = None  # vision | audio
    frontend_len: int = 0  # prompt positions fed by the frontend stub
    # --- misc ---
    # apply the model-internal attention sharding constraint (§Perf B1).
    # Empirically tuned OFF where the per-layer boundary<->attention
    # reshard costs more than the replication it removes (MoE archs,
    # internvl2's d=8192): see EXPERIMENTS.md §Perf C2/D1.
    attn_shard_constraint: bool = True
    tie_embeddings: bool = False
    norm_eps: float = 1e-6
    max_seq: int = 131072

    # The port's own settings: fields of ``PortArchConfig`` only, so an
    # ``ArchConfig`` stays field for field the reference's; here, the
    # defaults it reads.
    n_dense_layers = 0
    router_score = "softmax"
    router_bias = False
    routed_scale = 1.0
    moe_dropless = False

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_attention_free(self) -> bool:
        return self.attn_type == "none" and self.shared_attn_every == 0

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic long context: SSM/hybrid or mostly-sliding-window
        attention. Pure full-attention archs skip long_500k (DESIGN.md
        §Arch-applicability)."""
        return (
            self.ssm is not None
            or (self.sliding_window > 0 and self.local_global_ratio > 0)
        )

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L = self.d_model, self.n_layers
        hd = self.resolved_head_dim
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer = 0
        if self.attn_type == "gqa":
            per_layer += d * hd * self.n_heads  # q
            per_layer += 2 * d * hd * self.n_kv_heads  # k, v
            per_layer += hd * self.n_heads * d  # o
        elif self.attn_type == "mla":
            per_layer += d * self.q_lora_rank + self.q_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.qk_rope_dim
            )
            per_layer += d * (self.kv_lora_rank + self.qk_rope_dim)
            per_layer += self.kv_lora_rank * self.n_heads * (
                self.qk_nope_dim + self.v_head_dim
            )
            per_layer += self.n_heads * self.v_head_dim * d
        if self.ssm is not None:
            di = self.expand * d
            per_layer += 2 * d * di  # in_proj (x, z)
            per_layer += di * self.d_conv
            per_layer += di * (2 * self.ssm_state + 1) if self.ssm == "mamba1" else 0
            per_layer += di * d  # out_proj
        if self.is_moe:
            ff = self.moe_d_ff or self.d_ff
            n_mats = 3 if self.gated else 2
            per_layer += self.n_experts * n_mats * d * ff
            per_layer += d * self.n_experts  # router
            if self.n_shared_experts:
                per_layer += self.n_shared_experts * n_mats * d * ff
        elif self.d_ff:
            n_mats = 3 if self.gated else 2
            per_layer += n_mats * d * self.d_ff
        total = emb + L * per_layer
        if self.enc_dec:
            total += self.n_enc_layers * per_layer  # rough: same block cost
        if self.shared_attn_every:
            total += d * hd * self.n_heads * 2 + 2 * d * self.d_ff  # one shared block
        return total

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: top_k of n_experts)."""
        if not self.is_moe:
            return self.n_params()
        full = self.n_params()
        ff = self.moe_d_ff or self.d_ff
        n_mats = 3 if self.gated else 2
        expert_params = self.n_layers * self.n_experts * n_mats * self.d_model * ff
        active_experts = self.n_layers * (
            (self.top_k + self.n_shared_experts) * n_mats * self.d_model * ff
        )
        return full - expert_params + active_experts

    def reduced(self) -> "ArchConfig":
        """CPU smoke-test variant: same family/block structure, tiny dims."""
        return dataclasses.replace(
            self,
            name=self.name + "-reduced",
            n_layers=min(self.n_layers, 2),
            n_enc_layers=min(self.n_enc_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            head_dim=16,
            d_ff=128,
            moe_d_ff=64 if self.is_moe else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            n_shared_experts=min(self.n_shared_experts, 1),
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_dim=8 if self.qk_nope_dim else 0,
            qk_rope_dim=8 if self.qk_rope_dim else 0,
            v_head_dim=16 if self.v_head_dim else 0,
            ssm_state=min(self.ssm_state, 8) if self.ssm_state else 0,
            expand=2,
            ssm_chunk=16,
            sliding_window=32 if self.sliding_window else 0,
            shared_attn_every=2 if self.shared_attn_every else 0,
            frontend_len=8 if self.frontend else 0,
            max_seq=512,
        )


@dataclasses.dataclass(frozen=True)
class PortArchConfig(ArchConfig):
    """An ``ArchConfig`` with the port's own fields (DeepSeek-V3's block as
    Moonlight publishes it), each defaulting to the reference's
    behaviour."""

    # leading layers with a dense MLP of ``d_ff`` before the MoE layers
    # (``first_k_dense_replace``)
    n_dense_layers: int = 0
    # "softmax": top-k of the softmax, renormalised (the reference's);
    # "sigmoid": top-k of sigmoid(logits) + router_bias, the gates their
    # sigmoid renormalised, times routed_scale (``scoring_func`` sigmoid,
    # ``noaux_tc`` with one group, ``norm_topk_prob``)
    router_score: str = "softmax"
    router_bias: bool = False  # ``e_score_correction_bias``, (E,)
    routed_scale: float = 1.0  # ``routed_scaling_factor``
    # serve the MoE on the dropless path (K9), not the capacity path
    moe_dropless: bool = False

    def _layer_counts(self) -> tuple[int, int, int, int]:
        """Parameters of one attention part, dense MLP, MoE layer's
        experts and MoE layer's rest (router, bias, shared experts)."""
        d, nh = self.d_model, self.n_heads
        dn, dr, dv = self.qk_nope_dim, self.qk_rope_dim, self.v_head_dim
        n_mats = 3 if self.gated else 2
        if self.attn_type == "mla":
            rq, rkv = self.q_lora_rank, self.kv_lora_rank
            q = d * rq + rq * nh * (dn + dr) if rq else d * nh * (dn + dr)
            attn = (q + d * (rkv + dr) + rkv * nh * (dn + dv)
                    + nh * dv * d)
        else:
            hd = self.resolved_head_dim
            attn = 2 * d * hd * (self.n_heads + self.n_kv_heads)
        ff = self.moe_d_ff or self.d_ff
        experts = self.n_experts * n_mats * d * ff
        rest = (d * self.n_experts + self.n_experts * self.router_bias
                + self.n_shared_experts * n_mats * d * ff)
        return attn, n_mats * d * self.d_ff, experts, rest

    def n_params(self) -> int:
        """Parameters in products, the router's bias too (embeddings and
        blocks; no norms, as ``ArchConfig.n_params``)."""
        attn, dense, experts, rest = self._layer_counts()
        n_moe = self.n_layers - self.n_dense_layers if self.is_moe else 0
        emb = self.vocab * self.d_model * (1 if self.tie_embeddings else 2)
        return (emb + self.n_layers * attn
                + (self.n_layers - n_moe) * dense + n_moe * (experts + rest))

    def n_active_params(self) -> int:
        if not self.is_moe:
            return self.n_params()
        _, _, experts, _ = self._layer_counts()
        n_moe = self.n_layers - self.n_dense_layers
        return (self.n_params()
                - n_moe * experts * (self.n_experts - self.top_k)
                // self.n_experts)


_REGISTRY: dict[str, ArchConfig] = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_names() -> list[str]:
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # import side effect registers each architecture
    from repro_torch.configs import (  # noqa: F401
        falcon_mamba_7b,
        gemma3_4b,
        internvl2_76b,
        minicpm3_4b,
        moonlight_16b_a3b,
        moonshot_v1_16b,
        phi35_moe,
        qwen3_14b,
        starcoder2_7b,
        whisper_tiny,
        zamba2_7b,
    )
