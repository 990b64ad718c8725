"""Monotonic MoE dispatch and the dropless expert FFN on the grouped
matmul kernel (K9).

The port of ``src/repro/kernels/moe_group_mm/ops.py``.
``monotonic_dispatch`` sorts the token → expert stream (stable), so the
expert ids are monotone, and takes each expert's bounds with one
``searchsorted`` (the frontier merge of the paper's §3.3), then pads each
expert's group to whole ``block_t`` row blocks. ``moe_ffn`` is the
dropless top-k FFN built on it: routing (``route``: the reference's
softmax, or DeepSeek-V3's sigmoid with a correction bias), then
``expert_ffn``: dispatch (store), the experts' three grouped products
(``group_matmul``, K9 on the card), combine (load).

As in ``csr_spmv/ops.py``, the reference's ``use_kernel=`` and
``interpret=`` have no counterpart: the device decides, the kernel on
the card and its plain version on the CPU.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.kernels.moe_group_mm.kernel import group_matmul
from repro_torch.kernels.moe_group_mm.ref import group_matmul_ref

__all__ = ["monotonic_dispatch", "group_matmul", "group_matmul_ref",
           "moe_ffn", "expert_ffn", "route"]


def monotonic_dispatch(expert_ids, n_experts: int, block_t: int):
    """Sort the flattened token → expert stream into monotonic order and
    pad each expert's group to a multiple of ``block_t``.

    Returns ``(order, slot_of_assignment, block_expert, group_sizes,
    padded_offsets)``, int32 tensors equal to the reference's:
    ``slot_of_assignment[a]`` is the padded row of assignment ``a``, and
    ``block_expert`` (``n // block_t + n_experts`` entries, the static
    worst case) the expert of each row block, clipped to ``[0, E)``."""
    dev = expert_ids.device
    ids = expert_ids.long()
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_e = ids[order]
    bounds = torch.searchsorted(
        sorted_e, torch.arange(n_experts + 1, device=dev), side="left")
    sizes = bounds[1:] - bounds[:-1]
    padded_sizes = (sizes + block_t - 1) // block_t * block_t
    zero = torch.zeros(1, dtype=torch.long, device=dev)
    padded_offsets = torch.cat([zero, torch.cumsum(padded_sizes, 0)])
    rank_within = torch.arange(n, device=dev) - bounds[sorted_e]
    slot_sorted = padded_offsets[sorted_e] + rank_within
    slot = torch.zeros(n, dtype=torch.long, device=dev)
    slot[order] = slot_sorted
    max_blocks = n // block_t + n_experts
    block_starts = torch.cat([zero, torch.cumsum(padded_sizes // block_t, 0)])
    block_expert = torch.searchsorted(
        block_starts, torch.arange(max_blocks, device=dev), side="right") - 1
    block_expert = block_expert.clamp(0, n_experts - 1)
    return tuple(t.to(torch.int32) for t in (
        order, slot, block_expert, sizes, padded_offsets))


def route(router_logits, top_k: int, *, score: str = "softmax", bias=None,
          scale: float = 1.0):
    """Top-k routing. Returns ``(top_p, top_e)``, the gates and the
    experts, ``(T, top_k)`` each.

    - ``score="softmax"``, as both MoE paths of the reference compute it:
      softmax in float32, the ``top_k`` largest probabilities
      (descending), renormalised to sum to 1.
    - ``score="sigmoid"``, DeepSeek-V3's (``noaux_tc`` with one group):
      ``s = sigmoid(logits)`` in float32; the experts are the ``top_k``
      largest of ``s + bias`` (the correction bias chooses, it does not
      weigh), their gates their ``s``, renormalised to sum to 1.

    The gates are then multiplied by ``scale`` (the routed scaling
    factor)."""
    logits = router_logits.float()
    if score == "softmax":
        top_p, top_e = torch.topk(torch.softmax(logits, dim=-1), top_k,
                                  dim=-1)
    elif score == "sigmoid":
        s = torch.sigmoid(logits)
        _, top_e = torch.topk(s if bias is None else s + bias.float(),
                              top_k, dim=-1)
        top_p = s.gather(-1, top_e)
    else:
        raise ValueError(f"route: unknown score {score!r}")
    return top_p / top_p.sum(dim=-1, keepdim=True) * scale, top_e


def moe_ffn(x, router_logits, w_in, w_gate, w_out, *, top_k: int,
            block_t: int = 128, **routing):
    """Dropless top-k MoE FFN with monotonic dispatch: x ``(T, d_model)``,
    router logits ``(T, E)``, experts' ``w_in``/``w_gate`` ``(E, d_model,
    d_ff)`` (``w_gate`` None for an ungated FFN) and ``w_out`` ``(E,
    d_ff, d_model)`` → ``(T, d_model)`` in x's dtype: ``route`` (with
    ``routing``, its keywords), then ``expert_ffn``."""
    top_p, top_e = route(router_logits, top_k, **routing)
    return expert_ffn(x, top_p, top_e, w_in, w_gate, w_out, block_t=block_t)


def expert_ffn(x, top_p, top_e, w_in, w_gate, w_out, *, block_t: int = 128):
    """The dropless experts of routed tokens: x ``(T, d_model)``, each
    token's gates and experts ``top_p``, ``top_e`` ``(T, k)`` → ``Σ_j
    top_p[:, j] · expert_{top_e[:, j]}(x)``, ``(T, d_model)`` in x's dtype.
    Dispatch (store), the experts' three grouped products
    (``group_matmul``, K9 on the card), combine (load). As the
    reference's, a gated expert always uses SiLU and an ungated one the
    tanh GELU, whatever the config's activation."""
    t, d_model = x.shape
    n_experts, top_k = w_in.shape[0], top_e.shape[-1]
    flat_e = top_e.reshape(-1).to(torch.int32)
    n = flat_e.shape[0]
    _, slot, block_expert, _, _ = monotonic_dispatch(flat_e, n_experts,
                                                     block_t)
    slot = slot.long()
    t_pad = (n // block_t + n_experts) * block_t  # the static upper bound
    token_of_assignment = torch.arange(n, device=x.device) // top_k
    x_sorted = torch.zeros((t_pad, d_model), dtype=x.dtype, device=x.device)
    x_sorted[slot] = x[token_of_assignment]

    def mm(a, w):
        return group_matmul(a, w, block_expert, block_t=block_t)

    h = mm(x_sorted, w_in)
    if w_gate is not None:
        h = F.silu(mm(x_sorted, w_gate)) * h
    else:
        h = F.gelu(h, approximate="tanh")
    y_sorted = mm(h.to(x.dtype), w_out)

    y_assign = y_sorted[slot]
    w_assign = top_p.reshape(-1)[:, None].to(y_assign.dtype)
    out = torch.zeros((t, d_model), dtype=y_assign.dtype, device=x.device)
    out.index_add_(0, token_of_assignment, y_assign * w_assign)
    return out.to(x.dtype)
