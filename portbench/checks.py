"""The comparisons that decide ``correct``, each a number held against the
cell's limit (``check.limits`` in its traffic file).

- ``logit_gap`` (serving): for every served token of the sample, the
  reference's best logit at that position less the reference's logit of
  the served token; the widest gap. Greedy decoding serves the program's
  best token, so a sound program reads its rounding only, wherever the
  best two logits lie.
- ``loss_gap``, ``grad_norm_gap``, ``update_norm_gap`` (training): the
  first steps' losses, the norm of each leaf's first gradient as the
  optimizer takes it (clipped), and the norm of each leaf's change over
  the first steps, the program's against the reference's. A leaf is a
  layer's slice of a stacked weight. Each gap is relative: to the loss,
  or to the larger of the leaf's own reference norm and the median
  leaf's. Leaves whose reference gradient is under a thousandth of the
  median leaf's move by round-off alone under Adam, and are left out of
  the change.
"""

from __future__ import annotations

import statistics

import torch

NEGLIGIBLE_GRAD = 1e-3  # of the median leaf's gradient norm


def slices(tree: dict, prefix: str = ""):
    """``(name, tensor)`` of every leaf of a weight tree, the stacked
    layer weights (under ``layers``) cut into one slice a layer:
    ``layers.3.attn.wq_a``."""
    for k in sorted(tree):
        v = tree[k]
        name = prefix + k
        if isinstance(v, dict):
            if k == "layers":
                for sub, t in slices(v):
                    for i in range(t.shape[0]):
                        yield f"{name}.{i}.{sub}", t[i]
            else:
                yield from slices(v, name + ".")
        else:
            yield name, v


def norms(tree: dict) -> dict:
    """The float64 norm of every slice of ``tree``."""
    return {n: float(torch.linalg.vector_norm(t.double()))
            for n, t in slices(tree)}


def logit_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """``max(ref) - ref[served]`` at every position, the widest;
    ``ref_logits`` ``(k, m, V)``, ``served`` ``(k, m)``."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.long()[..., None])[..., 0]
    return float((best - got).max())


def _relative(prog: dict, ref: dict, keep) -> float:
    med = statistics.median(ref[n] for n in keep)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30) for n in keep)


def training_gaps(prog: dict, ref: dict) -> dict:
    """The three training gaps from each side's ``losses``, ``grad``
    (first gradient norms by slice) and ``change`` (norms of the change by
    slice)."""
    loss = max(abs(p - r) / abs(r) for p, r in zip(prog["losses"],
                                                    ref["losses"]))
    names = list(ref["grad"])
    med = statistics.median(ref["grad"].values())
    moved = [n for n in names if ref["grad"][n] >= NEGLIGIBLE_GRAD * med]
    return {"loss_gap": loss,
            "grad_norm_gap": _relative(prog["grad"], ref["grad"], names),
            "update_norm_gap": _relative(prog["change"], ref["change"], moved)}


def verdict(values: dict, limits: dict) -> tuple[bool, dict]:
    """``(correct, {name: {"value", "limit"}})``: correct where every
    number is finite and within its limit."""
    out = {n: {"value": values[n], "limit": limits[n]} for n in limits}
    ok = all(v["value"] == v["value"] and v["value"] <= v["limit"]
             for v in out.values())
    return ok, out
