"""A ``serve`` cell of a model that routes each token to its top-k experts:
``serve``'s closed loop of offline batches, unchanged, with the program's
routing kept for the check.

A top-k choice is not continuous. Where two experts score within rounding
of each other, the program and the plain reference, both in float32, may
choose differently; the token then takes another path through every later
layer, and ``serve``'s logit gap can read as wide as the TF32 control's
(PERF.md: with the experts on cuBLAS too, 2.06 on one seed in twelve,
against the control's 2.46 and up). So the run goes inside
``tracing.tapping``, and each MoE layer's experts, as the program chose
them, are copied into one buffer (``Routes``); the check's reference takes
the program's choice for a token wherever every expert of it scores within
the cell's ``check.route_tie`` of the reference's own top-k, and its own
choice everywhere else (``reference.logits(..., routes=, tie=)``): a
program that routes wrongly still reads a wide gap. The control, the
reference in TF32, is held to the same rule with its own choices in place
of the program's.

``serve.run`` makes its check through ``serve.reference_gaps``; this
runner puts its own in that name for the run.
"""

from __future__ import annotations

import functools
import sys

import torch

from portbench import checks
from portbench.kinds import serve

WARM_STEPS = 3  # ``serve.run``'s warm-up steps, tapped before the window
# the shortest step the routes' buffer is sized for: a step at the cell's
# batch reads every expert's weights (Moonlight's 64 GB: 19 ms at 3.35 TB/s)
MIN_STEP_S = 0.015


class Routes:
    """The experts each MoE layer of the program chose, copied as tapped
    into one ``uint8`` buffer ``(taps, batch, top_k)``, made before the
    window for as many steps as it can hold: holding the tapped tensors
    themselves would allocate through the window. The buffer doubles if
    it fills."""

    def __init__(self, capacity: int, batch: int, top_k: int, device):
        self.buf = torch.empty((capacity, batch, top_k), dtype=torch.uint8,
                               device=device)
        self.n = 0

    def __call__(self, experts):
        if self.n == len(self.buf):
            self.buf = torch.cat([self.buf, torch.empty_like(self.buf)])
        self.buf[self.n].copy_(experts)
        self.n += 1

    def rows(self, n_moe: int, first: int, steps: int, rows) -> torch.Tensor:
        """The experts of ``rows`` of the batch whose first step is tapped
        step ``first``, at its first ``steps`` positions: ``(len(rows),
        steps, n_moe, top_k)``. Step ``t`` of a batch feeds its position
        ``t``, and taps one tensor a MoE layer, in order."""
        if self.n % n_moe:
            raise RuntimeError(f"{self.n} routing taps for {n_moe} MoE "
                               "layers")
        by_step = self.buf[:self.n].view(self.n // n_moe, n_moe,
                                         *self.buf.shape[1:])
        idx = torch.as_tensor(rows, device=self.buf.device)
        return by_step[first:first + steps][:, :, idx].permute(2, 0, 1, 3)


def run(ctx) -> dict:
    from repro_torch import tracing

    s = ctx.sizes
    if s["n_experts"] > 256:
        raise ValueError("serve_routed keeps expert ids in uint8")
    n_moe = s["n_layers"] - s["n_dense_layers"]
    steps = WARM_STEPS + int(ctx.seconds / MIN_STEP_S) + 1
    kept = Routes(n_moe * steps, int(ctx.cell["traffic"]["batch"]),
                  s["top_k"], ctx.device)
    tie = float(ctx.cell["check"]["route_tie"])
    saved = serve.reference_gaps
    serve.reference_gaps = functools.partial(reference_gaps, routes=kept,
                                             tie=tie)
    try:
        with tracing.tapping({"moe.route": kept}):
            return serve.run(ctx)
    finally:
        serve.reference_gaps = saved


def reference_gaps(ctx, served_rows: list, k: int, *, control=False,
                   routes: Routes, tie: float) -> dict:
    """``serve.reference_gaps`` with the program's routing: the reference
    follows the program's experts within ``tie``, the control's its
    own."""
    s, dev = ctx.sizes, ctx.device
    n_moe = s["n_layers"] - s["n_dense_layers"]
    rows_served = [(0 if sv is None else sv.shape[1], pr.shape[0])
                   for _, pr, sv in served_rows]
    picks = serve._sample(rows_served, k, ctx.seed)
    if not picks:
        return {"logit_gap": float("nan"), "compared": 0}
    first, step = [], min(WARM_STEPS, served_rows[0][0])
    for p_len, _, sv in served_rows:  # every batch but the last is whole
        first.append(step)
        step += p_len + (0 if sv is None else sv.shape[1])
    w = ctx.reference.draw_weights(s, ctx.seed, dev)
    gap, ctl, compared = 0.0, 0.0, 0
    slacks, control_slacks = [], []
    by_batch: dict = {}
    for bi, r in picks:
        by_batch.setdefault(bi, []).append(r)
    for bi, rows in by_batch.items():
        p_len, prompts, served = served_rows[bi]
        seq = torch.cat([prompts[rows], served[rows]], dim=1).to(dev)
        m = served.shape[1]
        inputs = seq[:, :p_len + m - 1]
        want = seq[:, p_len:]
        theirs = routes.rows(n_moe, first[bi], inputs.shape[1], rows)
        used: list = []
        ref = ctx.reference.logits(w, inputs, s, first=p_len - 1,
                                   routes=theirs, tie=tie, chosen=used)
        gap = max(gap, checks.logit_gap(ref, want))
        compared += want.numel()
        slacks += [slack.flatten() for _, slack in used]
        if control:
            used = []
            low = ctx.reference.logits(w, inputs, s, first=p_len - 1,
                                       tf32=True, chosen=used)
            theirs, used = torch.stack([top for top, _ in used], dim=2), []
            held = ctx.reference.logits(w, inputs, s, first=p_len - 1,
                                        routes=theirs, tie=tie, chosen=used)
            ctl = max(ctl, checks.logit_gap(held, low.argmax(-1)))
            control_slacks += [slack.flatten() for _, slack in used]
            del low, held
        del ref
    _report("the program", slacks, tie)
    if control:
        _report("the control", control_slacks, tie)
    out = {"logit_gap": gap, "compared": compared}
    if control:
        out["control"] = {"logit_gap": ctl}
    del w
    return out


def _report(whose: str, slacks: list, tie: float) -> None:
    """One line on standard error: how many of ``whose`` routing choices
    the reference refused (beyond ``tie``) and took (other than its own,
    within ``tie``)."""
    slack = torch.cat(slacks)
    taken = slack[(slack > 0) & (slack <= tie)]
    print(f"routes: of {slack.numel()} choices of {whose}, "
          f"{int((slack > tie).sum())} beyond route_tie {tie!r}, "
          f"{taken.numel()} other than the reference's within it (widest "
          f"{float(taken.max()) if taken.numel() else 0.0!r})",
          file=sys.stderr)
