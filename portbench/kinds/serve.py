"""A ``serve`` cell: a closed loop of offline batches through the port's
serve step, a client that mirrors ``launch.serve.serve_batch``.

Set-up draws the weights on the device from the seed, makes the serve step
(``launch.steps.make_serve_step``) and warms it, ``argmax`` and the cache's
allocation up at the cell's batch. The window then runs batch after batch:
each a fresh cache (``models.transformer.init_cache``), its prompt fed one
position a step, then greedy tokens, the last fed back, as ``serve_batch``
does. A CUDA event after each step marks when its token (or its prompt
position) was done; the host clock brackets each step call. When the window's
time is up no further step starts; the run synchronises once and the window
ends.

The check: a sample of the rows served, drawn from the seed, with one row of
the batch that served the most tokens, goes through the plain reference over
its prompt and served tokens; ``checks.logit_gap``.
"""

from __future__ import annotations

import gc
import statistics
import time

import numpy as np
import torch

from portbench import checks, traffic
from portbench.profiling import Trace


def _sample(rows_served: list, k: int, seed: int) -> list:
    """``k`` (batch, row) pairs, one of them in the batch that served the
    most tokens; the rest drawn from every row that served a token."""
    rng = np.random.default_rng([seed, 7])
    pool = [(b, r) for b, (n, rows) in enumerate(rows_served) if n
            for r in range(rows)]
    if not pool:
        return []
    longest = max(range(len(rows_served)), key=lambda b: rows_served[b][0])
    first = (longest, int(rng.integers(rows_served[longest][1])))
    rest = [pool[i] for i in rng.permutation(len(pool)) if pool[i] != first]
    return [first] + rest[:k - 1]


def run(ctx) -> dict:
    from repro_torch.launch import steps
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T

    cfg, s, w, dev = ctx.cfg, ctx.sizes, ctx.cell, ctx.device
    tr = w["traffic"]
    b = int(tr["batch"])
    plan = traffic.decode_plan(tr, s["vocab"], ctx.seed)
    cuda = dev.type == "cuda"

    # -- set-up --------------------------------------------------------------
    params = ctx.reference.draw_weights(s, ctx.seed, dev)
    serve_step = steps.make_serve_step(cfg, L.FP32)
    warm = plan.prompts(0, dev)[:, :3]
    cache = T.init_cache(cfg, b, 4, L.FP32, device=dev)
    lens = torch.zeros(b, dtype=torch.int32, device=dev)
    for t in range(warm.shape[1]):
        logits, cache, lens = serve_step(params, warm[:, t:t + 1], cache, lens)
        torch.argmax(logits, dim=-1)
    del cache, lens, logits
    mark = (lambda: _Event(dev)) if cuda else time.perf_counter
    if cuda:
        torch.cuda.synchronize(dev)

    # -- the window ----------------------------------------------------------
    prof = w.get("profile", {})
    trace = Trace(dev, spans=("serve_step",)) if ctx.trace and cuda else None
    p_from = int(prof.get("skip_steps", 32))
    p_to = p_from + int(prof.get("steps", 16))
    enqueue, marks, in_trace = [], [], []
    batches = []  # (prompt_len, prompts, [served tokens])
    step = 0
    t0 = time.perf_counter()
    deadline = t0 + ctx.seconds

    def one(tokens, cache, lens, pick):
        """One serve step, and where ``pick`` the greedy token after it."""
        nonlocal step
        if trace is not None and step == p_from:
            trace.start()
        traced = trace is not None and trace.running
        h0 = time.perf_counter()
        if traced:
            with torch.profiler.record_function("serve_step"):
                logits, cache, lens = serve_step(params, tokens, cache, lens)
        else:
            logits, cache, lens = serve_step(params, tokens, cache, lens)
        enqueue.append(time.perf_counter() - h0)
        in_trace.append(traced)
        tok = (torch.argmax(logits, dim=-1)[:, None].to(torch.int32)
               if pick else None)
        marks.append(mark())
        step += 1
        if traced and step == p_to:
            trace.stop(p_to - p_from)
        return tok, cache, lens

    cache = lens = tok = None
    i = 0
    while time.perf_counter() < deadline:
        p_len, n_new = plan.shape(i)
        prompts = plan.prompts(i, dev)
        served = []
        batches.append((p_len, prompts, served))
        cache = lens = None  # freed first, as serve_batch's return frees it
        cache = T.init_cache(cfg, b, p_len + n_new + 1, L.FP32, device=dev)
        lens = torch.zeros(b, dtype=torch.int32, device=dev)
        i += 1
        for t in range(p_len):
            tok, cache, lens = one(prompts[:, t:t + 1], cache, lens,
                                   t == p_len - 1)
            if time.perf_counter() >= deadline:
                break
        else:
            for _ in range(n_new):
                served.append(tok)
                tok, cache, lens = one(tok, cache, lens, True)
                if time.perf_counter() >= deadline:
                    break
    if cuda:
        torch.cuda.synchronize(dev)
    window_s = time.perf_counter() - t0
    if trace is not None and trace.running:  # the window ended first
        trace.stop(step - p_from)
    profile = trace.collect() if trace is not None and trace.prof else None

    gaps_ms = [_elapsed_ms(a, z) for a, z in zip(marks, marks[1:])]
    steady = [g for g, a, z in zip(gaps_ms, in_trace, in_trace[1:])
              if not (a or z)]
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    served_rows = [(p, prompts.cpu(), torch.cat(sv, 1).cpu() if sv else None)
                   for p, prompts, sv in batches]
    del params, cache, lens, tok, batches, marks
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    check = w["check"]
    t_check = time.perf_counter()
    readings = reference_gaps(ctx, served_rows, int(check["sample"]),
                              control=ctx.control)
    correct, compared = checks.verdict(
        {"logit_gap": readings["logit_gap"]}, check["limits"])
    record = {
        "setup_s": ctx.setup_s(t0), "window_s": window_s, "steps": step,
        "tokens": step * b, "batch": b,
        "step_enqueue_s": [e for e, tr_ in zip(enqueue, in_trace) if not tr_],
        "gaps_ms": gaps_ms, "steady_step_s": (
            sum(steady) / len(steady) * 1e-3 if steady else None),
        "profile": profile,
    }
    return {"record": record, "correct": correct and readings["compared"] > 0,
            "attempted": b * len(served_rows), "failed": 0,
            "memory_peak_bytes": peak, "checks": compared,
            "check_s": time.perf_counter() - t_check,
            "timing": _spread(gaps_ms, record["step_enqueue_s"]),
            "control": readings.get("control")}


def _spread(gaps_ms: list, enqueue_s: list) -> dict:
    """The gaps' and the host's step times at a few quantiles, in ms."""
    out = {}
    for name, xs in (("gap_ms", gaps_ms),
                     ("enqueue_ms", [e * 1e3 for e in enqueue_s])):
        if len(xs) >= 100:
            q = statistics.quantiles(xs, n=100, method="inclusive")
            out.update({f"{name}_p{p}": q[p - 1] for p in (5, 50, 95, 99)})
    return out


class _Event:
    def __init__(self, dev):
        self.ev = torch.cuda.Event(enable_timing=True)
        self.ev.record(torch.cuda.current_stream(dev))


def _elapsed_ms(a, z) -> float:
    if isinstance(a, _Event):
        return a.ev.elapsed_time(z.ev)
    return (z - a) * 1e3


def reference_gaps(ctx, served_rows: list, k: int, *, control=False) -> dict:
    """The widest logit gap over a sample of ``k`` served rows, and with
    ``control`` the control's: the gap, in the float32 reference's logits,
    of the token that the TF32 reference puts first at each position."""
    s, dev = ctx.sizes, ctx.device
    rows_served = [(0 if sv is None else sv.shape[1], pr.shape[0])
                   for _, pr, sv in served_rows]
    picks = _sample(rows_served, k, ctx.seed)
    if not picks:
        return {"logit_gap": float("nan"), "compared": 0}
    w = ctx.reference.draw_weights(s, ctx.seed, dev)
    gap, ctl, compared = 0.0, 0.0, 0
    by_batch: dict = {}
    for bi, r in picks:
        by_batch.setdefault(bi, []).append(r)
    for bi, rows in by_batch.items():
        p_len, prompts, served = served_rows[bi]
        seq = torch.cat([prompts[rows], served[rows]], dim=1).to(dev)
        m = served.shape[1]
        inputs = seq[:, :p_len + m - 1]
        want = seq[:, p_len:]
        ref = ctx.reference.logits(w, inputs, s, first=p_len - 1)
        gap = max(gap, checks.logit_gap(ref, want))
        compared += want.numel()
        if control:
            low = ctx.reference.logits(w, inputs, s, first=p_len - 1,
                                       tf32=True)
            ctl = max(ctl, checks.logit_gap(ref, low.argmax(-1)))
            del low
        del ref
    out = {"logit_gap": gap, "compared": compared}
    if control:
        out["control"] = {"logit_gap": ctl}
    del w
    return out
