"""A ``train`` cell: training steps through the port's fault-tolerant loop,
built as ``launch.train.run`` builds it.

Set-up draws the weights on the device from the seed, makes the train step
(``launch.steps.make_train_step``, AdamW configured as ``launch.train.run``
configures it), the loader (``data.pipeline.ShardedLoader`` over the cell's
packed rows, seeded by the seed) and one ``distributed.fault.
FaultTolerantLoop`` over them, whose checkpoints never come due. It runs the
loop's first steps, which warm every shape up, and reads from them what the
check compares: each step's loss, each leaf's first gradient as the
optimizer took it (from its first moment after one step) and each leaf's
change over those steps (the weights less their draw from the seed). The
window hands the same loop on, a step at a time; each step ends by reading
its metrics on the host, as ``launch.train.run``'s do.

The check: once the window has closed and the program's state is freed, the
plain reference takes the same first steps from the same draw on rows it
packs itself; ``checks.training_gaps``.
"""

from __future__ import annotations

import gc
import shutil
import tempfile
import time

import torch

from portbench import checks, traffic
from portbench.profiling import Trace

SPAN = "adamw.apply_updates"


def program_readings(ctx, loop, opt_cfg, n: int) -> dict:
    """Run the loop's first ``n`` steps; the check's readings of them."""
    first = loop.run(1)
    m = loop.state["opt"]["m"]
    grad = {k: v / (1 - opt_cfg.b1) for k, v in checks.norms(m).items()}
    rest = loop.run(n)
    change = change_norms(ctx, loop.state["params"])
    return {"losses": [x["loss"] for x in first + rest], "grad": grad,
            "change": change}


def change_norms(ctx, params) -> dict:
    """The norm of each slice of ``params`` less its draw from the seed,
    drawn again a leaf at a time."""
    from portbench.reference import draw, get

    out = {}
    for i, (path, shape, spec) in enumerate(ctx.reference.leaves(ctx.sizes)):
        d = draw(spec, shape, ctx.seed, i, ctx.device).sub_(get(params, path))
        tree: dict = {}
        node = tree
        *parents, last = path.split(".")
        for k in parents:
            node = node.setdefault(k, {})
        node[last] = d
        out.update(checks.norms(tree))
        del d, tree, node
    return out


def build(ctx):
    """The program's objects: ``(loop, opt_cfg, checkpoint_dir)``."""
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed.fault import (FaultConfig, FaultTolerantLoop,
                                              StateChanged)
    from repro_torch.launch import steps
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw

    cfg, s, w, dev = ctx.cfg, ctx.sizes, ctx.cell, ctx.device
    tr, opt = w["traffic"], w["optimizer"]
    b, seq = int(tr["batch"]), int(tr["seq_len"])
    horizon = int(opt["horizon"])
    opt_cfg = adamw.AdamWConfig(lr=float(opt["lr"]),
                                warmup_steps=max(horizon // 20, 5),
                                total_steps=horizon)
    step = steps.make_train_step(cfg, opt_cfg, L.FP32)
    loader = ShardedLoader(DataConfig(
        vocab=s["vocab"], seq_len=seq, global_batch=b, seed=ctx.seed,
        mean_doc_len=int(tr["mean_doc_len"])))
    params = ctx.reference.draw_weights(s, ctx.seed, dev)
    state = {"params": params, "opt": adamw.init_state(params)}
    ctx.step_seconds = []

    def step_fn(state, batch):  # launch.train.run's
        t0 = time.perf_counter()
        bt = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        params, opt, metrics = step(state["params"], state["opt"], bt)
        try:
            metrics = {k: float(v) for k, v in metrics.items()}  # waits
        except Exception as e:
            raise StateChanged("the step's metrics could not be read") from e
        ctx.step_seconds.append(time.perf_counter() - t0)
        return {"params": params, "opt": opt}, metrics

    ckpt = tempfile.mkdtemp()
    loop = FaultTolerantLoop(step_fn, state, loader, FaultConfig(
        checkpoint_dir=ckpt, checkpoint_every=10 ** 9))
    return loop, opt_cfg, ckpt


def run(ctx) -> dict:
    from repro_torch.optim import adamw

    s, w, dev = ctx.sizes, ctx.cell, ctx.device
    cuda = dev.type == "cuda"
    tr, check = w["traffic"], w["check"]
    n_check = int(check["steps"])
    tokens_per_step = int(tr["batch"]) * int(tr["seq_len"])

    # -- set-up: the loop's first steps --------------------------------------
    loop, opt_cfg, ckpt = build(ctx)
    try:
        prog = program_readings(ctx, loop, opt_cfg, n_check)
        if cuda:
            torch.cuda.synchronize(dev)
            setup_peak = torch.cuda.max_memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)

        # -- the window ------------------------------------------------------
        prof = w.get("profile", {})
        p_at = int(prof.get("skip_steps", 1))
        p_n = int(prof.get("steps", 1))
        traced = ctx.trace and cuda
        apply_updates = adamw.apply_updates
        if traced:
            def spanned(*a, **k):
                with torch.profiler.record_function(SPAN):
                    return apply_updates(*a, **k)
            adamw.apply_updates = spanned
        trace, steady = None, []
        recoveries = loop.recoveries
        n = 0
        t0 = time.perf_counter()
        deadline = t0 + ctx.seconds
        try:
            while time.perf_counter() < deadline:
                if traced and n == p_at:
                    trace = Trace(dev, spans=(SPAN,))
                    trace.start()
                loop.run(loop.step + 1)
                n += 1
                if trace is not None and trace.running:
                    if n == p_at + p_n:
                        trace.stop(p_n)
                else:
                    steady.append(ctx.step_seconds[-1])
            if trace is not None and trace.running:
                trace.stop(n - p_at)
        finally:
            adamw.apply_updates = apply_updates
        window_s = time.perf_counter() - t0
        profile = trace.collect() if trace is not None else None
        failed = loop.recoveries - recoveries
        peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
        peak = max(setup_peak, peak_window) if cuda else 0
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)
    del loop
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    # -- the check -----------------------------------------------------------
    t_check = time.perf_counter()
    ref = reference_readings(ctx, n_check)
    values = checks.training_gaps(prog, ref)
    correct, compared = checks.verdict(values, check["limits"])
    out = {"record": {
        "setup_s": ctx.setup_s(t0), "window_s": window_s, "steps": n,
        "tokens": n * tokens_per_step, "tokens_per_step": tokens_per_step,
        "step_s": steady, "profile": profile,
        "peak_window_bytes": peak_window},
        "correct": correct, "attempted": n, "failed": failed,
        "memory_peak_bytes": peak, "checks": compared,
        "check_s": time.perf_counter() - t_check}
    if ctx.control:
        low = reference_readings(ctx, n_check, tf32=True)
        out["control"] = checks.training_gaps(low, ref)
    return out


def reference_readings(ctx, n: int, *, tf32: bool = False) -> dict:
    """The reference's first ``n`` steps from the seed's draw, on the rows
    ``traffic.train_rows`` packs: the same readings as the program's."""
    ref, s, dev, w = ctx.reference, ctx.sizes, ctx.device, ctx.cell
    tree = ref.draw_weights(s, ctx.seed, dev)
    zeros = lambda t: ({k: zeros(v) for k, v in t.items()}  # noqa: E731
                       if isinstance(t, dict) else torch.zeros_like(t))
    m, v, grads = zeros(tree), zeros(tree), zeros(tree)
    losses, grad = [], None
    for step in range(n):
        rows = traffic.train_rows(w["traffic"], s["vocab"], ctx.seed, step)
        batch = {k: torch.from_numpy(a).to(dev) for k, a in rows.items()}
        losses.append(ref.loss_and_grads(tree, batch, s, grads, tf32=tf32))
        ref.adamw_step(tree, grads, m, v, step + 1, w["optimizer"])
        if step == 0:
            grad = checks.norms(grads)  # clipped, as the optimizer takes it
    del m, v, grads
    change = change_norms(ctx, tree)
    del tree
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return {"losses": losses, "grad": grad, "change": change}
