"""Training driver: the end-to-end fault-tolerant train loop.

The port of ``src/repro/launch/train.py``: the sharded data pipeline ->
the train step (loss, gradients through K6 and K8, AdamW in place) ->
async checkpoints -> fault-tolerant resume, with the reference's flags,
plus ``--device`` (``cuda``, the default, or ``cpu`` for tests) and
``--n-layers`` (cut the depth), as ``serve.main`` has them. Parameters are
drawn from a ``torch.Generator`` seeded 0 on the device (so not the
reference's ``jax.random`` draws; the tests carry the reference's state
across through a checkpoint). Everything runs in float32. ``main``
returns the losses, as the reference's does; ``run`` returns the whole
record (``TrainRun``).

On the CPU (``PYTHONPATH=src``)::

    python -m repro_torch.launch.train --arch qwen3-14b --reduced \\
        --device cpu --steps 5

On the card, qwen3-14b at full width cut to 4 of its 40 layers (params,
gradients and the two moments in float32 take 16 bytes a parameter:
about 46 GB at 4 layers)::

    python -m repro_torch.launch.train --arch qwen3-14b --n-layers 4 \\
        --batch 4 --seq 1024 --steps 5 --ckpt-every 1000
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.configs import base as configs
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.device import resolve_device
from repro_torch.distributed.fault import (FaultConfig, FaultTolerantLoop,
                                          StateChanged)
from repro_torch.launch import steps as steps_lib
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.optim import adamw


def build_state(cfg, dt, seed: int = 0, *, device="cuda"):
    """``{"params", "opt"}``: parameters drawn on ``device`` from a
    generator seeded ``seed``, and a fresh AdamW state."""
    dev = resolve_device(device, "build_state")
    gen = torch.Generator(device=dev).manual_seed(seed)
    params = T.init_params(gen, cfg, dt, device=dev)
    return {"params": params, "opt": adamw.init_state(params)}


@dataclasses.dataclass
class TrainRun:
    """What a run did: each step's metrics (``loss``, ``grad_norm``,
    ``lr`` as floats), the seconds of each step's attempt that passed
    (the host's clock around the step, which ends by reading its metrics
    on the host), the loop's failed attempts and slow steps."""
    cfg: configs.ArchConfig
    metrics: list
    step_seconds: list
    recoveries: int
    straggler_events: list

    @property
    def losses(self) -> list:
        return [m["loss"] for m in self.metrics]


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--n-layers", type=int, default=0,
                    help="cut the depth to this many layers (0 keeps the "
                         "config's): qwen3-14b trains in float32 on one "
                         "80 GB card at 4 of its 40")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--total-steps", type=int, default=0,
                    help="LR-schedule horizon if it differs from --steps "
                         "(multi-leg runs that resume must share it)")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default) or cpu (the plain versions, "
                         "for tests)")
    return ap.parse_args(argv)


def run(argv=None) -> TrainRun:
    args = parse_args(argv)
    dev = resolve_device(args.device, "train")
    cfg = configs.get(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.n_layers:
        cfg = dataclasses.replace(cfg, n_layers=args.n_layers)
    dt = L.FP32

    horizon = args.total_steps or args.steps
    opt_cfg = adamw.AdamWConfig(
        lr=args.lr, warmup_steps=max(horizon // 20, 5),
        total_steps=horizon,
    )
    step = steps_lib.make_train_step(cfg, opt_cfg, dt)
    loader = ShardedLoader(DataConfig(
        vocab=cfg.vocab, seq_len=args.seq, global_batch=args.batch))
    state = build_state(cfg, dt, device=dev)
    seconds = []

    def step_fn(state, batch):
        t0 = time.perf_counter()
        b = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
        if cfg.frontend:
            b["frontend"] = torch.zeros(
                (args.batch, cfg.frontend_len, cfg.d_model),
                dtype=torch.float32, device=dev)
        params, opt, metrics = step(state["params"], state["opt"], b)
        try:
            metrics = {k: float(v) for k, v in metrics.items()}  # waits
        except Exception as e:  # a fault of the step, the update included
            raise StateChanged("the step's metrics could not be read") from e
        seconds.append(time.perf_counter() - t0)
        return {"params": params, "opt": opt}, metrics

    loop = FaultTolerantLoop(
        step_fn, state, loader,
        FaultConfig(checkpoint_dir=args.ckpt_dir,
                    checkpoint_every=args.ckpt_every),
    )
    if args.resume and loop.try_restore():
        print(f"resumed from step {loop.step}")

    t0 = time.time()
    metrics = loop.run(args.steps)
    dt_s = time.time() - t0
    out = TrainRun(cfg, metrics, seconds, loop.recoveries,
                   loop.straggler_events)
    losses = out.losses
    if losses:
        print(
            f"arch={cfg.name} layers={cfg.n_layers} steps={len(metrics)} "
            f"loss {losses[0]:.4f} -> {losses[-1]:.4f} "
            f"({dt_s:.1f}s, {dt_s / len(metrics) * 1e3:.0f} ms/step)"
        )
    return out


def main(argv=None):
    """The reference's entry point: run, and return the losses."""
    return run(argv).losses


if __name__ == "__main__":
    main()
