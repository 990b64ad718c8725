"""Fault tolerance: checkpointed restart loop + straggler watchdog.

The port of ``FaultConfig`` and ``FaultTolerantLoop`` from
``src/repro/distributed/fault.py``. The loop wraps the train step:

  * periodic async checkpoints (``checkpoint/manager.py``) with atomic
    commit and retention;
  * on any step failure: restore the latest checkpoint into the state's
    tensors (in place), and resume the exact data stream (the pipeline is
    a pure function of the step counter);
  * bounded retries with exponential backoff; a persistent failure
    re-raises as ``RuntimeError`` with the step, after ``max_retries``;
  * straggler watchdog: steps slower than ``straggler_factor`` x the EWMA
    of step times are logged and recorded.

``recoveries`` counts the failed attempts. A fault that does not go away
on retry is never turned into a pass: a launch the kernel refuses fails
the same way each time, and a sticky CUDA error (an illegal address, a
kernel trap) poisons the process's CUDA context, so every retry fails
too and the loop raises. The step's result is read on the host inside
the attempt (the train driver turns its metrics into floats), so an
asynchronous fault surfaces within the step that caused it. The port's
optimizer updates in place, so a step that fails after its update began
(the step raises ``StateChanged``) retries from the latest checkpoint;
before the first checkpoint there is no state to go back to, and the loop
raises rather than apply the step's update twice. A fault before the
update retries in place, as the reference's loop does.

A sharded state (DTensor leaves) is checkpointed whole, by rank 0
(``checkpoint.manager``). Its restore distributes the checkpoint onto
the current mesh (``checkpoint.restore(..., shardings=)``) and replaces
the state's tensors, as the reference's ``device_put`` does: under
``state_shardings`` (a tree of ``partition.Sharding``s of the state's
structure) where it is given, else under the live leaves' own meshes and
placements. A state of plain tensors is restored into them in place.
"""

from __future__ import annotations

import dataclasses
import logging
import os
import tempfile
import time
from typing import Callable, Optional

import torch
from torch.distributed.tensor import DTensor

from repro_torch import pytree, tracing
from repro_torch.checkpoint import manager as ckpt
from repro_torch.distributed import partition

log = logging.getLogger("repro_torch.fault")


class StateChanged(RuntimeError):
    """A step failed after it began to change the state in place: only a
    checkpoint can give back the state it started from."""


@dataclasses.dataclass
class FaultConfig:
    checkpoint_dir: str = os.path.join(tempfile.gettempdir(),
                                       "repro_torch_ckpt")
    checkpoint_every: int = 50
    max_retries: int = 3
    backoff_s: float = 0.1
    straggler_factor: float = 3.0
    ewma_alpha: float = 0.1


def _place(arr, like):
    """A restored array into ``like``: copied into a tensor in place, else
    returned as it is."""
    if not isinstance(like, torch.Tensor):
        return arr
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint leaf of shape {arr.shape} restored "
                         f"into a tensor of shape {tuple(like.shape)}")
    with torch.no_grad():
        like.copy_(torch.from_numpy(arr))
    return like


def _live_shardings(state):
    """The ``partition.Sharding``s of a state of DTensors (every leaf one,
    as ``partition.distribute`` makes it); None for plain tensors."""
    if not any(isinstance(x, DTensor) for x in pytree.leaves(state)):
        return None
    return pytree.map_leaves(
        lambda x: partition.Sharding(x.device_mesh, x.placements), state)


class FaultTolerantLoop:
    def __init__(
        self,
        step_fn: Callable,  # (state, batch) -> (state, metrics)
        state,  # nested dict: params/opt
        loader,  # data.pipeline.ShardedLoader
        cfg: FaultConfig,
        state_shardings=None,
    ):
        self.step_fn = step_fn
        self.state = state
        self.loader = loader
        self.cfg = cfg
        self.state_shardings = state_shardings
        self.saver = ckpt.AsyncCheckpointer(cfg.checkpoint_dir)
        self.step = 0
        self.ewma: Optional[float] = None
        self.straggler_events: list[tuple[int, float]] = []
        self.recoveries = 0

    # -- checkpoint/restore -------------------------------------------------

    def _save(self):
        self.saver.save({"state": self.state, "data": self.loader.state()},
                        self.step)

    def try_restore(self) -> bool:
        # a failure can race an in-flight async save: without draining it
        # we restore an older step and silently replay (and re-log) the
        # steps in between
        self.saver.wait()
        if ckpt.latest_step(self.cfg.checkpoint_dir) is None:
            return False
        like = {"state": self.state, "data": self.loader.state()}
        shardings = (self.state_shardings if self.state_shardings is not None
                     else _live_shardings(self.state))
        if shardings is None:
            restored, step = ckpt.restore(like, self.cfg.checkpoint_dir,
                                          place=_place)
        else:
            restored, step = ckpt.restore(
                like, self.cfg.checkpoint_dir,
                shardings={"state": shardings, "data": None})
        self.state = restored["state"]
        self.loader.restore(restored["data"])
        self.step = step
        return True

    # -- main loop ----------------------------------------------------------

    def run(self, n_steps: int):
        metrics_log = []
        while self.step < n_steps:
            with tracing.span("train.data"):
                batch = next(self.loader)
            t0 = time.monotonic()
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    self.state, metrics = self.step_fn(self.state, batch)
                    break
                except Exception as e:  # noqa: BLE001 — any step fault
                    log.warning("step %d failed (%s); recovering", self.step, e)
                    self.recoveries += 1
                    if attempt == self.cfg.max_retries:
                        raise RuntimeError(
                            f"step {self.step} failed after "
                            f"{self.cfg.max_retries} retries"
                        ) from e
                    time.sleep(self.cfg.backoff_s * 2 ** attempt)
                    if self.try_restore():
                        # loader rewound with the checkpoint: re-fetch so
                        # the retried step consumes the right batch and
                        # the stream stays aligned with the step counter
                        with tracing.span("train.data"):
                            batch = next(self.loader)
                    elif isinstance(e, StateChanged):
                        raise RuntimeError(
                            f"step {self.step} failed after it began to "
                            f"change the state, and no checkpoint holds "
                            f"the state before it"
                        ) from e
                    else:
                        log.warning("no checkpoint yet; retrying in place")
            dt = time.monotonic() - t0
            self._watch_straggler(dt)
            metrics_log.append(metrics)
            self.step += 1
            if self.step % self.cfg.checkpoint_every == 0:
                self._save()
        self.saver.wait()
        return metrics_log

    def _watch_straggler(self, dt: float):
        if self.ewma is None:
            self.ewma = dt
            return
        if dt > self.cfg.straggler_factor * self.ewma:
            log.warning("straggler step %d: %.3fs vs EWMA %.3fs",
                        self.step, dt, self.ewma)
            self.straggler_events.append((self.step, dt))
        a = self.cfg.ewma_alpha
        self.ewma = (1 - a) * self.ewma + a * dt
