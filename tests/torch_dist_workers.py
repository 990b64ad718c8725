"""Workers for the port's multi-process CPU tests (gloo), and the helper
that spawns them.

Each test spawns one process a rank (``spawn``), each of which joins a
gloo group at ``tcp://localhost:<free port>`` and runs one of the
functions below; rank 0 writes what the test reads to a JSON file. The
workers import torch and ``repro_torch`` only, so a spawned process
starts without JAX. A rank that hangs or fails fails the test: ``spawn``
waits at most ``timeout`` seconds and then kills every rank.
"""

from __future__ import annotations

import json
import os
import socket
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn(fn, world: int, *args, timeout: float = 120.0) -> None:
    """``fn(rank, world, port, *args)`` in ``world`` spawned processes;
    raises if any fails or the whole does not end within ``timeout``."""
    ctx = mp.start_processes(fn, args=(world, free_port()) + args,
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.1)):
            if time.monotonic() > deadline:
                raise TimeoutError(f"{fn.__name__}: ranks still running "
                                   f"after {timeout} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join(5)


def _init(rank, world, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world,
                            timeout=__import__("datetime").timedelta(
                                seconds=90))


def batches(cfg, n: int, b: int, s: int, seed: int = 0):
    """``n`` batches of ``(b, s)`` tokens and targets drawn by numpy."""
    rng = np.random.default_rng(seed)
    return [{k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, s),
                                               dtype=np.int32))
             for k in ("tokens", "targets")} for _ in range(n)]


def reduced(arch: str):
    from repro_torch.configs import base as configs
    return configs.get(arch).reduced()


def state(cfg, seed: int = 0):
    from repro_torch.models import layers as L
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw
    params = T.init_params(torch.Generator().manual_seed(seed), cfg, L.FP32,
                           device="cpu")
    return params, adamw.init_state(params)


def run_steps(cfg, params, opt, data):
    """``[(loss, grad_norm)]`` of ``make_train_step`` over ``data``."""
    from repro_torch.launch import steps as steps_lib
    from repro_torch.models import layers as L
    from repro_torch.optim import adamw
    step = steps_lib.make_train_step(cfg, adamw.AdamWConfig(), L.FP32)
    out = []
    for batch in data:
        params, opt, m = step(params, opt, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return out


def sharded_steps(rank, world, port, archs, mesh_shape, n_steps, b, s, out):
    """The train step of each of ``archs`` on a ``mesh_shape`` host mesh:
    params and moments distributed by ``partition``, the mesh context and
    the layer-boundary sharding set as the dry run sets them; rank 0
    writes ``{arch: [(loss, grad_norm), ...]}``."""
    from repro_torch.distributed import partition
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import shardctx
    from repro_torch.models import transformer as T

    _init(rank, world, port)
    try:
        mesh = make_host_mesh(*mesh_shape)
        shardctx.set_mesh_ctx(mesh, ("data",))
        T.set_activation_sharding(partition.P(("data",), "model", None))
        result = {}
        for arch in archs:
            cfg = reduced(arch)
            params, opt = state(cfg)
            pspecs = partition.validate_divisibility(
                partition.param_specs(params), params, mesh)
            ospecs = partition.validate_divisibility(
                {"m": pspecs, "v": pspecs, "step": partition.P()}, opt, mesh)
            params = partition.distribute(params, pspecs, mesh)
            opt = partition.distribute(opt, ospecs, mesh)
            bspec = partition.batch_spec(mesh)
            data = [partition.distribute(d, bspec, mesh)
                    for d in batches(cfg, n_steps, b, s)]
            result[arch] = run_steps(cfg, params, opt, data)
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        shardctx.clear_mesh_ctx()
        T.set_activation_sharding(None)
        dist.destroy_process_group()


RECOVERY_ARCH = "qwen3-14b"


def sharded_recovery(rank, world, port, mesh_shape, n_steps, b, s, fault_at,
                     every, root, out):
    """``FaultTolerantLoop`` on a ``mesh_shape`` host mesh over the train
    step of the reduced ``RECOVERY_ARCH`` (params and moments distributed
    by ``partition``, checkpointed every ``every`` steps): one run without
    a fault, and one for each way the loop learns the state's shardings
    (``state_shardings`` given, or read off the live DTensors) in which
    step ``fault_at`` fails after its in-place update (``StateChanged``).
    Rank 0 writes each run's ``(loss, grad_norm)`` log, its recoveries,
    and whether every leaf ends a DTensor under the placements it was
    distributed with."""
    from torch.distributed.tensor import DTensor

    from repro_torch import pytree
    from repro_torch.data.pipeline import DataConfig, ShardedLoader
    from repro_torch.distributed import partition
    from repro_torch.distributed.fault import (FaultConfig, FaultTolerantLoop,
                                               StateChanged)
    from repro_torch.launch import steps as steps_lib
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import layers as L
    from repro_torch.models import shardctx
    from repro_torch.models import transformer as T
    from repro_torch.optim import adamw

    _init(rank, world, port)
    try:
        mesh = make_host_mesh(*mesh_shape)
        shardctx.set_mesh_ctx(mesh, ("data",))
        T.set_activation_sharding(partition.P(("data",), "model", None))
        cfg = reduced(RECOVERY_ARCH)
        train_step = steps_lib.make_train_step(cfg, adamw.AdamWConfig(),
                                               L.FP32)
        bspec = partition.batch_spec(mesh)
        result = {}
        for run in ("unbroken", "given", "live"):
            params, opt = state(cfg)
            pspecs = partition.validate_divisibility(
                partition.param_specs(params), params, mesh)
            specs = {"params": pspecs,
                     "opt": partition.validate_divisibility(
                         {"m": pspecs, "v": pspecs, "step": partition.P()},
                         opt, mesh)}
            st = partition.distribute({"params": params, "opt": opt}, specs,
                                      mesh)
            placed = [tuple(x.placements) for x in pytree.leaves(st)]
            failed = []

            def step_fn(st, batch, run=run, failed=failed):
                batch = partition.distribute(
                    {k: torch.from_numpy(v) for k, v in batch.items()},
                    bspec, mesh)
                p, o, m = train_step(st["params"], st["opt"], batch)
                if run != "unbroken" and loop.step == fault_at and not failed:
                    failed.append(loop.step)
                    raise StateChanged("injected after the update")
                return {"params": p, "opt": o}, {k: float(v)
                                                 for k, v in m.items()}

            loop = FaultTolerantLoop(
                step_fn, st,
                ShardedLoader(DataConfig(vocab=cfg.vocab, seq_len=s,
                                         global_batch=b)),
                FaultConfig(checkpoint_dir=os.path.join(root, run),
                            checkpoint_every=every, backoff_s=0.0),
                state_shardings=(partition.shardings_of(specs, mesh)
                                 if run == "given" else None))
            log = loop.run(n_steps)
            leaves = pytree.leaves(loop.state)
            result[run] = {
                "metrics": [(m["loss"], m["grad_norm"]) for m in log],
                "recoveries": loop.recoveries,
                "placements_kept": all(
                    isinstance(x, DTensor) and tuple(x.placements) == want
                    for x, want in zip(leaves, placed)),
                "restored_new_tensors": not any(
                    x is y for x, y in zip(leaves, pytree.leaves(st)))}
        if rank == 0:
            with open(out, "w") as f:
                json.dump(result, f)
    finally:
        shardctx.clear_mesh_ctx()
        T.set_activation_sharding(None)
        dist.destroy_process_group()


ELASTIC_ARCH = "starcoder2-7b"


def elastic_save(rank, world, port, d_sync, d_async):
    """``world`` ranks on ``rebuild_mesh(prefer_model=4)``: the reduced
    model's params distributed, then checkpointed by ``save`` (step 1)
    and by ``AsyncCheckpointer`` (step 2)."""
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import elastic, partition

    _init(rank, world, port)
    try:
        mesh = elastic.rebuild_mesh(world, prefer_model=4)
        params, _ = state(reduced(ELASTIC_ARCH))
        specs = partition.validate_divisibility(
            partition.param_specs(params), params, mesh)
        params = partition.distribute(params, specs, mesh)
        ckpt.save(params, d_sync, 1)
        saver = ckpt.AsyncCheckpointer(d_async)
        saver.save(params, 2)
        saver.wait()
    finally:
        dist.destroy_process_group()


def elastic_restore(rank, world, port, d_sync, d_async, out):
    """``world`` ranks on ``rebuild_mesh(prefer_model=2)``: both
    checkpoints restored, by ``reshard_state`` and by ``restore(...,
    shardings=)``; rank 0 writes, per leaf, whether each equals the
    params drawn afresh bit for bit, and each local shard's shape."""
    from repro_torch import pytree
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.distributed import elastic, partition

    _init(rank, world, port)
    try:
        mesh = elastic.rebuild_mesh(world, prefer_model=2)
        params, _ = state(reduced(ELASTIC_ARCH))
        like = pytree.map_leaves(torch.zeros_like, params)
        host, step1 = ckpt.restore(like, d_sync)
        a = elastic.reshard_state(host, mesh)
        specs = partition.validate_divisibility(
            partition.param_specs(params), params, mesh)
        b, step2 = ckpt.restore(like, d_async,
                                shardings=partition.shardings_of(specs, mesh))
        rows = {}
        for (key, want), x, y in zip(pytree.items(params), pytree.leaves(a),
                                     pytree.leaves(b)):
            rows[key] = [bool(torch.equal(x.full_tensor(), want)),
                         bool(torch.equal(y.full_tensor(), want)),
                         list(x.to_local().shape), list(x.placements).__repr__()]
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"steps": [step1, step2], "mesh": list(mesh.shape),
                           "leaves": rows}, f)
    finally:
        dist.destroy_process_group()
