"""Dry run: every (architecture × input shape) cell's step on the
production meshes, as an account of FLOPs, bytes, collectives and memory
per device. It allocates nothing and needs no card.

The port of ``src/repro/launch/dryrun.py``. The reference lowers and
compiles each cell's real step function against ``ShapeDtypeStruct``
stand-ins on 256 or 512 forced CPU devices and reads XLA's memory and
cost analyses. The port runs the real step functions (``make_train_step``
with AdamW, ``make_prefill_step``, ``make_serve_step``) eagerly, in one
process, on DTensors over PyTorch's fake process group
(``mesh.fake_world``: collectives move nothing) whose local shards are
``meta`` tensors (shapes and no data; every kernel takes its plain
version on them), with the mesh context and the activation sharding set
as the reference's ``lower_cell`` sets them. ``cost.CostMode``
counts the ops on each device's shards as they run and
``cost.MemoryMode`` the bytes each device holds; ``analysis.roofline``
and ``analysis.memory_report`` turn them into the reference's terms.
Its outputs are an account, not a measurement: no time here comes from
a device.

Results land in ``<out>/<arch>__<shape>__<mesh>.json`` (``--out``
defaults to ``build/dryrun``, which git ignores)::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-14b \\
        --shape train_4k --mesh 16x16
"""

from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import base as configs
from repro_torch.distributed import partition
from repro_torch.distributed.partition import P
from repro_torch.launch import analysis, cost
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.shapes import SHAPES, applicable
from repro_torch.models import layers as L
from repro_torch.models import shardctx
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

DT = L.Dtypes(param=torch.bfloat16, compute=torch.bfloat16,
              accum=torch.float32)
DEV = torch.device("meta")  # shapes only: every kernel's plain version


def _dp(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def _zeros(shape, spec, mesh, dtype):
    return partition.zeros(tuple(shape), spec, mesh, dtype, DEV)


def input_specs(cfg, shape, mesh, dt=DT):
    """The step's arguments for one cell, as DTensors on ``mesh``: the
    reference's ``ShapeDtypeStruct``s and ``NamedSharding``s at once.
    Nothing is allocated: the leaves are ``meta`` shards."""
    dp = _dp(mesh)
    with FakeTensorMode():  # the parameters' shapes, drawn from nothing
        shapes = T.init_params(torch.Generator(), cfg, dt, device="cpu")
    pspecs = partition.validate_divisibility(
        partition.param_specs(shapes), shapes, mesh)
    params = partition.map_specs(
        lambda sp, x: _zeros(x.shape, sp, mesh, x.dtype), pspecs, shapes)
    long_ctx = shape.name == "long_500k"
    b, s = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def frontend():
        return _zeros((b, cfg.frontend_len, cfg.d_model), P(dp, None, None),
                      mesh, dt.compute)

    if shape.kind == "train":
        opt = adamw.init_state(params)  # zeros_like: the params' placements
        opt["step"] = _zeros((), P(), mesh, i32)
        batch = {k: _zeros((b, s), P(dp, None), mesh, i32)
                 for k in ("tokens", "targets")}
        if cfg.frontend:
            batch["frontend"] = frontend()
        return (params, opt, batch)

    if shape.kind == "prefill":
        batch = {"tokens": _zeros((b, s), P(dp, None), mesh, i32)}
        if cfg.frontend:
            batch["frontend"] = frontend()
        return (params, batch)

    # decode: one new token against a seq_len-deep cache
    meta = T._cache(cfg, b, s, dt, torch.device("meta"))
    cspecs = partition.validate_divisibility(
        partition.cache_specs(meta, mesh, long_context=long_ctx), meta, mesh)
    cache = partition.map_specs(
        lambda sp, m: _zeros(m.shape, sp, mesh, m.dtype), cspecs, meta)
    tokens = _zeros((b, 1), P(None, None) if long_ctx else P(dp, None), mesh,
                    i32)
    lengths = _zeros((b,), P(None) if long_ctx else P(dp), mesh, i32)
    enc = None
    if cfg.enc_dec:
        enc = _zeros((b, cfg.frontend_len, cfg.d_model),
                     P(None, None, None) if long_ctx else P(dp, None, None),
                     mesh, dt.compute)
    return (params, tokens, cache, lengths, enc)


def lower_cell(cfg, shape, mesh, dt=DT) -> dict:
    """Run one (arch, shape, mesh) cell's step under the account. Returns
    the results dict. ``mesh`` lies over a fake process group."""
    dp = _dp(mesh)
    shardctx.set_mesh_ctx(mesh, dp)
    # Megatron-SP at layer boundaries: batch over data, seq over model
    T.set_activation_sharding(P(dp, "model", None)
                              if shape.kind == "train" else None)
    try:
        if shape.kind == "train":
            fn = steps_lib.make_train_step(cfg, adamw.AdamWConfig(), dt)
        elif shape.kind == "prefill":
            fn = steps_lib.make_prefill_step(cfg, dt, max_seq=shape.seq_len)
        else:
            fn = steps_lib.make_serve_step(cfg, dt)
        t0 = time.time()
        args = input_specs(cfg, shape, mesh, dt)
        mem = cost.MemoryMode()
        mem.hold(args)
        t1 = time.time()
        with mem, cost.CostMode() as acct:
            fn(*args)
        t2 = time.time()
    finally:
        shardctx.clear_mesh_ctx()
        T.set_activation_sharding(None)
    n_dev = math.prod(tuple(mesh.shape))
    mf = analysis.model_flops(cfg, shape) / n_dev
    return {
        "arch": cfg.name,
        "shape": shape.name,
        "mesh": "x".join(map(str, tuple(mesh.shape))),
        "n_devices": n_dev,
        "setup_s": t1 - t0,
        "run_s": t2 - t1,
        "memory": analysis.memory_report(mem.report()),
        "roofline": analysis.roofline(acct.total(), n_dev,
                                      model_flops_per_device=mf),
    }


def run_cell(arch: str, shape_name: str, multi_pod: bool, outdir: str,
             dt=DT) -> dict:
    """One cell on a production mesh over a fake world of 256 (512 with
    ``multi_pod``) ranks; a cell ``applicable`` skips is recorded as
    skipped, and an error as an error (with its traceback)."""
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    ok, why = applicable(cfg, shape)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    tag = f"{arch}__{shape_name}__{mesh_tag}"
    if not ok:
        res = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "skipped": why}
    else:
        shape_, _ = mesh_lib.PRODUCTION[multi_pod]
        try:
            with mesh_lib.fake_world(math.prod(shape_)):
                mesh = mesh_lib.make_production_mesh(multi_pod=multi_pod,
                                                     device="cpu")
                res = lower_cell(cfg, shape, mesh, dt)
        except Exception as e:  # noqa: BLE001 — recorded, surfaced by caller
            res = {
                "arch": arch, "shape": shape_name, "mesh": mesh_tag,
                "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-4000:],
            }
    if outdir:
        os.makedirs(outdir, exist_ok=True)
        with open(os.path.join(outdir, tag + ".json"), "w") as f:
            json.dump(res, f, indent=1, default=float)
    return res


def status(res: dict) -> str:
    """One line for a cell's result."""
    if "error" in res:
        return "ERROR " + res["error"][:120]
    if "skipped" in res:
        return res["skipped"]
    r = res["roofline"]
    return (f"ok compute={r['compute_s']*1e3:.1f}ms "
            f"mem={r['memory_s']*1e3:.1f}ms "
            f"coll={r['collective_s']*1e3:.1f}ms "
            f"dominant={r['dominant']} "
            f"hbm={res['memory']['peak_bytes_per_device_est']/2**30:.2f}GiB")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="16x16",
                    choices=["16x16", "2x16x16", "both"])
    ap.add_argument("--out", default=os.path.join("build", "dryrun"))
    args = ap.parse_args(argv)

    archs = configs.all_names() if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    meshes = (
        [False, True] if args.mesh == "both" else [args.mesh == "2x16x16"]
    )

    failures = 0
    for arch in archs:
        for shape_name in shapes:
            for mp in meshes:
                t0 = time.time()
                res = run_cell(arch, shape_name, mp, args.out)
                failures += "error" in res
                mesh_tag = "2x16x16" if mp else "16x16"
                print(f"[{time.time() - t0:7.1f}s] {arch:24s} "
                      f"{shape_name:12s} {mesh_tag:8s} {status(res)}",
                      flush=True)
    if failures:
        raise SystemExit(f"{failures} cells failed")


if __name__ == "__main__":
    main()
