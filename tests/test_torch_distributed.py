"""The port's distribution layer on a CPU host mesh: the sharded train
step (``partition``, ``shardctx``, DTensor), MoE's capacity groups per
data shard, elastic re-sharding and sharded checkpoints.

Multi-process tests spawn one gloo rank a process
(``torch_dist_workers.spawn``, with its own free port and a time limit
after which every rank is killed).

- The train step of reduced qwen3-14b, phi3.5-moe and falcon-mamba-7b on
  a 2x4 mesh: the losses and gradient norms of two steps against the
  unsharded port's under the same mesh context (for MoE that context sets
  two capacity groups), within 1e-5 relative. The unsharded port is held
  to ``jax.value_and_grad`` by ``test_torch_train_loss*.py``.
- MoE's capacity path with two groups (``g_count = 2``) against the
  reference's ``moe_apply`` jitted on a 2x4 host mesh of forced CPU
  devices (a subprocess, as ``tests/test_system.py`` runs it; the mesh's
  axes typed ``Auto``, which this JAX no longer makes by default), at
  ``test_torch_moe.py``'s ``atol=1e-4``.
- The dropless MoE path (K9) on DTensors of a (1, 1) mesh in-process.
- Elastic: params distributed on 8 ranks and checkpointed (``save`` and
  ``AsyncCheckpointer``), then restored and re-sharded on 4, bit for bit;
  the same checkpoint restores in the reference's ``checkpoint.restore``,
  bit for bit.
"""

import json
import os
import pathlib
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch

import torch_dist_workers as W
from repro.checkpoint import manager as ref_ckpt
from repro_torch import pytree
from repro_torch.configs import base as configs
from repro_torch.models import layers as L
from repro_torch.models import shardctx

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["qwen3-14b", "phi3.5-moe-42b-a6.6b", "falcon-mamba-7b"]
MESH = (2, 4)
STEPS, B, S = 2, 8, 32


def _stand_in(shape):
    return types.SimpleNamespace(mesh_dim_names=("data", "model"),
                                 shape=shape)


@pytest.fixture(scope="module")
def sharded(tmp_path_factory):
    out = tmp_path_factory.mktemp("sharded") / "metrics.json"
    W.spawn(W.sharded_steps, MESH[0] * MESH[1], ARCHS, MESH, STEPS, B, S,
            str(out), timeout=240)
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_steps_match_unsharded(sharded, arch):
    cfg = W.reduced(arch)
    params, opt = W.state(cfg)
    shardctx.set_mesh_ctx(_stand_in(MESH), ("data",))
    try:
        want = W.run_steps(cfg, params, opt, W.batches(cfg, STEPS, B, S))
    finally:
        shardctx.clear_mesh_ctx()
    np.testing.assert_allclose(np.array(sharded[arch]), np.array(want),
                               rtol=1e-5)


MOE_REF = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, numpy as np
from repro.configs import base as configs
from repro.models import layers as L, shardctx
cfg = configs.get("phi3.5-moe-42b-a6.6b").reduced()
p = L.moe_init(jax.random.PRNGKey(0), cfg, L.FP32)
x = np.random.default_rng(0).standard_normal((4, 16, cfg.d_model)).astype(
    np.float32)
# make_host_mesh's axes, typed Auto: this JAX makes them Explicit by
# default, and with_sharding_constraint then refuses them
mesh = jax.make_mesh((2, 4), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)
shardctx.set_mesh_ctx(mesh, ("data",))
y = jax.jit(lambda p, x: L.moe_apply(p, x, cfg))(p, x)
np.savez(sys.argv[1], x=x, y=np.asarray(y),
         **{k: np.asarray(v) for k, v in p.items()})
"""


def test_moe_groups_match_reference_on_a_host_mesh(tmp_path):
    out = tmp_path / "moe.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    run = subprocess.run([sys.executable, "-c", MOE_REF, str(out)], env=env,
                         capture_output=True, text=True, timeout=300)
    assert run.returncode == 0, run.stderr[-2000:]
    f = np.load(out)
    cfg = configs.get("phi3.5-moe-42b-a6.6b").reduced()
    p = {k: torch.from_numpy(f[k]) for k in ("router", "w_in", "w_gate",
                                             "w_out")}
    x = torch.from_numpy(f["x"])
    shardctx.set_mesh_ctx(_stand_in(MESH), ("data",))
    try:
        got = L.moe_apply(p, x, cfg)
    finally:
        shardctx.clear_mesh_ctx()
    np.testing.assert_allclose(got.numpy(), f["y"], atol=1e-4)
    one_group = L.moe_apply(p, x, cfg)
    assert not torch.allclose(one_group, got, atol=1e-3)  # groups matter


def test_elastic_restore_on_fewer_ranks_is_bit_exact(tmp_path):
    d_sync, d_async = str(tmp_path / "sync"), str(tmp_path / "async")
    out = tmp_path / "restored.json"
    W.spawn(W.elastic_save, 8, d_sync, d_async, timeout=120)
    W.spawn(W.elastic_restore, 4, d_sync, d_async, str(out), timeout=120)
    res = json.loads(out.read_text())
    assert res["steps"] == [1, 2] and res["mesh"] == [2, 2]
    for key, (by_reshard, by_restore, local, _) in res["leaves"].items():
        assert by_reshard and by_restore, key
    # the embedding (256, 64): vocab over model, d_model over data
    assert res["leaves"]["embed"][2] == [128, 32]
    # the checkpoint is the reference's layout: its restore reads it
    params, _ = W.state(W.reduced(W.ELASTIC_ARCH))
    like = pytree.map_leaves(lambda t: np.zeros(t.shape, np.float32), params)
    for d, step in ((d_sync, 1), (d_async, 2)):
        tree, got_step = ref_ckpt.restore(like, d)
        assert got_step == step
        for (key, want), got in zip(pytree.items(params),
                                    jax.tree.leaves(tree)):
            np.testing.assert_array_equal(np.asarray(got), want.numpy(),
                                          err_msg=key)


def test_dropless_moe_on_dtensors_matches_plain():
    """The dropless path (K9's plain version here) on DTensors of a (1, 1)
    mesh in this process (gloo, world 1) runs on the local tokens against
    the whole experts: the same bits as on plain tensors."""
    import torch.distributed as dist
    from repro_torch.distributed import partition
    from repro_torch.launch import mesh as mesh_lib

    cfg = configs.get("phi3.5-moe-42b-a6.6b").reduced()
    p = L.moe_init(torch.Generator().manual_seed(0), cfg, L.FP32, "cpu")
    x = torch.randn(2, 16, cfg.d_model, generator=torch.Generator()
                    .manual_seed(1))
    want = L.moe_apply(p, x, cfg, use_kernel=True)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:"
                            f"{W.free_port()}", rank=0, world_size=1)
    try:
        mesh = mesh_lib.make_mesh((1, 1), ("data", "model"), "cpu")
        shardctx.set_mesh_ctx(mesh)
        dp = partition.distribute(p, partition.param_specs({"moe": p})["moe"],
                                  mesh)
        got = L.moe_apply(dp, partition.distribute(
            x, partition.P("data", None, None), mesh), cfg, use_kernel=True)
        assert type(got).__name__ == "DTensor"
        torch.testing.assert_close(got.full_tensor(), want, rtol=0, atol=0)
    finally:
        shardctx.clear_mesh_ctx()
        dist.destroy_process_group()
