"""The port's optimizer, gradient compression, data pipeline and
checkpoints against the JAX package's, on the CPU.

- one AdamW step (params, m, v, ``grad_norm``, ``lr``) within 1e-6 (the
  port updates in place; its global norm sums the leaves in JAX's order,
  the sums inside a leaf run in another), and ``lr_at`` over a warmup and
  a cosine horizon;
- int8 compression with error feedback, bit for bit;
- the data pipeline's batches, bit for bit, for several seeds, steps and
  shard counts;
- a checkpoint written by either package restores in the other, bit for
  bit, with the same manifest.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.configs import base as ref_configs
from repro.data import pipeline as ref_pipeline
from repro.models import layers as ref_L
from repro.models import transformer as ref_T
from repro.optim import adamw as ref_adamw
from repro.optim import compression as ref_comp
from repro_torch import pytree
from repro_torch.checkpoint import manager as ckpt
from repro_torch.data import pipeline
from repro_torch.models import convert
from repro_torch.optim import adamw, compression

RTOL = 1e-6


def _ref_params(name="qwen3-14b"):
    cfg = ref_configs.get(name).reduced()
    return jax.tree.map(np.asarray, ref_T.init_params(
        jax.random.PRNGKey(1), cfg, ref_L.FP32))


def _like(tree, seed, scale, positive=False):
    """A tree of ``tree``'s structure of seeded float32 noise."""
    rng = np.random.default_rng(seed)

    def one(a):
        x = rng.standard_normal(a.shape).astype(np.float32) * scale
        return np.abs(x) if positive else x

    return jax.tree.map(one, tree)


def _torch_tree(tree):
    return convert.from_reference(tree, device="cpu")


def _assert_tree_close(got, want, rtol=RTOL, atol=0.0):
    want = dict(pytree.items(want))
    got = dict(pytree.items(got))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        np.testing.assert_allclose(g.numpy(), np.asarray(want[path]),
                                   rtol=rtol, atol=atol, err_msg=path)


@pytest.mark.parametrize("grad_scale,step", [(1.0, 3), (1e-3, 0), (1.0, 200)])
def test_adamw_step_matches_reference(grad_scale, step):
    """At grad scale 1 the global norm is far above ``clip_norm`` (the
    clip binds); at 1e-3 it is below. Step 200 is past the warmup, in the
    cosine."""
    cfg = ref_adamw.AdamWConfig(warmup_steps=5, total_steps=400)
    params = _ref_params()
    grads = _like(params, 1, grad_scale)
    m, v = _like(params, 2, 1e-3), _like(params, 3, 1e-6, positive=True)
    state_r = {"m": m, "v": v, "step": jnp.int32(step)}
    p_r, s_r, met_r = ref_adamw.apply_updates(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        jax.tree.map(jnp.asarray, state_r), cfg)

    mine = adamw.AdamWConfig(warmup_steps=5, total_steps=400)
    assert mine == adamw.AdamWConfig(**vars(cfg))
    tp = _torch_tree(params)
    state = {"m": _torch_tree(m), "v": _torch_tree(v),
             "step": torch.tensor(step, dtype=torch.int32)}
    leaves = pytree.leaves(tp)
    p2, s2, met = adamw.apply_updates(tp, _torch_tree(grads), state, mine)
    assert pytree.leaves(p2)[0] is leaves[0]  # updated in place
    assert s2["step"].dtype == torch.int32 and int(s2["step"]) == step + 1
    for key in ("grad_norm", "lr"):
        np.testing.assert_allclose(float(met[key]), float(met_r[key]),
                                   rtol=RTOL, err_msg=key)
    _assert_tree_close(p2, p_r, atol=1e-9)
    _assert_tree_close(s2["m"], s_r["m"], atol=1e-12)
    _assert_tree_close(s2["v"], s_r["v"], atol=1e-15)


def test_global_norm_sums_in_jax_leaf_order():
    """The leaves are walked in sorted key order, as ``jax.tree.leaves``
    does, whatever the dicts' insertion order."""
    tree = {"b": torch.ones(3), "a": {"z": torch.full((2,), 2.0),
                                      "c": torch.zeros(1)}}
    assert [t.shape for t in pytree.leaves(tree)] == [(1,), (2,), (3,)]
    ref_tree = {"b": jnp.ones(3), "a": {"z": jnp.full((2,), 2.0),
                                        "c": jnp.zeros(1)}}
    assert [a.shape for a in jax.tree.leaves(ref_tree)] == [(1,), (2,), (3,)]
    assert float(adamw.global_norm(tree)) == float(
        ref_adamw.global_norm(ref_tree))


def test_lr_at_matches_reference_over_warmup_and_cosine():
    cfg = ref_adamw.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=60)
    mine = adamw.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=60)
    for step in range(0, 70):
        want = float(ref_adamw.lr_at(cfg, step))
        got = adamw.lr_at(mine, step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), want, rtol=RTOL, err_msg=step)
        np.testing.assert_allclose(
            float(adamw.lr_at(mine, torch.tensor(step, dtype=torch.int32))),
            want, rtol=RTOL)


def test_init_state_matches_reference_structure():
    params = _ref_params("falcon-mamba-7b")
    want = ref_adamw.init_state(params)
    got = adamw.init_state(_torch_tree(params))
    assert [p for p, _ in pytree.items(got)] == [
        "/".join(str(k.key) for k in path)
        for path, _ in jax.tree_util.tree_flatten_with_path(want)[0]]
    assert got["step"].dtype == torch.int32 and got["step"].shape == ()
    assert all(float(t.abs().sum()) == 0 for t in pytree.leaves(got))


# ---------------------------------------------------------------------------
# compression
# ---------------------------------------------------------------------------


def test_quantize_int8_bit_for_bit():
    rng = np.random.default_rng(4)
    x = rng.standard_normal(4099).astype(np.float32)
    # values on the rounding boundaries (half to even on both sides)
    x[:8] = np.float32(x.max()) / 127 * np.array(
        [0.5, 1.5, 2.5, -0.5, -1.5, 126.5, -126.5, 3.5], np.float32)
    q_r, s_r = ref_comp.quantize_int8(jnp.asarray(x))
    q, s = compression.quantize_int8(torch.from_numpy(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    assert s.numpy().tobytes() == np.asarray(s_r).tobytes()
    np.testing.assert_array_equal(
        compression.dequantize_int8(q, s).numpy(),
        np.asarray(ref_comp.dequantize_int8(q_r, s_r)))


def test_error_feedback_compression_bit_for_bit_over_steps():
    grads = _like(_ref_params(), 5, 1e-2)
    err_r = ref_comp.init_error_state(grads)
    err = compression.init_error_state(_torch_tree(grads))
    for step in range(3):
        g = _like(grads, 10 + step, 1e-2)
        deq_r, err_r = ref_comp.ef_compress_grads(
            jax.tree.map(jnp.asarray, g), err_r)
        deq, err = compression.ef_compress_grads(_torch_tree(g), err)
        for mine, theirs in ((deq, deq_r), (err, err_r)):
            theirs = dict(pytree.items(jax.tree.map(np.asarray, theirs)))
            for path, t in pytree.items(mine):
                assert t.numpy().tobytes() == theirs[path].tobytes(), path


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 3, 12345])
def test_batches_bit_identical_for_every_shard(seed):
    for vocab, seq, gb in ((256, 64, 8), (151936, 200, 4)):
        cfg_r = ref_pipeline.DataConfig(vocab=vocab, seq_len=seq,
                                        global_batch=gb, seed=seed)
        cfg = pipeline.DataConfig(vocab=vocab, seq_len=seq, global_batch=gb,
                                  seed=seed)
        for step in (0, 1, 7, 1000):
            for n_shards in (1, 2, 4):
                for shard in range(n_shards):
                    want = ref_pipeline.shard_batch_at(cfg_r, step, shard,
                                                       n_shards)
                    got = pipeline.shard_batch_at(cfg, step, shard, n_shards)
                    for k in ("tokens", "targets"):
                        assert got[k].dtype == want[k].dtype
                        np.testing.assert_array_equal(got[k], want[k])


def test_loader_state_and_restore_match_reference():
    cfg_r = ref_pipeline.DataConfig(vocab=256, seq_len=32, global_batch=4)
    cfg = pipeline.DataConfig(vocab=256, seq_len=32, global_batch=4)
    a = ref_pipeline.ShardedLoader(cfg_r, shard=1, n_shards=2, start_step=3)
    b = pipeline.ShardedLoader(cfg, shard=1, n_shards=2, start_step=3)
    for _ in range(3):
        np.testing.assert_array_equal(next(a)["tokens"], next(b)["tokens"])
    assert a.state() == b.state() == {"step": 6}
    b.restore({"step": np.int64(4)})
    a.restore({"step": 4})
    np.testing.assert_array_equal(next(a)["targets"], next(b)["targets"])


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


def _train_state_r(step=7):
    params = _ref_params()
    opt = ref_adamw.init_state(params)
    opt = {"m": _like(params, 6, 1e-3), "v": _like(params, 7, 1e-6, True),
           "step": np.asarray(opt["step"]) + np.int32(step)}
    return {"state": {"params": params, "opt": opt}, "data": {"step": step}}


def _port_tree(tree_r):
    st = tree_r["state"]
    return {"state": {"params": _torch_tree(st["params"]),
                      "opt": {"m": _torch_tree(st["opt"]["m"]),
                              "v": _torch_tree(st["opt"]["v"]),
                              "step": torch.from_numpy(
                                  np.array(st["opt"]["step"]))}},
            "data": {"step": tree_r["data"]["step"]}}


def _zeros_like(tree):
    return {"state": pytree.map_leaves(torch.zeros_like, tree["state"]),
            "data": {"step": 0}}


def _bits(tree):
    return {p: np.asarray(a.detach().numpy() if hasattr(a, "detach") else a)
            for p, a in pytree.items(tree)}


def test_reference_checkpoint_restores_in_the_port_bit_for_bit(tmp_path):
    tree_r = _train_state_r()
    ref_ckpt.save(tree_r, str(tmp_path), 7)
    assert ckpt.latest_step(str(tmp_path)) == 7
    like = _zeros_like(_port_tree(tree_r))
    got, step = ckpt.restore(like, str(tmp_path))
    assert step == 7
    want = _bits(tree_r)
    for path, arr in _bits(got).items():
        assert arr.dtype == want[path].dtype, path
        assert arr.tobytes() == want[path].tobytes(), path


def test_port_checkpoint_restores_in_the_reference_bit_for_bit(tmp_path):
    tree_r = _train_state_r(step=3)
    ckpt.save(_port_tree(tree_r), str(tmp_path / "port"), 3)
    ref_ckpt.save(tree_r, str(tmp_path / "ref"), 3)
    manifests = [json.load(open(tmp_path / d / "step_00000003" /
                                "manifest.json")) for d in ("port", "ref")]
    assert manifests[0] == manifests[1]
    assert sorted(os.listdir(tmp_path / "port" / "step_00000003")) == sorted(
        os.listdir(tmp_path / "ref" / "step_00000003"))
    like_r = jax.tree.map(np.zeros_like, tree_r)
    got, step = ref_ckpt.restore(like_r, str(tmp_path / "port"))
    assert step == 3
    want = _bits(tree_r)
    for path, arr in _bits(got).items():
        assert arr.dtype == want[path].dtype, path
        assert arr.tobytes() == want[path].tobytes(), path


def test_async_snapshot_is_not_moved_by_in_place_updates(tmp_path):
    """The optimizer updates CPU tensors in place right after a save: the
    snapshot must be a copy, not a view the writer thread still reads."""
    tree = {"w": torch.arange(2**16, dtype=torch.float32), "step": 5}
    saver = ckpt.AsyncCheckpointer(str(tmp_path), keep=2)
    saver.save(tree, 1)
    tree["w"].add_(1.0)  # in place, while the thread may still write
    saver.wait()
    got, _ = ckpt.restore({"w": torch.zeros(2**16), "step": 0},
                          str(tmp_path))
    np.testing.assert_array_equal(got["w"], np.arange(2**16,
                                                      dtype=np.float32))
    for step in (2, 3, 4):
        saver.save(tree, step)
    saver.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_00000003",
                                            "step_00000004"]


def test_restore_places_into_the_like_tensors(tmp_path):
    tree = {"a": torch.full((3,), 2.5), "b": {"c": torch.arange(4)}}
    ckpt.save(tree, str(tmp_path), 0)
    like = {"a": torch.zeros(3), "b": {"c": torch.zeros(4, dtype=torch.int64)}}
    target = like["a"]

    def place(arr, t):
        t.copy_(torch.from_numpy(arr))
        return t

    got, _ = ckpt.restore(like, str(tmp_path), place=place)
    assert got["a"] is target and torch.equal(target, tree["a"])
    assert torch.equal(got["b"]["c"], tree["b"]["c"])
