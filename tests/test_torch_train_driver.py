"""The port's training driver (``launch/train.py``, ``launch/steps.py``,
``distributed/fault.py``, ``launch/shapes.py``) against the JAX package's,
on the CPU.

- ``train.main([... "--device", "cpu"])``'s losses against the
  reference's ``train.main`` from the same initial state, within 2e-3
  each: the reference draws its state from ``PRNGKey(0)``; the test
  writes that state as a step-0 checkpoint with the reference's
  ``checkpoint.manager`` and the port resumes from it (``--resume``), so
  the checkpoint crossing is on this path too;
- resume: 20 straight steps against 10 + resume + 10, at the reference's
  ``rtol=1e-4`` (``tests/test_system.py``);
- the fault-tolerant loop: a transient fault is retried and counted, a
  persistent one raises the reference's ``RuntimeError``, a fault after a
  checkpoint rewinds the state and the data; a fault after the in-place
  update began restores the checkpoint, and without one raises instead
  of applying the update twice;
- the shape table; the host-only modules import no torch.
"""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import manager as ref_ckpt
from repro.configs import base as ref_configs
from repro.launch import shapes as ref_shapes
from repro.launch import train as ref_train
from repro.models import layers as ref_L
from repro_torch import pytree
from repro_torch.configs import base as configs
from repro_torch.data.pipeline import DataConfig, ShardedLoader
from repro_torch.distributed.fault import (FaultConfig, FaultTolerantLoop,
                                          StateChanged)
from repro_torch.launch import shapes, steps, train
from repro_torch.models import layers as L
from repro_torch.optim import adamw

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _argv(arch, steps_, ckpt_dir, *extra):
    return ["--arch", arch, "--reduced", "--steps", str(steps_), "--batch",
            "2", "--seq", "64", "--ckpt-dir", str(ckpt_dir), *extra]


@pytest.mark.parametrize("arch", ["qwen3-14b", "falcon-mamba-7b"])
def test_train_main_losses_match_reference_from_one_state(arch, tmp_path):
    want = ref_train.main(_argv(arch, 5, tmp_path / "ref"))
    cfg = ref_configs.get(arch).reduced()
    state = jax.tree.map(np.asarray, ref_train.build_state(cfg, ref_L.FP32))
    ref_ckpt.save({"state": state, "data": {"step": 0}},
                  str(tmp_path / "port"), 0)
    run = train.run(_argv(arch, 5, tmp_path / "port", "--resume",
                          "--device", "cpu"))
    assert run.recoveries == 0 and len(run.step_seconds) == 5
    np.testing.assert_allclose(run.losses, want, rtol=0, atol=2e-3)


def test_resume_equals_an_unbroken_run(tmp_path):
    """The reference's fault-tolerance invariant, on the port: 20 straight
    steps equal 10 steps + a new process's resume + 10 steps."""
    common = ["--batch", "2", "--seq", "32", "--ckpt-every", "5",
              "--device", "cpu"]
    a = train.main(["--arch", "starcoder2-7b", "--reduced", "--steps", "20",
                    "--ckpt-dir", str(tmp_path / "a"), *common])
    train.main(["--arch", "starcoder2-7b", "--reduced", "--steps", "10",
                "--total-steps", "20", "--ckpt-dir", str(tmp_path / "b"),
                *common])
    b = train.main(["--arch", "starcoder2-7b", "--reduced", "--steps", "20",
                    "--ckpt-dir", str(tmp_path / "b"), "--resume", *common])
    assert len(a) == 20 and len(b) == 10
    np.testing.assert_allclose(a[-1], b[-1], rtol=1e-4)
    np.testing.assert_allclose(a[10:], b, rtol=1e-4)


def test_train_step_gives_every_parameter_a_gradient():
    """One step moves every leaf (a leaf without a gradient would keep its
    value under weight decay only); the parameters require no grad
    between steps."""
    cfg = configs.get("zamba2-7b").reduced()
    state = train.build_state(cfg, L.FP32, device="cpu")
    before = {id(p): p.clone() for p in pytree.leaves(state["params"])}
    step = steps.make_train_step(cfg, adamw.AdamWConfig(warmup_steps=1),
                                 L.FP32)
    tok = torch.randint(3, cfg.vocab, (2, 32), generator=torch.Generator()
                        .manual_seed(0))
    params, opt, metrics = step(state["params"], state["opt"],
                                {"tokens": tok, "targets": tok})
    assert set(metrics) == {"loss", "grad_norm", "lr"}
    assert int(opt["step"]) == 1
    for p in pytree.leaves(params):
        assert not p.requires_grad
        assert not torch.equal(p, before[id(p)])
    for m in pytree.leaves(opt["m"]):
        assert float(m.abs().max()) > 0


# ---------------------------------------------------------------------------
# the fault-tolerant loop
# ---------------------------------------------------------------------------


def _loop(tmp_path, step_fn, every=2, retries=2):
    loader = ShardedLoader(DataConfig(vocab=64, seq_len=8, global_batch=2))
    state = {"w": torch.zeros(3)}
    return FaultTolerantLoop(step_fn, state, loader, FaultConfig(
        checkpoint_dir=str(tmp_path), checkpoint_every=every,
        max_retries=retries, backoff_s=0.0))


def _adding_step(fail_at):
    """Adds the batch's first token to ``w`` in place; raises once at each
    call count in ``fail_at``."""
    calls = []

    def step_fn(state, batch):
        calls.append(int(batch["tokens"][0, 1]))
        if len(calls) in fail_at:
            raise RuntimeError("transient fault")
        state["w"].add_(float(batch["tokens"][0, 1]))
        return state, {"loss": float(state["w"][0])}

    return step_fn, calls


def test_loop_retries_a_transient_fault_and_counts_it(tmp_path):
    step_fn, calls = _adding_step(fail_at={2})
    loop = _loop(tmp_path, step_fn, every=100)
    metrics = loop.run(4)
    assert loop.recoveries == 1 and len(metrics) == 4
    assert calls[1] == calls[2]  # no checkpoint: retried in place
    ref_fn, _ = _adding_step(fail_at=set())
    ref = _loop(tmp_path / "ref", ref_fn, every=100)
    assert [m["loss"] for m in metrics] == [m["loss"] for m in ref.run(4)]


def test_loop_restores_the_checkpoint_and_the_data_stream(tmp_path):
    """A fault at step 3 (after the step-2 checkpoint) rewinds state and
    loader to step 2 and re-fetches step 2's batch: the run equals an
    unbroken one."""
    step_fn, _ = _adding_step(fail_at={4})
    loop = _loop(tmp_path, step_fn, every=2)
    got = [m["loss"] for m in loop.run(6)]
    ref_fn, _ = _adding_step(fail_at=set())
    want = [m["loss"] for m in _loop(tmp_path / "ref", ref_fn).run(6)]
    assert loop.recoveries == 1
    assert got[-1] == want[-1]


def test_loop_raises_on_a_persistent_fault(tmp_path):
    """A fault that every retry meets (as a sticky CUDA error does) is
    never turned into a pass: after ``max_retries`` the reference's
    ``RuntimeError`` names the step."""
    def step_fn(state, batch):
        raise RuntimeError("CUDA error: an illegal memory access")

    loop = _loop(tmp_path, step_fn, retries=2)
    with pytest.raises(RuntimeError, match="step 0 failed after 2 retries"):
        loop.run(3)
    assert loop.recoveries == 3


def test_loop_does_not_retry_a_changed_state_without_a_checkpoint(tmp_path):
    """A step that fails after it changed the state in place, before any
    checkpoint, is not retried on the changed state: the loop raises and
    the update stands once."""
    def step_fn(state, batch):
        state["w"].add_(1.0)
        raise StateChanged("the update failed")

    loop = _loop(tmp_path, step_fn, every=100)
    with pytest.raises(RuntimeError, match="step 0 failed after it began"):
        loop.run(3)
    assert loop.recoveries == 1
    assert loop.state["w"].tolist() == [1.0, 1.0, 1.0]


def _update_failing_once(monkeypatch, at_call):
    """``adamw.apply_updates`` that fails once, on call ``at_call``, after
    it has updated the parameters and moments in place."""
    update, calls = adamw.apply_updates, []

    def failing(*args, **kwargs):
        out = update(*args, **kwargs)
        calls.append(1)
        if len(calls) == at_call:
            raise RuntimeError("fault after the update")
        return out

    monkeypatch.setattr(adamw, "apply_updates", failing)


def test_train_fault_after_the_update_restores_the_checkpoint(
        tmp_path, monkeypatch):
    """The train driver on the CPU, its AdamW update failing after it ran
    at step 3: the loop restores the step-2 checkpoint and the run ends
    where an unbroken one does; without a checkpoint it raises."""
    argv = ["--arch", "qwen3-14b", "--reduced", "--steps", "6", "--batch",
            "2", "--seq", "16", "--device", "cpu", "--ckpt-every", "2"]
    want = train.run(argv + ["--ckpt-dir", str(tmp_path / "straight")])
    _update_failing_once(monkeypatch, at_call=4)
    got = train.run(argv + ["--ckpt-dir", str(tmp_path / "faulted")])
    assert got.recoveries == 1
    assert got.losses[-4:] == want.losses[-4:]
    monkeypatch.undo()
    _update_failing_once(monkeypatch, at_call=2)
    with pytest.raises(RuntimeError, match="step 1 failed after it began"):
        train.run(argv[:-1] + ["100", "--ckpt-dir", str(tmp_path / "none")])


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train.main(["--arch", "qwen3-14b", "--reduced", "--steps", "1"])


# ---------------------------------------------------------------------------
# shapes, and the host-only modules
# ---------------------------------------------------------------------------


def test_shape_table_and_applicability_match_reference():
    assert {k: vars(v) for k, v in shapes.SHAPES.items()} == {
        k: vars(v) for k, v in ref_shapes.SHAPES.items()}
    mine = [(c.name, s.name, ok) for c, s, ok in shapes.cells(
        [configs.get(n) for n in configs.all_names()])]
    theirs = [(c.name, s.name, ok) for c, s, ok in ref_shapes.cells(
        [ref_configs.get(n) for n in ref_configs.all_names()])]
    assert mine == theirs
    assert ("qwen3-14b", "long_500k", (False, "SKIP(full-attn)")) in mine


def test_host_only_training_modules_load_no_torch():
    """The data pipeline, the checkpoint manager and the shape table are
    host code, as the reference's data pipeline and shape table are free
    of JAX: importing them loads no torch (nor JAX, nor the reference)."""
    code = (
        "import sys\n"
        "import repro_torch.data.pipeline, repro_torch.checkpoint.manager\n"
        "import repro_torch.launch.shapes, repro_torch.pytree\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0]\n"
        "             in ('torch', 'jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
