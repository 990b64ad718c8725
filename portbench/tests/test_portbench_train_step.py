"""The training cell's loop steps as ``launch.train.run``'s does: from the
same weights and rows, the first steps' metrics and the state after them
are the same, bit for bit. The cell drives a copy of ``train.run``'s step
function and AdamW configuration; this holds the copy to the original."""

import importlib

import torch

import pb_cases
from pb_cases import TRAIN

from portbench import harness
from portbench.kinds import train as cell_train

STEPS = 3


def _leaves(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _leaves(v, f"{prefix}{k}.")
        else:
            yield prefix + k, v


def test_the_cell_steps_as_launch_train_run_does(tmp_path, monkeypatch):
    from repro_torch.configs import base as configs
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adamw

    config = harness.data("configs", "minicpm3-4b")
    cfg = configs.get(config["arch"]).reduced()
    sizes = {k: getattr(cfg, k) for k in config["sizes"]}
    cell = harness.data("workloads", TRAIN)
    seq = pb_cases.TRAFFIC[TRAIN]["seq_len"]
    cell["traffic"]["seq_len"] = seq
    ref = importlib.import_module(f"portbench.reference.{config['reference']}")
    dev = torch.device("cpu")
    ctx = harness.Context(cell=cell, config=config, sizes=sizes, cfg=cfg,
                          reference=ref, device=dev, seed=0, seconds=0.0,
                          trace=False, t_start=0.0)
    loop, _, ckpt = cell_train.build(ctx)
    mine = loop.run(STEPS)

    made = {}

    class Kept(launch_train.FaultTolerantLoop):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            made["loop"] = self

    def build_state(cfg_, dt, seed=0, *, device="cuda"):
        params = ref.draw_weights(sizes, 0, dev)  # the cell's draw
        return {"params": params, "opt": adamw.init_state(params)}

    monkeypatch.setattr(launch_train, "FaultTolerantLoop", Kept)
    monkeypatch.setattr(launch_train, "build_state", build_state)
    opt = cell["optimizer"]
    theirs = launch_train.run([
        "--arch", config["arch"], "--reduced", "--steps", str(STEPS),
        "--total-steps", str(opt["horizon"]), "--lr", str(opt["lr"]),
        "--batch", str(cell["traffic"]["batch"]), "--seq", str(seq),
        "--ckpt-dir", str(tmp_path), "--ckpt-every", "1000",
        "--device", "cpu"])
    assert len(mine) == STEPS and mine == theirs.metrics
    a, b = dict(_leaves(loop.state)), dict(_leaves(made["loop"].state))
    assert a.keys() == b.keys()
    assert all(torch.equal(a[k], b[k]) for k in a), [
        k for k in a if not torch.equal(a[k], b[k])]
