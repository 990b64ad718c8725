"""The fault-tolerant loop's sharded restore on a CPU host mesh.

``FaultTolerantLoop`` over the train step of reduced qwen3-14b on a 2x4
gloo mesh (one spawned rank a process, ``torch_dist_workers.spawn``),
checkpointed every 2 steps; step 3 fails after its in-place update
(``StateChanged``). The loop restores the step-2 checkpoint onto the mesh,
under the ``state_shardings`` it was given or under the live DTensors'
own: every leaf is a new DTensor under the placements it was distributed
with, and the run's log equals an unbroken run's bit for bit, the
replayed step 2 logged twice.
"""

import json

import pytest

import torch_dist_workers as W

MESH = (2, 4)
STEPS, FAULT_AT, EVERY, B, S = 4, 3, 2, 8, 32


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("recovery")
    out = root / "runs.json"
    W.spawn(W.sharded_recovery, MESH[0] * MESH[1], MESH, STEPS, B, S,
            FAULT_AT, EVERY, str(root), str(out), timeout=240)
    return json.loads(out.read_text())


@pytest.mark.parametrize("shardings", ["given", "live"])
def test_sharded_loop_restores_onto_the_mesh_after_a_fault(runs, shardings):
    want = runs["unbroken"]["metrics"]
    run = runs[shardings]
    assert runs["unbroken"]["recoveries"] == 0
    assert run["recoveries"] == 1
    assert run["placements_kept"] and run["restored_new_tensors"]
    # rewound to the step-2 checkpoint: step 2 runs (and is logged) again
    assert run["metrics"] == want[:FAULT_AT] + want[EVERY:]
