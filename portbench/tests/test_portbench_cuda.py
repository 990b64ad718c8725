"""On the card: one run of each cell through the command line, at the
benchmark's own length (a decode window must outlast a batch's prompt to
serve a token), and a result line of the required form. Skips without a
card."""

import json
import subprocess
import sys

import pytest

import pb_cases
from pb_cases import ROOT


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [pb_cases.DECODE, pb_cases.TRAIN])
@pytest.mark.parametrize("trace", [0, 1])
def test_a_run_on_the_card(cell, trace):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    seconds = json.loads((ROOT / "BENCHMARK.json").read_text())["run_seconds"]
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2**31 + 99), "--seconds", str(seconds), "--trace", str(trace)],
        cwd=ROOT, capture_output=True, text=True, timeout=600, check=False)
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert list(out)[-1] == "checks" and out["correct"], out
    assert out["device"]["platform"] == "gpu" and out["device"]["count"] == 1
    assert "setup_s" in out["metrics"] or trace


def test_without_a_card_the_command_fails(tmp_path):
    """No card (or no port beside the harness): a non-zero exit, no
    result."""
    import shutil

    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", pb_cases.DECODE,
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=300,
        check=False)
    assert p.returncode != 0 and not p.stdout.strip()
