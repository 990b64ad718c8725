"""The port's package boundary: ``repro_torch`` and ``chip_smoke.py``
import neither ``jax`` nor anything of ``repro``, the entry points never
switch to the CPU by themselves, and the port's ``RunConfig`` keeps the
reference's fields and defaults (the backend's default aside)."""

import ast
import dataclasses
import os
import pathlib
import subprocess
import sys

import pytest
import torch

from repro.core import config as ref_config
from repro_torch.core import config, executor, programs
from repro_torch.kernels import wave_exec

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _forbidden(name: str) -> bool:
    top = name.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_importing_every_port_module_loads_no_jax_or_reference():
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.__path__, 'repro_torch.')]\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20  # every module was imported


def test_hls_tools_load_no_torch():
    """The linter, the DSE sweep service and the sweep summaries are host
    code: importing them loads no torch either, so the sweep's spawned
    workers start without it."""
    code = (
        "import sys, pkgutil\n"
        "import repro_torch.analysis.lint, repro_torch.dse\n"
        "import repro_torch.launch.analysis\n"
        "mods = [m.name for m in pkgutil.walk_packages(\n"
        "    repro_torch.dse.__path__, 'repro_torch.dse.')]\n"
        "assert set(mods) <= set(sys.modules), mods\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0]\n"
        "             in ('torch', 'jax', 'jaxlib', 'repro'))\n"
        "assert not bad, bad\n"
        "print(len(mods))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True,
        text=True, timeout=300,
    )
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) == 6  # spec .. calibrate, all loaded


def _imports(path: pathlib.Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.extend(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, f"{path}: relative import"
            names.append(node.module)
    return names


def test_port_sources_name_no_jax_or_reference_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    for path in files:
        bad = [n for n in _imports(path) if _forbidden(n)]
        assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid")
    prog, arrays, params = programs.get("RAWloop").make(8)
    for backend in (config.UNSET, "torch"):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            executor.execute(prog, arrays, params, backend=backend)
    plan = executor.build_wave_plan(prog, arrays, params)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wave_exec.run_plan(plan, arrays)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        wave_exec.run_sequential(plan, arrays)


def test_run_config_matches_reference():
    """Same fields and defaults, but for one deliberate deviation: the
    port's ``backend`` defaults to its card backend ``"torch"`` where the
    reference defaults to the host replay ``"numpy"``."""
    deviates = {"backend": ("torch", "numpy")}
    got = [(f.name, f.default) for f in dataclasses.fields(config.RunConfig)]
    want = [(f.name, f.default)
            for f in dataclasses.fields(ref_config.RunConfig)]
    assert [n for n, _ in got] == [n for n, _ in want]
    for (name, mine), (_, theirs) in zip(got, want):
        assert (mine, theirs) == deviates.get(name, (theirs, theirs)), name
    for vocab in ("MODES", "ENGINES", "TRACE_MODES", "SPECULATIONS",
                  "PREDICTORS", "SIM_FIELDS"):
        assert getattr(config, vocab) == getattr(ref_config, vocab), vocab
    assert ref_config.BACKENDS == ("numpy", "pallas")
    assert config.BACKENDS == ("numpy", "torch")
    with pytest.raises(ValueError, match="unknown backend"):
        config.RunConfig(backend="pallas")
    with pytest.raises(config.ConfigConflict):
        config.resolve(config.RunConfig(backend="torch"), backend="numpy")
