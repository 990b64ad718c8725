"""The benchmark of the PyTorch and CUDA port: one cell, run once.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the root of a checkout. Everything a cell needs is
found by name from ``BENCHMARK.json``:

- the cell's traffic file ``workloads/<cell>.json``, whose ``kind`` names
  the runner (``kinds/<kind>.py``) and holds its parameters and the
  check's limits;
- its configuration's file ``configs/<config>.json``: the program's arch
  (``repro_torch.configs``), the sizes it runs at, and the plain
  reference (``reference/<reference>.py``) that also lays out and draws
  the weights;
- one reader a metric, ``metrics/<metric>.py``, with ``read(record)``
  giving the metric's value, or None where the run has nothing to read.

With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics and the traced sub-window's device
time. The result is the last line of standard output, one JSON object;
the numbers the check compared, each beside its limit, are the last key
there and the last lines of standard error.
"""

from __future__ import annotations

import argparse
import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def data(kind: str, name: str) -> dict:
    """``configs/<name>.json`` or ``workloads/<name>.json``."""
    return json.loads((PKG / kind / f"{name}.json").read_text())


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``."""
    path = PKG / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def cell_metrics(spec: dict, cell: str, trace: bool) -> list:
    """The cell's metrics, in ``BENCHMARK.json``'s order: its end-to-end
    ones, or with ``trace`` its per-layer ones (a metric without
    ``workloads`` goes to every cell that reports the metric it moves)."""
    e2e = [m for m in spec["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if cell in m.get("workloads", [cell] if m["moves"] in names
                             else [])]


@dataclasses.dataclass
class Context:
    """What a kind's runner is handed."""
    cell: dict
    config: dict
    sizes: dict
    cfg: object  # the program's ArchConfig at ``sizes``
    reference: object  # the module reference/<config's reference>.py
    device: object
    seed: int
    seconds: float
    trace: bool
    t_start: float
    control: bool = False

    def setup_s(self, window_start: float) -> float:
        return window_start - self.t_start


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", t_start=None, sizes=None, traffic=None,
             control=False, spec=None) -> dict:
    """Run cell ``name`` once and return its result (without the check for
    a chip: ``main`` makes it). ``sizes`` and ``traffic`` override the
    configuration's sizes and some of the traffic's parameters (tests run
    reduced ones on the CPU); ``control`` adds the check's control
    readings under ``"control"``."""
    t_start = time.perf_counter() if t_start is None else t_start
    spec = load_spec() if spec is None else spec
    ws = {w["name"]: w for w in spec["workloads"]}
    cell = dict(data("workloads", name), chips=ws[name]["chips"])
    cell["traffic"].update(traffic or {})
    config = data("configs", ws[name]["config"])
    sizes = dict(config["sizes"] if sizes is None else sizes)
    _cache_dirs()
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False  # float32 as configured
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.configs import base as configs

    cfg = dataclasses.replace(configs.get(config["arch"]), **sizes)
    ctx = Context(
        cell=cell, config=config, sizes=sizes, cfg=cfg,
        reference=importlib.import_module(
            f"portbench.reference.{config['reference']}"),
        device=torch.device(device), seed=int(seed), seconds=float(seconds),
        trace=bool(trace), t_start=t_start, control=control)
    runner = importlib.import_module(f"portbench.kinds.{cell['kind']}")
    out = runner.run(ctx)
    rec = out["record"]
    dev = ctx.device
    is_cuda = dev.type == "cuda"
    rec.update(sizes=sizes, cell=cell,
               device_kind=(torch.cuda.get_device_name(dev) if is_cuda
                            else "cpu"))
    metrics = {}
    for m in cell_metrics(spec, name, trace):
        value = reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {"platform": "gpu" if is_cuda else "cpu",
                   "kind": rec["device_kind"], "count": 1,
                   "memory_peak_bytes": out["memory_peak_bytes"]}
    breakdown = None
    prof = rec.get("profile")
    if trace and prof:
        from portbench import profiling

        device_info.update(busy_s=prof["busy_s"], window_s=prof["window_s"])
        breakdown = {"device_ops": profiling.top_ops(prof),
                     "idle_gaps": profiling.idle_gaps(prof)}
    result = {"correct": bool(out["correct"]), "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": device_info}
    if breakdown:
        result["breakdown"] = breakdown
    if control:
        result["control"] = out.get("control")
    result["timing"] = {"setup_s": rec["setup_s"], "window_s": rec["window_s"],
                        "check_s": out["check_s"], **out.get("timing", {})}
    result["checks"] = out["checks"]
    del out, rec
    gc.collect()
    return result


def _cache_dirs():
    """Every kernel cache at a fixed path inside the checkout (the port
    builds its own kernels under ``build/repro_torch``)."""
    base = ROOT / "build" / "portbench"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(base / sub)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start=None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = parse(argv)
    spec = load_spec()
    cells = {w["name"]: w for w in spec["workloads"]}
    if args.workload not in cells:
        print(f"portbench: no cell {args.workload!r}", file=sys.stderr)
        return 2
    import torch

    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: the cell needs {chips} CUDA device(s); {have} "
              f"available", file=sys.stderr)
        return 3
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), t_start=t_start, spec=spec)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}",
              file=sys.stderr)
        return 4
    result["device"]["power_limit"] = _power_limit()
    print(json.dumps(result))
    for n, c in result["checks"].items():
        print(f"check {n} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stdout.flush()
    return 0


def _power_limit() -> str:
    import subprocess

    try:
        p = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"], capture_output=True,
                           text=True, timeout=20, check=False)
        return p.stdout.strip().splitlines()[0] if p.stdout.strip() else ""
    except (OSError, subprocess.TimeoutExpired):
        return ""
