#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

Run from the repository root on a machine with an NVIDIA H100 and the
CUDA toolkit: ``python3 chip_smoke.py``. The first run builds the CUDA
kernels from source into ``build/repro_torch/``. Phases, in order; any
failure exits non-zero:

1. device — the card's name, power limit and compute capability
   (must be 9.0);
2. build  — every kernel of the port compiled with ``nvcc`` (sm_90a);
3. kernel — each kernel against its plain torch version on the card,
   bit for bit, on seeded tables: the wave-step kernel on an image of
   2**24 + 1 words with 2**20 lanes x 8 steps (WAR aliasing, clipped
   gathers, NaN payloads), on one 8-lane step, on an L2-resident image
   (64 steps, where barriers weigh more) and at the largest launch
   shape of the main path; device times from CUDA events, and for each
   timed case the cost of one grid barrier at its grid, timed alone;
4. main path — the nine Table-1 programs at ``--scale-mult 8`` through
   ``executor.execute(..., backend="torch")`` on the card, each final
   array bit-identical to the port's sequential oracle, plus one
   ``run_sequential`` baseline; the kernel's launch count is read
   around this phase only;
5. the card line, the ``{"kernels": [...]}`` line, and last
   ``{"ok": true, "device": {...}}``.

Exits non-zero without a result where no CUDA device is present, and
where the port's package is missing. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the Table-1 scales of the reference benchmark, times 8
SCALES_8X = {
    "RAWloop": 16384, "WARloop": 16384, "WAWloop": 16384,
    "bnn": 512, "pagerank": 768, "fft": 2048, "matpower": 512,
    "hist+add": 8192, "tanh+spmv": 2048,
}
SEQ_PROGRAM, SEQ_STEPS = "hist+add", 256
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BIG_M, BIG_W, BIG_S = 2**24 + 1, 2**20, 8
L2_M, L2_W, L2_S = 2**18 + 1, 2**18, 64
SYNC_STEPS = (100, 1100)


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def _wave_bytes(writes: np.ndarray) -> int:
    """Bytes the wave steps must move: per lane its address (4), write
    flag (1), gathered word read (8) and written out (8); per write lane
    its store value read (8) and its scattered word written (8)."""
    return writes.size * (4 + 1 + 8 + 8) + int(writes.sum()) * (8 + 8)


def _sync_us(grid: int) -> float:
    """Microseconds one grid barrier of the wave kernel costs at
    ``grid`` blocks, measured apart from memory traffic: the barrier
    kernel's time at SYNC_STEPS[1] steps less its time at SYNC_STEPS[0],
    over the extra barriers (two per step)."""
    from repro_torch.kernels.wave_exec import kernel

    lo, hi = (_time_ms(lambda n=n: kernel.grid_sync(grid, n), 10)
              for n in SYNC_STEPS)
    return (hi - lo) * 1e3 / (2 * (SYNC_STEPS[1] - SYNC_STEPS[0]))


def _time_ms(fn, reps: int) -> float:
    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def check_wave_kernel(seed, m, s, w, *, timed):
    """The wave kernel against ``wave_loop_ref`` on seeded tables; with
    ``timed``, both timed on the same inputs. Returns a result dict."""
    from repro_torch.kernels.wave_exec import kernel
    from repro_torch.kernels.wave_exec.ref import random_tables, wave_loop_ref

    dev = torch.device("cuda")
    mem, addrs, writes, svals = random_tables(
        np.random.default_rng(seed), m, s, w
    )
    mem_d = torch.from_numpy(mem).to(dev)
    tabs = [torch.from_numpy(t).to(dev) for t in (addrs, writes, svals)]
    k_mem, k_vals = kernel.wave_loop(mem_d.clone(), *tabs)
    r_mem, r_vals = wave_loop_ref(mem_d.clone(), *tabs)
    torch.cuda.synchronize()
    if not (torch.equal(k_mem, r_mem) and torch.equal(k_vals, r_vals)):
        raise AssertionError(
            f"wave kernel != plain version at M={m} S={s} W={w}"
        )
    err = max(
        (k_mem - r_mem).abs().max().item(),
        (k_vals - r_vals).abs().max().item(),
    )
    out = {"M": m, "S": s, "W": w, "max_abs_err": float(err)}
    if timed:
        scratch = mem_d.clone()
        out["ms"] = _time_ms(lambda: kernel.wave_loop(scratch, *tabs), 20)
        out["plain_ms"] = _time_ms(lambda: wave_loop_ref(scratch, *tabs), 5)
        out["bound_ms"] = _wave_bytes(writes) / HBM_BYTES_PER_S * 1e3
        # the bytes bound plus the design's two grid barriers per step,
        # each timed alone at this launch's grid
        out["grid"] = kernel.launch_grid(w, dev)
        out["sync_us"] = _sync_us(out["grid"])
        out["bound_with_syncs_ms"] = (
            out["bound_ms"] + 2 * s * out["sync_us"] * 1e-3
        )
    return out


def run_main_path():
    """The nine Table-1 programs through the port's entry point on the
    card, each checked bit for bit against the oracle."""
    from repro_torch.core import executor, loopir as ir, programs
    from repro_torch.kernels import wave_exec

    rows, shapes = [], []
    for name in programs.TABLE1:
        prog, arrays, params = programs.get(name).make(SCALES_8X[name])
        res = executor.execute(prog, arrays, params, backend="torch")
        oracle = ir.interpret(prog, arrays, params)
        for k in oracle:
            if res.arrays[k].tobytes() != oracle[k].tobytes():
                raise AssertionError(f"{name}: '{k}' differs from the oracle")
        run = res.run
        row = {
            "program": name, "scale": SCALES_8X[name],
            "n_requests": res.stats.n_requests, "n_steps": run.n_steps,
            "n_segments": run.n_segments, "resolve_s": run.resolve_s,
            "device_s": run.device_s,
        }
        print(json.dumps(row), flush=True)
        rows.append(row)
        m = res.plan.mem_size + 1
        shapes.extend((m, s, w) for s, w in run.segments)
    prog, arrays, params = programs.get(SEQ_PROGRAM).make(
        SCALES_8X[SEQ_PROGRAM]
    )
    plan = executor.build_wave_plan(prog, arrays, params)
    seq = wave_exec.run_sequential(plan, arrays, max_steps=SEQ_STEPS,
                                   check=True)
    if seq.n_steps != SEQ_STEPS or seq.complete:
        raise AssertionError("run_sequential did not stop at max_steps")
    row = {
        "program": SEQ_PROGRAM, "sequential": True, "n_steps": seq.n_steps,
        "n_segments": seq.n_segments, "resolve_s": seq.resolve_s,
        "device_s": seq.device_s,
    }
    print(json.dumps(row), flush=True)
    rows.append(row)
    shapes.extend((plan.mem_size + 1, s, w) for s, w in seq.segments)
    return rows, shapes


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    from repro_torch import _build
    from repro_torch.kernels.wave_exec import kernel

    # 1. device
    card = _card_line()
    cap = torch.cuda.get_device_capability(0)
    print(f"device: {card}, capability {cap[0]}.{cap[1]}", flush=True)
    if cap != (9, 0):
        raise AssertionError(f"expected a Hopper card (9.0), got {cap}")

    # 2. build
    for name in _build.SOURCES:
        took = _build.build(name)
        print(f"build: {name} nvcc {took:.2f} s")
        log = _build.library_path(name).with_suffix(".log")
        if log.exists():
            print(log.read_text().strip())

    # 3. kernel against its plain version (launches here are not counted)
    big = check_wave_kernel(0, BIG_M, BIG_S, BIG_W, timed=True)
    print("wave kernel:", json.dumps(big), flush=True)
    small = check_wave_kernel(1, 9, 1, 8, timed=True)
    print("wave kernel, one 8-lane step:", json.dumps(small), flush=True)
    # an image that stays in L2: bytes matter less, barriers more
    l2 = check_wave_kernel(3, L2_M, L2_S, L2_W, timed=True)
    print("wave kernel, L2-resident image:", json.dumps(l2), flush=True)

    # 4. main path, with the launch count read around it alone
    kernel.wave_loop.launches = 0
    rows, shapes = run_main_path()
    launches = kernel.wave_loop.launches
    expected = sum(r["n_segments"] for r in rows)
    if launches == 0 or launches != expected:
        raise AssertionError(
            f"main path launched the wave kernel {launches} times, "
            f"its runs report {expected} segments"
        )
    m, s, w = max(shapes, key=lambda t: t[1] * t[2])
    main_shape = check_wave_kernel(2, m, s, w, timed=True)
    print("wave kernel at the main path's largest launch:",
          json.dumps(main_shape), flush=True)

    # 5. result lines
    entry = {
        "name": "wave_loop", "route": "cuda",
        "source": "src/repro_torch/kernels/wave_exec/csrc/wave_exec.cu",
        "replaces": "src/repro/kernels/wave_exec/kernel.py:43",
        "launches": launches,
        "tolerance": "bit-exact (torch.equal on image and gathered words)",
        "max_abs_err": max(c["max_abs_err"]
                           for c in (big, small, l2, main_shape)),
        "ms": big["ms"], "plain_ms": big["plain_ms"],
        "bound_ms": big["bound_ms"], "bound_by": "bytes",
        "bound_with_syncs_ms": big["bound_with_syncs_ms"],
        "sync_us": big["sync_us"], "grid": big["grid"],
        "library_ms": None,
        "shape": {"M": BIG_M, "S": BIG_S, "W": BIG_W},
        "main_path_largest_launch": main_shape,
        "one_8_lane_step": small, "l2_resident": l2,
    }
    print(_card_line())
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
