"""The dry run's roofline terms, and design-space sweep summarization
(per-kernel speedups, Pareto fronts).

The port of ``src/repro/launch/analysis.py``. Its sweep half
(``harmonic_mean``, ``sweep_speedups``, ``pareto_front``,
``ParetoTracker``, ``summarize_sweep``) is unchanged: plain dict rows
(``dse.SweepResult.rows()``), nothing of the ``dse`` package.

Its roofline half reads the account of ``launch/cost.py`` (the
reference's reads XLA's compiled HLO): ``collective_bytes``,
``roofline``, ``memory_report``, and ``model_flops``, copied. The module
imports nothing, torch included; the torch side lives in ``cost.py`` and
``dryrun.py``.

Hardware constants: one NVIDIA H100 SXM at its 700 W limit, NVIDIA's
published data-sheet peaks (not measurements): 989 TFLOP/s bf16 dense
(the dry run's dtype), 67 TFLOP/s float32 outside the tensor cores,
3.35 TB/s HBM, NVLink 450 GB/s each way.

Terms per (arch, shape, mesh):
  compute    = dot FLOPs per device / PEAK_FLOPS
  memory     = bytes per device / HBM_BW
  collective = per-device collective bytes / LINK_BW

Collective byte conventions (ring-algorithm bytes per device):
  all-gather       out * (g-1)/g
  all-reduce       2 * out * (g-1)/g
  reduce-scatter   out * (g-1)          (input = g * out)
  all-to-all       out * (g-1)/g
  collective-permute  out
"""

from __future__ import annotations

PEAK_FLOPS = 989e12  # bf16 dense, H100 SXM data sheet
HBM_BW = 3.35e12
LINK_BW = 450e9  # NVLink, each way

_COLLECTIVES = {
    "all-gather": lambda out, g: out * (g - 1) / max(g, 1),
    "all-reduce": lambda out, g: 2 * out * (g - 1) / max(g, 1),
    "reduce-scatter": lambda out, g: out * (g - 1),
    "all-to-all": lambda out, g: out * (g - 1) / max(g, 1),
    "collective-permute": lambda out, g: out,
}


def collective_bytes(record: list) -> dict:
    """Per-device collective bytes by op kind from ``(kind, out_bytes,
    group_size)`` records (the reference parses them out of HLO text)."""
    out: dict[str, float] = {k: 0.0 for k in _COLLECTIVES}
    counts: dict[str, int] = {k: 0 for k in _COLLECTIVES}
    for kind, out_bytes, g in record:
        out[kind] += _COLLECTIVES[kind](out_bytes, g)
        counts[kind] += 1
    return {"per_op": out, "counts": counts, "total_bytes": sum(out.values())}


def roofline(cost: dict, n_devices: int,
             model_flops_per_device: float = 0.0) -> dict:
    """All three terms + the dominant one from an account
    (``cost.CostMode.total()``, per device)."""
    flops = float(cost["flops"])
    bytes_accessed = float(cost["bytes"])
    coll_total = float(cost["collective_bytes"])

    t_compute = flops / PEAK_FLOPS
    t_memory = bytes_accessed / HBM_BW
    t_collective = coll_total / LINK_BW
    terms = {
        "compute_s": t_compute,
        "memory_s": t_memory,
        "collective_s": t_collective,
    }
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    util = t_compute / bound if bound > 0 else 0.0
    out = {
        **terms,
        "dominant": dominant.replace("_s", ""),
        "n_devices": n_devices,
        "flops_per_device": flops,
        "flops_elementwise": float(cost["flops_elementwise"]),
        "bytes_per_device": bytes_accessed,
        "collective_bytes_per_device": coll_total,
        "collective_per_op": cost["collective_per_op"],
        "roofline_fraction": util,  # compute-time share of the bound
    }
    if model_flops_per_device:
        out["model_flops_per_device"] = model_flops_per_device
        out["useful_flops_ratio"] = model_flops_per_device / max(flops, 1.0)
    return out


def memory_report(mem: dict) -> dict:
    """Per-device bytes from ``cost.MemoryMode.report()``: the state
    (the arguments), the temporaries above it at the peak, and the
    peak."""
    args = int(mem["argument_bytes"])
    peak = int(mem["peak_bytes"])
    return {
        "argument_size_in_bytes": args,
        "temp_size_in_bytes": peak - args,
        "peak_bytes_per_device_est": peak,
    }


def harmonic_mean(xs) -> float:
    xs = [x for x in xs if x > 0]
    return len(xs) / sum(1.0 / x for x in xs) if xs else 0.0


def sweep_speedups(rows: list, base_modes=("STA", "LSQ")) -> dict:
    """Per-kernel and harmonic-mean FUS2 speedups from sweep rows.

    ``rows`` are ``dse.SweepResult.rows()`` dicts (needs ``kernel``,
    ``mode``, ``sizing``, ``cycles``). Speedups compare FUS2 against
    each base mode *at the same kernel/sizing/scale*; kernels or
    sizings missing either side are skipped. Returns
    ``{"per_kernel": {kernel: {"FUS2_vs_STA": ...}}, "hmean": {...}}``
    computed at the ``"base"`` sizing when present (else the first
    sizing seen), mirroring paper Table 1's headline structure.
    """
    cyc: dict[tuple, int] = {}
    sizings: list = []
    for r in rows:
        key = (r["kernel"], r["scale"], r["sizing"], r["mode"])
        cyc.setdefault(key, r["cycles"])
        if r["sizing"] not in sizings:
            sizings.append(r["sizing"])
    ref_sizing = "base" if "base" in sizings else (sizings[0] if sizings else "base")
    # one scale per kernel keys rows by kernel name; multi-scale sweeps
    # key by "kernel@scale" so scales don't overwrite each other
    kernel_scales: dict = {}
    for (kernel, scale, _sizing, _mode) in cyc:
        kernel_scales.setdefault(kernel, set()).add(scale)
    per_kernel: dict = {}
    for (kernel, scale, sizing, mode) in list(cyc):
        if sizing != ref_sizing or mode != "FUS2":
            continue
        f2 = cyc[(kernel, scale, sizing, "FUS2")]
        name = (
            kernel if len(kernel_scales[kernel]) == 1 else f"{kernel}@{scale}"
        )
        ks = per_kernel.setdefault(name, {})
        for base in base_modes:
            b = cyc.get((kernel, scale, sizing, base))
            if b is not None and f2 > 0:
                ks[f"FUS2_vs_{base}"] = round(b / f2, 3)
    hmean = {}
    for base in base_modes:
        vals = [
            k[f"FUS2_vs_{base}"]
            for k in per_kernel.values()
            if f"FUS2_vs_{base}" in k
        ]
        if vals:
            hmean[f"FUS2_vs_{base}_hmean"] = round(harmonic_mean(vals), 3)
    return {"per_kernel": per_kernel, "hmean": hmean, "sizing": ref_sizing}


def pareto_front(rows: list, objectives=("cycles", "dram_bursts")) -> list:
    """Indices of the Pareto-optimal rows (all objectives minimized).

    A row is kept when no other row is <= on every objective and < on
    at least one. Ties (exactly equal vectors) keep the first
    occurrence. Typical use: per kernel, find the DU sizings that trade
    simulated cycles against DRAM traffic."""
    vecs = [tuple(r[o] for o in objectives) for r in rows]
    keep = []
    for i, v in enumerate(vecs):
        dominated = False
        for j, w in enumerate(vecs):
            if j == i:
                continue
            if all(a <= b for a, b in zip(w, v)) and (
                any(a < b for a, b in zip(w, v)) or (w == v and j < i)
            ):
                dominated = True
                break
        if not dominated:
            keep.append(i)
    return keep


class ParetoTracker:
    """Incremental partial Pareto front over streamed sweep rows.

    The live-observability companion of ``pareto_front``: feed it rows
    as ``dse.sweep(on_point=...)`` / ``dse.iter_points()`` deliver
    them and read ``front()`` at any moment. The dominance rule (and
    the keep-first tie rule) match ``pareto_front`` exactly, so after
    any prefix of updates ``front()`` equals
    ``[rows[i] for i in pareto_front(rows_so_far, objectives)]`` —
    pinned per-prefix against the JAX package's by
    tests/test_torch_sweep_service.py.
    """

    def __init__(self, objectives=("cycles", "dram_bursts")):
        self.objectives = tuple(objectives)
        self._front: list = []  # (vector, row), insertion-ordered
        self.n_seen = 0

    def _vec(self, row) -> tuple:
        return tuple(row[o] for o in self.objectives)

    def update(self, row) -> bool:
        """Offer one row; returns True when the front changed."""
        self.n_seen += 1
        v = self._vec(row)
        for w, _r in self._front:
            # w dominates v, or ties it (earlier row wins ties)
            if all(a <= b for a, b in zip(w, v)):
                return False
        survivors = [
            (w, r)
            for w, r in self._front
            if not (
                all(a <= b for a, b in zip(v, w))
                and any(a < b for a, b in zip(v, w))
            )
        ]
        survivors.append((v, row))
        self._front = survivors
        return True

    def front(self) -> list:
        """Current Pareto-optimal rows, in first-seen order."""
        return [r for _v, r in self._front]


def summarize_sweep(rows: list) -> dict:
    """Sweep-level digest: speedups + per-kernel Pareto sizings.

    The Pareto set is computed over FUS2 rows per kernel (one per
    sizing) on (cycles, dram_bursts) — the DU cost/performance
    trade-off the paper's LSQ-sizing discussion gestures at."""
    out = {"speedups": sweep_speedups(rows)}
    pareto: dict = {}
    by_kernel: dict = {}
    if not rows:
        out["pareto_fus2"] = pareto
        return out
    for r in rows:
        if r["mode"] == "FUS2":
            by_kernel.setdefault(r["kernel"], []).append(r)
    for kernel, krows in by_kernel.items():
        seen: dict = {}
        for r in krows:
            seen.setdefault(r["sizing"], r)
        krows = list(seen.values())
        idx = pareto_front(krows)
        pareto[kernel] = [
            {
                "sizing": krows[i]["sizing"],
                "cycles": krows[i]["cycles"],
                "dram_bursts": krows[i]["dram_bursts"],
            }
            for i in idx
        ]
    out["pareto_fus2"] = pareto
    return out


def model_flops(cfg, shape) -> float:
    """MODEL_FLOPS: 6·N·D for training (fwd+bwd), 2·N·D for inference,
    with N = active params (MoE-aware)."""
    n = cfg.n_active_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6 if shape.kind == "train" else 2
    return float(mult * n * tokens)
