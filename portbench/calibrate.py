"""The readings that a cell's check limits are set from, on the chip, in
one process: the program's numbers and the control's on each of a list of
seeds, and, for a training cell, each of ``faults.FAULTS`` planted in the
program on the first three of them.

    python3 portbench/calibrate.py --workload <cell> --seeds 1,2,3 \
        --seconds 51 [--faults] [--out <file>.jsonl]

One JSON line a run: the seed, the fault (or null), ``correct``, the
numbers compared and, for sound runs, the control's with the control's own
``correct`` from the same comparison (``checks.verdict`` against the cell's
limits), which has to come out false. A training cell's
readings come from its first steps, in set-up, so ``--seconds 0`` reads it
without a window; a serving cell's come from the tokens its window served.
The reference's readings of a seed are made once and kept for its faults.
"""

import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

import argparse  # noqa: E402
import json  # noqa: E402

from portbench import checks, faults, harness  # noqa: E402
from portbench.kinds import train  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    seeds = [int(x) for x in args.seeds.split(",")]
    cell = harness.data("workloads", args.workload)
    kind, limits = cell["kind"], cell["check"]["limits"]
    if kind == "train":  # one reference a seed, for the sound run and faults
        made, reference = {}, train.reference_readings

        def kept(ctx, n, *, tf32=False):
            key = (ctx.seed, n, tf32)
            if key not in made:
                made[key] = reference(ctx, n, tf32=tf32)
            return made[key]
        train.reference_readings = kept
    sink = open(args.out, "a") if args.out else None
    plan = [(s, None) for s in seeds]
    if args.faults:
        plan += [(s, f) for f in faults.FAULTS for s in seeds[:3]]
    for seed, fault in plan:
        t0 = time.perf_counter()
        try:
            if fault:
                with faults.FAULTS[fault](kind):
                    r = harness.run_cell(args.workload, seed, args.seconds,
                                         False)
            else:
                r = harness.run_cell(args.workload, seed, args.seconds, False,
                                     control=True)
            line = {"seed": seed, "fault": fault, "correct": r["correct"],
                    "checks": {k: v["value"] for k, v in r["checks"].items()},
                    "control": r.get("control"), "metrics": {
                        k: v["value"] for k, v in r["metrics"].items()},
                    "timing": r["timing"], "wall_s": time.perf_counter() - t0,
                    "memory_peak_bytes": r["device"]["memory_peak_bytes"]}
            if r.get("control"):
                line["control_correct"] = checks.verdict(
                    r["control"], limits)[0]
        except Exception as e:  # a fault may crash the step: no number
            line = {"seed": seed, "fault": fault, "error": repr(e)[:500]}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
