"""Run one cell of the port's benchmark once; see ``harness.py``.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout (the port is imported from ``src/``).
"""

import time

T0 = time.perf_counter()  # the set-up time counts from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the checkout's root and its src/, in place of this script's own folder
sys.path[0:1] = [str(ROOT), str(ROOT / "src")]

from portbench import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(t_start=T0))
