"""python3 sfm_bench/run.py --workload CELL --seed N --seconds S --trace 0|1

Runs one cell of BENCHMARK.json once and prints its result as the last line
of standard output (sfm_bench/harness.py)."""

import time

_T_PROCESS = time.monotonic()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sfm_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(t_process=_T_PROCESS))
