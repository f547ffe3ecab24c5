import time

_T_PROCESS = time.monotonic()

from sfm_bench.harness import main  # noqa: E402

raise SystemExit(main(t_process=_T_PROCESS))
