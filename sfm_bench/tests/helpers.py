"""Shared by the benchmark's tests: the repository root and a runner of the
harness in a process of its own."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run_harness(args, root=ROOT, prelude="", timeout=900):
    """Run sfm_bench's main(args) in a new Python process from `root`, after
    `prelude` (Python source run first in that process, such as a planted
    fault). Returns (exit code, last stdout line parsed or None, stderr)."""
    code = (f"import sys, time; t = time.monotonic(); sys.path.insert(0, {root!r})\n"
            f"{prelude}\n"
            f"from sfm_bench.harness import main\n"
            f"raise SystemExit(main({list(args)!r}, t_process=t))\n")
    env = {**os.environ, "PYTHONPATH": root}
    proc = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                          text=True, timeout=timeout)
    lines = proc.stdout.strip().splitlines()
    try:
        last = json.loads(lines[-1]) if lines else None
    except json.JSONDecodeError:
        last = None
    return proc.returncode, last, proc.stderr
