"""What the scripts that time several source trees in turns share
(torch_ba_kernel_turns.py, torch_top2_turns.py, torch_k3_routes.py --tree).

Each tree is a checkout of this repository (for example the parent commit
unpacked with `git archive` into a directory that .gitignore lists, then
`.`, `.`, and the parent again). Every tree runs in a process of its own,
the script itself with `--one TREE`, which imports that tree's
orthosfm_torch and builds its kernels from that tree's csrc/, and prints
its result as one JSON object on its last line.
"""

import importlib.util
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def bench():
    """This checkout's orthosfm_torch/utils/kernel_bench.py (its timers),
    whichever tree is being timed, loaded by its path: an older tree may
    not have it."""
    path = os.path.join(REPO, "orthosfm_torch", "utils", "kernel_bench.py")
    spec = importlib.util.spec_from_file_location("kernel_bench", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def run_turns(script, trees, argv=(), timeout=900):
    """Runs `script *argv --one TREE` for each TREE in the order given, each
    in a process of its own, echoes the lines each prints before its last,
    and returns the JSON objects of their last lines. Exits with a child's
    code, after its output, where one fails."""
    runs = []
    for i, tree in enumerate(trees):
        print(f"== turn {i + 1}: {tree}", flush=True)
        proc = subprocess.run([sys.executable, os.path.abspath(script), *argv, "--one", tree],
                              capture_output=True, text=True, timeout=timeout)
        lines = proc.stdout.strip().splitlines()
        if proc.returncode != 0:
            print(proc.stdout + proc.stderr[-8000:], file=sys.stderr)
            raise SystemExit(proc.returncode)
        for line in lines[:-1]:
            print(line, flush=True)
        runs.append(json.loads(lines[-1]))
    return runs
