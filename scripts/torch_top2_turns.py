#!/usr/bin/env python3
"""Times the port's top-2 matching kernel (orthosfm_torch/csrc/match_kernels.cu)
of several source trees in turns, on one GPU.

    python3 scripts/torch_top2_turns.py TREE [TREE ...] [--json OUT]

Each TREE is a checkout of this repository. This process makes the inputs
once with this checkout's code, on the card: the real SIFT (D = 128) and SURF (64)
descriptor stacks of chip_smoke.py's phase 5 (16 sphere views of 2048^2,
seed 7, all 120 pairs) and phase 2's random sets (8 pairs x 8192 rows, D =
128 and 64, with duplicated rows, a repeated view and databases of 0 and
1 rows). Every tree then runs in a process of its own
(scripts/torch_turns.py), which imports that tree's orthosfm_torch, builds
its kernels from its own csrc/ and times both directions of every pair:
  - a tree whose top2 returns both directions (six outputs): one call,
    by CUDA events over many calls (the host never waits on the card);
  - an older tree (three outputs, one direction, a host sync a call): two
    calls, (bi, bj) and (bj, bi).
In both, torch.profiler gives each kernel's device time per call, which a
host sync does not inflate. torch.bmm on the same gathered stacks (the
product alone, cuBLAS f32) is timed beside. Prints one JSON line per tree
and a table; needs CUDA.
"""

import argparse
import importlib.util
import json
import os
import re
import sys
import tempfile

import torch_turns
from torch_turns import REPO

CASES = ("sift", "surf", "random_128", "random_64")


def _smoke():
    """This checkout's chip_smoke module (phase 5's scene)."""
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def make_inputs(path):
    """Every case's (stack, bi, bj, ci, cj), saved to `path`."""
    import torch

    sys.path.insert(0, REPO)
    smoke = _smoke()
    dev = torch.device("cuda:0")
    cases = {}
    for kind, (stack, cols) in smoke.front_end_stacks(dev).items():
        cases[kind] = (stack, *cols)
    for D in (128, 64):
        stack, cols = torch_turns.bench().random_top2_set(dev, D)
        cases[f"random_{D}"] = (stack, *cols)
    torch.save({k: [t.cpu() for t in v] for k, v in cases.items()}, path)


def profile(fn, n):
    """Device microseconds per call of each kernel or memset that fn
    launches (torch.profiler); {} where the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile as prof

    fn()
    torch.cuda.synchronize()
    with prof(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    times = {}
    for e in p.key_averages():
        us = getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        name = re.search(r"(\w+_kernel(<\w+>)?)", e.key)
        key = name.group(1) if name else ("memset" if "emset" in e.key else None)
        if us > 0 and key:
            times[key] = times.get(key, 0.0) + us / n
    return times


def time_tree(tree, inputs):
    """Runs in the child process: the top2 of `tree` on every case."""
    sys.path.insert(0, os.path.abspath(tree))
    import torch

    from orthosfm_torch.ops import matching_kernels as mk

    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    dev = torch.device("cuda:0")
    mk.library()
    cuda_ms = torch_turns.bench().cuda_ms
    data = torch.load(inputs)
    out = {"tree": tree, "device": torch.cuda.get_device_name(0)}
    for case in CASES:
        stack, bi, bj, ci, cj = (t.to(dev) for t in data[case])
        both = len(mk.top2(stack, bi, bj, ci, cj, impl="kernel")) == 6
        if both:
            call = lambda: mk.top2(stack, bi, bj, ci, cj, impl="kernel")  # noqa: E731
        else:
            def call():
                mk.top2(stack, bi, bj, ci, cj, impl="kernel")
                mk.top2(stack, bj, bi, cj, ci, impl="kernel")
        n = 20 if stack.shape[1] < 4096 else 5
        t = {"two_way": both, "ms": cuda_ms(call, n), "device_us": profile(call, n)}
        qa, qb = stack[bi.long()], stack[bj.long()].transpose(1, 2)
        t["bmm_ms"] = cuda_ms(lambda: torch.bmm(qa, qb), n)
        del qa, qb
        out[case] = t
    print(json.dumps(out))


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("trees", nargs="*")
    p.add_argument("--json", default="")
    p.add_argument("--inputs", default="", help=argparse.SUPPRESS)
    p.add_argument("--one", default="", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.one:
        time_tree(args.one, args.inputs)
        return 0
    if not args.trees:
        p.error("give at least one TREE")
    card = torch_turns.card()
    print(card)
    with tempfile.TemporaryDirectory() as tmp:
        inputs = os.path.join(tmp, "top2_inputs.pt")
        make_inputs(inputs)
        runs = torch_turns.run_turns(__file__, args.trees, ["--inputs", inputs])
    for case in CASES:
        for r in runs:
            t = r[case]
            dev_ms = sum(t["device_us"].values()) / 1e3
            print(f"{case:10s} {r['tree']:24s} {'one call' if t['two_way'] else 'two calls'}: "
                  f"events {t['ms']:.4f} ms   profiler device {dev_ms:.4f} ms   "
                  f"bmm {t['bmm_ms']:.4f} ms   {t['device_us']}")
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"nvidia_smi": card, "runs": runs}, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
