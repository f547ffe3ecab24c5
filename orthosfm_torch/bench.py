"""The BA bench: robust Schur-LM bundle adjustment throughput on the card.
Port of the JAX system's bench.py (at the repo root), by its method.

    python -m orthosfm_torch.bench [--device cuda|cpu]

Prints ONE JSON line with bench.py's metric and keys, and the card:

    {"metric": "ba_iterations_per_s_16cam_8192trk", "value": N, "unit": "iter/s",
     "vs_baseline": N, "synced_single_call_iter_per_s": N, "sync_floor_ms": N,
     "pallas_iter_per_s": N, "xla_iter_per_s": N, "euler_iter_per_s": N,
     "device": "<name>, <power limit>"}

The problem is bench.py's: testbench.problems.make_problem (16 quaternion
cameras perturbed by up to 1 degree, camera 0 fixed, 8192 sphere tracks
triangulated from them, 2048^2 images). The Euler key runs Euler cameras
built from those as bench.py builds them: the angles of each camera's basis,
`fixed` carried, on the same points. They are not make_problem("euler")'s
cameras, which perturbs the Euler angles directly: the same rotations, but
the angles lie on other branches (2 pi apart on some views) and the points
are triangulated from them.

The keys, on the port's routes (kernel_build.IMPL_ALIASES):
  value                          "auto": lm_fused, the whole LM solve in one
                                 launch (16 x 8192 fits)
  pallas_iter_per_s              "pallas": the per-iteration kernels K1, K3
                                 and K2, with K4's accept rule in K2's tail
  xla_iter_per_s                 "xla": the plain PyTorch versions, on the card
  euler_iter_per_s               "auto" on the Euler cameras
  synced_single_call_iter_per_s  value's route, one solve to a synchronize
  sync_floor_ms                  the best of 5 round trips of x * 2 + 1 on an
                                 (8, 128) tensor, each to a synchronize
  vs_baseline                    value over the same "auto" solver on the host
                                 CPU (its "torch" route), one repeat of 2
                                 calls as in bench.py; 1.0 with --device cpu
  device                         the card's name and power limit as
                                 nvidia-smi gives them ("cpu" on the CPU)

Method (bench.py's time_ba): BundleAdjustConfig(max_iterations=30,
function_tolerance=0.0, min_lambda=1e-12, impl=...); one warm-up solve,
whose iterations must be 30; the best of `repeats` single solves, each to a
torch.cuda.synchronize() (the synced rate); the best of `repeats` runs of
`calls` back-to-back ba.run calls with one synchronize at the end (the
pipelined rate: value and the *_iter_per_s keys). Before the line, stderr
gets every repeat's rates, each route's kernel launches, and on the card
the device bound: iterations over the device time of one 30-iteration
lm_fused solve by CUDA events (utils.kernel_bench.cuda_ms), which value
cannot exceed unless its timed window ended early.

Unlike bench.py, which wraps each secondary key in try/except and prints
what failed, this bench lets every failure raise: a key that could not be
measured fails the run rather than drop out of the line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

METRIC = "ba_iterations_per_s_16cam_8192trk"
N_VIEWS = 16
N_POINTS = 8192
WIDTH = 2048.0
ITERATIONS = 30


class Timing(NamedTuple):
    """time_ba's result: bench.py's three numbers (the best pipelined rate,
    the iterations a solve, the best synced rate), then every repeat's
    rates, the number of ba.run calls and the kernels' launches over them
    (ba_kernels.launch_counts())."""

    iter_per_s: float
    iterations: int
    synced_iter_per_s: float
    pipelined: list
    synced: list
    calls: int
    launches: dict


def make_problem(device="cuda", num_views=N_VIEWS, n_points=N_POINTS):
    """bench.py's problem on `device` (CUDA unless the caller names another):
    (cams, points4 (T, 4), obs (T, V, 2), mask (T, V))."""
    from orthosfm_torch.testbench import problems

    return problems.make_problem("quat", device, num_views, n_points, WIDTH)


def euler_cameras(cams):
    """Euler cameras of the same rotations, as bench.py builds them: the
    (phi, theta, roll) of each camera's basis, its `fixed` flags carried."""
    from orthosfm_torch.core import cameras as cam_mod

    e = cam_mod.make_euler(np.arange(len(cams)), WIDTH, WIDTH,
                           angles=cam_mod.basis_to_phi_theta_roll(cam_mod.basis(cams)),
                           device=cams.device)
    return e.replace(fixed=cams.fixed)


def _on(device, cams, *tensors):
    """The cameras and tensors on `device`."""
    moved = {k: v.to(device) for k, v in vars(cams).items() if isinstance(v, torch.Tensor)}
    return (cams.replace(**moved), *(x.to(device) for x in tensors))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ba(device, cams, points, obs, mask, iters=ITERATIONS, repeats=3, impl="auto",
            calls=10) -> Timing:
    """Times `iters` LM iterations of ba.run on `device` by bench.py's method
    (module docstring): one warm-up solve, which must run `iters`
    iterations; `repeats` single solves each to a synchronize; `repeats`
    runs of `calls` back-to-back solves with one synchronize at the end."""
    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk

    device = torch.device(device)
    cfg = BundleAdjustConfig(max_iterations=iters, function_tolerance=0.0, min_lambda=1e-12,
                             impl=impl)
    args = _on(device, cams, points, obs, mask)

    def run():
        return ba.run(*args, optimize_points=True, config=cfg)

    before = bk.launch_counts()
    n_iters = int(run().iterations)  # the build (first call) and warm-up
    if n_iters != iters:
        raise RuntimeError(f"impl {impl!r} on {device}: the warm-up solve ran {n_iters} "
                           f"iterations, not {iters}")
    synced = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        run()
        _sync(device)
        synced.append(n_iters / (time.perf_counter() - t0))
    pipelined = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        for _ in range(calls):
            run()
        _sync(device)
        pipelined.append(n_iters * calls / (time.perf_counter() - t0))
    after = bk.launch_counts()
    return Timing(max(pipelined), n_iters, max(synced), pipelined, synced,
                  1 + repeats + repeats * calls, {k: after[k] - before[k] for k in after})


def sync_floor_ms(device, n=5) -> float:
    """The best of n round trips of a trivial op (x * 2 + 1 on an (8, 128)
    tensor), each to a synchronize: the runtime's completion floor."""
    device = torch.device(device)
    x = torch.ones((8, 128), device=device)
    x * 2.0 + 1.0
    _sync(device)
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        x * 2.0 + 1.0
        _sync(device)
        best = min(best, time.perf_counter() - t0)
    return best * 1e3


def device_bound(cams, points, obs, mask, iters=ITERATIONS, n=20) -> dict:
    """The most iterations/s "auto" can reach on the card: `iters` over the
    device time of one `iters`-iteration lm_fused solve (lm_solve on
    ba.run's LM buffers, restored before each solve; the restore, timed
    alone, is taken off), by CUDA events (utils.kernel_bench.cuda_ms).
    ba.run's pipelined calls do this work and more (their inputs' layout,
    the result's halves), so a pipelined rate above it means the timed
    window ended early."""
    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.core import cameras as cam_mod
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.kernel_bench import cuda_ms

    cfg = BundleAdjustConfig(max_iterations=iters, function_tolerance=0.0, min_lambda=1e-12)
    pT, obsT, maskT = ba.prepare(points, obs.to(torch.float32), mask)
    free = cam_mod.free_mask(cams).to(torch.float32).contiguous()
    start = bk.lm_buffers(pT, cams.rot.to(torch.float32), ba.pack_camp(cams))
    bufs = tuple(b.clone() for b in start)
    args = (cams.kind, bufs[0], obsT, maskT, bufs[1], bufs[2], free, float(cfg.huber_delta),
            True, bk.LMConfig.of(cfg), iters)

    def reset():
        for b, b0 in zip(bufs, start):
            b.copy_(b0)

    def solve():
        reset()
        return bk.lm_solve(*args)

    n_iters = int(solve()[bk.ITERS])
    if n_iters != iters:
        raise RuntimeError(f"lm_fused ran {n_iters} iterations, not {iters}")
    ms = cuda_ms(solve, n) - cuda_ms(reset, n)
    return {"iter_per_s": iters / (ms / 1e3), "solve_ms": ms, "iterations": iters}


def measure(device="cuda", num_views=N_VIEWS, n_points=N_POINTS, iters=ITERATIONS, repeats=3,
            calls=10):
    """The bench on `device` (CUDA unless the caller names another): (line,
    detail). line is the JSON line's dict; detail holds each key's Timing
    as a dict, the CPU baseline's, and on the card the device bound. The
    secondary routes run max(1, repeats - 1) repeats (bench.py's 2 of 3)."""
    from orthosfm_torch.pipeline.matching import checked_device
    from orthosfm_torch.testbench.bench_pipeline import card

    device = checked_device(device)
    cams, points, obs, mask = make_problem(device, num_views, n_points)
    problem = (cams, points, obs, mask)
    timings = {"value": time_ba(device, *problem, iters, repeats, calls=calls)}
    value = timings["value"].iter_per_s
    vs_baseline = 1.0
    if device.type != "cpu":
        timings["cpu_baseline"] = time_ba("cpu", *problem, iters, repeats=1, calls=2)
        vs_baseline = value / timings["cpu_baseline"].iter_per_s
    extras = {"synced_single_call_iter_per_s": round(timings["value"].synced_iter_per_s, 3),
              "sync_floor_ms": round(sync_floor_ms(device), 2)}
    secondary = max(1, repeats - 1)
    for key, impl, c in (("pallas_iter_per_s", "pallas", cams), ("xla_iter_per_s", "xla", cams),
                         ("euler_iter_per_s", "auto", euler_cameras(cams))):
        timings[key] = time_ba(device, c, points, obs, mask, iters, secondary, impl, calls)
        extras[key] = round(timings[key].iter_per_s, 3)
    line = {"metric": METRIC, "value": round(value, 3), "unit": "iter/s",
            "vs_baseline": round(vs_baseline, 3), **extras,
            "device": card() if device.type == "cuda" else "cpu"}
    detail = {key: t._asdict() for key, t in timings.items()}
    if device.type == "cuda":
        bound = device_bound(*problem, iters)
        detail["device_bound"] = {**bound, "value_within": value <= bound["iter_per_s"]}
    return line, detail


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="orthosfm-torch-bench",
                                description="BA iterations/s on the standard problem "
                                            "(the JAX system's bench.py)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default: cuda; pass cpu to run on the CPU)")
    args = p.parse_args(argv)
    if torch.device(args.device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    line, detail = measure(args.device)
    for key, d in detail.items():
        print(f"{key}: {json.dumps(d)}", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
