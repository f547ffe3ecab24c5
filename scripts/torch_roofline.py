#!/usr/bin/env python3
"""Speed-of-light accounting of the port's kernels on one H100: the
counterpart of scripts/roofline.py (the JAX package's TPU roofline) and of
scripts/ablate_ba_fused.py (the per-stage table of one LM iteration below,
beside the whole solve in one launch).

For each kernel it takes the FLOP and byte counts of orthosfm_torch/utils/
roofline.py (the count chip_smoke.py's kernels line reads) at this run's
inputs, its device time (CUDA events) on the standard inputs of
orthosfm_torch/utils/kernel_bench.py (chip_smoke.py's phase 2 times with
the same functions), and reports the
achieved TFLOP/s and GB/s against the card's f32 peak (67 TFLOP/s) and HBM
bandwidth (3.35 TB/s), and the share of the bound it reaches:
  - K1 schur_assemble, K3 camera_solve, K2 point_update_cost with its accept
    tail and K4 lm_accept's own launch, at 16 x 8192 (make_problem(), the
    standard BA problem), 64 x 4096 and 64 x 50000 (the many-view run's
    global BA), quaternion cameras, points optimized;
  - top2 on 8 pairs of random unit descriptors, 8192 x 128, both directions
    from one launch;
  - the Tomasi-Kanade kernels at TK_SHAPES (241 hypotheses of 3 views
    on 4096 and 50 000 blob tracks at 1 px, kernel_bench.tk_inputs): K5
    tk_factorize on the hypotheses and as the fallback over every valid
    track (with its Gram, one torch.matmul), and K6 tk_score (utils/
    roofline.py tk_factorize_work, a floor that counts the normal equations
    once, and tk_score_work);
  - lm_fused, the whole LM solve in one cooperative launch, at
    FUSED_SHAPES (16 x 8192, phase 9's local BA 3 x 50000, the one-CTA
    camera solve's edge 37 x 2048, and on its cluster 64 x 4096 and phase
    9's global BA 64 x 50000), 30 iterations that all work: its work is the initial cost and K1 + K3 + K2
    an iteration, its bytes the inputs read once and the outputs written
    once (utils/roofline.py lm_solve_work), beside the sum of the three
    stages' own bounds over the iterations.
The per-stage table of one LM iteration at each BA shape puts K1 + K3 + K2's
device time beside the host's enqueue time an iteration and ba.run's wall
time an iteration (30 iterations, function_tolerance 0): whichever is larger
sets BA's pace; and, where it serves, lm_fused's device time an iteration.
Last, lm_fused's split at SPLIT_SHAPES (kernel_bench.lm_fused_split, its
timing build: %globaltimer stamps at every stage boundary, 30 iterations
that all work): each stage's ms an iteration, each barrier's own wait,
beside the per-iteration kernels' K1 + K3 + K2 at the same shape, and
lm_fused's registers, stack and spill from the build's -Xptxas -v log.

    python3 scripts/torch_roofline.py [--json OUT] [--split VxT ...]

--split runs only the last table, lm_fused's split, at the shapes given
(for example 128x1024 192x4096 375x2000, where its camera solve is K3's
grid route inside the launch), beside K1 + K3 + K2 timed at each; --tk only
the Tomasi-Kanade rows.

Needs a CUDA device; prints the card's name and power limit first.
"""

import argparse
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

BA_SHAPES = ((16, 8192), (64, 4096), (64, 50000))
FUSED_SHAPES = ((16, 8192), (3, 50000), (37, 2048), (64, 4096), (64, 50000))
SPLIT_SHAPES = ((16, 8192), (3, 50000), (37, 2048), (64, 4096))
LM_ITERATIONS = 30
TK_SHAPES = (4096, 50000)


def row(name, flops, nbytes, ms):
    from orthosfm_torch.utils.roofline import F32_FLOPS, HBM_BYTES, bound

    b_ms, b_by = bound(flops, nbytes)
    return {"kernel": name, "flops": flops, "bytes": nbytes, "ms": ms,
            "tflops": flops / ms / 1e9, "gb_per_s": nbytes / ms / 1e6,
            "pct_f32_peak": 100.0 * flops / ms / 1e-3 / F32_FLOPS,
            "pct_hbm": 100.0 * nbytes / ms / 1e-3 / HBM_BYTES,
            "bound_ms": b_ms, "bound_by": b_by, "pct_of_bound": 100.0 * b_ms / ms}


def print_row(r, label):
    print(f"{r['kernel']:18s} {label:9s} {r['flops'] / 1e9:9.4f} {r['bytes'] / 1e6:9.3f} "
          f"{r['ms']:9.4f} {r['tflops']:8.3f} {r['gb_per_s']:8.1f} {r['pct_f32_peak']:6.2f} "
          f"{r['pct_hbm']:6.2f} {r['bound_ms']:9.5f} {r['bound_by']:10s} {r['pct_of_bound']:7.2f}")


def tk_rows(device):
    """K5 (the hypotheses, and the fallback with its Gram) and K6 at
    TK_SHAPES."""
    import torch

    from orthosfm_torch.config import RansacConfig
    from orthosfm_torch.solvers import tk_kernels as tkk
    from orthosfm_torch.utils.kernel_bench import cuda_ms, tk_inputs
    from orthosfm_torch.utils.roofline import tk_factorize_work, tk_score_work

    cfg = RansacConfig()
    out = {}
    for n_tracks in TK_SHAPES:
        obs, valid, samp, q0, q0f = tk_inputs(device, n_tracks)
        H, S = samp.shape
        label = f"{H}x{n_tracks}"
        o, fb = obs[samp], (obs[None], valid[None], q0f[None])
        sol1, _, usable, _ = tkk.tk_factorize(o, None, q0, cfg)
        w = torch.full((3,), 2048.0, device=device)
        rows = [row("tk_factorize", *tk_factorize_work(H, S, 3),
                    cuda_ms(lambda: tkk.tk_factorize(o, None, q0, cfg))),
                row("tk_factorize_fb", *tk_factorize_work(1, n_tracks, 3, gram_given=True),
                    cuda_ms(lambda: tkk.tk_factorize(*fb, cfg))),
                row("tk_score", *tk_score_work(H, n_tracks, int(valid.sum()), 3, S),
                    cuda_ms(lambda: tkk.tk_score(sol1, usable, obs, valid, w, w, samp, cfg)))]
        for r in rows:
            print_row(r, label)
        out[label] = rows
    return out


def lm_iteration(device, num_views, n_tracks):
    """ba.run on the kernels, LM_ITERATIONS iterations that all do work:
    (wall ms an iteration, host enqueue ms an iteration)."""
    import torch

    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.solvers import ba
    from orthosfm_torch.testbench.problems import make_problem
    from orthosfm_torch.utils import profiling

    args = make_problem("quat", device, num_views, n_tracks, 2048.0)
    cfg = BundleAdjustConfig(max_iterations=LM_ITERATIONS, function_tolerance=0.0,
                             min_lambda=1e-12, impl="kernel")
    ba.run(*args, True, cfg)
    torch.cuda.synchronize()
    recorder = profiling.BARecorder()
    t0 = time.perf_counter()
    with recorder.recording():
        res = ba.run(*args, True, cfg)
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / LM_ITERATIONS
    if int(res.iterations) != LM_ITERATIONS:
        raise AssertionError(f"{num_views}x{n_tracks}: {int(res.iterations)} iterations")
    return wall, recorder.summary()["enqueue_ms_per_it"]


def lm_fused_split_table(device, ba_rows, cfg, shapes=SPLIT_SHAPES):
    """lm_fused's split (kernel_bench.lm_fused_split) at `shapes` beside
    the per-iteration kernels' K1 + K3 + K2 device time there (ba_rows'
    where this run timed that shape), and its registers and spill in both
    builds (both instantiations: below the grid route and with it)."""
    from concurrent.futures import ThreadPoolExecutor

    from orthosfm_torch import kernel_build
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.utils.kernel_bench import lm_fused_split, stage_inputs, time_ba_kernels

    with ThreadPoolExecutor(2) as pool:
        logs = list(pool.map(lambda d: kernel_build.build(bk.SOURCE, d)[1],
                             ((), bk.TIMING_DEFINES)))
    out = {"ptxas": {name: {fn: kernel_build.ptxas_usage(log, entry) for fn, entry in (
                                ("lm_fused_kernel", "lm_fused_kernelILb0"),
                                ("lm_fused_kernel<grid route>", "lm_fused_kernelILb1"))}
                     for name, log in zip(("main", "timing"), logs)}, "shapes": {}}
    print(f"lm_fused ptxas: {out['ptxas']}")
    print("lm_fused split (ms an iteration that worked): blocks, product, reduce, solve, k2, "
          "accept | barrier waits | iteration | per-iteration K1 + K3 + K2")
    for num_views, n_tracks in shapes:
        label = f"{num_views}x{n_tracks}"
        if not bk.fused_fits(num_views, n_tracks, device):
            out["shapes"][label] = None
            print(f"  {label:9s} lm_fused does not serve it")
            continue
        rows = ba_rows.get(label)
        if rows is None:
            times = time_ba_kernels(stage_inputs("quat", device, num_views, n_tracks))
            per_it = {k: times[k]["ms"] for k in ("schur_assemble", "camera_solve",
                                                   "point_update_cost")}
        else:
            per_it = {r["kernel"]: r["ms"] for r in rows if r["kernel"] != "lm_accept"}
        t = lm_fused_split("quat", device, num_views, n_tracks, cfg)
        t["per_iteration_kernels_ms"] = per_it
        t["per_iteration_sum_ms"] = sum(per_it.values())
        t["grid_ctas"] = bk._fused_grid(num_views)
        out["shapes"][label] = t

        def f(x):
            return "-" if x is None else f"{x:.4f}"

        print(f"  {label:9s} " + " ".join(f(x) for x in t["stage_ms"].values()) + " | "
              + " ".join(f(x) for x in t["barrier_wait_ms"].values())
              + f" | {f(t['iteration_ms'])} | {t['per_iteration_sum_ms']:.4f} "
              f"({t['iterations']} iterations on {t['grid_ctas']} CTAs at most; "
              f"{t['barriers_per_iteration']:.2f} barriers an "
              f"iteration; timer step {t['timer_step_ns']} ns; a solve {t['timing_build_ms']:.4f} "
              f"ms stamped, {t['main_build_ms']:.4f} ms main build)")
    return out


def main() -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--json", default="")
    p.add_argument("--split", nargs="+", default=None, help="VxT shapes: only lm_fused's split")
    p.add_argument("--tk", action="store_true", help="only the Tomasi-Kanade kernels' rows")
    args = p.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("torch_roofline: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(smi)
    from orthosfm_torch.config import BundleAdjustConfig
    from orthosfm_torch.ops import matching_kernels as mk
    from orthosfm_torch.utils.kernel_bench import (cuda_ms, random_top2_set, stage_inputs,
                                                   time_ba_kernels, time_lm_solve)
    from orthosfm_torch.utils.roofline import (F32_FLOPS, HBM_BYTES, ba_work, lm_solve_work,
                                               top2_work)

    device = torch.device("cuda:0")
    out = {"card": smi, "peaks": {"f32_flops": F32_FLOPS, "hbm_bytes_per_s": HBM_BYTES},
           "ba": {}, "lm_iteration": {}}
    cfg = BundleAdjustConfig(max_iterations=LM_ITERATIONS, function_tolerance=0.0,
                             min_lambda=1e-12)
    if args.split:
        shapes = [tuple(map(int, shape.split("x"))) for shape in args.split]
        out["lm_fused_split"] = lm_fused_split_table(device, {}, cfg, shapes)
        return finish(out, args.json)
    head = (f"{'kernel':18s} {'shape':9s} {'GFLOP':>9s} {'MB':>9s} {'ms':>9s} {'TFLOP/s':>8s} "
            f"{'GB/s':>8s} {'%f32':>6s} {'%HBM':>6s} {'bound ms':>9s} {'by':10s} {'%bound':>7s}")
    print(head)
    out["tk"] = tk_rows(device)
    if args.tk:
        return finish(out, args.json)
    for num_views, n_tracks in BA_SHAPES:
        label = f"{num_views}x{n_tracks}"
        inputs = stage_inputs("quat", device, num_views, n_tracks)
        times = time_ba_kernels(inputs)
        work = ba_work(inputs[2], True)
        rows = [row(name, *work[name], times[name]["ms"])
                for name in ("schur_assemble", "camera_solve", "point_update_cost", "lm_accept")]
        out["ba"][label] = rows
        for r in rows:
            print(f"{r['kernel']:18s} {label:9s} {r['flops'] / 1e9:9.4f} {r['bytes'] / 1e6:9.3f} "
                  f"{r['ms']:9.4f} {r['tflops']:8.3f} {r['gb_per_s']:8.1f} "
                  f"{r['pct_f32_peak']:6.2f} {r['pct_hbm']:6.2f} {r['bound_ms']:9.5f} "
                  f"{r['bound_by']:10s} {r['pct_of_bound']:7.2f}")
        wall, enqueue = lm_iteration(device, num_views, n_tracks)
        device_ms = sum(times[k]["ms"] for k in ("schur_assemble", "camera_solve",
                                                 "point_update_cost"))
        out["lm_iteration"][label] = {
            "schur_assemble_ms": times["schur_assemble"]["ms"],
            "camera_solve_ms": times["camera_solve"]["ms"],
            "point_update_cost_with_tail_ms": times["point_update_cost"]["ms"],
            "device_ms": device_ms, "host_enqueue_ms": enqueue, "ba_run_ms": wall,
            "paced_by": "host" if enqueue > device_ms else "device"}
    stack, cols = random_top2_set(device, 128)
    t_ms = cuda_ms(lambda: mk.top2(stack, *cols, impl="kernel"), 20)
    out["top2"] = row("top2", *top2_work(stack, cols[2], cols[3]), t_ms)
    r = out["top2"]
    print(f"{'top2':18s} {'8x8192':9s} {r['flops'] / 1e9:9.4f} {r['bytes'] / 1e6:9.3f} "
          f"{r['ms']:9.4f} {r['tflops']:8.3f} {r['gb_per_s']:8.1f} {r['pct_f32_peak']:6.2f} "
          f"{r['pct_hbm']:6.2f} {r['bound_ms']:9.5f} {r['bound_by']:10s} "
          f"{r['pct_of_bound']:7.2f}")
    print("one LM iteration (ms): K1, K3, K2 + tail, their sum on the device, the host's "
          "enqueue, ba.run's wall")
    for label, t in out["lm_iteration"].items():
        print(f"  {label:9s} {t['schur_assemble_ms']:.4f} {t['camera_solve_ms']:.4f} "
              f"{t['point_update_cost_with_tail_ms']:.4f} = {t['device_ms']:.4f} device; "
              f"enqueue {t['host_enqueue_ms']:.4f}; ba.run {t['ba_run_ms']:.4f} "
              f"({t['paced_by']}-paced)")
    out["lm_fused"] = {}
    for num_views, n_tracks in FUSED_SHAPES:
        label = f"{num_views}x{n_tracks}"
        t = time_lm_solve("quat", device, num_views, n_tracks, cfg)
        flops, nbytes, stages_ms = lm_solve_work(stage_inputs("quat", device, num_views,
                                                              n_tracks)[2], True, t["iterations"])
        r = out["lm_fused"][label] = {**row("lm_fused", flops, nbytes, t["ms"]), **t}
        if label in out["lm_iteration"]:
            out["lm_iteration"][label]["lm_fused_ms_per_it"] = t["ms_per_iteration"]
        print(f"{'lm_fused':18s} {label:9s} {r['flops'] / 1e9:9.4f} {r['bytes'] / 1e6:9.3f} "
              f"{r['ms']:9.4f} {r['tflops']:8.3f} {r['gb_per_s']:8.1f} {r['pct_f32_peak']:6.2f} "
              f"{r['pct_hbm']:6.2f} {r['bound_ms']:9.5f} {r['bound_by']:10s} "
              f"{r['pct_of_bound']:7.2f}  ({t['iterations']} iterations; the stages' bounds "
              f"{stages_ms:.5f} ms; per-iteration kernels {t['per_iteration_ms']:.4f} ms)")
    for label, t in out["lm_iteration"].items():
        if "lm_fused_ms_per_it" in t:
            print(f"  {label:9s} lm_fused {t['lm_fused_ms_per_it']:.4f} ms an iteration, one "
                  f"launch a solve")
    out["lm_fused_split"] = lm_fused_split_table(device, out["ba"], cfg)
    return finish(out, args.json)


def finish(out, path) -> int:
    print(json.dumps(out))
    if path:
        with open(path, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
