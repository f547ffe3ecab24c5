"""End-to-end pipeline throughput benchmark (frames/s). Port of
orthosfm_tpu/testbench/bench_pipeline.py.

Measures the whole reconstruct() driver (image loading → SIFT/SURF →
batched pairwise matching → tracks → incremental pose estimation → export)
on a rendered 16-view sphere dataset (seed 7, a 200° ring), reporting
per-phase seconds (time_measurements.txt, as the reference measures them,
src/sfm/reconstruct.cpp:163-168), the total, frames/s and the pose errors,
with the card's name and power limit. Each run is timed after one warm-up
run of the same data.

Usage:
    python -m orthosfm_torch.testbench.bench_pipeline [--views 16] [--width 512]
        [--compare-cpu] [--no-warmup]

It prints one JSON line and writes nothing else.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import tempfile
import time


def _run_once(images: str, gt, solver, device):
    import numpy as np
    import torch

    from orthosfm_torch.config import ReconstructionConfig
    from orthosfm_torch.io import timing
    from orthosfm_torch.pipeline.reconstruct import reconstruct
    from orthosfm_torch.testbench import metrics

    proj = tempfile.mkdtemp(prefix="osfm_bench_")
    try:
        cfg = ReconstructionConfig(project_folder=proj, image_folder=images, solver=solver)
        t0 = time.monotonic()
        res, views = reconstruct(cfg, verbose=False, device=device)
        if device.type == "cuda":
            torch.cuda.synchronize()
        total = time.monotonic() - t0
        m = timing.load_runtimes(os.path.join(proj, "time_measurements.txt"))
        ang, pos = metrics.pose_errors(res.cameras, gt)
        return {
            "initialization_s": m.init_time,
            "track_building_s": m.track_building_time,
            "pose_estimation_s": m.pose_estimation_time,
            "total_s": total,
            "frames_per_s": len(views) / total,
            "views_placed": int(res.present.sum()),
            "mean_angular_error_deg": float(np.mean(ang)),
            "mean_position_error": float(np.mean(pos)),
        }
    finally:
        shutil.rmtree(proj, ignore_errors=True)


def card() -> str:
    """The card's name and power limit as nvidia-smi reports them, or "" where
    nvidia-smi does not run."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def run_benchmark(num_views: int = 16, width: int = 512, seed: int = 7,
                  compare_cpu: bool = False, warmup: bool = True, device="cuda"):
    """Render once, run the pipeline (a warm-up run, then the timed run) on
    `device` (CUDA unless the caller names another) and return the metrics
    dict. With compare_cpu, the same port also runs on the host CPU, and the
    dict gains its total and the throughput ratio."""
    import torch

    from orthosfm_torch.config import SolverType
    from orthosfm_torch.pipeline.matching import checked_device
    from orthosfm_torch.testbench import render

    device = checked_device(device)
    images = tempfile.mkdtemp(prefix="osfm_bench_imgs_")
    try:
        gt = render.make_image_dataset(images, num_views=num_views, width=width, height=width,
                                       seed=seed, ring_degrees=200.0, device=device)
        solver = SolverType.ORTHO_QUATERNION
        if warmup:
            _run_once(images, gt, solver, device)
        out = _run_once(images, gt, solver, device)
        out.update(num_views=num_views, width=width, platform=device.type,
                   device=card() if device.type == "cuda" else "cpu")
        if compare_cpu and device.type != "cpu":
            cpu = torch.device("cpu")
            if warmup:
                _run_once(images, gt, solver, cpu)
            cpu_out = _run_once(images, gt, solver, cpu)
            out["cpu_total_s"] = cpu_out["total_s"]
            # the baseline is this port on the host CPU, not the reference's C++
            out["cpu_baseline"] = "same-code-on-torch-cpu"
            out["vs_cpu_throughput"] = cpu_out["total_s"] / out["total_s"]
        return out
    finally:
        shutil.rmtree(images, ignore_errors=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="orthosfm-torch-bench-pipeline")
    p.add_argument("--views", type=int, default=16)
    p.add_argument("--width", type=int, default=512)
    p.add_argument("--compare-cpu", action="store_true")
    p.add_argument("--no-warmup", action="store_true")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    out = run_benchmark(num_views=args.views, width=args.width, compare_cpu=args.compare_cpu,
                        warmup=not args.no_warmup, device=args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
