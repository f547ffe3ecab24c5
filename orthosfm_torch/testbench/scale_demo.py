"""Many-view scale run: the whole incremental reconstruction at 64 views ×
50 000 tracks. Port of scripts/scale_demo.py.

The reference's group builder enumerates all (groupSize-1)-combinations of
used cameras per group (src/data_structures/group.cpp:13-88) and its Ceres
BA is CPU-bound; published runs stop at ~16 views. This run drives the
complete incremental loop (grouping, RANSAC'd TK inits, local BAs,
align/merge, periodic and final global BAs over all cameras, outlier
filters) on an asymmetric blob of `tracks` points seen by `views` cameras
with `noise_px` of Gaussian pixel noise, through the normal entry points:
synthetic.blob_cloud → generate_dataset → add_observation_noise (a numpy
Generator seeded `seed`) → incremental.run_pose_estimation (quaternion
solver) → metrics.pose_errors.

On the card it first builds the BA kernels, then times `runs`
reconstructions (the first cold, the rest warm), each to a
torch.cuda.synchronize(), with the launches of the BA kernels (lm_fused,
one a BA of up to ba_kernels.FUSED_MAX_VIEWS (375) views, so every BA at 64
and at 192 views, by the route of its camera solve; K1, K3 by route and K2
an iteration of the larger ones), of the outlier filter's
neighbour-search kernel (outlier_nn, once a filter call) and the bundle adjustments
it ran, by route (utils.profiling.BARecorder); then it
measures Tomasi-Kanade's peak device memory on the first group, and runs
once more under utils.profiling.collect_stages for the share of the wall time in each
stage of the pose estimation (each stage ends in a device barrier there),
with the Tomasi-Kanade kernels that ran (K5 tk_factorize twice and K6
tk_score once a group), read from the profiler's kernel records
(utils.profiling.kernel_runs), since the card replays them from CUDA graphs.

    python -m orthosfm_torch.testbench.scale_demo [--views 64] [--tracks 50000]
        [--seed 0] [--noise-px 1.0] [--runs 2] [--json OUT] [--platform cpu|gpu|cuda]

It prints one JSON line: the JAX script's keys (views, tracks, noise_px,
wall_s, views_placed, mean/max angular error, mean position error,
platform) with platform "cuda" or "cpu" and the card's name and power limit
beside it, and the counts and times above.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

#: the JAX package's run of this size on its TPU (docs/scale_demo.json):
#: the accuracy to stand beside this run's, not a time to match
JAX_ACCURACY_DEG = {"mean_angular_error_deg": 0.007, "max_angular_error_deg": 0.013}
WIDTH = 2048.0


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def tk_peak_bytes(tracks, config, device) -> dict:
    """One Tomasi-Kanade initialization of the first three views (every track
    full-size): on the card, the bytes allocated at its peak above what was
    allocated before it (None on the CPU); the hypotheses, tracks and inliers
    it ran on."""
    from orthosfm_torch.data import tracks as tracks_mod
    from orthosfm_torch.solvers import tomasi_kanade as tk

    cols = np.arange(3)
    obs = tracks.obs[:, :3].contiguous()
    valid = tracks_mod.full_size_mask(tracks, cols)
    gen = torch.Generator(device=device).manual_seed(config.seed)
    cuda = device.type == "cuda"
    _sync(device)
    if cuda:
        base = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    res = tk.robust_factorization(obs, valid, WIDTH, WIDTH, config.ransac, generator=gen)
    _sync(device)
    return {"tk_peak_bytes": torch.cuda.max_memory_allocated(device) - base if cuda else None,
            "hypotheses": config.ransac.max_iterations, "tracks": int(valid.sum()),
            "num_inliers": int(res.num_inliers)}


def run_scale_demo(views: int = 64, tracks: int = 50000, seed: int = 0, noise_px: float = 1.0,
                   runs: int = 2, device="cuda") -> dict:
    """The many-view reconstruction on `device` (CUDA unless the caller
    names another); returns the JSON object main() prints. `wall_s` is the
    last (warm) run's; `wall_s_runs` has every run's, the first cold."""
    from orthosfm_torch.config import ReconstructionConfig, SolverType
    from orthosfm_torch.data import synthetic
    from orthosfm_torch.ops import outlier_kernels
    from orthosfm_torch.pipeline import incremental
    from orthosfm_torch.pipeline.matching import checked_device
    from orthosfm_torch.solvers import ba_kernels as bk
    from orthosfm_torch.solvers import tk_kernels as tkk
    from orthosfm_torch.testbench import bench_pipeline, metrics
    from orthosfm_torch.utils import profiling

    device = checked_device(device)
    cuda = device.type == "cuda"
    out = {"views": views, "tracks": tracks, "noise_px": noise_px}
    t0 = time.perf_counter()
    if cuda:
        bk.library()  # built at first use: outside the timed runs
        tkk.library()
        outlier_kernels.library()
    build_s = time.perf_counter() - t0

    # Asymmetric blob: mirror disambiguation needs asymmetric geometry
    cloud = synthetic.blob_cloud(tracks, seed=seed)
    ds = synthetic.generate_dataset(cloud, num_views=views, seed=seed, device=device)
    noisy = synthetic.add_observation_noise(ds.tracks, noise_px, np.random.default_rng(seed))
    cfg = ReconstructionConfig(solver=SolverType.ORTHO_QUATERNION, seed=seed)

    walls, peaks = [], []
    for _ in range(runs):
        recorder = profiling.BARecorder()
        bk.reset_launch_counts()
        outlier_start = outlier_kernels.outlier_nn.launches
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        _sync(device)
        t0 = time.perf_counter()
        with recorder.recording():
            res = incremental.run_pose_estimation(noisy, WIDTH, WIDTH, cfg, verbose=False)
        _sync(device)
        walls.append(time.perf_counter() - t0)
        launches, routes = bk.launch_counts(), bk.route_launches()
        fused_routes = bk.fused_route_launches()
        outlier_nn_launches = outlier_kernels.outlier_nn.launches - outlier_start
        peaks.append(torch.cuda.max_memory_allocated(device) if cuda else None)

    tk_mem = tk_peak_bytes(noisy, cfg, device)
    stages: dict = {}
    with (profiling.kernel_runs(tkk.KERNEL_NAMES) if cuda
          else contextlib.nullcontext(dict.fromkeys(tkk.KERNEL_NAMES, 0))) as tk_launches:
        _sync(device)
        t0 = time.perf_counter()
        with profiling.collect_stages(stages, device, trace=False):
            incremental.run_pose_estimation(noisy, WIDTH, WIDTH, cfg, verbose=False)
        _sync(device)
        staged_s = time.perf_counter() - t0

    ang, pos = metrics.pose_errors(res.cameras, ds.gt_cameras)
    ba_calls = recorder.summary()
    ba_calls["global_ba_calls"] = ba_calls["by_views"].get(views, {}).get("ba_calls", 0)
    out.update({
        "wall_s": walls[-1],
        "views_placed": int(np.sum(res.present)),
        "mean_angular_error_deg": float(np.mean(ang)),
        "max_angular_error_deg": float(np.max(ang)),
        "mean_position_error": float(np.mean(pos)),
        "platform": device.type,
        "device": bench_pipeline.card() if cuda else "cpu",
        "jax_package": JAX_ACCURACY_DEG,
        "wall_s_runs": walls,
        "build_s": build_s,
        "launches": {k: launches[k] for k in ("lm_solve", "schur_assemble", "camera_solve",
                                              "point_update_cost")},
        "camera_solve_routes": routes,
        "lm_fused_routes": fused_routes,
        "tk_launches": tk_launches,
        "outlier_nn_launches": outlier_nn_launches,
        "ba": ba_calls,
        "peak_bytes": peaks[-1],
        "tk": tk_mem,
        "staged_wall_s": staged_s,
        "stages_s": stages,
        "stage_shares": {k: v / staged_s for k, v in stages.items()},
    })
    return out


def main(argv=None) -> int:
    from orthosfm_torch.app import PLATFORMS

    p = argparse.ArgumentParser(prog="orthosfm-torch-scale-demo")
    p.add_argument("--views", type=int, default=64)
    p.add_argument("--tracks", type=int, default=50000)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-px", type=float, default=1.0)
    p.add_argument("--runs", type=int, default=2, help="timed runs, the first cold")
    p.add_argument("--json", default="", help="also write the JSON object to this file")
    p.add_argument("--platform", default="cuda", choices=sorted(PLATFORMS),
                   help="cpu runs on the CPU, gpu or cuda (the default) on the card")
    args = p.parse_args(argv)
    out = run_scale_demo(args.views, args.tracks, args.seed, args.noise_px, args.runs,
                         PLATFORMS[args.platform])
    print(json.dumps(out))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=1)
            f.write("\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
