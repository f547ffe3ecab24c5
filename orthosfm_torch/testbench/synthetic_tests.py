"""Synthetic robustness testbench: pose accuracy against observation noise.
Port of orthosfm_tpu/testbench/synthetic_tests.py.

Reproduces src/testbench/synthethic_tests.cpp:14-265: 16-view datasets built
from the reference's Cube/Sphere/Suzanne PLY vertex clouds (through
data.synthetic.reference_cloud; procedural stand-ins when the resources are
not there), a sweep of Gaussian observation noise σ ∈ [0, max] on the
tracks, both algorithm families run in process through run_pose_estimation
on the device, and per-(algorithm, noise) mean/std of the per-camera
quaternion angular distance to ground truth with mirror-flip handling
(synthethic_tests.cpp:138-196).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

from orthosfm_torch.config import ReconstructionConfig, SolverType
from orthosfm_torch.data import synthetic
from orthosfm_torch.pipeline import incremental
from orthosfm_torch.pipeline.matching import checked_device
from orthosfm_torch.testbench import metrics

CSV_HEADER = ("dataset,solver,noise_px,mean_angular_error_deg,std_angular_error_deg,"
              "mean_position_error,failed\n")


@dataclasses.dataclass
class SweepEntry:
    dataset: str
    solver: str
    noise_px: float
    mean_angular_error_deg: float
    std_angular_error_deg: float
    mean_position_error: float
    failed: bool = False


def _csv_row(r: SweepEntry) -> str:
    return (f"{r.dataset},{r.solver},{r.noise_px},{r.mean_angular_error_deg},"
            f"{r.std_angular_error_deg},{r.mean_position_error},{int(r.failed)}\n")


def run_noise_sweep(
    datasets: Sequence[str] = ("Cube", "Sphere", "Suzanne"),
    solvers: Sequence[SolverType] = (SolverType.ORTHO_QUATERNION,
                                     SolverType.ORTHO_EULER_ALL_DOF),
    noise_levels: Sequence[float] = tuple(np.linspace(0.0, 100.0, 101)),
    num_views: int = 16,
    seed: int = 0,
    max_tracks: int = 2048,
    verbose: bool = True,
    csv_path: str = "",
    device="cuda",
) -> List[SweepEntry]:
    """The reference sweeps 101 noise samples from 0 to 100 px
    (synthethic_tests.cpp:41-48); smaller grids serve quick checks. Runs on
    `device` (CUDA unless the caller names another). The noise of level ni
    is drawn from np.random.default_rng(seed * 7919 + ni). A run that raises
    is recorded as failed and the sweep goes on.

    ``csv_path``: write each entry as soon as it is computed (a multi-hour
    sweep must survive a crash near the end)."""
    device = checked_device(device)
    results: List[SweepEntry] = []
    csv_f = open(csv_path, "w") if csv_path else None
    if csv_f is not None:
        csv_f.write(CSV_HEADER)
        csv_f.flush()
    for ds_name in datasets:
        ds = synthetic.generate_dataset(ds_name, num_views=num_views, seed=seed, device=device)
        tracks = ds.tracks
        if int(tracks.alive.sum()) > max_tracks:
            # subsample for runtime parity with the reference's point clouds
            rng = np.random.default_rng(seed)
            alive = tracks.alive.cpu().numpy()
            keep = rng.choice(np.flatnonzero(alive), size=max_tracks, replace=False)
            new_alive = np.zeros_like(alive)
            new_alive[keep] = True
            tracks = tracks.replace(alive=torch.as_tensor(new_alive, device=device))
        wh = np.full(num_views, 2048.0, np.float32)
        for solver in solvers:
            config = ReconstructionConfig(solver=solver, seed=seed)
            for ni, sigma in enumerate(noise_levels):
                noisy = synthetic.add_observation_noise(
                    tracks, float(sigma), np.random.default_rng(seed * 7919 + ni))
                try:
                    res = incremental.run_pose_estimation(noisy, wh, wh, config, verbose=False)
                    ang, pos = metrics.pose_errors(res.cameras, ds.gt_cameras)
                    m, s = metrics.mean_and_std(ang)
                    entry = SweepEntry(ds_name, solver.name, float(sigma), m, s,
                                       float(np.mean(pos)))
                except Exception as e:  # noqa: BLE001 — the testbench's swallow-and-
                    # continue behavior (full_pipeline_tests.cpp:535)
                    if verbose:
                        print(f"  {ds_name}/{solver.name}/σ={sigma:.1f} failed: {e}")
                    entry = SweepEntry(ds_name, solver.name, float(sigma), float("nan"),
                                       float("nan"), float("nan"), failed=True)
                results.append(entry)
                if csv_f is not None:
                    csv_f.write(_csv_row(entry))
                    csv_f.flush()
                if verbose:
                    print(f"{ds_name} {solver.name} σ={sigma:6.2f}px → angular "
                          f"{entry.mean_angular_error_deg:.3f} ± "
                          f"{entry.std_angular_error_deg:.3f} deg")
    if csv_f is not None:
        csv_f.close()
    return results


def save_results(results: List[SweepEntry], path: str) -> None:
    with open(path, "w") as f:
        f.write(CSV_HEADER)
        for r in results:
            f.write(_csv_row(r))


def save_plot(results: List[SweepEntry], path: str) -> None:
    """Noise-robustness curves (the reference plots via matplotlibcpp,
    synthethic_tests.cpp:239-264). No-op if matplotlib is unavailable."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except Exception:  # pragma: no cover
        return
    series: Dict[str, List[SweepEntry]] = {}
    for r in results:
        series.setdefault(f"{r.dataset}/{r.solver}", []).append(r)
    fig, ax = plt.subplots(figsize=(8, 5))
    for label, entries in series.items():
        entries = sorted(entries, key=lambda r: r.noise_px)
        ax.plot([r.noise_px for r in entries],
                [r.mean_angular_error_deg for r in entries], label=label)
    ax.set_xlabel("observation noise σ [px]")
    ax.set_ylabel("mean angular error [deg]")
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
