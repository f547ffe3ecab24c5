"""Testbench CLI, the mirror of the reference's orthosfm-testbench
(src/testbench/testbench.cpp:15-77). Port of orthosfm_tpu/testbench/run.py.

Usage:
    python -m orthosfm_torch.testbench.run PROJECT_FOLDER DATASET_FOLDER [--synthetic]
        [--generate] [--solvers all|0,3] [--repetitions N] [--width W]
        [--subprocess] [--platform cpu|gpu|cuda]

--synthetic runs the in-process noise-robustness sweep (no images needed);
otherwise the full-pipeline evaluation runs the CLI app per dataset, config
and repetition, in this process unless --subprocess is given. With
--generate the datasets of dataset_matrix (images, masks and
references.txt) are rendered into DATASET_FOLDER first. Everything runs on
the card unless --platform cpu or the environment variable ORTHOSFM_TB_CPU
names the CPU.
"""

from __future__ import annotations

import argparse
import os
import sys

SOLVER_NAMES = {0: "Quaternion", 1: "EulerHorizontal", 2: "EulerHorizontalVertical",
                3: "EulerAllDoF"}


def main(argv=None) -> int:
    from orthosfm_torch.app import PLATFORMS

    p = argparse.ArgumentParser(prog="orthosfm-torch-testbench")
    p.add_argument("project_folder")
    p.add_argument("dataset_folder")
    p.add_argument("--synthetic", action="store_true",
                   help="run synthetic robustness tests instead of full pipeline")
    p.add_argument("--generate", action="store_true",
                   help="render hermetic test datasets into the dataset folder")
    p.add_argument("--noise-samples", type=int, default=101)
    p.add_argument("--max-noise", type=float, default=100.0)
    p.add_argument("--repetitions", type=int, default=5)
    p.add_argument("--num-views", type=int, default=8)
    p.add_argument("--width", type=int, default=320, help="generated dataset image size")
    p.add_argument("--solvers", default="0",
                   help="comma-separated solver indices or 'all' (the reference runs the "
                        "full matrix, full_pipeline_tests.cpp:414-477)")
    p.add_argument("--subprocess", action="store_true",
                   help="isolate every run in a fresh process like the reference's system() "
                        "harness; default is in process")
    p.add_argument("--platform", default="", choices=["", *PLATFORMS],
                   help="cpu runs on the CPU, gpu or cuda (the default) on the card")
    args = p.parse_args(argv)

    from orthosfm_torch.pipeline.matching import checked_device

    # ORTHOSFM_TB_CPU, the JAX package's switch of the app runs to the CPU,
    # names the CPU for the whole testbench here
    cpu = args.platform == "cpu" or bool(os.environ.get("ORTHOSFM_TB_CPU"))
    device = checked_device("cpu" if cpu else "cuda")
    os.makedirs(args.project_folder, exist_ok=True)

    if args.synthetic:
        import numpy as np

        from orthosfm_torch.testbench import synthetic_tests

        out_csv = os.path.join(args.project_folder, "synthetic_results.csv")
        results = synthetic_tests.run_noise_sweep(
            noise_levels=np.linspace(0.0, args.max_noise, args.noise_samples),
            csv_path=out_csv, device=device)
        synthetic_tests.save_plot(results,
                                  os.path.join(args.project_folder, "synthetic_results.png"))
        print(f"Wrote {out_csv}")
        return 0

    from orthosfm_torch.testbench import full_pipeline

    dataset_names = []
    supported = {}
    masked = {}
    if args.generate:
        from orthosfm_torch.testbench import render

        for row in dataset_matrix(args.width):
            name, scene, ring, min_views, width, theta, roll, solvers = row[:8]
            trajectory = row[8] if len(row) > 8 else "circle"
            with_masks = row[9] if len(row) > 9 else False
            # A closed ring needs enough views that neighbours still match
            # (≤ ~30° apart); an arc can use the requested count directly.
            n_views = max(args.num_views, min_views)
            ds_dir = os.path.join(args.dataset_folder, name)
            # a fixed seed per name (str.hash is salted per process)
            seed = sum(name.encode()) % 1000
            mask_dir = os.path.join(ds_dir, "masks") if with_masks else ""
            gt = render.make_image_dataset(
                os.path.join(ds_dir, "images"), num_views=n_views, width=width, height=width,
                seed=seed, ring_degrees=ring, theta_range=theta, roll_range=roll, scene=scene,
                trajectory=trajectory, mask_folder=mask_dir, device=device)
            names = [f"view_{i:02d}.png" for i in range(n_views)]
            full_pipeline.write_references(os.path.join(ds_dir, "references.txt"), gt, names)
            dataset_names.append(name)
            supported[name] = solvers
            if with_masks:
                masked[name] = mask_dir
    else:
        dataset_names = [d for d in sorted(os.listdir(args.dataset_folder))
                         if os.path.isdir(os.path.join(args.dataset_folder, d))]

    solver_ids = (list(SOLVER_NAMES) if args.solvers == "all"
                  else [int(s) for s in args.solvers.split(",")])
    extra = ("--device", "cpu") if cpu else ()
    results = []
    for ds_name in dataset_names:
        ids = [s for s in solver_ids if s in supported.get(ds_name, tuple(SOLVER_NAMES))]
        ds_extra = (extra + (f"--mask-folder={masked[ds_name]}",)
                    if ds_name in masked else extra)
        configs = [full_pipeline.RunConfiguration(name=SOLVER_NAMES[s], solver=s,
                                                  extra_args=ds_extra) for s in ids]
        if configs:
            results += full_pipeline.run_full_pipeline_tests(
                args.project_folder, args.dataset_folder, [ds_name], configs,
                repetitions=args.repetitions, in_process=not args.subprocess)
    out_csv = os.path.join(args.project_folder, "results.csv")
    full_pipeline.save_results_csv(results, out_csv)
    print(f"Wrote {out_csv}")
    return 0


def dataset_matrix(base_width: int):
    """Scene × trajectory matrix, the hermetic analog of the reference's
    Suzanne/Rings/Dragon × Circle/3Lat/3Lat_rotated sets, with per-dataset
    supported solver sets (full_pipeline_tests.cpp:404-412, :428-439: a
    dof-restricted Euler solver cannot represent camera motion outside its
    dof span, so it gets a trajectory it can represent).

    Rows: (name, scene, ring_degrees, min_views, width, theta_range,
    roll_range, supported solver indices[, trajectory[, with_masks]]).
    Thin ring structures need ≤ ~10° spacing and more pixels to keep
    neighbouring views matchable; the Blob needs a denser ring and more
    pixels to keep the first group above the 10-full-size-track floor.

    The Suzanne rows mirror the reference's object × {Circle, 3Lat,
    3Lat_rotated} shape with its per-trajectory solver support: the flat
    ring is representable by every solver, 3Lat needs a vertical dof,
    3Lat_rotated needs roll. They are frontal 100° arcs, not full rings: the
    point-sphere Suzanne surface is thin and almost featureless in profile
    and back views. SuzanneMasked drives the --mask-folder flow end to end
    (reference mask filtering: src/matching/matching.cpp:325-368)."""
    w = base_width
    return (
        ("SphereCircle", "sphere", 360.0, 12, w, 10.0, 6.0, (0, 3)),
        ("BlobCircle", "blob", 360.0, 16, max(w, 384), 10.0, 6.0, (0, 3)),
        ("CubeArc", "ornament_cube", 140.0, 0, w, 10.0, 6.0, (0, 3)),
        ("RingsArc", "rings", 140.0, 16, max(w, 384), 10.0, 6.0, (0, 3)),
        # dof-compatible trajectories for the restricted Euler solvers
        ("SphereCircleFlat", "sphere", 360.0, 12, w, 0.0, 0.0, (1,)),
        ("SphereCircleTilt", "sphere", 360.0, 12, w, 10.0, 0.0, (2,)),
        ("SuzanneArc", "suzanne", 100.0, 14, max(w, 384), 0.0, 0.0, (0, 1, 2, 3), "circle"),
        ("Suzanne3Lat", "suzanne", 100.0, 24, max(w, 384), 20.0, 0.0, (0, 2, 3), "3lat"),
        ("Suzanne3LatRotated", "suzanne", 100.0, 24, max(w, 384), 20.0, 15.0, (0, 3),
         "3lat_rotated"),
        ("SuzanneMasked", "suzanne", 100.0, 14, max(w, 384), 0.0, 0.0, (0, 3), "circle", True),
    )


if __name__ == "__main__":
    sys.exit(main())
