"""Top-level reconstruction driver (reference: src/sfm/reconstruct.cpp:32-172).

Port of orthosfm_tpu/pipeline/reconstruct.py. Phases and their timers mirror
the reference: initialization (image loading) → track building (feature
matching from the images, or a track-file load) → pose estimation
(incremental alignment) → artifact export (cameras.txt, sparse_cloud.ply,
tracks.txt when built from images, time_measurements.txt).
"""

from __future__ import annotations

import os
import time
from typing import List, Tuple

import numpy as np

from orthosfm_torch.config import ReconstructionConfig
from orthosfm_torch.data.views import View, load_views
from orthosfm_torch.io import cameras_io, ply, timing, tracks_io
from orthosfm_torch.pipeline import incremental, matching, track_utils


def reconstruct(config: ReconstructionConfig, verbose: bool = True, device="cuda"
                ) -> Tuple[incremental.PoseEstimationResult, List[View]]:
    """Full reconstruction on ``device``, from ``config.track_file`` when it
    is set and from the images otherwise. The device is CUDA unless the
    caller names another; without a CUDA device this raises at once rather
    than run on the CPU unasked."""
    device = matching.checked_device(device)
    start_all = time.monotonic()

    # --- Initialization: load views (+ masks) ---------------------------------
    views = load_views(config.image_folder, config.mask_folder, config.downscale_factor)
    if verbose:
        print(f"Initialized project with {len(views)} views")
    end_init = time.monotonic()

    # --- Track building -------------------------------------------------------
    if config.track_file:
        view_ids = np.asarray([v.view_id for v in views], np.int32)
        if verbose:
            print(f"Loading tracks from {config.track_file}")
        tracks = tracks_io.load_tracks(config.track_file, view_ids, device=device)
    else:
        tracks = matching.build_tracks(views, config, verbose=verbose, device=device)
        tracks = track_utils.filter_tracks_with_masks(tracks, views)
        tracks = track_utils.propagate_colors(tracks, views)
        if config.project_folder:
            tracks_io.save_tracks(tracks, os.path.join(config.project_folder, "tracks.txt"))
    if verbose:
        track_utils.print_track_overview(tracks)
    end_track = time.monotonic()

    if config.export_pairwise_tracks and config.project_folder:
        tracks_io.save_pairwise_tracks(tracks, config.project_folder)

    # --- Pose estimation ------------------------------------------------------
    widths = np.asarray([v.width for v in views], np.float32)
    heights = np.asarray([v.height for v in views], np.float32)
    start_pose = time.monotonic()
    result = incremental.run_pose_estimation(tracks, widths, heights, config, verbose=verbose)
    end_pose = time.monotonic()

    # --- Export ---------------------------------------------------------------
    if config.project_folder:
        export_cameras(result, [v.image_name for v in views],
                       os.path.join(config.project_folder, "cameras.txt"))
        ply.save_point_cloud(result.tracks,
                             os.path.join(config.project_folder, "sparse_cloud.ply"))
        end_all = time.monotonic()
        timing.save_runtimes(
            os.path.join(config.project_folder, "time_measurements.txt"),
            end_init - start_all, end_track - end_init, end_pose - start_pose,
            end_all - start_all)
    return result, views


def export_cameras(result: incremental.PoseEstimationResult, image_names: List[str],
                   path: str) -> None:
    """cameras.txt in reconstruction (insertion) order, like the reference's
    alignedCameras vector (reconstruct.cpp:290); image_names are indexed by
    view id."""
    vids = result.cameras.view_ids.cpu().numpy()
    col_of = {int(v): i for i, v in enumerate(vids)}
    order = [col_of[vid] for vid in result.insertion_order]
    names = [image_names[int(vids[i])] for i in range(len(vids))]
    cameras_io.export_cameras(result.cameras, names, path, order=order)
