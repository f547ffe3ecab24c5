"""Track utilities bridging views (host images) and track tensors: mask
filtering and color propagation (reference: src/matching/matching.cpp:325-368,
src/util/common.cpp:289-315). Port of orthosfm_tpu/pipeline/track_utils.py."""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.data.views import View


def _sample_at(tracks: tracks_mod.TrackSet, c: int, view: View):
    """Integer pixel (ys, xs) of every track's feature in column c, clamped
    to the view."""
    obs = tracks.obs[:, c].cpu().numpy()
    xs = np.clip(obs[:, 0], 0, view.width - 1).astype(np.int32)
    ys = np.clip(obs[:, 1], 0, view.height - 1).astype(np.int32)
    return ys, xs


def filter_tracks_with_masks(tracks: tracks_mod.TrackSet,
                             views: List[View]) -> tracks_mod.TrackSet:
    """Drop every track that has ANY feature on a masked-out pixel
    (reference: matching.cpp:325-368). No-op when no view has a mask."""
    by_id = {v.view_id: v for v in views}
    if not any(v.mask is not None for v in views):
        print("No masks available. Continuing without masking.")
        return tracks
    mask = tracks.obs_mask.cpu().numpy()
    alive = tracks.alive.cpu().numpy()
    keep = alive.copy()
    for c, vid in enumerate(tracks.view_ids.tolist()):
        view = by_id.get(int(vid))
        if view is None or view.mask is None:
            continue
        ys, xs = _sample_at(tracks, c, view)
        keep &= ~mask[:, c] | (view.mask[ys, xs] > 16)
    print(f"{int(keep.sum())} tracks out of {int(alive.sum())} remaining after filtering")
    return tracks.replace(alive=torch.as_tensor(keep, device=tracks.device))


def propagate_colors(tracks: tracks_mod.TrackSet, views: List[View]) -> tracks_mod.TrackSet:
    """Sample each feature's pixel color from its view image
    (reference: common.cpp:289-315)."""
    by_id = {v.view_id: v for v in views}
    colors = tracks.colors.clone()
    for c, vid in enumerate(tracks.view_ids.tolist()):
        view = by_id.get(int(vid))
        if view is None or view.pixels is None:
            continue
        ys, xs = _sample_at(tracks, c, view)
        colors[:, c] = torch.as_tensor(view.pixels[ys, xs], device=tracks.device)
    return tracks.replace(colors=colors)


def print_track_overview(tracks: tracks_mod.TrackSet) -> None:
    """Histogram of track lengths (reference: track.cpp:101-120)."""
    counts = tracks.feature_counts().cpu().numpy()
    counts = counts[tracks.alive.cpu().numpy()]
    total = len(counts)
    print(f"Built {total} tracks:")
    if total:
        for length in range(2, int(counts.max()) + 1):
            n = int(np.sum(counts == length))
            if n:
                print(f"  {n} tracks of length {length}")
