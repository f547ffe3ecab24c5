"""Outlier filtering on track tensors.

Port of orthosfm_tpu/ops/outliers.py (reference:
src/triangulation/outlier_filtering.cpp): the O(N²) nearest-neighbour scan
becomes a row-chunked pairwise-distance matmul sweep, and the per-feature
reprojection filter becomes masked updates on the observation mask.
"""

from __future__ import annotations

import torch

from orthosfm_torch.config import FilterConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.ops import triangulate

_NN_CHUNK = 2048  # rows per tile of the pairwise-distance sweep


def nearest_neighbor_distances(pts, has_pt):
    """Min distance from each pointed track to any other pointed track
    (reference: outlier_filtering.cpp:14-38). Each (chunk × T) distance tile
    is one matmul + reduction, so only O(chunk·T) memory is live."""
    T = pts.shape[0]
    sq = torch.sum(pts * pts, dim=-1)  # (T,)
    big = torch.tensor(1e12, dtype=pts.dtype, device=pts.device)
    idx = torch.arange(T, device=pts.device)
    d2min = []
    for s in range(0, T, _NN_CHUNK):
        e = min(s + _NN_CHUNK, T)
        d2 = sq[s:e, None] + sq[None, :] - 2.0 * (pts[s:e] @ pts.T)  # (chunk, T)
        d2 = torch.clamp(d2, min=0.0)
        pair_valid = has_pt[s:e, None] & has_pt[None, :] & (idx[s:e, None] != idx[None, :])
        d2min.append(torch.amin(torch.where(pair_valid, d2, big), dim=1))
    nn = torch.sqrt(torch.cat(d2min))
    return torch.where(has_pt, nn, torch.zeros_like(nn))


def filter_outlier_tracks(tracks: tracks_mod.TrackSet,
                          cfg: FilterConfig = FilterConfig()) -> tracks_mod.TrackSet:
    """Drop triangulated tracks whose nearest-neighbour distance exceeds
    mean + 1.6·σ, or that lie outside the radius-10 bounding sphere; tracks
    without points are always kept (reference: outlier_filtering.cpp:40-125).

    The reference's σ divides the squared sum by 2N (its counter keeps
    incrementing through the second loop, outlier_filtering.cpp:83-94); that
    is reproduced exactly for behavioral parity.
    """
    has_pt = tracks.has_point & tracks.alive
    pts = tracks.points  # (T, 4) homogeneous; reference measures 4-D norms
    nn = nearest_neighbor_distances(pts, has_pt)

    n = torch.clamp(torch.sum(has_pt), min=1)
    mean = torch.sum(nn) / n
    sq_sum = torch.sum(torch.where(has_pt, (nn - mean) ** 2, torch.zeros_like(nn)))
    sigma = torch.clamp(torch.sqrt(sq_sum / (2 * n)), min=cfg.nn_sigma_floor)

    in_sphere = torch.linalg.vector_norm(pts, dim=-1) <= cfg.bounding_radius
    keep_pointed = (nn < mean + cfg.nn_sigma_threshold * sigma) & in_sphere
    keep = torch.where(has_pt, keep_pointed, torch.ones_like(keep_pointed)) & tracks.alive
    return tracks.replace(alive=keep, has_point=tracks.has_point & keep)


def filter_tracks_reprojection_error(tracks: tracks_mod.TrackSet,
                                     cams: cam_mod.CameraSet, cam_cols,
                                     cfg: FilterConfig = FilterConfig()
                                     ) -> tracks_mod.TrackSet:
    """Per-feature reprojection filter (reference: outlier_filtering.cpp:127-192).

    Full-size tracks (w.r.t. the given cameras) are triangulated; their
    features observed by those cameras are dropped when the reprojection
    error exceeds 1.5 px; a filtered track survives only with ≥2 features.
    Non-full-size tracks pass through untouched.
    """
    cols = tracks_mod.col_index(tracks, cam_cols)
    full = tracks_mod.full_size_mask(tracks, cam_cols)

    # Fresh points for the full-size tracks (mirrors outlier_filtering.cpp:131-134)
    pts = triangulate.triangulate_tracks(cams, tracks.replace(alive=full), cam_cols).points

    pix = cam_mod.project(cams, pts).permute(1, 0, 2)  # (T, Vc, 2)
    err = torch.linalg.vector_norm(pix - tracks.obs[:, cols, :], dim=-1)  # (T, Vc)
    feat_ok = err < cfg.max_reprojection_error_px

    remove = torch.zeros_like(tracks.obs_mask)
    remove[:, cols] = ~feat_ok
    remove = remove & full[:, None]
    new_mask = tracks.obs_mask & ~remove

    counts = torch.sum(new_mask, dim=1)
    keep = torch.where(full, counts >= 2, torch.ones_like(full)) & tracks.alive
    return tracks.replace(obs_mask=new_mask, alive=keep, has_point=tracks.has_point & keep)
