"""Batched orthographic ray triangulation.

Port of orthosfm_tpu/ops/triangulate.py (reference:
src/triangulation/triangulation.cpp:11-93): every track's least-squares
nearest-point-to-N-lines system Σ(I − d dᵀ)p = Σ(I − d dᵀ)o is assembled with
masked reductions and solved as a batch of closed-form 3×3 systems.
"""

from __future__ import annotations

import torch

from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.solvers.ba import solve3x3


def intersect_rays(origins, directions, mask):
    """Least-squares intersection point of masked ray bundles.

    origins, directions: (..., N, 3); mask: (..., N) → points (..., 3), valid (...,).
    (reference: triangulation.cpp:11-42)
    """
    d = directions / torch.clamp(torch.linalg.vector_norm(directions, dim=-1, keepdim=True),
                                 min=1e-12)
    eye = torch.eye(3, dtype=d.dtype, device=d.device)
    proj = eye - d[..., :, None] * d[..., None, :]  # (..., N, 3, 3)
    m = mask[..., None, None].to(d.dtype)
    R = torch.sum(proj * m, dim=-3)
    q = torch.sum(torch.einsum("...nij,...nj->...ni", proj, origins)
                  * mask[..., None].to(d.dtype), dim=-2)
    valid = torch.sum(mask, dim=-1) >= 2
    # Small ridge keeps the solve defined for degenerate bundles; those
    # results are masked out by `valid` anyway.
    return solve3x3(R + 1e-8 * eye, q), valid


def triangulate_tracks(cams: cam_mod.CameraSet, tracks: tracks_mod.TrackSet,
                       cam_cols, reset_existing: bool = True) -> tracks_mod.TrackSet:
    """Triangulate all alive tracks against the cameras sitting at columns
    ``cam_cols`` of the track tensor (reference: triangulation.cpp:44-93).

    cam_cols: (V_c,) column indices such that cams[i] observes column
    cam_cols[i]. Tracks with <2 rays get has_point=False when reset_existing.
    """
    cols = tracks_mod.col_index(tracks, cam_cols)
    pixels = tracks.obs[:, cols, :]  # (T, Vc, 2)
    mask = tracks.obs_mask[:, cols] & tracks.alive[:, None]  # (T, Vc)

    origins = cam_mod.pixel_to_plane_point(cams, pixels.permute(1, 0, 2)).permute(1, 0, 2)
    dirs = cam_mod.look_directions(cams)[None, :, :].expand(origins.shape)

    pts, valid = intersect_rays(origins, dirs, mask)
    new_points4 = torch.cat([pts, torch.ones_like(pts[..., :1])], dim=-1)

    if reset_existing:
        points = torch.where(valid[:, None], new_points4, tracks.points)
        has_point = valid
    else:
        update = valid & ~tracks.has_point
        points = torch.where(update[:, None], new_points4, tracks.points)
        has_point = tracks.has_point | update
    return tracks.replace(points=points, has_point=has_point & tracks.alive)
