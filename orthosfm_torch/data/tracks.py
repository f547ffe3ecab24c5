"""Feature tracks as dense padded tensors.

Port of orthosfm_tpu/data/tracks.py. The reference stores tracks as ragged
`std::vector<Track>` (src/data_structures/track.h:21-107); here every list
operation is a mask update on fixed-capacity tensors:

    obs[T, V, 2]    pixel position of track t in view v
    obs_mask[T, V]  does track t contain a feature for view v
    alive[T]        track-level validity (padding + outlier filtering)

`filterTracksToAvailableCameras` (src/util/common.cpp:85-139) becomes
boolean reductions over obs_mask columns.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from orthosfm_torch.core import cameras as cam_mod


@dataclasses.dataclass
class TrackSet:
    obs: torch.Tensor  # (T, V, 2) float32 pixels
    obs_mask: torch.Tensor  # (T, V) bool
    colors: torch.Tensor  # (T, V, 3) uint8
    local_ids: torch.Tensor  # (T, V) int32
    global_ids: torch.Tensor  # (T, V) int32
    points: torch.Tensor  # (T, 4) float32 homogeneous
    has_point: torch.Tensor  # (T,) bool
    alive: torch.Tensor  # (T,) bool
    view_ids: torch.Tensor  # (V,) int32 — column → view id

    @property
    def capacity(self) -> int:
        return self.obs.shape[0]

    @property
    def num_views(self) -> int:
        return self.obs.shape[1]

    @property
    def device(self) -> torch.device:
        return self.obs.device

    def feature_counts(self):
        """Number of features per track, 0 for dead tracks."""
        return torch.sum(self.obs_mask & self.alive[:, None], dim=1)

    def replace(self, **changes) -> "TrackSet":
        return dataclasses.replace(self, **changes)


def from_host(obs, obs_mask, colors, local_ids, global_ids, points, has_point,
               alive, view_ids, device) -> TrackSet:
    """TrackSet from host arrays, with every float cast to f32."""
    def t(x, dtype):
        return torch.as_tensor(np.array(x, dtype), device=device)

    return TrackSet(
        obs=t(obs, np.float32), obs_mask=t(obs_mask, bool),
        colors=t(colors, np.uint8), local_ids=t(local_ids, np.int32),
        global_ids=t(global_ids, np.int32), points=t(points, np.float32),
        has_point=t(has_point, bool), alive=t(alive, bool),
        view_ids=t(view_ids, np.int32))


def from_numpy(src, device="cpu") -> TrackSet:
    """TrackSet from any object with TrackSet's fields as arrays (for example
    the JAX package's TrackSet); floats are cast to f32."""
    return from_host(**{f.name: np.asarray(getattr(src, f.name))
                         for f in dataclasses.fields(TrackSet)}, device=device)


def empty(capacity: int, num_views: int, view_ids=None, device="cpu") -> TrackSet:
    if view_ids is None:
        view_ids = np.arange(num_views)
    return from_host(
        obs=np.zeros((capacity, num_views, 2)),
        obs_mask=np.zeros((capacity, num_views)),
        colors=np.zeros((capacity, num_views, 3)),
        local_ids=np.full((capacity, num_views), -1),
        global_ids=np.full((capacity, num_views), -1),
        points=np.zeros((capacity, 4)),
        has_point=np.zeros((capacity,)),
        alive=np.zeros((capacity,)),
        view_ids=view_ids, device=device)


def from_feature_lists(track_list, view_ids, capacity: int | None = None,
                       device="cpu") -> TrackSet:
    """Build a TrackSet from a Python list of tracks; each track is a list of
    features (view_id, local_id, global_id, x, y, r, g, b). Equivalent to the
    reference's loadTracksFromFile product (src/matching/matching_io.cpp:52-95)."""
    view_ids = np.asarray(view_ids, np.int32)
    col = {int(v): i for i, v in enumerate(view_ids)}
    n_views = len(view_ids)
    n = len(track_list)
    cap = capacity or max(n, 1)
    if n > cap:
        import warnings

        warnings.warn(f"track capacity {cap} < {n} tracks; dropping {n - cap}")
        track_list = track_list[:cap]

    obs = np.zeros((cap, n_views, 2), np.float32)
    obs_mask = np.zeros((cap, n_views), bool)
    colors = np.zeros((cap, n_views, 3), np.uint8)
    local_ids = np.full((cap, n_views), -1, np.int32)
    global_ids = np.full((cap, n_views), -1, np.int32)
    alive = np.zeros((cap,), bool)
    for t, features in enumerate(track_list):
        alive[t] = True
        for f in features:
            v = col[int(f[0])]
            obs[t, v] = (float(f[3]), float(f[4]))
            obs_mask[t, v] = True
            colors[t, v] = tuple(int(c) for c in f[5:8]) if len(f) >= 8 else (0, 0, 0)
            local_ids[t, v] = int(f[1])
            global_ids[t, v] = int(f[2])
    return from_host(obs, obs_mask, colors, local_ids, global_ids,
                      np.zeros((cap, 4)), np.zeros((cap,)), alive, view_ids,
                      device=device)


def from_flat_arrays(counts, vid, lid, gid, xy, rgb, view_ids, capacity: int | None = None,
                     device="cpu") -> TrackSet:
    """Vectorized TrackSet construction from flat per-feature arrays (what the
    native tracks.txt reader returns); the same TrackSet as
    from_feature_lists on the same data.

    counts: (T,) features per track; vid/lid/gid: (F,); xy: (F, 2);
    rgb: (F, 3)."""
    view_ids = np.asarray(view_ids, np.int32)
    n_views = len(view_ids)
    n = len(counts)
    cap = capacity or max(n, 1)
    if n > cap:
        import warnings

        warnings.warn(f"track capacity {cap} < {n} tracks; dropping {n - cap}")
        keep_feats = int(np.sum(counts[:cap]))
        counts = counts[:cap]
        vid, lid, gid = vid[:keep_feats], lid[:keep_feats], gid[:keep_feats]
        xy, rgb = xy[:keep_feats], rgb[:keep_feats]
        n = cap

    order = np.argsort(view_ids, kind="stable")
    cols = order[np.searchsorted(view_ids[order], vid)]
    t_idx = np.repeat(np.arange(n), counts)

    obs = np.zeros((cap, n_views, 2), np.float32)
    obs_mask = np.zeros((cap, n_views), bool)
    colors = np.zeros((cap, n_views, 3), np.uint8)
    local_ids = np.full((cap, n_views), -1, np.int32)
    global_ids = np.full((cap, n_views), -1, np.int32)
    alive = np.arange(cap) < n
    obs[t_idx, cols] = xy
    obs_mask[t_idx, cols] = True
    colors[t_idx, cols] = rgb
    local_ids[t_idx, cols] = lid
    global_ids[t_idx, cols] = gid.astype(np.int32)
    return from_host(obs, obs_mask, colors, local_ids, global_ids, np.zeros((cap, 4)),
                     np.zeros((cap,)), alive, view_ids, device=device)


def to_feature_lists(tracks: TrackSet):
    """Inverse of from_feature_lists (for file IO). Returns python lists."""
    obs = tracks.obs.cpu().numpy()
    mask = tracks.obs_mask.cpu().numpy()
    colors = tracks.colors.cpu().numpy()
    lids = tracks.local_ids.cpu().numpy()
    gids = tracks.global_ids.cpu().numpy()
    alive = tracks.alive.cpu().numpy()
    vids = tracks.view_ids.cpu().numpy()
    out = []
    for t in np.flatnonzero(alive):
        out.append([
            (int(vids[v]), int(lids[t, v]), int(gids[t, v]),
             float(obs[t, v, 0]), float(obs[t, v, 1]),
             int(colors[t, v, 0]), int(colors[t, v, 1]), int(colors[t, v, 2]))
            for v in np.flatnonzero(mask[t])])
    return out


# ---------------------------------------------------------------------------
# Mask-algebra equivalents of the reference's track filtering


def col_index(tracks: TrackSet, cols):
    """Column indices as a long tensor on the tracks' device: a tensor
    already there unchanged, a host sequence copied (cameras.as_index)."""
    return cam_mod.as_index(cols, tracks.device)


def full_size_mask(tracks: TrackSet, cols):
    """Tracks containing features for ALL the given columns
    (= filterTracksToAvailableCameras(..., onlyFullSizeTracks=true),
    reference: src/util/common.cpp:110-121)."""
    return tracks.alive & torch.all(tracks.obs_mask[:, col_index(tracks, cols)], dim=1)


def shared_mask(tracks: TrackSet, cols, min_features: int = 2):
    """Tracks with ≥ min_features features among the given columns
    (= onlyFullSizeTracks=false branch, reference: common.cpp:122-133)."""
    n = torch.sum(tracks.obs_mask[:, col_index(tracks, cols)], dim=1)
    return tracks.alive & (n >= min_features)


def restrict_to_columns(tracks: TrackSet, cols, only_full_size: bool,
                        keep_additional: bool) -> TrackSet:
    """Dense analog of filterTracksToAvailableCameras (common.cpp:85-139).

    Instead of building new lists, returns a TrackSet whose ``alive`` mask
    keeps the qualifying tracks and (unless keep_additional) whose obs_mask
    zeroes the features outside ``cols``.
    """
    keep = full_size_mask(tracks, cols) if only_full_size else shared_mask(tracks, cols)
    if keep_additional:
        return tracks.replace(alive=keep)
    col_mask = torch.zeros((tracks.num_views,), dtype=torch.bool, device=tracks.device)
    col_mask[col_index(tracks, cols)] = True
    return tracks.replace(alive=keep, obs_mask=tracks.obs_mask & col_mask[None, :])


def incidence(tracks: TrackSet):
    """(T, V) bool incidence matrix for group scoring (alive tracks only)."""
    return tracks.obs_mask & tracks.alive[:, None]
