"""Track building from pairwise matches (union-find): port of
orthosfm_tpu/pipeline/tracks_build.py.

Host-side equivalent of MVE's bundler Tracks stage
(src/mve/sfm/bundler_tracks.cc:24-176): pairwise matches union into
multi-view tracks; a track that ends up with two features in one view is
removed. The DSU runs in C++ (csrc/union_find.cpp, built at first use by
orthosfm_torch.kernel_build) with the JAX package's rule, so the roots, and
with them the order of the tracks, agree with the JAX run. Grouping and
conflict removal are vectorized numpy.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Tuple

import numpy as np

from orthosfm_torch import kernel_build

SOURCE = kernel_build.CSRC / "union_find.cpp"
_I64P = ctypes.POINTER(ctypes.c_int64)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    return kernel_build.load(SOURCE, {"osfm_union_find": [_I64P, _I64P, ctypes.c_int64,
                                                          ctypes.c_int64, _I64P]})


def union_find_roots(edges_a: np.ndarray, edges_b: np.ndarray, n: int) -> np.ndarray:
    """Root of each of n nodes after uniting the edges in order."""
    ea = np.ascontiguousarray(edges_a, np.int64)
    eb = np.ascontiguousarray(edges_b, np.int64)
    if ea.shape != eb.shape or (ea.size and min(ea.min(), eb.min()) < 0) \
            or (ea.size and max(ea.max(), eb.max()) >= n):
        raise ValueError(f"edges must be pairs of node indices in [0, {n})")
    out = np.empty(n, np.int64)
    library().osfm_union_find(ea.ctypes.data_as(_I64P), eb.ctypes.data_as(_I64P), len(ea), n,
                              out.ctypes.data_as(_I64P))
    return out


def track_members(pair_matches: List[Tuple[int, int, np.ndarray, np.ndarray]],
                  feature_counts: List[int]):
    """Tracks as flat arrays: (track, view, feature) of every member, grouped
    by track in the order of build_tracks (tracks by root, members by global
    feature index)."""
    empty = np.zeros((0,), np.int64)
    if not pair_matches:
        return empty, empty, empty
    offsets = np.concatenate([[0], np.cumsum(feature_counts)]).astype(np.int64)
    ea = np.concatenate([offsets[vi] + np.asarray(ii, np.int64)
                         for vi, vj, ii, jj in pair_matches])
    eb = np.concatenate([offsets[vj] + np.asarray(jj, np.int64)
                         for vi, vj, ii, jj in pair_matches])
    root = union_find_roots(ea, eb, int(offsets[-1]))

    # Only nodes that participated in a match form tracks
    touched = np.unique(np.concatenate([ea, eb]))
    t_root = root[touched]
    view_of = (np.searchsorted(offsets, touched, side="right") - 1).astype(np.int64)
    feat_of = touched - offsets[view_of]

    # Group by root; drop singleton groups and groups with duplicate views
    order = np.argsort(t_root, kind="stable")
    r, v, f = t_root[order], view_of[order], feat_of[order]
    starts = np.flatnonzero(np.concatenate([[True], r[1:] != r[:-1]]))
    sizes = np.diff(np.concatenate([starts, [len(r)]]))
    key = r * (np.max(view_of) + 2) + v
    sorted_keys = np.sort(key)
    dup_roots = np.unique(sorted_keys[1:][sorted_keys[1:] == sorted_keys[:-1]]
                          // (np.max(view_of) + 2))
    keep_group = (sizes >= 2) & ~np.isin(r[starts], dup_roots)
    keep = np.repeat(keep_group, sizes)
    track = np.repeat(np.cumsum(keep_group) - 1, sizes)
    return track[keep], v[keep], f[keep]


def build_tracks(pair_matches: List[Tuple[int, int, np.ndarray, np.ndarray]],
                 feature_counts: List[int]):
    """Union pairwise matches into tracks.

    pair_matches: list of (view_i, view_j, idx_i, idx_j) with idx arrays of
    matched feature indices. feature_counts: features per view. Returns a
    list of tracks, each a list of (view, feature_idx), with same-view
    conflict tracks removed (bundler_tracks.cc:151-176)."""
    track, view, feat = track_members(pair_matches, feature_counts)
    starts = np.flatnonzero(np.concatenate([[True], track[1:] != track[:-1]])) if len(track) \
        else np.zeros((0,), np.int64)
    ends = np.concatenate([starts[1:], [len(track)]]).astype(np.int64)
    return [[(int(view[k]), int(feat[k])) for k in range(s, e)] for s, e in zip(starts, ends)]
