"""Track file IO in the reference's formats.

tracks.txt: one line per track, semicolon-separated
``count;viewID;localID;globalID;x;y;r;g;b;...`` (reference:
src/matching/matching_io.cpp:16-95). Pairwise export: per view pair a
``{aaa}_{bbb}.txt`` with ``x1 y1 x2 y2`` lines for interop with other SfM
tools (matching_io.cpp:97-141).
"""

from __future__ import annotations

import os

import numpy as np

from orthosfm_torch.data import tracks as tracks_mod


def save_tracks(tracks: tracks_mod.TrackSet, path: str) -> None:
    feature_lists = tracks_mod.to_feature_lists(tracks)
    with open(path, "w") as f:
        for feats in feature_lists:
            parts = [str(len(feats))]
            for (vid, lid, gid, x, y, r, g, b) in feats:
                parts += [str(vid), str(lid), str(gid),
                          _fmt(x), _fmt(y), str(r), str(g), str(b)]
            f.write(";".join(parts) + "\n")


def _fmt(v: float) -> str:
    # C++ streams print floats with 6 significant digits
    return f"{v:g}"


def load_tracks(path: str, view_ids, capacity: int | None = None,
                device="cpu") -> tracks_mod.TrackSet:
    """Parse tracks.txt with the pure-Python reader (the native C++ reader
    of the JAX package is not ported yet)."""
    track_list = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            parts = line.split(";")
            n = int(parts[0])
            feats = []
            idx = 1
            for _ in range(n):
                vid = int(parts[idx]); lid = int(parts[idx + 1]); gid = int(parts[idx + 2])
                x = float(parts[idx + 3]); y = float(parts[idx + 4])
                r = int(parts[idx + 5]); g = int(parts[idx + 6]); b = int(parts[idx + 7])
                feats.append((vid, lid, gid, x, y, r, g, b))
                idx += 8
            track_list.append(feats)
    return tracks_mod.from_feature_lists(track_list, view_ids, capacity=capacity,
                                        device=device)


def save_pairwise_tracks(tracks: tracks_mod.TrackSet, folder: str) -> None:
    """Per-pair correspondence files (reference: matching_io.cpp:97-141)."""
    obs = tracks.obs.cpu().numpy()
    mask = tracks.obs_mask.cpu().numpy() & tracks.alive.cpu().numpy()[:, None]
    vids = tracks.view_ids.cpu().numpy()
    V = len(vids)
    for i in range(V):
        for j in range(i + 1, V):
            both = mask[:, i] & mask[:, j]
            if not both.any():
                continue
            name = f"{int(vids[i]):03d}_{int(vids[j]):03d}.txt"
            with open(os.path.join(folder, name), "w") as f:
                for t in np.flatnonzero(both):
                    f.write(f"{obs[t, i, 0]:g} {obs[t, i, 1]:g} "
                            f"{obs[t, j, 0]:g} {obs[t, j, 1]:g}\n")
