"""ASCII PLY point-cloud IO.

Writer matches the reference's sparse-cloud export exactly — header plus
``x y z r g b`` rows colored by each track's first feature
(reference: src/util/common.cpp:141-188). Reader parses vertex positions the
way the testbench consumes its resource clouds (dataset_generation.cpp:95-137).
"""

from __future__ import annotations

import numpy as np

from orthosfm_torch.data import tracks as tracks_mod


def save_point_cloud(tracks: tracks_mod.TrackSet, path: str) -> None:
    pts = tracks.points.cpu().numpy()
    has = tracks.has_point.cpu().numpy() & tracks.alive.cpu().numpy()
    mask = tracks.obs_mask.cpu().numpy()
    colors = tracks.colors.cpu().numpy()

    idx = np.flatnonzero(has)
    with open(path, "w") as f:
        f.write("ply\n" "format ascii 1.0\n")
        f.write(f"element vertex {len(idx)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write("end_header\n")
        for t in idx:
            # color of the first feature (common.cpp:179-182)
            feats = np.flatnonzero(mask[t])
            c = colors[t, feats[0]] if len(feats) else (0, 0, 0)
            f.write(f"{pts[t, 0]:g} {pts[t, 1]:g} {pts[t, 2]:g} "
                    f"{int(c[0])} {int(c[1])} {int(c[2])}\n")


def load_vertices(path: str) -> np.ndarray:
    """Read x/y/z of every vertex row from an ascii PLY."""
    pts = []
    with open(path) as f:
        in_header = True
        for line in f:
            if in_header:
                if line.startswith("end_header"):
                    in_header = False
                continue
            parts = line.split()
            if len(parts) >= 3:
                pts.append([float(parts[0]), float(parts[1]), float(parts[2])])
    return np.asarray(pts, np.float64)
