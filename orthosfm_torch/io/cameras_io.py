"""Camera file IO (reference: src/data_structures/camera_io.cpp).

cameras.txt: per camera ``imageName;m00,m01,...,m33`` with the 4×4 matrix
[X Y Z origin; 0 0 0 1] in row-major order (camera_io.cpp:24-36). std::to_string
prints 6 fixed decimals; we match that.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

from orthosfm_torch.core import cameras as cam_mod


class CameraTransform(NamedTuple):
    image_name: str
    transform: np.ndarray  # (4, 4)


def export_cameras(cams: cam_mod.CameraSet, image_names: List[str], path: str,
                   order=None) -> None:
    """Write cameras.txt. ``order``: row indices in output order (defaults to
    camera-set order); image_names aligned to camera-set rows."""
    mats = cam_mod.export_matrices(cams).cpu().numpy().astype(np.float64)
    idx = range(len(image_names)) if order is None else order
    with open(path, "w") as f:
        for i in idx:
            m = mats[i]
            vals = ",".join(f"{v:.6f}" for v in m.reshape(-1))
            f.write(f"{image_names[i]};{vals}\n")


def import_cameras(path: str) -> List[CameraTransform]:
    """Parse cameras.txt back into name + 4×4 matrix pairs
    (reference: camera_io.cpp:42-71)."""
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            name, rest = line.split(";", 1)
            vals = [float(v) for v in rest.split(",")]
            out.append(CameraTransform(name, np.asarray(vals, np.float64).reshape(4, 4)))
    return out
