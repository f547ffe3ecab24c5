"""The standard bundle-adjustment problem: the JAX package's
bench.make_problem (16 cameras, 8192 sphere tracks, 2048² images), built
with the port's own modules on any device."""

from __future__ import annotations

import numpy as np
import torch

from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.data import synthetic
from orthosfm_torch.ops import triangulate


def make_problem(kind="quat", device="cpu", num_views=16, n_points=8192, width=2048.0):
    """GT ring cameras perturbed by up to 1° per angle (numpy seed 0), camera
    0 fixed, points triangulated from the perturbed cameras. Returns
    (cams, points4 (T, 4), obs (T, V, 2), mask (T, V))."""
    ds = synthetic.generate_dataset(synthetic.sphere_cloud(n_points), num_views=num_views,
                                    seed=0, width=int(width), height=int(width), device=device)
    rng = np.random.default_rng(0)
    pert = ds.gt_cameras.rot[:, :3].cpu().numpy() + np.deg2rad(
        rng.uniform(-1.0, 1.0, (num_views, 3))).astype(np.float32)
    cams = cam_mod.make_euler(np.arange(num_views), width, width, angles=pert, device=device)
    if kind == "quat":
        cams = cam_mod.make_quaternion(np.arange(num_views), width, width,
                                       q=quat.from_matrix(cam_mod.basis(cams)))
    fixed = torch.zeros(num_views, dtype=torch.bool, device=device)
    fixed[0] = True
    cams = cams.replace(fixed=fixed)
    ts = triangulate.triangulate_tracks(cams, ds.tracks, np.arange(num_views))
    mask = ts.obs_mask & ts.alive[:, None] & ts.has_point[:, None]
    return cams, ts.points, ts.obs, mask
