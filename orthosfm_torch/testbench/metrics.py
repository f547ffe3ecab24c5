"""Evaluation metrics with global-flip normalization.

Port of orthosfm_tpu/testbench/metrics.py, reproducing the reference
testbench's scoring (src/testbench/full_pipeline_tests.cpp:235-297): detect
whether the reconstruction landed on the mirrored solution via the
origin-difference dot product, un-mirror if so, then per-camera quaternion
angular distance (degrees) and normalized-origin position error.
"""

from __future__ import annotations

import numpy as np
import torch

from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat

FLIP_ROT = np.diag([1.0, 1.0, -1.0])
FLIP_POS = np.diag([-1.0, -1.0, 1.0])


def detect_flip(est_origins, ref_origins) -> bool:
    """Global mirror detection from the first two cameras
    (reference: full_pipeline_tests.cpp:235-250)."""

    def unit(v):
        return v / max(np.linalg.norm(v), 1e-12)

    ref_dir = unit(unit(ref_origins[1]) - unit(ref_origins[0]))
    est_dir = unit(unit(est_origins[1]) - unit(est_origins[0]))
    return float(np.dot(ref_dir, est_dir)) < 0.0


def pose_errors(est_cams: cam_mod.CameraSet, ref_cams: cam_mod.CameraSet):
    """Per-camera (angular_error_deg, position_error) arrays, flip-normalized.
    Cameras must be index-aligned (same view order)."""
    R_est = cam_mod.basis(est_cams).cpu().numpy().astype(np.float64)
    R_ref = cam_mod.basis(ref_cams).cpu().numpy().astype(np.float64)
    o_est = np.einsum("vij,j->vi", R_est, [0.0, 0.0, -cam_mod.CAMERA_DISTANCE])
    o_ref = np.einsum("vij,j->vi", R_ref, [0.0, 0.0, -cam_mod.CAMERA_DISTANCE])

    if detect_flip(o_est, o_ref):
        R_est = np.einsum("ij,vjk,kl->vil", FLIP_ROT, R_est, FLIP_ROT)
        o_est = np.einsum("ij,vj->vi", FLIP_POS, o_est)

    q_est = quat.from_matrix(torch.as_tensor(R_est, dtype=torch.float32))
    q_ref = quat.from_matrix(torch.as_tensor(R_ref, dtype=torch.float32))
    ang = np.rad2deg(quat.angular_distance(q_est, q_ref).numpy().astype(np.float64))

    on_est = o_est / np.maximum(np.linalg.norm(o_est, axis=-1, keepdims=True), 1e-12)
    on_ref = o_ref / np.maximum(np.linalg.norm(o_ref, axis=-1, keepdims=True), 1e-12)
    pos = np.linalg.norm(on_est - on_ref, axis=-1)
    return np.abs(ang), np.abs(pos)



def mean_and_std(values):
    """Population mean/std pair (reference: src/util/common.cpp:218-239)."""
    v = np.asarray(values, np.float64)
    return float(v.mean()), float(v.std())
