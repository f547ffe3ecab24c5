"""Synthetic dataset generation for solver development and robustness tests.

Port of orthosfm_tpu/data/synthetic.py (reference testbench fixtures,
src/testbench/dataset_generation.cpp:14-93): 16 virtual 2048×2048 views on a
22.5°-spaced ring with random theta/roll ∈ ±30°, perfect tracks built by
projecting a point cloud through the ground-truth cameras. All randomness is
numpy's, so the same seed gives the same clouds, cameras and noise as the
JAX package's numpy draws.

When $ORTHOSFM_REFERENCE_RESOURCES names a folder with the reference's
Cube/Sphere/Suzanne PLY resources the named clouds load them; procedural
stand-ins are the fallback.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from orthosfm_torch.config import SolverType
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.data import tracks as tracks_mod


@dataclasses.dataclass
class SyntheticDataset:
    tracks: tracks_mod.TrackSet
    gt_cameras: cam_mod.CameraSet  # Euler ground truth
    name: str = ""


def cube_cloud(n_per_edge: int = 21, extent: float = 1.0) -> np.ndarray:
    """Points on the surface of a cube (≈ the reference's Cube.ply, 2.7k pts)."""
    lin = np.linspace(-extent, extent, n_per_edge)
    g1, g2 = np.meshgrid(lin, lin, indexing="ij")
    faces = []
    for axis in range(3):
        for sign in (-extent, extent):
            pts = np.zeros((n_per_edge * n_per_edge, 3))
            other = [a for a in range(3) if a != axis]
            pts[:, other[0]] = g1.ravel()
            pts[:, other[1]] = g2.ravel()
            pts[:, axis] = sign
            faces.append(pts)
    return np.unique(np.round(np.concatenate(faces, axis=0), 9), axis=0)


def sphere_cloud(n: int = 3800, radius: float = 1.0) -> np.ndarray:
    """Fibonacci-spiral sphere (≈ the reference's Sphere.ply, 3.8k pts)."""
    i = np.arange(n, dtype=np.float64)
    phi = np.arccos(1.0 - 2.0 * (i + 0.5) / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return radius * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=-1)


def blob_cloud(n: int = 7800, seed: int = 7) -> np.ndarray:
    """Asymmetric multi-sphere blob (stands in for Suzanne.ply, 7.8k pts) —
    asymmetric geometry matters for disambiguating mirror solutions."""
    rng = np.random.default_rng(seed)
    centers = np.array(
        [[0.0, 0.0, 0.0], [0.6, 0.45, 0.2], [-0.6, 0.45, 0.2], [0.0, -0.35, 0.55]])
    radii = np.array([0.7, 0.28, 0.28, 0.35])
    weights = radii**2 / np.sum(radii**2)
    which = rng.choice(len(centers), size=n, p=weights)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return centers[which] + radii[which][:, None] * dirs


def reference_cloud(name: str):
    """Vertex cloud from the reference's PLY fixture (reference:
    src/testbench/dataset_generation.cpp:95-137) rescaled to max-norm 1, read
    from the directory named by $ORTHOSFM_REFERENCE_RESOURCES; None when that
    is unset or holds no such file."""
    folder = os.environ.get("ORTHOSFM_REFERENCE_RESOURCES", "")
    path = os.path.join(folder, f"{name}.ply")
    if not folder or not os.path.exists(path):
        return None
    from orthosfm_torch.io import ply

    pts = ply.load_vertices(path)
    if not len(pts):
        return None
    return pts / np.max(np.linalg.norm(pts, axis=1))


def _cloud_with_reference_fallback(name: str, procedural):
    def make():
        pts = reference_cloud(name)
        return pts if pts is not None else procedural()

    return make


CLOUDS = {
    "Cube": _cloud_with_reference_fallback("Cube", cube_cloud),
    "Sphere": _cloud_with_reference_fallback("Sphere", sphere_cloud),
    "Blob": blob_cloud,
    "Suzanne": _cloud_with_reference_fallback("Suzanne", blob_cloud),
}


def generate_gt_cameras(num_views: int = 16, width: int = 2048, height: int = 2048,
                        theta_range: float = 30.0, roll_range: float = 30.0,
                        seed: int = 0, device="cuda") -> cam_mod.CameraSet:
    """Ring of cameras: camera 0 identity, camera i at phi = 360°/V·i with
    random theta/roll (reference: dataset_generation.cpp:14-39), on `device`:
    CUDA unless the caller names another (without a card this raises rather
    than run on the CPU unasked)."""
    from orthosfm_torch.pipeline.matching import checked_device

    device = checked_device(device)
    rng = np.random.default_rng(seed)
    phis = np.deg2rad(360.0 / num_views * np.arange(num_views))
    thetas = np.deg2rad(rng.uniform(-theta_range, theta_range, size=num_views))
    rolls = np.deg2rad(rng.uniform(-roll_range, roll_range, size=num_views))
    thetas[0] = 0.0
    rolls[0] = 0.0
    angles = np.stack([phis, thetas, rolls], axis=-1).astype(np.float32)
    return cam_mod.make_euler(np.arange(num_views), float(width), float(height),
                              angles=angles, solver=SolverType.ORTHO_EULER_ALL_DOF,
                              device=device)


def generate_dataset(cloud="Cube", num_views: int = 16, width: int = 2048,
                     height: int = 2048, seed: int = 0, capacity: int | None = None,
                     scene_scale: float = 3.0, device="cuda") -> SyntheticDataset:
    """Project every cloud point through every GT camera into perfect
    full-length tracks (reference: dataset_generation.cpp:41-93), on
    `device`: CUDA unless the caller names another (without a card this
    raises rather than run on the CPU unasked)."""
    from orthosfm_torch.pipeline.matching import checked_device

    device = checked_device(device)
    name = cloud if isinstance(cloud, str) else "custom"
    pts = CLOUDS[cloud]() if isinstance(cloud, str) else np.asarray(cloud)
    pts = pts / scene_scale
    gt = generate_gt_cameras(num_views, width, height, seed=seed, device=device)
    n = pts.shape[0]
    points4 = torch.cat([torch.as_tensor(pts, dtype=torch.float32, device=device),
                         torch.ones((n, 1), device=device)], dim=-1)
    pixels = cam_mod.project(gt, points4).permute(1, 0, 2)  # (T, V, 2)

    ts = tracks_mod.empty(capacity or n, num_views, device=device)
    ids = torch.arange(n, device=device)
    ts.obs[:n] = pixels
    ts.obs_mask[:n] = True
    ts.local_ids[:n] = ids.to(torch.int32)[:, None]
    ts.global_ids[:n] = (ids[:, None] * num_views
                         + torch.arange(num_views, device=device)[None, :]).to(torch.int32)
    ts.alive[:n] = True
    return SyntheticDataset(tracks=ts, gt_cameras=gt, name=name)


def add_observation_noise(tracks: tracks_mod.TrackSet, sigma_px: float,
                          rng: np.random.Generator,
                          frequency: float = 1.0) -> tracks_mod.TrackSet:
    """Gaussian pixel noise with an application-frequency gate, reproducing the
    testbench's observation-noise fault injection
    (reference: synthethic_tests.cpp:41-108). Draws from numpy's ``rng``."""
    noise = sigma_px * rng.standard_normal(tuple(tracks.obs.shape))
    gate = rng.uniform(size=tuple(tracks.obs_mask.shape)) < frequency
    applied = np.where((tracks.obs_mask.cpu().numpy() & gate)[..., None], noise, 0.0)
    return tracks.replace(obs=tracks.obs + torch.as_tensor(
        applied.astype(np.float32), device=tracks.device))
