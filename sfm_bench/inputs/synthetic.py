"""Track inputs as upstream's synthetic testbench makes them, frozen here.

Upstream: src/testbench/dataset_generation.cpp:17-93 (a ring of cameras
22.5 degrees apart at 16 views, theta and roll drawn from U(-30, 30)
degrees, camera 0 at the identity, every cloud point projected into every
view as a full-length track) and src/testbench/synthethic_tests.cpp:41-108
(Gaussian pixel noise applied to each observation with a frequency gate).
The clouds stand in for upstream's resources/{Cube,Sphere,Suzanne}.ply,
which the repository does not hold: a cube surface grid (2402 points), a
Fibonacci sphere (3800) and an asymmetric blob of spheres (7800 or any
count). The arithmetic is plain numpy in float64 and the noise is numpy's,
in the order upstream's port draws it, so a seed gives the same tracks on
every machine.
"""

from __future__ import annotations

import numpy as np
import torch

from sfm_bench.reference import camera_model as cm

SCENE_SCALE = 3.0


def cube_cloud(n_per_edge: int = 21, extent: float = 1.0) -> np.ndarray:
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
    i = np.arange(n, dtype=np.float64)
    phi = np.arccos(1.0 - 2.0 * (i + 0.5) / n)
    theta = np.pi * (1.0 + 5.0**0.5) * i
    return radius * np.stack(
        [np.sin(phi) * np.cos(theta), np.sin(phi) * np.sin(theta), np.cos(phi)], axis=-1)


def blob_cloud(n: int = 7800, seed: int = 7) -> np.ndarray:
    rng = np.random.default_rng(seed)
    centers = np.array(
        [[0.0, 0.0, 0.0], [0.6, 0.45, 0.2], [-0.6, 0.45, 0.2], [0.0, -0.35, 0.55]])
    radii = np.array([0.7, 0.28, 0.28, 0.35])
    weights = radii**2 / np.sum(radii**2)
    which = rng.choice(len(centers), size=n, p=weights)
    dirs = rng.normal(size=(n, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    return centers[which] + radii[which][:, None] * dirs


def cloud(spec: dict, seed: int) -> np.ndarray:
    """A cloud from its mix entry: `shape` cube (`n_per_edge`), sphere or
    blob (`points`); a blob takes `blob_seed`, or the input's seed where the
    entry says `"seeded": true`."""
    shape = spec["shape"]
    if shape == "cube":
        return cube_cloud(spec.get("n_per_edge", 21))
    if shape == "sphere":
        return sphere_cloud(spec.get("points", 3800))
    if shape == "blob":
        return blob_cloud(spec.get("points", 7800),
                          seed=seed if spec.get("seeded") else spec.get("blob_seed", 7))
    raise ValueError(f"unknown cloud shape {shape!r}")


def ring_angles(num_views: int, seed: int, theta_range: float = 30.0,
                roll_range: float = 30.0, ring_degrees: float = 360.0) -> np.ndarray:
    """(V, 3) (phi, theta, roll) radians: phi on the ring, theta and roll from
    U(-range, range) degrees, view 0 at the identity."""
    rng = np.random.default_rng(seed)
    phis = np.deg2rad(ring_degrees / num_views * np.arange(num_views))
    thetas = np.deg2rad(rng.uniform(-theta_range, theta_range, size=num_views))
    rolls = np.deg2rad(rng.uniform(-roll_range, roll_range, size=num_views))
    thetas[0] = 0.0
    rolls[0] = 0.0
    return np.stack([phis, thetas, rolls], axis=-1).astype(np.float32).astype(np.float64)


def project_cloud(pts: np.ndarray, angles: np.ndarray, width: float, height: float):
    """(T, V, 2) float32 pixels of the cloud (scaled by 1/SCENE_SCALE) in the
    ring's cameras (scale 1, offset 0), and their (V, 3, 3) bases."""
    R = cm.euler_basis(torch.as_tensor(angles, dtype=torch.float64))
    V = R.shape[0]
    wh = torch.tensor([[width, height]], dtype=torch.float64).expand(V, 2)
    pix = cm.project(R, torch.zeros((V, 2), dtype=torch.float64),
                     torch.ones(V, dtype=torch.float64), wh,
                     torch.as_tensor(pts / SCENE_SCALE, dtype=torch.float64))
    return pix.permute(1, 0, 2).numpy().astype(np.float32), R.numpy()


def add_noise(obs: np.ndarray, sigma_px: float, rng: np.random.Generator,
              frequency: float = 1.0) -> np.ndarray:
    """Gaussian noise of `sigma_px` on each observation that the frequency
    gate lets through (every observation is present in these tracks)."""
    noise = sigma_px * rng.standard_normal(obs.shape)
    gate = rng.uniform(size=obs.shape[:2]) < frequency
    return (obs + np.where(gate[..., None], noise, 0.0).astype(np.float32)).astype(np.float32)
