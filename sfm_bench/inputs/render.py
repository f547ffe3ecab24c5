"""Image inputs: orthographic views of a textured sphere, rendered on the
card, frozen here.

Each pixel's ray (orthographic, along the camera's viewing axis) is
intersected with a sphere of radius 0.75 and the hit is shaded by a
band-limited random Fourier texture in 3D, which is rigid on the surface,
so features repeat across views; the background is a flat grey. Cameras
sit on a ring of `ring_degrees` with theta and roll drawn from U(-range,
range) degrees and view 0 at the identity (upstream's full-pipeline test
renders real objects: src/testbench/full_pipeline_tests.cpp:404-533; the
repository does not hold its image archives). Rendering is float64 torch
on the given device; the draws are numpy's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from sfm_bench.reference import camera_model as cm

F64 = torch.float64


class FourierTexture3D:
    """f(p) = 0.5 + 0.35 tanh(1.5 sum_k a_k cos(w_k . p + phi_k))."""

    def __init__(self, n_components: int = 80, max_freq: float = 40.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.w = rng.uniform(-max_freq, max_freq, (n_components, 3))
        self.phase = rng.uniform(0, 2 * np.pi, n_components)
        self.amp = rng.uniform(0.5, 1.0, n_components) / np.sqrt(n_components)

    def __call__(self, pts):
        def t(x):
            return torch.as_tensor(x, dtype=F64, device=pts.device)

        v = torch.cos(pts @ t(self.w).T + t(self.phase)) @ t(self.amp)
        return 0.5 + 0.35 * torch.tanh(1.5 * v)


def circle_angles(num_views: int, ring_degrees: float, theta_range: float,
                  roll_range: float, rng: np.random.Generator) -> np.ndarray:
    """(V, 3) float32 (phi, theta, roll) radians on the ring."""
    phis = np.deg2rad(np.linspace(0.0, ring_degrees, num_views, endpoint=False))
    thetas = np.deg2rad(rng.uniform(-theta_range, theta_range, num_views))
    rolls = np.deg2rad(rng.uniform(-roll_range, roll_range, num_views))
    thetas[0] = rolls[0] = 0.0
    return np.stack([phis, thetas, rolls], -1).astype(np.float32)


def basis_f32(angles: np.ndarray) -> torch.Tensor:
    """The cameras' bases as float32 products C^T Rz Rx Rz of float32 sines
    and cosines rounded from float64, as the rendered scenes were drawn."""
    a = torch.as_tensor(angles, dtype=torch.float32)
    phi, theta, roll = a.unbind(-1)
    omega = theta + 0.5 * math.pi

    def cs(x):
        return torch.cos(x.double()).float(), torch.sin(x.double()).float()

    (cph, sph), (com, som), (crl, srl) = cs(phi), cs(omega), cs(roll)
    z, o = torch.zeros_like(phi), torch.ones_like(phi)

    def mat(rows):
        return torch.stack([torch.stack(r, -1) for r in rows], -2)

    S = (mat([[cph, -sph, z], [sph, cph, z], [z, z, o]])
         @ mat([[o, z, z], [z, com, -som], [z, som, com]])
         @ mat([[crl, -srl, z], [srl, crl, z], [z, z, o]]))
    C = torch.tensor([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]])
    return C.T @ S


def render_sphere(angles: np.ndarray, width: int, height: int, texture: FourierTexture3D,
                  radius: float = 0.75, device="cuda"):
    """(V, H, W) uint8 grey views of the sphere and the cameras' float64
    bases (V, 3, 3), rendered on `device`."""
    R_all = basis_f32(angles).to(device=device, dtype=F64)
    o_all = R_all @ torch.tensor([0.0, 0.0, -cm.CAMERA_DISTANCE], dtype=F64, device=device)
    xs = torch.arange(width, dtype=F64, device=device)
    ys = torch.arange(height, dtype=F64, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")
    out = []
    for v in range(R_all.shape[0]):
        R = R_all[v]
        xn = -2.0 * (px / width - 0.5)
        yn = -2.0 * (py / height - 0.5)
        origin = o_all[v] + xn[..., None] * R[:, 0] + yn[..., None] * R[:, 1]
        d = R[:, 2]
        b = origin @ d
        disc = b * b - (torch.sum(origin * origin, dim=-1) - radius * radius)
        hit = disc > 0.0
        p = origin + (-b - torch.sqrt(torch.clamp(disc, min=0.0)))[..., None] * d
        lam = 0.75 + 0.25 * torch.clamp(-((p / radius) @ d), 0.0, 1.0)
        shade = torch.where(hit, texture(p) * lam, 0.55)
        out.append((torch.clamp(shade, 0, 1) * 255).to(torch.uint8))
    return torch.stack(out), R_all.cpu().numpy()
