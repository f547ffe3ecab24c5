"""Synthetic image rendering for full-pipeline tests and the card's smoke run.

Port of orthosfm_tpu/testbench/render.py: orthographic views of procedurally
textured analytic scenes. Each pixel's ray (orthographic, along the camera's
look direction) is intersected with the scene and the hit point is shaded
with a band-limited random-Fourier 3D texture, which is rigid on the
surface, so local appearance repeats across moderate viewpoint changes.

Rendering runs in torch float64 on an explicit device (the cameras' device
unless one is given), so a 2048^2 view set renders on the card; the random
scene and texture parameters are numpy draws, as in the JAX package.

Scenes (in rough difficulty order): sphere (no occlusion), blob (union of
spheres: self-occlusion, concavities), cube (flat faces, sharp silhouettes),
ornament_cube (a cube with a bump on each face), rings (two interlocking
rings of spheres: thin structures and holes) and suzanne (the reference's
Suzanne vertex cloud as a PointCloudScene where its PLY is available, the
blob otherwise).
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from orthosfm_torch.core import cameras as cam_mod

F64 = torch.float64


def _t(x, like):
    return torch.as_tensor(np.asarray(x, np.float64), dtype=F64, device=like.device)


class FourierTexture3D:
    """Smooth random 3D texture f(p) = Σ a_k cos(w_k·p + φ_k), values ≈ [0,1]."""

    def __init__(self, n_components: int = 80, max_freq: float = 40.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.w = rng.uniform(-max_freq, max_freq, (n_components, 3))
        self.phase = rng.uniform(0, 2 * np.pi, n_components)
        self.amp = rng.uniform(0.5, 1.0, n_components) / np.sqrt(n_components)

    def __call__(self, pts):
        v = torch.cos(pts @ _t(self.w, pts).T + _t(self.phase, pts)) @ _t(self.amp, pts)
        return 0.5 + 0.35 * torch.tanh(1.5 * v)


# ---------------------------------------------------------------------------
# Analytic scenes: intersect(origins (..., 3), d (3,)) →
# (hit (...,) bool, p_hit (..., 3), normal (..., 3)), all float64 tensors


class SphereScene:
    def __init__(self, radius: float = 0.75, center=(0.0, 0.0, 0.0)):
        self.radius = radius
        self.center = np.asarray(center, np.float64)

    def intersect(self, origins, d):
        o = origins - _t(self.center, origins)
        b = o @ d
        c = torch.sum(o * o, dim=-1) - self.radius * self.radius
        disc = b * b - c
        hit = disc > 0.0
        t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
        p = origins + t[..., None] * d
        n = (p - _t(self.center, origins)) / self.radius
        return hit, p, n


class BlobScene:
    """Union of K spheres: self-occluding, concave, view-dependent
    silhouettes."""

    def __init__(self, n_spheres: int = 6, seed: int = 3, radius: float = 0.8):
        rng = np.random.default_rng(seed)
        self.centers = rng.uniform(-0.45, 0.45, (n_spheres, 3))
        self.centers[0] = 0.0  # keep one anchor sphere at the origin
        self.radii = rng.uniform(0.45, 0.75, n_spheres) * radius

    def intersect(self, origins, d):
        shape = origins.shape[:-1]
        t_best = torch.full(shape, np.inf, dtype=F64, device=origins.device)
        idx_best = torch.full(shape, -1, dtype=torch.long, device=origins.device)
        for i, (c0, r) in enumerate(zip(self.centers, self.radii)):
            o = origins - _t(c0, origins)
            b = o @ d
            c = torch.sum(o * o, dim=-1) - r * r
            disc = b * b - c
            hit_i = disc > 0.0
            t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
            closer = hit_i & (t < t_best)
            t_best = torch.where(closer, t, t_best)
            idx_best = torch.where(closer, i, idx_best)
        hit = idx_best >= 0
        t = torch.where(hit, t_best, 0.0)
        p = origins + t[..., None] * d
        k = torch.clamp(idx_best, min=0)
        centers = torch.where(hit[..., None], _t(self.centers, origins)[k], 0.0)
        radii = torch.where(hit, _t(self.radii, origins)[k], 1.0)
        n = (p - centers) / radii[..., None]
        return hit, p, n


class CubeScene:
    """Box via the slab method: flat faces, sharp silhouettes.

    The box is rotated corner-on (45° yaw + ~35.26° tilt) by default so every
    equatorial view sees 2-3 faces: a one-plane view is degenerate for
    orthographic SfM (the bas-relief ambiguity)."""

    def __init__(self, half_extent: float = 0.55, corner_on: bool = True):
        self.h = half_extent
        if corner_on:
            cy, sy = np.cos(np.pi / 4), np.sin(np.pi / 4)
            tilt = np.arctan(1.0 / np.sqrt(2.0))
            ct, st = np.cos(tilt), np.sin(tilt)
            yaw = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
            pitch = np.array([[1, 0, 0], [0, ct, -st], [0, st, ct]])
            self.R = pitch @ yaw  # world → cube frame
        else:
            self.R = np.eye(3)

    def intersect(self, origins, d):
        h = self.h
        R = _t(self.R, origins)
        o = origins @ R.T  # into cube frame
        dc = R @ d
        parallel = torch.abs(dc) <= 1e-12
        inv = torch.where(parallel, np.inf, 1.0 / dc)
        t1 = torch.where(parallel, 0.0, (-h - o) * inv)
        t2 = torch.where(parallel, 0.0, (h - o) * inv)
        tmin_ax = torch.minimum(t1, t2)
        tmax_ax = torch.maximum(t1, t2)
        # Parallel rays: inside the slab → ±inf bounds, outside → miss
        inside = torch.abs(o) <= h
        tmin_ax = torch.where(parallel, torch.where(inside, -np.inf, np.inf), tmin_ax)
        tmax_ax = torch.where(parallel, torch.where(inside, np.inf, -np.inf), tmax_ax)
        t_near = torch.max(tmin_ax, dim=-1).values
        t_far = torch.min(tmax_ax, dim=-1).values
        hit = t_near <= t_far
        t = torch.where(hit, t_near, 0.0)
        p = origins + t[..., None] * d
        # Normal: the axis achieving t_near, rotated back to the world frame
        ax = torch.argmax(tmin_ax, dim=-1, keepdim=True)
        nc = torch.zeros_like(p).scatter_(-1, ax, -torch.sign(dc)[ax])
        return hit, p, nc @ R


class CompositeScene:
    """Union of sub-scenes: nearest hit wins (t recovered as (p − o)·d)."""

    def __init__(self, *scenes):
        self.scenes = scenes

    def intersect(self, origins, d):
        shape = origins.shape[:-1]
        t_best = torch.full(shape, np.inf, dtype=F64, device=origins.device)
        p_best = torch.zeros_like(origins)
        n_best = torch.zeros_like(origins)
        any_hit = torch.zeros(shape, dtype=torch.bool, device=origins.device)
        for sc in self.scenes:
            hit, p, n = sc.intersect(origins, d)
            t = torch.sum((p - origins) * d, dim=-1)
            closer = hit & (t < t_best)
            t_best = torch.where(closer, t, t_best)
            p_best = torch.where(closer[..., None], p, p_best)
            n_best = torch.where(closer[..., None], n, n_best)
            any_hit = any_hit | hit
        return any_hit, p_best, n_best


def ornament_cube_scene(half_extent: float = 0.55, bump_radius: float = 0.3):
    """Corner-on cube with a bump sphere poking out of each face: the flat
    faces keep the polyhedron's sharp silhouettes and locally planar patches
    (homography-degenerate pairs), the bumps give every view the 3-D relief
    orthographic SfM needs (a pure plane is bas-relief-ambiguous)."""
    cube = CubeScene(half_extent=half_extent)
    blob = BlobScene.__new__(BlobScene)
    face_centers = half_extent * np.concatenate([np.eye(3), -np.eye(3)], 0)
    blob.centers = face_centers @ cube.R  # cube frame → world (Rᵀ·c)
    blob.radii = np.full(6, bump_radius)
    return CompositeScene(cube, blob)


class RingsScene(BlobScene):
    """Two interlocking rings of small spheres, the counterpart of the
    reference's Rings dataset: strongly non-planar, self-occluding, with
    thin structures and holes."""

    def __init__(self, n_per_ring: int = 14, ring_radius: float = 0.62,
                 tube_radius: float = 0.21):
        ang = np.linspace(0, 2 * np.pi, n_per_ring, endpoint=False)
        ring_a = np.stack([ring_radius * np.cos(ang), ring_radius * np.sin(ang),
                           np.zeros_like(ang)], -1)
        ring_b = np.stack([ring_radius * np.cos(ang) + ring_radius, np.zeros_like(ang),
                           ring_radius * np.sin(ang)], -1)
        ring_b[:, 0] -= ring_radius * 0.5
        self.centers = np.concatenate([ring_a, ring_b], 0)
        self.radii = np.full(len(self.centers), tube_radius)


def _fma(a, b, c):
    """a·b + c rounded once to f32, as the JAX package's f32 arithmetic forms
    it (XLA contracts a product and a sum into one FMA): the product of two
    f32 is exact in f64."""
    return (a.double() * b.double() + c.double()).float()


def _dot3(a, b):
    """Σₖ a[..., k]·b[k] over the last axis of 3 as XLA computes it: an FMA
    chain from k = 0."""
    return _fma(a[..., 2], b[..., 2], _fma(a[..., 1], b[..., 1], a[..., 0] * b[..., 0]))


class PointCloudScene:
    """A surface rendered from a vertex cloud as a union of small spheres.
    Each chunk of rays finds its nearest sphere hit at once: the o·c term of
    the |o − c|² expansion is an (N, 3)·(3, P) torch.matmul on the rays'
    device. The arithmetic is the JAX package's f32 with its FMAs (_fma):
    the expansion cancels ~100 against a squared radius of ~1e-3, so another
    rounding moves the nearest hit among overlapping spheres.

    The counterpart of the reference's Suzanne image sets: the reference
    ships only `resources/Suzanne.ply` vertices (its image datasets are
    external Blender renders), so the surface here is the vertex cloud itself
    inflated by ~1.5× its nearest-neighbour spacing."""

    def __init__(self, points: np.ndarray, radius: float | None = None, chunk: int = 16384):
        self.points = np.asarray(points, np.float32)
        if radius is None:
            radius = 1.5 * _median_nn_spacing(self.points)
        self.radius = float(radius)
        self.chunk = chunk

    def intersect(self, origins, d):
        device = origins.device
        c = torch.as_tensor(self.points, device=device)  # (P, 3)
        r = torch.tensor(self.radius, dtype=torch.float32, device=device)
        r2 = torch.tensor(self.radius * self.radius, dtype=torch.float32, device=device)
        c_sq = _dot3(c, c)  # (P,)
        d32 = d.to(torch.float32)
        cd = _dot3(c, d32)  # (P,)
        shape = origins.shape[:-1]
        o_flat = origins.to(torch.float32).reshape(-1, 3)
        hits, ps, ns = [], [], []
        for s in range(0, o_flat.shape[0], self.chunk):
            o = o_flat[s:s + self.chunk]
            b = _dot3(o, d32)[:, None] - cd[None, :]  # (N, P)
            dist2 = (_dot3(o, o)[:, None] + c_sq[None, :]) - 2.0 * (o @ c.T)
            disc = _fma(b, b, -dist2) + r2
            hit = disc > 0.0
            t = -b - torch.sqrt(torch.clamp(disc, min=0.0))
            t = torch.where(hit, t, np.inf)
            idx = torch.argmin(t, dim=-1)  # (N,)
            t_best = torch.gather(t, 1, idx[:, None])[:, 0]
            ok = torch.isfinite(t_best)
            p = _fma(torch.where(ok, t_best, 0.0)[:, None], d32, o)
            hits.append(ok)
            ps.append(p)
            ns.append((p - c[idx]) / r)
        hit = torch.cat(hits).reshape(shape)
        p = torch.cat(ps).reshape(*shape, 3).to(F64)
        n = torch.cat(ns).reshape(*shape, 3).to(F64)
        return hit, p, n


def _median_nn_spacing(pts: np.ndarray, sample: int = 2000, seed: int = 0) -> float:
    """Median nearest-neighbour distance over a sample of the cloud (host
    numpy, as in the JAX package). Exported PLYs often duplicate vertices per
    flat-shaded face (Blender's Suzanne does), which would put the spacing at
    exactly 0: dedupe first and floor the result by the cloud extent."""
    pts = np.unique(np.asarray(pts, np.float32), axis=0)
    rng = np.random.default_rng(seed)
    idx = (rng.choice(len(pts), sample, replace=False)
           if len(pts) > sample else np.arange(len(pts)))
    sub = pts[idx]
    d2 = np.sum((sub[:, None] - pts[None]) ** 2, -1)
    d2[np.arange(len(sub)), idx] = np.inf
    spacing = float(np.median(np.sqrt(d2.min(axis=1))))
    extent = float(np.linalg.norm(pts.max(0) - pts.min(0)))
    return max(spacing, 1e-3 * extent)


def suzanne_scene(seed: int = 0):
    """The Suzanne vertex cloud of the reference's resources
    (src/testbench/dataset_generation.cpp:95-137 loads the same PLY for the
    synthetic track tests) as a PointCloudScene; the blob scene when the
    resources are not there (data.synthetic.reference_cloud)."""
    from orthosfm_torch.data import synthetic

    pts = synthetic.reference_cloud("Suzanne")
    if pts is None:
        return BlobScene(seed=seed + 31)
    return PointCloudScene(pts)


SCENES = {
    "sphere": lambda seed: SphereScene(),
    "blob": lambda seed: BlobScene(seed=seed + 31),
    "cube": lambda seed: CubeScene(),
    "ornament_cube": lambda seed: ornament_cube_scene(),
    "rings": lambda seed: RingsScene(),
    "suzanne": suzanne_scene,
}


def _basis_f32(cams: cam_mod.CameraSet):
    """The cameras' f32 world-axes basis as the JAX package's renderer takes
    it. For Euler cameras it is core.cameras' product Cᵀ·Rz·Rx·Rz in f32, but
    with cos/sin rounded from float64: the JAX package's f32 cos/sin is
    correctly rounded, torch's vectorized one can be an ulp off, and the
    texture turns that ulp into a grey level on ~0.3% of the pixels."""
    if cams.kind != "euler":
        return cam_mod.basis(cams)
    phi, theta, roll = cams.rot[..., :3].unbind(-1)
    omega = theta + 0.5 * np.pi
    (cph, sph), (com, som), (crl, srl) = (
        (torch.cos(a.double()).to(a.dtype), torch.sin(a.double()).to(a.dtype))
        for a in (phi, omega, roll))
    z, o = torch.zeros_like(phi), torch.ones_like(phi)
    Rz = cam_mod._mat([[cph, -sph, z], [sph, cph, z], [z, z, o]])
    Rx = cam_mod._mat([[o, z, z], [z, com, -som], [z, som, com]])
    Rr = cam_mod._mat([[crl, -srl, z], [srl, crl, z], [z, z, o]])
    S = Rz @ Rx @ Rr
    return cam_mod.coord_transform(S).T @ S


def render_views(gt_cams: cam_mod.CameraSet, width: int, height: int, scene,
                 texture: FourierTexture3D | None = None, return_masks: bool = False,
                 device=None):
    """Ray-trace each camera's orthographic view of the scene on `device`
    (default: the cameras' device). Returns a list of (height, width, 3)
    uint8 tensors on that device.

    With return_masks, also returns per-view uint8 foreground masks (255
    where a scene surface is hit) in the reference's mask convention:
    brightness > 16 = foreground (src/data_structures/view.cpp:100-112)."""
    texture = texture or FourierTexture3D()
    device = gt_cams.device if device is None else torch.device(device)
    R_all = _basis_f32(gt_cams).to(device=device, dtype=F64)  # (V, 3, 3)
    o_all = R_all @ torch.tensor([0.0, 0.0, -cam_mod.CAMERA_DISTANCE], dtype=F64,
                                 device=device)
    scales = gt_cams.scale.to(device=device, dtype=F64)
    offsets = gt_cams.offset.to(device=device, dtype=F64)

    xs = torch.arange(width, dtype=F64, device=device)
    ys = torch.arange(height, dtype=F64, device=device)
    py, px = torch.meshgrid(ys, xs, indexing="ij")  # (H, W)

    images, masks = [], []
    for v in range(len(gt_cams)):
        R = R_all[v]
        # Pixel → point on camera plane (reference: OrthographicCamera.cpp:187-193)
        xn = -2.0 * (px / width - 0.5) + offsets[v, 0]
        yn = -2.0 * (py / height - 0.5) + offsets[v, 1]
        origin = o_all[v] + scales[v] * (xn[..., None] * R[:, 0] + yn[..., None] * R[:, 1])
        d = R[:, 2]  # look direction (unit)
        hit, p_hit, normal = scene.intersect(origin, d)
        # Slight lambert-style modulation for silhouette stability
        lam = 0.75 + 0.25 * torch.clamp(-(normal @ d), 0.0, 1.0)
        shade = torch.where(hit, texture(p_hit) * lam, 0.55)
        g = (torch.clamp(shade, 0, 1) * 255).to(torch.uint8)
        images.append(torch.stack([g, g, g], dim=-1))
        if return_masks:
            masks.append(torch.where(hit, 255, 0).to(torch.uint8))
    if return_masks:
        return images, masks
    return images


def render_sphere_views(gt_cams: cam_mod.CameraSet, width: int, height: int,
                        radius: float = 0.75, texture: FourierTexture3D | None = None,
                        device=None) -> List[torch.Tensor]:
    """render_views of a single textured sphere."""
    return render_views(gt_cams, width, height, SphereScene(radius=radius), texture=texture,
                        device=device)


def trajectory_angles(trajectory: str, num_views: int, ring_degrees: float,
                      theta_range: float, roll_range: float,
                      rng: np.random.Generator) -> np.ndarray:
    """(V, 3) [phi, theta, roll] GT camera angles for a named trajectory
    family (the reference's eval sets come in Circle / 3Lat / 3Lat_rotated
    variants, full_pipeline_tests.cpp:404-412):

    circle        — one ring at the equator with small random theta/roll
                    jitter (view 0 pinned to identity);
    3lat          — three latitude bands (theta = +lat, 0, −lat), each a
                    phi ring, roll = 0 everywhere;
    3lat_rotated  — 3lat with per-view random roll ∈ ±roll_range.
    """
    if trajectory == "circle":
        phis = np.deg2rad(np.linspace(0.0, ring_degrees, num_views, endpoint=False))
        thetas = np.deg2rad(rng.uniform(-theta_range, theta_range, num_views))
        rolls = np.deg2rad(rng.uniform(-roll_range, roll_range, num_views))
        thetas[0] = rolls[0] = 0.0
        return np.stack([phis, thetas, rolls], -1).astype(np.float32)
    if trajectory in ("3lat", "3lat_rotated"):
        lat = np.deg2rad(max(theta_range, 20.0))
        # Equator band first, so view 0 sits at (phi 0, theta 0, roll 0)
        band_theta = [0.0, lat, -lat]
        counts = [num_views - 2 * (num_views // 3), num_views // 3, num_views // 3]
        phis, thetas, rolls = [], [], []
        for b, (th, n) in enumerate(zip(band_theta, counts)):
            # Stagger bands by a fraction of a step so columns don't repeat
            ph = np.linspace(0.0, ring_degrees, n, endpoint=False)
            ph += b * ring_degrees / max(n, 1) / 3.0
            phis += list(np.deg2rad(ph))
            thetas += [th] * n
            if trajectory == "3lat_rotated":
                rolls += list(np.deg2rad(rng.uniform(-max(roll_range, 15.0),
                                                     max(roll_range, 15.0), n)))
            else:
                rolls += [0.0] * n
        rolls[0] = 0.0
        return np.stack([phis, thetas, rolls], -1).astype(np.float32)
    raise ValueError(f"unknown trajectory {trajectory!r}")


def make_scene_views(num_views: int = 8, width: int = 256, height: int = 256,
                     seed: int = 0, theta_range: float = 10.0, roll_range: float = 6.0,
                     ring_degrees: float = 360.0, radius: float = 0.75,
                     scene: str = "sphere", trajectory: str = "circle", device="cuda"):
    """(GT cameras, images, masks) of make_image_dataset, rendered on
    `device` (CUDA unless the caller names the CPU) and kept in memory."""
    from orthosfm_torch.pipeline.matching import checked_device

    device = checked_device(device)
    rng = np.random.default_rng(seed)
    angles = trajectory_angles(trajectory, num_views, ring_degrees, theta_range,
                               roll_range, rng)
    gt = cam_mod.make_euler(np.arange(num_views), width, height, angles=angles,
                            device=device)
    texture = FourierTexture3D(seed=seed + 17)
    sc = SphereScene(radius=radius) if scene == "sphere" else SCENES[scene](seed)
    images, masks = render_views(gt, width, height, sc, texture=texture, return_masks=True)
    return gt, images, masks


def make_image_dataset(folder: str, num_views: int = 8, width: int = 256,
                       height: int = 256, seed: int = 0, theta_range: float = 10.0,
                       roll_range: float = 6.0, ring_degrees: float = 360.0,
                       radius: float = 0.75, scene: str = "sphere",
                       trajectory: str = "circle", mask_folder: str = "", device="cuda"):
    """Write a synthetic rendered image dataset as PNGs (rendered on
    `device`, CUDA unless the caller names the CPU); returns the GT cameras,
    on `device`. scene:
    a key of SCENES; trajectory: "circle" | "3lat" | "3lat_rotated"
    (trajectory_angles). mask_folder: also write per-view foreground masks
    `{name}_mask.png` there (reference mask discovery:
    src/data_structures/view.cpp:84-98)."""
    import os

    from PIL import Image

    gt, images, masks = make_scene_views(num_views, width, height, seed, theta_range,
                                         roll_range, ring_degrees, radius, scene, trajectory,
                                         device=device)
    os.makedirs(folder, exist_ok=True)
    for i, img in enumerate(images):
        Image.fromarray(img.cpu().numpy()).save(os.path.join(folder, f"view_{i:02d}.png"))
    if mask_folder:
        os.makedirs(mask_folder, exist_ok=True)
        for i, mk in enumerate(masks):
            Image.fromarray(mk.cpu().numpy()).save(
                os.path.join(mask_folder, f"view_{i:02d}_mask.png"))
    return gt
