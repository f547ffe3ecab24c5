"""The orthographic camera of OrthoSfM, written out plainly.

Upstream: src/algorithms/orthographic/OrthographicCamera.cpp:58-207 and
src/algorithms/orthographic_quaternion/OrthoQuaternionCamera.cpp:14-83.

- A camera is a local->world rotation R (3x3, columns are the camera's x, y
  and z axes in the world), an offset (2,) and a scale.
- World point X projects to local = R^T X and to the pixel
      pix = wh * (-(local_xy / scale - offset) / 2 + 1/2),
  both image axes mirrored.
- Euler cameras: R = C^T S(phi, theta, roll) with
  S = Rz(phi) Rx(theta + pi/2) Rz(roll) and C = Rx(pi/2).
- Quaternion cameras: R = R(q), q = (w, x, y, z), scalar first.
- The camera centre sits at R (0, 0, -10).

Everything here is plain PyTorch and works in any floating dtype; it imports
nothing of the program.
"""

from __future__ import annotations

import math

import torch

CAMERA_DISTANCE = 10.0


def rot_x(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([o, z, z], -1), torch.stack([z, c, -s], -1),
                        torch.stack([z, s, c], -1)], -2)


def rot_z(a):
    c, s = torch.cos(a), torch.sin(a)
    z, o = torch.zeros_like(a), torch.ones_like(a)
    return torch.stack([torch.stack([c, -s, z], -1), torch.stack([s, c, z], -1),
                        torch.stack([z, z, o], -1)], -2)


def euler_basis(angles):
    """(..., 3) (phi, theta, roll) in radians -> (..., 3, 3) local->world R."""
    phi, theta, roll = angles.unbind(-1)
    S = rot_z(phi) @ rot_x(theta + 0.5 * math.pi) @ rot_z(roll)
    C = rot_x(torch.full_like(phi, 0.5 * math.pi))
    return C.transpose(-1, -2) @ S


def euler_basis_derivs(angles):
    """d R / d (phi, theta, roll): (..., 3 angles, 3, 3)."""
    phi, theta, roll = angles.unbind(-1)
    omega = theta + 0.5 * math.pi
    Rz, Rx, Rr = rot_z(phi), rot_x(omega), rot_z(roll)
    dRz = rot_z(phi + 0.5 * math.pi) * torch.tensor([1.0, 1.0, 0.0], dtype=phi.dtype,
                                                    device=phi.device)[:, None]
    dRx = rot_x(omega + 0.5 * math.pi) * torch.tensor([0.0, 1.0, 1.0], dtype=phi.dtype,
                                                      device=phi.device)[:, None]
    dRr = rot_z(roll + 0.5 * math.pi) * torch.tensor([1.0, 1.0, 0.0], dtype=phi.dtype,
                                                     device=phi.device)[:, None]
    Ct = rot_x(torch.full_like(phi, 0.5 * math.pi)).transpose(-1, -2)
    return torch.stack([Ct @ dRz @ Rx @ Rr, Ct @ Rz @ dRx @ Rr, Ct @ Rz @ Rx @ dRr], dim=-3)


def quaternion_basis(q):
    """(..., 4) quaternion (w, x, y, z), normalised here -> (..., 3, 3) R."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    rows = [[1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
            [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
            [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]]
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def basis(kind: str, rot):
    """R from a camera's raw rotation parameters: `kind` "quat" reads
    rot[..., :4] as a quaternion, "euler" rot[..., :3] as angles."""
    return quaternion_basis(rot[..., :4]) if kind == "quat" else euler_basis(rot[..., :3])


def project(R, offset, scale, wh, X):
    """Pixels (V, T, 2) of points X (T, 3) in cameras R (V, 3, 3), offset
    (V, 2), scale (V,), wh (V, 2)."""
    local = torch.einsum("vij,ti->vtj", R, X)[..., :2]
    return wh[:, None, :] * (-(local / scale[:, None, None] - offset[:, None, :]) * 0.5 + 0.5)


def so3_exp(w):
    """Rotation matrices (..., 3, 3) of rotation vectors w (..., 3)."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)[..., None]
    z = torch.zeros_like(w[..., 0])
    K = torch.stack([torch.stack([z, -w[..., 2], w[..., 1]], -1),
                     torch.stack([w[..., 2], z, -w[..., 0]], -1),
                     torch.stack([-w[..., 1], w[..., 0], z], -1)], -2)
    small = theta < 1e-12
    t = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, torch.ones_like(theta), torch.sin(t) / t)
    b = torch.where(small, torch.full_like(theta, 0.5), (1 - torch.cos(t)) / (t * t))
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(K.shape)
    return eye + a * K + b * (K @ K)


def rotation_angle_deg(Ra, Rb):
    """Angle in degrees of Ra Rb^T, batched (from its skew part and trace, so
    that small angles keep their digits)."""
    M = Ra @ Rb.transpose(-1, -2)
    v = torch.stack([M[..., 2, 1] - M[..., 1, 2], M[..., 0, 2] - M[..., 2, 0],
                     M[..., 1, 0] - M[..., 0, 1]], -1)
    tr = torch.diagonal(M, dim1=-2, dim2=-1).sum(-1)
    return torch.rad2deg(torch.atan2(0.5 * torch.linalg.vector_norm(v, dim=-1), 0.5 * (tr - 1)))
