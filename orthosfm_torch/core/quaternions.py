"""Quaternion utilities (w, x, y, z convention, scalar-first).

Plain torch functions; everything broadcasts over leading batch dimensions.
Port of orthosfm_tpu/core/quaternions.py (reference: Eigen::Quaternion in
src/algorithms/orthographic_quaternion/OrthoQuaternionCamera.cpp:14-83).
"""

from __future__ import annotations

import torch


def normalize(q):
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def multiply(a, b):
    """Hamilton product a ⊗ b, both (..., 4) scalar-first."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def conjugate(q):
    return q * q.new_tensor([1.0, -1.0, -1.0, -1.0])


def to_matrix(q):
    """Unit quaternion (..., 4) -> rotation matrix (..., 3, 3)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def from_matrix(m):
    """Rotation matrix (..., 3, 3) -> unit quaternion (..., 4), scalar-first.

    Computes all four candidate extractions and selects the numerically best
    by the largest pivot (the same branch-free rule as the JAX package)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def s_of(x):
        return torch.sqrt(torch.clamp(x, min=1e-12)) * 2.0

    s = s_of(1.0 + tr)
    cw = torch.stack([0.25 * s, (m21 - m12) / s, (m02 - m20) / s, (m10 - m01) / s], -1)
    s = s_of(1.0 + m00 - m11 - m22)
    cx = torch.stack([(m21 - m12) / s, 0.25 * s, (m01 + m10) / s, (m02 + m20) / s], -1)
    s = s_of(1.0 - m00 + m11 - m22)
    cy = torch.stack([(m02 - m20) / s, (m01 + m10) / s, 0.25 * s, (m12 + m21) / s], -1)
    s = s_of(1.0 - m00 - m11 + m22)
    cz = torch.stack([(m10 - m01) / s, (m02 + m20) / s, (m12 + m21) / s, 0.25 * s], -1)

    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22, -m00 - m11 + m22], -1)
    cands = torch.stack([cw, cx, cy, cz], -2)  # (..., 4 cand, 4)
    idx = torch.argmax(pivots, dim=-1)
    q = torch.gather(cands, -2, idx[..., None, None].expand(idx.shape + (1, 4)))
    return normalize(q[..., 0, :])


def exp_map(delta):
    """Angle-axis tangent (..., 3) -> unit quaternion, matching Ceres
    EigenQuaternionParameterization::Plus step construction."""
    a2 = torch.sum(delta * delta, dim=-1, keepdim=True)
    small = a2 < 1e-12
    angle = torch.sqrt(torch.where(small, torch.ones_like(a2), a2))
    k = torch.where(small, 0.5 - a2 / 48.0, torch.sin(0.5 * angle) / angle)
    w = torch.where(small, 1.0 - a2 / 8.0, torch.cos(0.5 * angle))
    return torch.cat([w, k * delta], dim=-1)


def from_to_rotation(q_from, q_to):
    """Relative rotation from⁻¹ ⊗ to, normalized (reference:
    OrthoQuaternionCamera.cpp:34-43)."""
    return normalize(multiply(conjugate(normalize(q_from)), normalize(q_to)))


def slerp(q0, q1, t):
    """Spherical linear interpolation (reference uses Eigen slerp at
    OrthoQuaternionRecoAlgorithm.cpp:100)."""
    d = torch.sum(q0 * q1, dim=-1, keepdim=True)
    q1 = torch.where(d < 0, -q1, q1)
    d = torch.clamp(torch.abs(d), -1.0, 1.0)
    theta = torch.arccos(d)
    sin_theta = torch.sin(theta)
    use_lerp = sin_theta < 1e-6
    safe_sin = torch.where(use_lerp, torch.ones_like(sin_theta), sin_theta)
    w0 = torch.where(use_lerp, 1.0 - t, torch.sin((1.0 - t) * theta) / safe_sin)
    w1 = torch.where(use_lerp, t * torch.ones_like(theta), torch.sin(t * theta) / safe_sin)
    return normalize(w0 * q0 + w1 * q1)


def angular_distance(q0, q1):
    """Angle in radians between two rotations (Eigen angularDistance analog;
    reference: full_pipeline_tests.cpp:281)."""
    rel = multiply(conjugate(normalize(q0)), normalize(q1))
    vec_norm = torch.linalg.vector_norm(rel[..., 1:], dim=-1)
    return 2.0 * torch.atan2(vec_norm, torch.abs(rel[..., 0]))
