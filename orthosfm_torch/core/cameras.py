"""Orthographic camera models as a dataclass of tensors.

Port of orthosfm_tpu/core/cameras.py, which replaces the reference's
`Camera` class hierarchy (src/data_structures/Camera.h,
src/algorithms/orthographic/OrthographicCamera.{h,cpp},
src/algorithms/orthographic_quaternion/OrthoQuaternionCamera.{h,cpp}) with a
single `CameraSet` covering all four solver parameterizations behind plain
functions.

Conventions (matching the reference exactly):
- Euler spherical rotation  S(phi, theta, roll) = Rz(phi) · Rx(theta + π/2) · Rz'(roll)
  (reference: OrthographicCamera.cpp:78-95).
- Coordinate transform C = [[1,0,0],[0,0,-1],[0,1,0]] maps the world up-axis (y)
  to the spherical system's z (reference: OrthographicCamera.cpp:128-134).
- World→local: p_local = Sᵀ · C · p (Euler) or p_local = q⁻¹ · p (quaternion);
  the local→world rotation is R = Cᵀ·S, or R(q).
- Pixel projection with both axes mirrored (reference: OrthographicCamera.cpp:63-76):
      x_pix = W · ((p_local.x/scale − offX)/(−2) + 0.5)
      y_pix = H · ((p_local.y/scale − offY)/(−2) + 0.5)
- Camera origin sits at distance 10 behind the target: origin = R · (0,0,−10).
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import torch

from orthosfm_torch.config import SolverType
from orthosfm_torch.core import quaternions as quat

CAMERA_DISTANCE = 10.0
# Tangent layout for BA (both parameterizations): [r0, r1, r2, offX, offY, scale]
CAMERA_TANGENT_DIM = 6

# The coordinate-system transform C (reference: OrthographicCamera.cpp:128-134)
_COORD_TRANSFORM = ((1.0, 0.0, 0.0), (0.0, 0.0, -1.0), (0.0, 1.0, 0.0))
# A camera's origin in its own frame, (0, 0, -d) (reference: OrthographicCamera.cpp:58-61)
_DOWN = (0.0, 0.0, -CAMERA_DISTANCE)


@functools.lru_cache(maxsize=None)
def _constant(values: tuple, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """``values`` as a tensor, made once a (device, dtype): a copy from the
    host on every call would synchronize the host with a card, and cannot
    be captured in a CUDA graph. Callers only read it."""
    return torch.tensor(values, dtype=dtype, device=device)


def coord_transform(like: torch.Tensor) -> torch.Tensor:
    """C as a (3, 3) tensor on ``like``'s device and dtype (made once)."""
    return _constant(_COORD_TRANSFORM, like.device, like.dtype)


def down(like: torch.Tensor) -> torch.Tensor:
    """(0, 0, -CAMERA_DISTANCE) as a (3,) tensor on ``like``'s device and
    dtype (made once): R @ down(R) is the origin of the camera of basis R."""
    return _constant(_DOWN, like.device, like.dtype)


@dataclasses.dataclass
class CameraSet:
    """A batch of cameras for one solver type.

    ``rot`` is interpreted per ``kind``:
      - kind == 'euler': rot[..., :3] = (phi, theta, roll) radians (col 3 unused)
      - kind == 'quat' : rot[..., :4] = unit quaternion (w, x, y, z)
    """

    rot: torch.Tensor  # (V, 4) f32
    offset: torch.Tensor  # (V, 2) f32
    scale: torch.Tensor  # (V,) f32
    width: torch.Tensor  # (V,) f32
    height: torch.Tensor  # (V,) f32
    view_ids: torch.Tensor  # (V,) int32
    fixed: torch.Tensor  # (V,) bool — fully-fixed cameras (gauge anchoring)
    kind: str = "quat"
    solver: int = int(SolverType.ORTHO_QUATERNION)

    def __len__(self):
        return self.rot.shape[0]

    @property
    def device(self) -> torch.device:
        return self.rot.device

    def replace(self, **changes) -> "CameraSet":
        return dataclasses.replace(self, **changes)


def from_numpy(src, device="cpu") -> CameraSet:
    """CameraSet from any object with CameraSet's fields as arrays (for
    example the JAX package's CameraSet); floats are cast to f32."""
    def f32(x):
        return torch.as_tensor(np.array(x, np.float32), device=device)

    return CameraSet(
        rot=f32(src.rot), offset=f32(src.offset), scale=f32(src.scale),
        width=f32(src.width), height=f32(src.height),
        view_ids=torch.as_tensor(np.array(src.view_ids, np.int32), device=device),
        fixed=torch.as_tensor(np.array(src.fixed, bool), device=device),
        kind=str(src.kind), solver=int(src.solver))


# ---------------------------------------------------------------------------
# Construction


def _vec(x, n, default, device):
    if x is None:
        return torch.full((n,), default, dtype=torch.float32, device=device)
    if not isinstance(x, torch.Tensor):
        x = np.array(x, np.float32)
    return torch.broadcast_to(torch.as_tensor(x, dtype=torch.float32, device=device),
                              (n,)).clone()


def as_index(idx, device, dtype=torch.long):
    """``idx`` as a ``dtype`` tensor on ``device``. A tensor already there is
    used as it is, never read back to the host; only a host sequence is
    copied to the device."""
    if isinstance(idx, torch.Tensor):
        return idx.to(device=device, dtype=dtype)
    return torch.as_tensor(np.asarray(idx), dtype=dtype, device=device)


def make_euler(view_ids, width, height, angles=None, offset=None, scale=None,
               solver: SolverType = SolverType.ORTHO_EULER_ALL_DOF,
               device=None) -> CameraSet:
    if device is None:
        device = angles.device if isinstance(angles, torch.Tensor) else "cpu"
    v = as_index(view_ids, device, torch.int32)
    n = v.shape[0]
    ang = (torch.zeros((n, 3), device=device) if angles is None
           else torch.as_tensor(angles, dtype=torch.float32, device=device))
    rot = torch.cat([ang, torch.zeros((n, 1), dtype=ang.dtype, device=device)], dim=-1)
    return CameraSet(
        rot=rot,
        offset=(torch.zeros((n, 2), device=device) if offset is None
                else torch.as_tensor(offset, dtype=torch.float32, device=device)),
        scale=_vec(scale, n, 1.0, device),
        width=_vec(width, n, 0.0, device),
        height=_vec(height, n, 0.0, device),
        view_ids=v,
        fixed=torch.zeros((n,), dtype=torch.bool, device=device),
        kind="euler",
        solver=int(solver),
    )


def make_quaternion(view_ids, width, height, q=None, offset=None, scale=None,
                    device=None) -> CameraSet:
    if device is None:
        device = q.device if isinstance(q, torch.Tensor) else "cpu"
    v = as_index(view_ids, device, torch.int32)
    n = v.shape[0]
    if q is None:
        q = torch.tensor([[1.0, 0.0, 0.0, 0.0]], device=device).repeat(n, 1)
    return CameraSet(
        rot=torch.as_tensor(q, dtype=torch.float32, device=device),
        offset=(torch.zeros((n, 2), device=device) if offset is None
                else torch.as_tensor(offset, dtype=torch.float32, device=device)),
        scale=_vec(scale, n, 1.0, device),
        width=_vec(width, n, 0.0, device),
        height=_vec(height, n, 0.0, device),
        view_ids=v,
        fixed=torch.zeros((n,), dtype=torch.bool, device=device),
        kind="quat",
        solver=int(SolverType.ORTHO_QUATERNION),
    )


def euler_free_angles(solver: SolverType, device="cpu"):
    """(3,) bool: which of (phi, theta, roll) are free for an Euler solver
    (reference: OrthographicCamera.cpp:195-207); made once a device."""
    dof = solver.degrees_of_freedom
    return _constant((dof >= 1, dof >= 2, dof >= 3), torch.device(device), torch.bool)


def basis_rotations(basis, solver: SolverType):
    """The rotation parameters (V, 4), as CameraSet.rot holds them for
    ``solver``, of local→world basis matrices (V, 3, 3) (columns = x/y/z
    world axes): a unit quaternion, or the free Euler angles and a zero
    (reference: tomasi_kanade.cpp:169-191)."""
    basis = basis.to(torch.float32)
    if solver.is_quaternion:
        return quat.from_matrix(basis)
    angles = basis_to_phi_theta_roll(basis)
    angles = torch.where(euler_free_angles(solver, basis.device)[None, :], angles,
                         torch.zeros_like(angles))
    return torch.cat([angles, torch.zeros_like(angles[:, :1])], dim=-1)


def with_rotations(rot, view_ids, width, height, solver: SolverType) -> CameraSet:
    """Cameras of ``solver`` with the rotation parameters ``rot`` (V, 4)
    (basis_rotations' form) and default offsets and scales."""
    if solver.is_quaternion:
        return make_quaternion(view_ids, width, height, q=rot)
    return make_euler(view_ids, width, height, angles=rot[:, :3], solver=solver)


def from_basis(basis, view_ids, width, height, solver: SolverType) -> CameraSet:
    """Build cameras from local→world basis matrices (columns = x/y/z world
    axes), as the TK init produces (reference: tomasi_kanade.cpp:169-191)."""
    return with_rotations(basis_rotations(basis, solver), view_ids, width, height, solver)


# ---------------------------------------------------------------------------
# Rotation representations


def _mat(rows):
    return torch.stack([torch.stack(r, -1) for r in rows], -2)


def _euler_factors(angles):
    phi, theta, roll = angles.unbind(-1)
    omega = theta + 0.5 * math.pi
    cph, sph = torch.cos(phi), torch.sin(phi)
    com, som = torch.cos(omega), torch.sin(omega)
    crl, srl = torch.cos(roll), torch.sin(roll)
    z = torch.zeros_like(phi)
    o = torch.ones_like(phi)
    Rz = _mat([[cph, -sph, z], [sph, cph, z], [z, z, o]])
    Rx = _mat([[o, z, z], [z, com, -som], [z, som, com]])
    Rr = _mat([[crl, -srl, z], [srl, crl, z], [z, z, o]])
    dRz = _mat([[-sph, -cph, z], [cph, -sph, z], [z, z, z]])
    dRx = _mat([[z, z, z], [z, -som, -com], [z, com, -som]])
    dRr = _mat([[-srl, -crl, z], [crl, -srl, z], [z, z, z]])
    return (Rz, Rx, Rr), (dRz, dRx, dRr)


def spherical_matrix(angles):
    """S = Rz(phi) · Rx(theta+π/2) · Rz(roll); angles (..., 3) = (phi, theta, roll)."""
    (Rz, Rx, Rr), _ = _euler_factors(angles)
    return Rz @ Rx @ Rr


def spherical_matrix_derivs(angles):
    """∂S/∂(phi, theta, roll): angles (..., 3) → (..., 3 param, 3, 3)."""
    (Rz, Rx, Rr), (dRz, dRx, dRr) = _euler_factors(angles)
    return torch.stack([dRz @ Rx @ Rr, Rz @ dRx @ Rr, Rz @ Rx @ dRr], dim=-3)


def basis_to_phi_theta_roll(basis, apply_coordinate_transform: bool = True):
    """World-axes basis (columns x,y,z) -> (phi, theta, roll)
    (reference: OrthographicCamera.cpp:151-181)."""
    b = basis
    if apply_coordinate_transform:
        b = coord_transform(b) @ b
    phi = torch.atan2(-b[..., 1, 2], -b[..., 0, 2]) - 0.5 * math.pi
    col2_norm = torch.linalg.vector_norm(b[..., :, 2], dim=-1)
    theta = torch.arccos(torch.clamp(b[..., 2, 2] / col2_norm, -1.0, 1.0)) - 0.5 * math.pi
    omega = theta + 0.5 * math.pi
    cph, sph = torch.cos(phi), torch.sin(phi)
    com, som = torch.cos(omega), torch.sin(omega)
    z = torch.zeros_like(phi)
    o = torch.ones_like(phi)
    Rz = _mat([[cph, -sph, z], [sph, cph, z], [z, z, o]])
    Rx = _mat([[o, z, z], [z, com, -som], [z, som, com]])
    test_axis = (Rz @ Rx).transpose(-1, -2) @ b[..., :, 0:1]
    roll = torch.atan2(test_axis[..., 1, 0], test_axis[..., 0, 0])
    return torch.stack([phi, theta, roll], dim=-1)


def rotation_matrices(kind: str, rot):
    """Local→world rotation matrices (V, 3, 3) of the rotation parameters
    ``rot`` (V, 4) of cameras of ``kind``: Euler R = Cᵀ·S, quaternion R(q)."""
    if kind == "quat":
        return quat.to_matrix(quat.normalize(rot))
    S = spherical_matrix(rot[..., :3])
    return coord_transform(S).T @ S


def rotation_l2w(cams: CameraSet):
    """Local→world rotation matrices (V, 3, 3): Euler R = Cᵀ·S, quaternion R(q)."""
    return rotation_matrices(cams.kind, cams.rot)


def basis(cams: CameraSet):
    """World-space axes as matrix columns [x y z] — same as rotation_l2w."""
    return rotation_l2w(cams)


def origins(cams: CameraSet):
    """Camera centers R·(0,0,−d) (reference: OrthographicCamera.cpp:58-61)."""
    R = rotation_l2w(cams)
    return R @ R.new_tensor([0.0, 0.0, -CAMERA_DISTANCE])


def look_directions(cams: CameraSet):
    """World-space viewing direction = z axis (reference: OrthographicCamera.cpp:183-185)."""
    return rotation_l2w(cams)[..., :, 2]


# ---------------------------------------------------------------------------
# Projection / unprojection


def dehomogenize(points4):
    w = points4[..., 3:4]
    safe_w = torch.where(torch.abs(w) < 1e-12,
                         torch.where(w < 0, -1e-12, 1e-12).to(w.dtype), w)
    return points4[..., :3] / safe_w


def project_from_params(R_l2w, offset, scale, width, height, points4):
    """Project homogeneous points with explicit rotation and intrinsics.

    R_l2w (..., 3, 3); offset (..., 2); scale, width, height (...,);
    points4 (..., 4) → pixels (..., 2).
    (reference: OrthographicCamera.cpp:63-76 and the two residual functors.)
    """
    p = dehomogenize(points4)
    local = torch.einsum("...ij,...i->...j", R_l2w, p)  # Rᵀ·p via contraction over rows
    proj = local[..., :2] / scale[..., None]
    xy = (proj - offset) / (-2.0) + 0.5
    return torch.stack([width, height], dim=-1) * xy


def project(cams: CameraSet, points4):
    """Project points (T, 4) through every camera → pixels (V, T, 2)."""
    R = rotation_l2w(cams)  # (V, 3, 3)
    p = dehomogenize(points4)  # (T, 3)
    local = torch.einsum("vij,ti->vtj", R, p)
    proj = local[..., :2] / cams.scale[:, None, None]
    xy = (proj - cams.offset[:, None, :]) / (-2.0) + 0.5
    wh = torch.stack([cams.width, cams.height], dim=-1)
    return wh[:, None, :] * xy


def pixel_to_plane_point(cams: CameraSet, pixels):
    """Ray origins on the camera plane for pixel coords (V, T, 2) → (V, T, 3)
    (reference: OrthographicCamera.cpp:187-193, OrthoQuaternionCamera.cpp:49-59)."""
    wh = torch.stack([cams.width, cams.height], dim=-1)[:, None, :]
    norm = -2.0 * (pixels / wh - 0.5) + cams.offset[:, None, :]
    R = rotation_l2w(cams)
    x_axis = R[..., :, 0][:, None, :]
    y_axis = R[..., :, 1][:, None, :]
    o = origins(cams)[:, None, :]
    s = cams.scale[:, None, None]
    return o + s * (norm[..., 0:1] * x_axis + norm[..., 1:2] * y_axis)


# ---------------------------------------------------------------------------
# BA manifold: free-parameter masks and retraction


def _base_free(cams: CameraSet):
    if cams.kind == "quat":
        return [True, True, True, True, True, False]
    dof = SolverType(cams.solver).degrees_of_freedom
    return [dof >= 1, dof >= 2, dof >= 3, dof >= 4, dof >= 4, dof >= 5]


def free_mask(cams: CameraSet):
    """Per-camera (V, 6) mask of free tangent coordinates.

    Mirrors Ceres SetParameterBlockConstant wiring:
      - quaternion solver: rotation + offset free, scale fixed
        (OrthoQuaternionCamera.h:89-91, OrthoQuaternionRecoAlgorithm.cpp:141-145)
      - Euler solvers by dof: 1→phi; 2→phi,theta; 4→phi,theta,roll,offset
        (OrthographicCamera.cpp:195-207); offset/scale default-fixed
        (OrthographicCamera.h:133-134).
      - a fully `fixed` camera freezes everything (gauge anchor,
        reconstruct.cpp:215).

    The free slots are a prefix of the six, so the mask is built on the
    device from their count: a copy of a host list would synchronize the
    host with the card.
    """
    n_free = sum(_base_free(cams))
    base = torch.arange(CAMERA_TANGENT_DIM, device=cams.device) < n_free
    mask = torch.broadcast_to(base, (len(cams), CAMERA_TANGENT_DIM))
    return mask & ~cams.fixed[:, None]


def active_param_slots(cams: CameraSet) -> tuple:
    """Tangent slots whose free_mask base can be True for SOME camera —
    statically known from (kind, solver). The remaining slots are constant
    for every camera (Ceres never adds constant parameter blocks to the
    Schur system); solvers exclude them from the reduced camera system."""
    return tuple(i for i, on in enumerate(_base_free(cams)) if on)


def retract_rotation(kind: str, rot, delta):
    """Rotation parameters (V, 4) after the tangent step delta (V, 6).

    Quaternion rotation update follows Ceres EigenQuaternionParameterization:
    q ← exp(δ) ⊗ q. Euler angles update additively (IdentityParameterization).
    """
    if kind == "quat":
        return quat.normalize(quat.multiply(quat.exp_map(delta[..., :3]), rot))
    return torch.cat([rot[..., :3] + delta[..., :3], rot[..., 3:]], dim=-1)


def retract(cams: CameraSet, delta):
    """Apply a tangent step delta (V, 6) → new CameraSet: the rotation by
    retract_rotation, offsets and scale additively."""
    return cams.replace(
        rot=retract_rotation(cams.kind, cams.rot, delta),
        offset=cams.offset + delta[..., 3:5],
        scale=cams.scale + delta[..., 5],
    )


# ---------------------------------------------------------------------------
# Scene normalization / alignment (reference semantics)


def apply_rotation(cams: CameraSet, R_or_q):
    """Left-multiply a global rotation onto every camera; Euler cameras
    re-extract their free angles from the transformed axes (convertFromAxis)."""
    if cams.kind == "quat":
        q = R_or_q if R_or_q.shape[-1] == 4 else quat.from_matrix(R_or_q)
        return cams.replace(rot=quat.normalize(quat.multiply(q, quat.normalize(cams.rot))))
    R = R_or_q if R_or_q.shape[-1] == 3 else quat.to_matrix(R_or_q)
    angles = basis_to_phi_theta_roll(R @ rotation_l2w(cams))
    free = euler_free_angles(SolverType(cams.solver), cams.device)
    angles = torch.where(free[None, :], angles, cams.rot[..., :3])
    return cams.replace(rot=torch.cat([angles, cams.rot[..., 3:4]], dim=-1))


def normalize_scene_to_camera(cams: CameraSet, target_index):
    """Rotate all cameras so the target camera's basis becomes the identity
    (reference: OrthoQuaternionRecoAlgorithm.cpp:56-70,
    OrthographicReconstructionAlgorithm.cpp:69-99)."""
    Rt = rotation_l2w(cams)[target_index]
    if cams.kind == "quat":
        return apply_rotation(cams, quat.conjugate(quat.from_matrix(Rt)))
    return apply_rotation(cams, Rt.T)


def normalize_scene(cams: CameraSet):
    return normalize_scene_to_camera(cams, 0)


def concatenate(a: CameraSet, b: CameraSet) -> CameraSet:
    """The cameras of `a` then those of `b` (one kind and solver)."""
    if a.kind != b.kind or a.solver != b.solver:
        raise ValueError(f"cannot concatenate {a.kind}/{a.solver} and {b.kind}/{b.solver} "
                         "cameras")
    return CameraSet(**{f: torch.cat([getattr(a, f), getattr(b, f)])
                        for f in ("rot", "offset", "scale", "width", "height", "view_ids",
                                  "fixed")},
                     kind=a.kind, solver=a.solver)


def take(cams: CameraSet, indices) -> CameraSet:
    idx = as_index(indices, cams.device)
    return CameraSet(
        rot=cams.rot[idx], offset=cams.offset[idx], scale=cams.scale[idx],
        width=cams.width[idx], height=cams.height[idx],
        view_ids=cams.view_ids[idx], fixed=cams.fixed[idx],
        kind=cams.kind, solver=cams.solver)


def format_cameras(cams: CameraSet, mask=None) -> str:
    """Human-readable camera dump in the reference's print format
    (OrthographicCamera.cpp:146-149 / OrthoQuaternionCamera.cpp:23-32)."""
    angles = np.rad2deg(basis_to_phi_theta_roll(basis(cams)).cpu().numpy())
    off = cams.offset.cpu().numpy()
    sc = cams.scale.cpu().numpy()
    ids = cams.view_ids.cpu().numpy()
    lines = []
    for i in range(len(cams)):
        if mask is not None and not mask[i]:
            continue
        prefix = "Quaternion Camera" if cams.kind == "quat" else "Camera"
        lines.append(
            f"{prefix} {int(ids[i])} [phi: {angles[i, 0]:.4g}; "
            f"theta: {angles[i, 1]:.4g}; roll: {angles[i, 2]:.4g}; "
            f"offset ({off[i, 0]:.4g}; {off[i, 1]:.4g}); scale: {sc[i]:.4g}]")
    return "\n".join(lines)


def export_matrices(cams: CameraSet):
    """4×4 [X Y Z origin; 0 0 0 1] export matrices
    (reference: src/data_structures/camera_io.cpp:24-36)."""
    R = rotation_l2w(cams)
    top = torch.cat([R, origins(cams)[..., :, None]], dim=-1)  # (V, 3, 4)
    bottom = R.new_tensor([[[0.0, 0.0, 0.0, 1.0]]]).expand(len(cams), 1, 4)
    return torch.cat([top, bottom], dim=-2)
