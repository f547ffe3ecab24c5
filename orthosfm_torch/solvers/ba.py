"""Bundle adjustment: Huber-robustified Levenberg–Marquardt with Schur
complement over point blocks (reference: Ceres SPARSE_SCHUR in
src/bundle_adjustment/bundle_adjustment.cpp:49-161).

Port of orthosfm_tpu/solvers/ba.py. The math is the same:
  - residual per observation r[t,v] = project(cam_v, point_t) − obs[t,v],
    Huber-weighted (δ=1.0) via IRLS weights;
  - closed-form manifold Jacobians: cameras use the 6-dim tangent of
    core.cameras.retract, points the 3-dim tangent of the unit sphere in R⁴
    (HomogeneousVectorParameterization analog);
  - the point blocks are eliminated (Schur), the reduced (6V×6V) camera
    system is solved densely with Jacobi preconditioning, point updates
    back-substitute per track;
  - fixed parameters are zeroed Jacobian columns + identity rows.

Per-observation tensors keep the track dimension T minor-most: r (V,2,T),
Jc (V,2,6,T), Jp (V,2,3,T).

`run` drives one LM loop of three stages (solvers/ba_kernels.py):
assemble → camera solve + retract → point update + cost + accept. It takes
one of three routes (config.impl, kernel_build.resolve_impl):
  - "fused": the whole solve in one cooperative CUDA launch (lm_fused,
    ba_kernels.lm_solve), which stops at convergence on the device. "auto"
    takes it on the card wherever ba_kernels.fused_fits holds: up to
    ba_kernels.FUSED_MAX_VIEWS (375) views, which covers the local BAs,
    the testbench and the global BAs of the 64- and 192-view runs, as the
    JAX package's ba.run takes its run_lm wherever ba_fused.fits() holds.
    The gate is the card's, not the JAX package's fits(): there the whole
    problem had to sit in VMEM; here the problem lives in device memory,
    and the limit is the per-view tables that the launch keeps in shared
    memory. Its camera solve is K3's own route at each size: one warp, one
    CTA (up to 37 views), the cluster of 8 CTAs (the launch then made in
    clusters), or from the crossover K3's grid route on every CTA.
  - "kernel": the hand-written CUDA kernels one iteration at a time
    (ba_kernels.lm_iterate), which serve any size: "auto" takes it on the
    card past FUSED_MAX_VIEWS views (the many-view problems). The loop
    enqueues ``max_iterations`` iterations with no host sync; a device
    `done` flag turns the converged ones into no-ops.
  - "torch": their plain PyTorch versions in the same loop ("auto" on the
    CPU, where reading `done` syncs nothing and the loop stops there).
The JAX package's "xla" and "pallas" name the "torch" and "kernel" routes,
and as there, "auto" with config.use_pallas false is the plain route on
every device.
Nothing falls back: a route that cannot serve a problem raises. The points
and cameras live in LM buffers of two halves; the scalar state names the
current one, and an accepted step flips it.
"""

from __future__ import annotations

import time
from typing import NamedTuple

import torch

from orthosfm_torch.config import BundleAdjustConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.kernel_build import resolve_impl
from orthosfm_torch.utils import profiling

# ---------------------------------------------------------------------------
# Homogeneous point manifold: track-major (..., 4) and track-minor (4, T)


def point_tangent_basis(p_hat):
    """Orthonormal basis (..., 4, 3) of the tangent space at unit p_hat ∈ S³,
    via the Householder reflection mapping e₃ → ∓p_hat (Ceres
    HomogeneousVectorParameterization's construction)."""
    sign = torch.where(p_hat[..., 3:4] >= 0, 1.0, -1.0).to(p_hat.dtype)
    v = p_hat + sign * p_hat.new_tensor([0.0, 0.0, 0.0, 1.0])
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    eye4 = torch.eye(4, dtype=p_hat.dtype, device=p_hat.device)
    H = eye4 - 2.0 * v[..., :, None] * v[..., None, :] / torch.clamp(vn2[..., None], min=1e-20)
    return H[..., :, :3]


def retract_point(p_hat, delta):
    """(..., 4), (..., 3) → (..., 4) unit-norm retraction p ← normalize(p + B δ)."""
    B = point_tangent_basis(p_hat)
    p_new = p_hat + torch.einsum("...ij,...j->...i", B, delta)
    return p_new / torch.clamp(torch.linalg.vector_norm(p_new, dim=-1, keepdim=True), min=1e-20)


def point_tangent_basis_T(pT):
    """(4, T) unit points → (4, 3, T) tangent bases via the Householder
    reflection mapping e₃ → ∓p̂ (Ceres HomogeneousVectorParameterization)."""
    sign = torch.where(pT[3] >= 0, 1.0, -1.0).to(pT.dtype)  # (T,)
    e3 = pT.new_tensor([0.0, 0.0, 0.0, 1.0])
    v = pT + sign[None, :] * e3[:, None]  # (4, T)
    vn2 = torch.clamp(torch.sum(v * v, dim=0), min=1e-20)  # (T,)
    eye43 = torch.eye(4, dtype=pT.dtype, device=pT.device)[:, :3]
    return eye43[:, :, None] - 2.0 * v[:, None, :] * v[None, :3, :] / vn2[None, None, :]


def retract_point_T(pT, deltaT):
    """(4, T), (3, T) → (4, T) unit-norm retraction p ← normalize(p + B δ)."""
    B = point_tangent_basis_T(pT)
    p_new = pT + torch.einsum("ijt,jt->it", B, deltaT)
    return p_new / torch.clamp(torch.linalg.vector_norm(p_new, dim=0, keepdim=True), min=1e-20)


def _adjugate_inverse(a, b, c, d, e, f, g, h, i):
    A = e * i - f * h
    B = -(d * i - f * g)
    C = d * h - e * g
    det = a * A + b * B + c * C
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-30, torch.full_like(det, 1e-30), det)
    rows = [[A, -(b * i - c * h), b * f - c * e],
            [B, a * i - c * g, -(a * f - c * d)],
            [C, -(a * h - b * g), a * e - b * d]]
    return rows, inv_det


def inv3x3(M):
    """Closed-form batched 3×3 inverse for (..., 3, 3) stacks (adjugate/det)."""
    rows, inv_det = _adjugate_inverse(*[M[..., r, c] for r in range(3) for c in range(3)])
    adj = torch.stack([torch.stack(r, -1) for r in rows], -2)
    return adj * inv_det[..., None, None]


def inv3x3_T(M):
    """Closed-form 3×3 inverse for a (3, 3, T) stack (T-minor layout)."""
    rows, inv_det = _adjugate_inverse(*[M[r, c] for r in range(3) for c in range(3)])
    return torch.stack([torch.stack(r, 0) for r in rows], 0) * inv_det[None, None, :]


def solve3x3(M, y):
    """Batched 3×3 solve via the closed-form inverse ((..., 3, 3) stacks)."""
    return torch.einsum("...ij,...j->...i", inv3x3(M), y)


# ---------------------------------------------------------------------------
# Camera tensors


def rotation_tensors(kind: str, rot):
    """Local→world R (V, 3, 3) and, for Euler cameras, ∂S/∂angle
    dS (V, k, b, a) (None for quaternions) from the raw rotation params."""
    if kind == "quat":
        return quat.to_matrix(quat.normalize(rot)), None
    S = cam_mod.spherical_matrix(rot[..., :3])
    return cam_mod.coord_transform(S).T @ S, cam_mod.spherical_matrix_derivs(rot[..., :3])


def pack_camp(cams: cam_mod.CameraSet):
    """Packed per-camera params [scale, w, h, offx, offy, 0, 0, 0] (V, 8)."""
    n = len(cams)
    return torch.cat([cams.scale[:, None], cams.width[:, None], cams.height[:, None],
                      cams.offset, cams.rot.new_zeros((n, 3))], dim=-1).contiguous()


# ---------------------------------------------------------------------------
# Residuals and Jacobians (T-minor)


class _Blocks(NamedTuple):
    r: torch.Tensor  # (V, 2, T) raw residuals
    Jc: torch.Tensor  # (V, 2, 6, T)
    Jp: torch.Tensor  # (V, 2, 3, T)
    weight: torch.Tensor  # (V, T) IRLS robust weights (0 where masked)


def _safe_w(w_comp):
    return torch.where(torch.abs(w_comp) < 1e-12,
                       torch.where(w_comp < 0, -1e-12, 1e-12).to(w_comp.dtype), w_comp)


def _project_residuals_T(R, camp, pT, obsT):
    """(V, 2, T) raw reprojection residuals; pT is (4, T) homogeneous."""
    p3 = pT[:3] / _safe_w(pT[3])[None, :]  # (3, T)
    local = torch.einsum("vij,it->vjt", R, p3)  # (V, 3, T) = Rᵀ p3
    s = camp[:, 0, None, None]
    wh = camp[:, 1:3, None]
    off = camp[:, 3:5, None]
    pix = wh * (-(local[:, :2] / s - off) * 0.5 + 0.5)
    return pix - obsT


def _residuals_and_jacobians(kind, R, dS, camp, pT, obsT, maskT, huber_delta):
    """Closed-form batched residuals + manifold Jacobians, T-minor layout
    (port of the JAX package's ba._residuals_and_jacobians, with the cameras
    given as tensors).

    R (V, 3, 3), dS (V, k, b, a) Euler derivatives or None, camp (V, 8);
    pT (4, T) unit homogeneous points; obsT (V, 2, T); maskT (V, T) bool.
    Derivation (pix = wh·(−(Rᵀp/s − off)/2 + 0.5), r = pix − obs):

      ∂pix/∂local_xy = diag(−wh/2s) =: a
      quaternion tangent (q ← exp(δ)⊗q): ∂local/∂δ = Rᵀ[p]ₓ
      Euler angles:                      ∂local/∂angleₖ = ∂Sₖᵀ·(C·p)
      ∂pix/∂off = diag(wh/2);   ∂pix/∂s = −a·local_xy/s
      point tangent: ∂local/∂ε = Rᵀ·J₃·B with J₃ = [I/w | −p₃/w] (dehomog)
      and B the S³ tangent basis.
    """
    V, T = obsT.shape[0], obsT.shape[2]
    sw = _safe_w(pT[3])  # (T,)
    p3 = pT[:3] / sw[None, :]  # (3, T)
    local = torch.einsum("vij,it->vjt", R, p3)  # (V, 3, T)
    s = camp[:, 0]
    wh = camp[:, 1:3]
    off = camp[:, 3:5]
    pix = wh[:, :, None] * (-(local[:, :2] / s[:, None, None] - off[:, :, None]) * 0.5 + 0.5)
    r = pix - obsT  # (V, 2, T)
    a = -wh / (2.0 * s[:, None])  # (V, 2)

    if kind == "quat":
        x, y, z = p3[0], p3[1], p3[2]
        zero = torch.zeros_like(x)
        Pcols = torch.stack([
            torch.stack([zero, z, -y], 0),
            torch.stack([-z, zero, x], 0),
            torch.stack([y, -x, zero], 0),
        ], 1)  # (j=3, k=3, T)
        dl_rot = torch.einsum("vja,jkt->vakt", R, Pcols)  # (V, 3, 3, T)
    else:
        Cp = torch.einsum("ab,bt->at", cam_mod.coord_transform(p3), p3)
        dl_rot = torch.einsum("vkba,bt->vakt", dS, Cp)  # (V, 3, 3, T)

    Jc_rot = a[:, :, None, None] * dl_rot[:, :2]  # (V, 2, 3, T)
    eye2 = torch.eye(2, dtype=obsT.dtype, device=obsT.device)
    Jc_off = (wh[:, :, None] * 0.5 * eye2[None])[:, :, :, None].expand(V, 2, 2, T)
    Jc_s = (-a[:, :, None] * local[:, :2] / s[:, None, None])[:, :, None, :]  # (V, 2, 1, T)
    Jc = torch.cat([Jc_rot, Jc_off, Jc_s], dim=2)  # (V, 2, 6, T)

    B = point_tangent_basis_T(pT)  # (4, 3, T)
    J3B = (B[:3] - p3[:, None, :] * B[3][None]) / sw[None, None, :]
    dl_pt = torch.einsum("vja,jkt->vakt", R, J3B)  # (V, 3, 3, T)
    Jp = a[:, :, None, None] * dl_pt[:, :2]  # (V, 2, 3, T)

    m2 = maskT[:, None, :]
    zero = obsT.new_zeros(())
    r = torch.where(m2, r, zero)
    Jc = torch.where(m2[:, :, None], Jc, zero)
    Jp = torch.where(m2[:, :, None], Jp, zero)
    rnorm = torch.sqrt(torch.clamp(torch.sum(r * r, dim=1), min=1e-30))  # (V, T)
    wgt = torch.where(rnorm <= huber_delta, torch.ones_like(rnorm), huber_delta / rnorm)
    wgt = torch.where(maskT, wgt, zero)
    return _Blocks(r=r, Jc=Jc, Jp=Jp, weight=wgt)


def _obs_residual(kind, rot, offset, scale, w, h, p_hat, obs, dc, dp):
    """Residual (2,) of one observation after camera step dc (6,) and point
    step dp (3,), from the raw parameters through the retractions: the
    autodiff reference for the analytic Jacobians. Mirrors the reference
    residual functors (OrthographicReprojectionError.h:26-77,
    OrthographicQuaternionReprojectorError.h:24-67)."""
    if kind == "quat":
        R = quat.to_matrix(quat.normalize(quat.multiply(quat.exp_map(dc[:3]), rot)))
    else:
        S = cam_mod.spherical_matrix(rot[:3] + dc[:3])
        R = cam_mod.coord_transform(S).T @ S
    return cam_mod.project_from_params(R, offset + dc[3:5], scale + dc[5], w, h,
                                       retract_point(p_hat, dp)) - obs


def _residuals_and_jacobians_autodiff(cams: cam_mod.CameraSet, points_hat, obs, mask,
                                      huber_delta):
    """torch.func.jacrev reference in the track-major layout, kept to hold
    the analytic T-minor Jacobians to: (r (T, V, 2), Jc (T, V, 2, 6),
    Jp (T, V, 2, 3), robust weights (T, V)), zero where masked."""
    from torch.func import jacrev, vmap

    def per_obs(rot, offset, scale, w, h, p_hat, o):
        zc, zp = o.new_zeros(6), o.new_zeros(3)
        args = (cams.kind, rot, offset, scale, w, h, p_hat, o)
        r = _obs_residual(*args, zc, zp)
        Jc, Jp = jacrev(lambda dc, dp: _obs_residual(*args, dc, dp), argnums=(0, 1))(zc, zp)
        return r, Jc, Jp

    per_track = vmap(per_obs, in_dims=(None, None, None, None, None, 0, 0))
    per_all = vmap(per_track, in_dims=(0, 0, 0, 0, 0, None, 1), out_dims=1)
    r, Jc, Jp = per_all(cams.rot, cams.offset, cams.scale, cams.width, cams.height,
                        points_hat, obs)
    # Hard-zero masked entries: padded or dead observations can carry NaN/Inf
    zero = obs.new_zeros(())
    r = torch.where(mask[..., None], r, zero)
    Jc = torch.where(mask[..., None, None], Jc, zero)
    Jp = torch.where(mask[..., None, None], Jp, zero)
    rnorm = torch.linalg.vector_norm(r, dim=-1)
    wgt = torch.where(rnorm <= huber_delta, torch.ones_like(rnorm),
                      huber_delta / torch.clamp(rnorm, min=1e-20))
    return r, Jc, Jp, torch.where(mask, wgt, zero)


def robust_cost(r, mask, huber_delta, comp_axis=1):
    """½ Σ ρ(‖r‖²) with Huber ρ (Ceres convention); r (V, 2, T), mask (V, T)."""
    s = torch.sum(r * r, dim=comp_axis)
    d2 = huber_delta * huber_delta
    rho = torch.where(s <= d2, s, 2.0 * huber_delta * torch.sqrt(torch.clamp(s, min=1e-20)) - d2)
    return 0.5 * torch.sum(torch.where(mask, rho, torch.zeros_like(rho)))


def normal_equations(blocks: _Blocks, free_c):
    """Schur-ready blocks (T-minor): U (V, 6, 6), Wc (V, 6, 3, T),
    Vt (3, 3, T), g_c (V, 6), g_p (3, T); gradients are −Jᵀr. Fixed camera
    params are projected out."""
    Jc = blocks.Jc * free_c[:, None, :, None].to(blocks.Jc.dtype)
    Jp = blocks.Jp
    w = blocks.weight[:, None, None, :]
    Jcw = Jc * w
    Jpw = Jp * w
    U = torch.einsum("vkat,vkbt->vab", Jcw, Jc)
    Wc = (Jcw[:, 0, :, None, :] * Jp[:, 0, None, :, :] +
          Jcw[:, 1, :, None, :] * Jp[:, 1, None, :, :])  # (V, 6, 3, T)
    Vt = torch.einsum("vkpt,vkqt->pqt", Jpw, Jp)  # (3, 3, T)
    g_c = -torch.einsum("vkit,vkt->vi", Jcw, blocks.r)
    g_p = -torch.einsum("vkpt,vkt->pt", Jpw, blocks.r)
    return U, Wc, Vt, g_c, g_p


def damped_point_inverse(Vt, lam, optimize_points: bool):
    """V̂⁻¹ (3, 3, T) of the LM-damped point blocks (zeros when points are
    held fixed)."""
    eye3 = torch.eye(3, dtype=Vt.dtype, device=Vt.device)
    dV = torch.clamp(torch.stack([Vt[0, 0], Vt[1, 1], Vt[2, 2]], 0), min=1e-8)  # (3, T)
    V_d = Vt + eye3[:, :, None] * (lam * dV + 1e-10)[:, None, :]
    return inv3x3_T(V_d) if optimize_points else torch.zeros_like(V_d)


def prepare_camera_system(S_p, dU, rhs, free_c, lam):
    """The damped, pinned, Jacobi-scaled reduced camera system: (S_s (n, n),
    b (n,), d (n,)) with S_s x = b and the camera step x / d. S_p is
    U−WV̂⁻¹Wᵀ with U already on the block diagonal; dU its raw diag."""
    n = S_p.shape[0]
    S_f = S_p + torch.diag(lam * torch.clamp(dU, min=1e-8))
    fm = free_c.reshape(n).to(S_p.dtype)
    S_f = S_f * fm[:, None] * fm[None, :] + torch.diag(1.0 - fm)
    d = torch.sqrt(torch.clamp(torch.abs(torch.diagonal(S_f)), min=1e-12))
    return S_f / d[:, None] / d[None, :], rhs * fm / d, d


def _solve_camera_system(S_p, dU, rhs, free_c, lam):
    """Dense solve of the damped/pinned/preconditioned reduced camera system."""
    S_s, b, d = prepare_camera_system(S_p, dU, rhs, free_c, lam)
    # solve_ex does not raise on a singular system: like the JAX package's
    # solve, it returns a non-finite step, whose cost the LM step rejects.
    delta_c = (torch.linalg.solve_ex(S_s, b)[0] / d).reshape(-1, 6)
    return delta_c * free_c.reshape(-1, 6).to(S_p.dtype)


def reduce_camera_system(U, Wc, g_c, g_p, V_inv):
    """The Schur complement of the point blocks, on normal_equations'
    T-minor blocks and V̂⁻¹ (3, 3, T): S = blkdiag(U) − W V̂⁻¹ Wᵀ (n, n) in
    block-major (view·6 + param) order, dU = diag(U) (n,) and
    rhs = g_c − W V̂⁻¹ g_p (n,), with n = 6V; and W as (n, 3T), which the
    points' back-substitution reads."""
    V, T = Wc.shape[0], Wc.shape[3]
    WVi = (Wc[:, :, 0, None, :] * V_inv[None, None, 0] +
           Wc[:, :, 1, None, :] * V_inv[None, None, 1] +
           Wc[:, :, 2, None, :] * V_inv[None, None, 2])  # (V, 6, 3, T)
    X = WVi.reshape(V * 6, 3 * T)
    Y = Wc.reshape(V * 6, 3 * T)
    ar = torch.arange(V, device=Wc.device)
    S = Wc.new_zeros((V, 6, V, 6))
    S[ar, :, ar, :] = U
    S = S.reshape(V * 6, V * 6) - X @ Y.T
    dU = torch.diagonal(U, dim1=1, dim2=2).reshape(V * 6)
    rhs = g_c.reshape(V * 6) - X @ g_p.reshape(3 * T)
    return S, dU, rhs, Y


def schur_solve(U, Wc, Vt, g_c, g_p, free_c, lam, optimize_points: bool):
    """The plain LM step by Schur elimination of the point blocks, on
    normal_equations' T-minor blocks: (delta_c (V, 6), delta_p (3, T)).
    The reduced system (reduce_camera_system) is solved by
    _solve_camera_system (damped, pinned, Jacobi-scaled), and the points
    back-substitute δp = V̂⁻¹(g_p − Wᵀ δc)."""
    V, T = Wc.shape[0], Wc.shape[3]
    V_inv = damped_point_inverse(Vt, lam, optimize_points)  # (3, 3, T)
    S, dU, rhs, Y = reduce_camera_system(U, Wc, g_c, g_p, V_inv)
    delta_c = _solve_camera_system(S, dU, rhs, free_c, torch.as_tensor(lam, dtype=U.dtype))
    tmp = g_p - (Y.T @ delta_c.reshape(V * 6)).reshape(3, T)
    return delta_c, torch.einsum("pqt,qt->pt", V_inv, tmp)


# ---------------------------------------------------------------------------
# LM driver


class BAResult(NamedTuple):
    cams: cam_mod.CameraSet
    points: torch.Tensor  # (T, 4) homogeneous (unit-norm)
    cost: torch.Tensor
    initial_cost: torch.Tensor
    iterations: torch.Tensor


def prepare(points4, obs, mask):
    """Padding and safe-point handling of the JAX package's ba._run_jit:
    unit-normalized (4, T) points, with a safe unit point [0,0,0,1] for
    tracks without a valid observation; obsT (V, 2, T); maskT (V, T) f32.
    The safe point is made on the device (a copy from the host would
    synchronize the host with the card)."""
    p_hat = points4 / torch.clamp(torch.linalg.vector_norm(points4, dim=-1, keepdim=True),
                                  min=1e-20)
    track_valid = torch.any(mask, dim=1)
    mask = mask & track_valid[:, None]
    safe = (torch.arange(4, device=points4.device) == 3).to(points4.dtype)
    p_hat = torch.where(track_valid[:, None], p_hat, safe)
    pT = p_hat.T.contiguous()
    obsT = obs.permute(1, 2, 0).contiguous()
    maskT = mask.T.to(obs.dtype).contiguous()
    return pT, obsT, maskT


def run(cams: cam_mod.CameraSet, points4, obs, mask,
        optimize_points: bool = True,
        config: BundleAdjustConfig = BundleAdjustConfig()) -> BAResult:
    """Run robust LM bundle adjustment.

    Args:
      cams: V cameras (their ``fixed`` flags and solver type drive free masks).
      points4: (T, 4) homogeneous points (w≠0 for valid tracks).
      obs: (T, V, 2) pixel observations aligned to the camera order.
      mask: (T, V) which observations participate (obs_mask & alive & has_point).

    Equivalent call in the reference: runBundleAdjustment(cameras, tracks,
    algorithm, optimizePoints, retriangulate); retriangulation is done by the
    caller, as bundle_adjustment.cpp:74-83 does.
    """
    from orthosfm_torch.solvers import ba_kernels as bk

    recorder = profiling.ba_recorder()
    t0 = time.monotonic() if recorder is not None else None
    kind = cams.kind
    T, V = obs.shape[0], len(cams)
    wants_fused = config.impl == "fused" or (config.impl == "auto" and config.use_pallas)
    fits = wants_fused and bk.fused_fits(V, T, obs.device)
    route = resolve_impl(config.impl, obs.device, fused=fits, use_pallas=config.use_pallas)
    pT, obsT, maskT = prepare(points4, obs.to(torch.float32), mask)
    free = cam_mod.free_mask(cams).to(torch.float32).contiguous()
    pT2, rot2, camp2 = bk.lm_buffers(pT, cams.rot.to(torch.float32), pack_camp(cams))
    args = (kind, pT2, obsT, maskT, rot2, camp2, free, float(config.huber_delta),
            optimize_points, bk.LMConfig.of(config), config.max_iterations)
    if route == "fused":
        final = bk.lm_solve(*args)
    else:
        final = bk.lm_iterate(*args, plain=route == "torch",
                              stop_at_done=obs.device.type == "cpu")
    rot, camp, pT = (bk.current(x, final) for x in (rot2, camp2, pT2))
    cams_f = cams.replace(rot=rot, offset=camp[:, 3:5].contiguous(), scale=camp[:, 0].contiguous())
    res = BAResult(cams=cams_f, points=pT.T[:T], cost=final[bk.COST],
                   initial_cost=final[bk.INIT_COST], iterations=final[bk.ITERS].to(torch.int32))
    if recorder is not None:
        solve_route = bk.fused_solve_route(V, obs.device) if route == "fused" else None
        recorder.add(V, T, route, solve_route, config.max_iterations, mask, final, t0,
                     time.monotonic())
    return res


def reprojection_errors(cams: cam_mod.CameraSet, points4, obs, mask):
    """Per-observation euclidean reprojection errors (T, V), 0 where masked:
    the evaluateReprojectionError analog
    (reference: OrthographicReconstructionAlgorithm.cpp:204-223)."""
    r = cam_mod.project(cams, points4).permute(1, 0, 2) - obs
    return torch.where(mask, torch.linalg.vector_norm(r, dim=-1), obs.new_zeros(()))


def run_even_odd(cams: cam_mod.CameraSet, points4, obs, mask,
                 optimize_points: bool = True,
                 config: BundleAdjustConfig = BundleAdjustConfig(),
                 fix_first_two: bool = False) -> BAResult:
    """Alternating even/odd-camera bundle adjustment
    (reference: bundle_adjustment.cpp:163-198 runEvenOddBundleAdjustment,
    present in the reference API though its call sites are commented out).

    Fixes the even cameras and solves; fixes the odd ones and solves;
    restores the original fixed flags (plus, optionally, the first two) and
    solves once more. Each solve is `run`, so it takes the kernels where
    `run` does; the iterations are summed."""
    idx = torch.arange(len(cams), device=cams.device)
    first_two = (idx < 2) & fix_first_two
    even = (idx % 2 == 0) | first_two
    r1 = run(cams.replace(fixed=even), points4, obs, mask, optimize_points, config)
    odd = (idx % 2 != 0) | first_two
    r2 = run(r1.cams.replace(fixed=odd), r1.points, obs, mask, optimize_points, config)
    r3 = run(r2.cams.replace(fixed=cams.fixed | first_two), r2.points, obs, mask,
             optimize_points, config)
    return BAResult(cams=r3.cams, points=r3.points, cost=r3.cost,
                    initial_cost=r1.initial_cost,
                    iterations=r1.iterations + r2.iterations + r3.iterations)
