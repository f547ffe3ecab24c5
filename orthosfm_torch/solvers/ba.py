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
assemble → camera solve + retract → point update + cost + accept. With
impl "kernel" each stage is a hand-written CUDA kernel, with impl "torch"
its plain PyTorch version. The points and cameras live in LM buffers of two
halves; the scalar state names the current one, and an accepted step flips
it. On the card the loop runs ``max_iterations`` times with no host sync
for either impl (a device `done` flag turns the converged iterations into
no-ops) and reads the state once at the end; on the CPU, where reading
`done` syncs nothing, it stops at convergence.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orthosfm_torch.config import BundleAdjustConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.kernel_build import resolve_impl

# ---------------------------------------------------------------------------
# Homogeneous point manifold, track-minor (..., T) layout


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
    tracks without a valid observation; obsT (V, 2, T); maskT (V, T) f32."""
    p_hat = points4 / torch.clamp(torch.linalg.vector_norm(points4, dim=-1, keepdim=True),
                                  min=1e-20)
    track_valid = torch.any(mask, dim=1)
    mask = mask & track_valid[:, None]
    safe = points4.new_tensor([0.0, 0.0, 0.0, 1.0])
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

    impl = resolve_impl(config.impl, obs.device)
    kind = cams.kind
    T = obs.shape[0]
    pT, obsT, maskT = prepare(points4, obs.to(torch.float32), mask)
    free = cam_mod.free_mask(cams).to(torch.float32).contiguous()
    pT2, rot2, camp2 = bk.lm_buffers(pT, cams.rot.to(torch.float32), pack_camp(cams))
    hub = float(config.huber_delta)
    if impl == "kernel":
        assemble, solve = bk.schur_assemble, bk.camera_solve
    else:
        assemble, solve = bk.normal_eq_schur_ref, bk.camera_solve_ref
    update = bk.PointUpdateCost(kind, pT2, obsT, maskT, rot2, camp2, free, hub, optimize_points,
                                bk.LMConfig.of(config), plain=impl == "torch")

    state = torch.zeros((2, bk.STATE_SIZE), dtype=torch.float32, device=obs.device)
    update(None, state[0])
    for it in range(config.max_iterations):
        s_in, s_out = state[it % 2], state[(it + 1) % 2]
        S, dU, rhs = assemble(kind, pT2, obsT, maskT, rot2, camp2, free, s_in, hub,
                              optimize_points)
        delta = solve(kind, S, dU, rhs, free, s_in, rot2, camp2)
        update(s_in, s_out, delta)
        if obs.device.type == "cpu" and bool(s_out[bk.DONE] != 0):
            state[config.max_iterations % 2] = s_out
            break
    final = state[config.max_iterations % 2]
    rot, camp, pT = (bk.current(x, final) for x in (rot2, camp2, pT2))
    cams_f = cams.replace(rot=rot, offset=camp[:, 3:5].contiguous(), scale=camp[:, 0].contiguous())
    return BAResult(cams=cams_f, points=pT.T[:T], cost=final[bk.COST],
                    initial_cost=final[bk.INIT_COST], iterations=final[bk.ITERS].to(torch.int32))
