"""A plain bundle adjustment of OrthoSfM's objective, for judging a
reconstruction.

The objective is upstream's (src/bundle_adjustment/bundle_adjustment.cpp:49-161):
half the sum over the kept observations of Huber's rho (delta 1 px) of the
squared reprojection error. Every camera but the anchor (the first camera
placed, which the pipeline holds fixed) has its rotation and its offset free;
scales are fixed, as for the quaternion solver and the Euler all-dof solver.
A rotation moves as its solver parameterizes it: a quaternion camera on
SO(3) (R <- exp(w) R), an Euler camera by its three angles, whose
singularities the optimum then shares with the program's. Points are
Euclidean.

`refine` runs Levenberg's method from a given solution: Gauss-Newton with
IRLS weights and the damping lambda * I, with the points eliminated by their
Schur complement, and the reduced camera system solved densely. A damping of
lambda * I keeps every step orthogonal to the objective's one gauge freedom
(a shift of all points along the anchor's viewing axis that the other
cameras' offsets take up), so two solutions compare without a gauge fit.

`refine` runs in float64. `control_step` is the lower precision the
judge's control uses: one step in float32, with the inputs of every
contraction (the projection, the normal equations, the Schur product and
the back-substitution) rounded to TF32's 10 mantissa bits, as a float32
matrix product with TF32 on rounds them on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from sfm_bench.reference import camera_model as cm

HUBER_DELTA_PX = 1.0
#: the trust region of one step: the largest turn of any camera
MAX_TURN_DEG = 1.0


def tf32_round(x):
    """float32 -> float32 rounded to 10 mantissa bits, to nearest with ties
    away from zero (what cvt.rna.tf32.f32 does)."""
    bits = x.contiguous().view(torch.int32).to(torch.int64)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.to(torch.int32).view(torch.float32)


@dataclasses.dataclass
class Problem:
    """One reconstruction's observations and a solution, on one device."""

    obs: torch.Tensor  # (N, 2) pixels of the kept observations
    t_idx: torch.Tensor  # (N,) track of each observation
    v_idx: torch.Tensor  # (N,) camera of each observation
    wh: torch.Tensor  # (V, 2)
    scale: torch.Tensor  # (V,)
    free: torch.Tensor  # (V,) bool: rotation and offset free
    R: torch.Tensor  # (V, 3, 3)
    offset: torch.Tensor  # (V, 2)
    X: torch.Tensor  # (T, 3)
    angles: Optional[torch.Tensor] = None  # (V, 3) for Euler cameras, R their basis

    def to(self, dtype):
        cur = {fd.name: getattr(self, fd.name) for fd in dataclasses.fields(self)}
        return Problem(**{k: (v.to(dtype) if v is not None and v.is_floating_point() else v)
                          for k, v in cur.items()})

    def with_solution(self, R, offset, X, angles=None):
        return dataclasses.replace(self, R=R, offset=offset, X=X, angles=angles)


def _c(x, tf32: bool):
    return tf32_round(x) if tf32 else x


def residuals(p: Problem, tf32: bool = False):
    """(N, 2) reprojection residuals of the kept observations."""
    Rn = _c(p.R[p.v_idx], tf32)
    local = torch.einsum("nij,ni->nj", Rn, _c(p.X[p.t_idx], tf32))[:, :2]
    wh, s = p.wh[p.v_idx], p.scale[p.v_idx, None]
    return wh * (-(local / s - p.offset[p.v_idx]) * 0.5 + 0.5) - p.obs


def cost(r):
    """Half the summed Huber rho of the squared residual norms."""
    s = torch.sum(r * r, dim=-1)
    d = HUBER_DELTA_PX
    return 0.5 * torch.sum(torch.where(s <= d * d, s, 2 * d * torch.sqrt(s) - d * d))


def _skew(x):
    z = torch.zeros_like(x[:, 0])
    return torch.stack([torch.stack([z, -x[:, 2], x[:, 1]], -1),
                        torch.stack([x[:, 2], z, -x[:, 0]], -1),
                        torch.stack([-x[:, 1], x[:, 0], z], -1)], -2)


def step(p: Problem, lam: float, tf32: bool = False):
    """One damped Gauss-Newton step from p's solution: (dR (V, 3): rotation
    vectors applied as R <- exp(dR) R, or the Euler angles' steps; doff
    (V, 2); dX (T, 3))."""
    V, T = p.R.shape[0], p.X.shape[0]
    dt = p.X.dtype
    r = residuals(p, tf32)
    norm = torch.sqrt(torch.clamp(torch.sum(r * r, -1), min=1e-300 if dt == torch.float64
                                  else 1e-30))
    w = torch.where(norm <= HUBER_DELTA_PX, torch.ones_like(norm), HUBER_DELTA_PX / norm)
    Rn, Xn = p.R[p.v_idx], p.X[p.t_idx]
    a = -p.wh[p.v_idx] / (2.0 * p.scale[p.v_idx, None])  # (N, 2)
    # d local / d X = R^T; d local / d dR = R^T [X]x (R <- exp(dR) R), or
    # (dR/d angle_k)^T X for Euler angles
    JX = a[:, :, None] * Rn.transpose(1, 2)[:, :2, :]
    if p.angles is None:
        dl = torch.einsum("nji,njk->nik", _c(Rn, tf32), _c(_skew(Xn), tf32))
    else:
        dR = cm.euler_basis_derivs(p.angles)[p.v_idx]  # (N, 3 angles, 3, 3)
        dl = torch.einsum("nkji,nj->nik", _c(dR, tf32), _c(Xn, tf32))
    Jr = a[:, :, None] * dl[:, :2]
    Jo = torch.diag_embed(p.wh[p.v_idx] * 0.5)
    Jc = torch.cat([Jr, Jo], dim=2) * p.free[p.v_idx, None, None].to(dt)  # (N, 2, 5)

    def tn(A, B):  # sum_k w A[k, i] B[k, j], per observation
        return torch.einsum("nki,nkj->nij", _c(A * w[:, None, None], tf32), _c(B, tf32))

    U = torch.zeros((V, 5, 5), dtype=dt, device=r.device).index_add_(0, p.v_idx, tn(Jc, Jc))
    Vt = torch.zeros((T, 3, 3), dtype=dt, device=r.device).index_add_(0, p.t_idx, tn(JX, JX))
    W = tn(Jc, JX)  # (N, 5, 3)
    rw = r * w[:, None]
    gc = -torch.zeros((V, 5), dtype=dt, device=r.device).index_add_(
        0, p.v_idx, torch.einsum("nki,nk->ni", _c(Jc, tf32), _c(rw, tf32)))
    gp = -torch.zeros((T, 3), dtype=dt, device=r.device).index_add_(
        0, p.t_idx, torch.einsum("nki,nk->ni", _c(JX, tf32), _c(rw, tf32)))
    eye3 = torch.eye(3, dtype=dt, device=r.device)
    Vinv = torch.linalg.inv(Vt + lam * eye3)
    Y = torch.einsum("nij,njk->nik", _c(W, tf32), _c(Vinv[p.t_idx], tf32))  # (N, 5, 3)
    # S = blkdiag(U) + lam I - sum_t sum_{v, v'} Y_tv W_tv'^T, by one dense product
    Yd = torch.zeros((V, 5, T, 3), dtype=dt, device=r.device)
    Wd = torch.zeros((V, 5, T, 3), dtype=dt, device=r.device)
    Yd[p.v_idx, :, p.t_idx, :] = Y
    Wd[p.v_idx, :, p.t_idx, :] = W
    Yd, Wd = Yd.reshape(5 * V, 3 * T), Wd.reshape(5 * V, 3 * T)
    S = -(_c(Yd, tf32) @ _c(Wd, tf32).T)
    ar = torch.arange(V, device=r.device)
    S.view(V, 5, V, 5)[ar, :, ar, :] += U
    fixed = ~p.free
    S.view(V, 5, V, 5)[fixed.nonzero()[:, 0], :, fixed.nonzero()[:, 0], :] = torch.eye(
        5, dtype=dt, device=r.device)
    S = S + lam * torch.eye(5 * V, dtype=dt, device=r.device)
    rhs = gc.reshape(-1) - _c(Yd, tf32) @ _c(gp.reshape(-1), tf32)
    dc = torch.linalg.solve(S, rhs).reshape(V, 5) * p.free[:, None].to(dt)
    back = torch.zeros((T, 3), dtype=dt, device=r.device).index_add_(
        0, p.t_idx, torch.einsum("nij,ni->nj", _c(W, tf32), _c(dc[p.v_idx], tf32)))
    dX = torch.einsum("tij,tj->ti", _c(Vinv, tf32), _c(gp - back, tf32))
    return dc[:, :3], dc[:, 3:], dX


def apply(p: Problem, dR, doff, dX) -> Problem:
    if p.angles is None:
        return p.with_solution(cm.so3_exp(dR) @ p.R, p.offset + doff, p.X + dX)
    angles = p.angles + dR
    return p.with_solution(cm.euler_basis(angles), p.offset + doff, p.X + dX, angles)


def bounded(p: Problem, dR, doff, dX) -> Problem:
    """p moved by a step, the whole step shortened so that no camera turns by
    more than MAX_TURN_DEG: a trust region, so that a refinement stays in the
    basin it starts in. (Where noise leaves a camera all but unconstrained,
    the undamped step turns it by tens of degrees for a sliver of cost and
    lands in another basin.) A camera's turn is bounded by its rotation
    vector's norm, or by the sum of its Euler angles' steps."""
    turn = (torch.linalg.vector_norm(dR, dim=-1) if p.angles is None
            else torch.sum(torch.abs(dR), dim=-1))
    turn = float(torch.rad2deg(turn.max()))
    f = min(1.0, MAX_TURN_DEG / turn) if turn > 0 else 1.0
    return apply(p, dR * f, doff * f, dX * f)


def damping(p: Problem) -> float:
    """A damping far below the curvature of any free parameter: enough to
    make the gauge direction and points seen once solvable."""
    return 1e-9 * float((p.wh.max() / p.scale.min()) ** 2)


def refine(p: Problem, iterations: int = 20, rel_tol: float = 1e-15) -> Problem:
    """Levenberg iterations in float64 from p's solution until the cost stops
    falling; returns the optimum (a Problem in float64)."""
    p = p.to(torch.float64)
    if p.obs.shape[0] == 0:
        return p
    lam = damping(p)
    c = float(cost(residuals(p)))
    for _ in range(iterations):
        q = bounded(p, *step(p, lam))
        cq = float(cost(residuals(q)))
        if cq < c:
            done = (c - cq) <= rel_tol * max(c, 1e-300)
            p, c, lam = q, cq, max(lam * 0.1, damping(p) * 1e-3)
            if done:
                break
        else:
            lam *= 10.0
            if lam > 1e12:
                break
    return p


def control_step(p: Problem) -> Problem:
    """The control: the reference's step from p's solution computed in TF32
    (float32 with TF32-rounded contractions), taken; returned in float64."""
    q = p.to(torch.float32)
    if q.obs.shape[0] == 0:
        return p.to(torch.float64)
    return bounded(q, *step(q, damping(q), tf32=True)).to(torch.float64)
