"""Tomasi-Kanade factorization initialization with batched RANSAC.

Port of orthosfm_tpu/solvers/tomasi_kanade.py (reference: the OpenMP RANSAC
loop of src/algorithms/tomasi_kanade.cpp:20-470). All hypotheses run as one
batched tensor computation: Gumbel top-k sampling replaces std::sample, the
Ceres DENSE_QR metric upgrade is a batched dense LM (solvers/lm.py),
consensus scoring is a masked reduction and the best model an argmax.

Randomness comes from an explicit torch.Generator. The JAX package draws
with JAX keys, which torch cannot reproduce, so `score_hypothesis`,
`robust_factorization` and `factorize` also accept the sample indices and
metric-upgrade inits as inputs (tests feed them the JAX draws).

Terminology follows the paper/reference: D is the 2G×S measurement matrix of
mean-centered negated pixel coordinates, RStar its first three left singular
vectors, Q the 3×3 metric-upgrade matrix, and the two returned models are the
depth-ambiguity mirror pair (flip diag(1,1,−1)).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from orthosfm_torch.config import RansacConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.solvers import lm
from orthosfm_torch.solvers.ba import solve3x3


def _tk_residual(q, RStar):
    """Metric-upgrade constraints and their Jacobian, batched over problems
    (reference: tomasi_kanade.h:43-117): per camera iᵀQQᵀi=1, jᵀQQᵀj=1,
    iᵀQQᵀj=0, plus 6 gauge residuals pinning camera 0 to the world axes.

    q (B, 9) row-major Q; RStar (B, 2G, 3). With u = Qᵀi and v = Qᵀj,
    ∂(u·u)/∂Q_ab = 2 i_a u_b, ∂(u·v)/∂Q_ab = i_a v_b + j_a u_b, and
    ∂u_b/∂Q_ab' = i_a δ_bb'. Returns (r (B, 3G+6), J (B, 3G+6, 9))."""
    B, G = q.shape[0], RStar.shape[1] // 2
    Q = q.reshape(B, 3, 3)
    i = RStar[:, :G]
    j = RStar[:, G:]
    u = i @ Q  # (B, G, 3)
    v = j @ Q
    r = torch.stack([torch.sum(u * u, -1) - 1.0, torch.sum(v * v, -1) - 1.0,
                     torch.sum(u * v, -1)], -1).reshape(B, 3 * G)
    c1 = u[:, 0] - RStar.new_tensor([1.0, 0.0, 0.0])
    c2 = v[:, 0] - RStar.new_tensor([0.0, 1.0, 0.0])

    def outer(a, b):
        return a[..., :, None] * b[..., None, :]

    Jr = torch.stack([2.0 * outer(i, u), 2.0 * outer(j, v), outer(i, v) + outer(j, u)],
                     dim=2).reshape(B, 3 * G, 9)
    eye3 = torch.eye(3, dtype=q.dtype, device=q.device)
    Jc1 = (eye3[None, :, None, :] * i[:, 0, None, :, None]).reshape(B, 3, 9)
    Jc2 = (eye3[None, :, None, :] * j[:, 0, None, :, None]).reshape(B, 3, 9)
    return torch.cat([r, c1, c2], dim=1), torch.cat([Jr, Jc1, Jc2], dim=1)


def _unit(v):
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-12)


FLIP = (1.0, 1.0, -1.0)


def factorize(obs, mask, q0=None, generator: Optional[torch.Generator] = None):
    """Batched TK factorizations on masked observations.

    obs: (B, S, G, 2) pixels; mask: (B, S) valid columns; q0: (B, 9)
    metric-upgrade inits, drawn uniformly in [-1, 1) from ``generator`` when
    not given. Returns the mirror pair (model1, model2), each
    (B, G, 3, 3) basis matrices normalized so camera 0 is the identity
    (reference: tomasi_kanade.cpp:20-151)."""
    G = obs.shape[2]
    m = mask.to(obs.dtype)
    D = -torch.cat([obs[..., 0].transpose(1, 2), obs[..., 1].transpose(1, 2)], dim=1)  # (B, 2G, S)
    count = torch.clamp(torch.sum(m, dim=1), min=1.0)
    mean = torch.sum(D * m[:, None, :], dim=2, keepdim=True) / count[:, None, None]
    D = (D - mean) * m[:, None, :]
    if q0 is None:
        q0 = torch.rand((obs.shape[0], 9), generator=generator, device=obs.device) * 2.0 - 1.0

    U, _, _ = torch.linalg.svd(D, full_matrices=False)
    RStar = U[..., :3].contiguous()  # (B, 2G, 3)

    q, _ = lm.solve(_tk_residual, q0, (RStar,), iters=40)
    RFinal = RStar @ q.reshape(-1, 3, 3)  # (B, 2G, 3)

    x = RFinal[:, :G]
    y = RFinal[:, G:]
    z = torch.linalg.cross(x, y)
    combined = torch.stack([_unit(x), _unit(y), _unit(z)], dim=-1)  # (B, G, 3, 3) cols=axes
    sol1 = torch.einsum("bji,bgjk->bgik", combined[:, 0], combined)

    flip = torch.diag(obs.new_tensor(FLIP))
    combined2 = flip @ combined @ flip
    sol2 = torch.einsum("bji,bgjk->bgik", combined2[:, 0], combined2)
    return sol1, sol2


def is_result_usable(model, cfg: RansacConfig):
    """Validity heuristic, batched over models (..., G, 3, 3): reject
    factorizations with near-duplicate cameras (reference: tomasi_kanade.cpp:446-470)."""
    G = model.shape[-3]
    angles = cam_mod.basis_to_phi_theta_roll(model)  # (..., G, 3)
    dphi = torch.abs(angles[..., :, None, 0] - angles[..., None, :, 0])
    dtheta = torch.abs(angles[..., :, None, 1] - angles[..., None, :, 1])
    too_close_ang = (dphi < cfg.min_angle_separation_rad) & (dtheta < cfg.min_angle_separation_rad)
    diff = (model[..., :, None, :, :] - model[..., None, :, :, :]).reshape(
        model.shape[:-3] + (G, G, 9))
    too_close_basis = torch.linalg.vector_norm(diff, dim=-1) < cfg.min_basis_distance
    off_diag = ~torch.eye(G, dtype=torch.bool, device=model.device)
    return ~torch.any(((too_close_ang | too_close_basis) & off_diag).flatten(-2), dim=-1)


def _model_geometry(model):
    """Basis trio -> (R_l2w (..., G, 3, 3), origins, look dirs) through the
    reference's angle-projection path (convertFromAxis → spherical matrix)."""
    S = cam_mod.spherical_matrix(cam_mod.basis_to_phi_theta_roll(model))
    R = cam_mod.coord_transform(S).T @ S
    o = R @ R.new_tensor([0.0, 0.0, -cam_mod.CAMERA_DISTANCE])
    return R, o, R[..., :, 2]


def _triangulate_and_errors(model, obs, valid, width, height):
    """Triangulate all tracks under each model and return per-(track, cam)
    reprojection errors in pixels. model: (B, G, 3, 3); obs: (T, G, 2);
    valid: (T,); width/height: (G,). Returns pts (B, T, 3), err (B, T, G).

    Every ray of a model shares its camera's direction, so the normal matrix
    Σ_g (I − d dᵀ) is one per model for all valid tracks."""
    R, o, look = _model_geometry(model)  # (B, G, 3, 3), (B, G, 3), (B, G, 3)
    wh = torch.stack([width, height], -1)  # (G, 2)
    norm = -2.0 * (obs / wh[None] - 0.5)  # (T, G, 2)
    origins = (o[:, None] + norm[None, ..., 0:1] * R[:, None, :, :, 0]
               + norm[None, ..., 1:2] * R[:, None, :, :, 1])  # (B, T, G, 3)
    eye = torch.eye(3, dtype=obs.dtype, device=obs.device)
    proj = eye - look[..., :, None] * look[..., None, :]  # (B, G, 3, 3)
    A_valid = torch.sum(proj, dim=1) + 1e-8 * eye  # (B, 3, 3)
    A = torch.where(valid[None, :, None, None], A_valid[:, None], 1e-8 * eye)  # (B, T, 3, 3)
    b = torch.sum(torch.einsum("bgij,btgj->btgi", proj, origins), dim=2)
    b = b * valid[None, :, None].to(obs.dtype)
    pts = solve3x3(A, b)  # (B, T, 3)

    local = torch.einsum("bgij,bti->btgj", R, pts)  # Rᵀ·p
    pix = wh * (local[..., :2] / (-2.0) + 0.5)
    err = torch.linalg.vector_norm(pix - obs[None], dim=-1)  # (B, T, G)
    return pts, err


class TKResult(NamedTuple):
    model1: torch.Tensor  # (G, 3, 3)
    model2: torch.Tensor  # mirror solution
    num_inliers: torch.Tensor
    found: torch.Tensor  # bool — consensus model found (else fallback used)


def draw_hypotheses(valid, cfg: RansacConfig, generator: torch.Generator):
    """RANSAC draws from ``generator``: sample indices (H, S) — a uniform
    sample of S valid tracks without replacement per hypothesis (Gumbel
    top-k) — metric-upgrade inits (H, 9) in [-1, 1), and the fallback's
    init (9,)."""
    H, S, T = cfg.max_iterations, cfg.sample_size, valid.shape[0]
    dev = valid.device
    u = torch.rand((H, T), generator=generator, device=dev).clamp_(min=1e-12)
    gumbel = -torch.log(-torch.log(u))
    scores = torch.where(valid[None, :], gumbel, torch.full_like(gumbel, -torch.inf))
    samp_idx = torch.topk(scores, S, dim=1).indices
    q0 = torch.rand((H + 1, 9), generator=generator, device=dev) * 2.0 - 1.0
    return samp_idx, q0[:H], q0[H]


def score_hypothesis(obs, valid, width, height, cfg: RansacConfig, samp_idx=None, q0=None,
                     generator: Optional[torch.Generator] = None):
    """All RANSAC hypotheses at once: factorize each sample → validity
    heuristic → triangulate → consensus score (reference:
    tomasi_kanade.cpp:225-343). samp_idx (H, S) and q0 (H, 9) are the draws,
    taken from ``generator`` (draw_hypotheses) when not given.

    Returns (samp_idx, score (H,), n_consensus (H,), model1 (H, G, 3, 3), model2)."""
    if samp_idx is None:
        samp_idx, q0, _ = draw_hypotheses(valid, cfg, generator)
    T = obs.shape[0]
    H, S = samp_idx.shape
    sol1, sol2 = factorize(obs[samp_idx], torch.ones((H, S), dtype=torch.bool,
                                                     device=obs.device), q0)
    usable = is_result_usable(sol1, cfg)

    _, err = _triangulate_and_errors(sol1, obs, valid, width, height)
    in_sample = torch.zeros((H, T), dtype=torch.bool, device=obs.device)
    in_sample.scatter_(1, samp_idx, True)
    track_ok = torch.all(err <= cfg.max_inlier_reprojection_error_px, dim=2)
    consensus = valid[None] & ~in_sample & track_ok
    n_consensus = torch.sum(consensus, dim=1)

    # Model error over the inlier set (sample + consensus), matching the
    # reference's selection statistic (tomasi_kanade.cpp:318-343)
    inlier = consensus | (in_sample & valid[None])
    err_sum = torch.sum(torch.where(inlier[..., None], err, torch.zeros_like(err)), dim=(1, 2))
    mean_err = err_sum / torch.clamp(torch.sum(inlier, dim=1) * obs.shape[1], min=1)

    ok = usable & (n_consensus >= cfg.min_consensus_size)
    thr = cfg.max_inlier_reprojection_error_px
    score = torch.where(
        ok,
        n_consensus.to(obs.dtype) + (thr - torch.clamp(mean_err, 0.0, thr)) / (10.0 * thr),
        torch.full_like(mean_err, -torch.inf))
    return samp_idx, score, n_consensus, sol1, sol2


def robust_factorization(obs, valid, width, height, cfg: RansacConfig = RansacConfig(),
                         generator: Optional[torch.Generator] = None,
                         samp_idx=None, q0=None, q0_fallback=None) -> TKResult:
    """RANSAC'd TK factorization (reference: tomasi_kanade.cpp:193-370).

    obs: (T, G, 2) pixel observations of full-group tracks; valid: (T,) mask.
    The draws come from ``generator`` unless given. The fallback (factorize on
    all valid tracks) is always computed and selected when no hypothesis
    reaches the consensus threshold, so the choice needs no host sync.
    """
    if samp_idx is None:
        if generator is None:
            raise ValueError("robust_factorization needs a generator or injected draws")
        samp_idx, q0, q0_fallback = draw_hypotheses(valid, cfg, generator)
    width = torch.as_tensor(width, dtype=obs.dtype, device=obs.device)
    height = torch.as_tensor(height, dtype=obs.dtype, device=obs.device)
    G = obs.shape[1]
    width = torch.broadcast_to(width, (G,))
    height = torch.broadcast_to(height, (G,))

    _, scores, n_con, sol1, sol2 = score_hypothesis(obs, valid, width, height, cfg,
                                                   samp_idx=samp_idx, q0=q0)
    best = torch.argmax(scores)
    found = scores[best] > -torch.inf

    # Factorize over all valid tracks (tomasi_kanade.cpp:361-365)
    fb1, fb2 = factorize(obs[None], valid[None], q0_fallback[None])
    model1 = torch.where(found, sol1[best], fb1[0])
    model2 = torch.where(found, sol2[best], fb2[0])
    num_inliers = torch.where(found, n_con[best] + samp_idx.shape[1], torch.sum(valid))
    return TKResult(model1=model1, model2=model2, num_inliers=num_inliers, found=found)


def resolve_ambiguity(model1, model2, global_dir):
    """Pick the mirror solution whose cam0→cam1 origin direction best matches
    the already-aligned global cameras (reference: tomasi_kanade.cpp:372-444).
    global_dir: (3,), or None for the first group."""
    if global_dir is None:
        return model1

    def local_vec(model):
        on = _unit(_model_geometry(model)[1])
        return on[1] - on[0]

    s1 = torch.dot(global_dir, local_vec(model1))
    s2 = torch.dot(global_dir, local_vec(model2))
    return torch.where(s1 > s2, model1, model2)
