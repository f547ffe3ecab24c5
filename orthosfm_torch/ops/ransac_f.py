"""Pair-batched RANSAC fundamental-matrix estimation (geometric verification):
port of orthosfm_tpu/ops/ransac_f.py.

Replaces MVE's sequential 1000-iteration loop (src/mve/sfm/
ransac_fundamental.cc:26-105): every hypothesis of every pair at once. The
8-point null vector comes from eight unrolled Householder reflections
(_nullspace9, the JAX package's numerics), the rank-2 enforcement is a
batched 3x3 SVD per hypothesis (mve/sfm/fundamental.cc), inliers are scored
by Sampson distance, and the first hypothesis with the most inliers wins.
Coordinates are MVE-normalized ((x + 0.5 − w/2)/max(w, h), feature_set.cc:43-56),
matching the 0.0015 threshold convention.

The samples are an input: (P, iterations, 8) indices into each pair's
valid prefix. JAX keys cannot be reproduced by a torch.Generator, so the
pipeline draws them with one (draw_samples) and the tests inject JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RansacFResult(NamedTuple):
    inliers: torch.Tensor  # (P, M) bool
    num_inliers: torch.Tensor  # (P,)
    fundamental: torch.Tensor  # (P, 3, 3)


def _epipolar_rows(p1, p2):
    """(..., 8, 9) linear-system rows of the 8-point algorithm."""
    x1, y1 = p1[..., 0], p1[..., 1]
    x2, y2 = p2[..., 0], p2[..., 1]
    ones = torch.ones_like(x1)
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1, ones], dim=-1)


def _nullspace9(A):
    """Unit null vectors of (..., 8, 9) systems by unrolled Householder QR of
    Aᵀ: Aᵀ = QR ⇒ null(A) = Q·e₉ = H₁(H₂(…H₈(e₉))). Backward stable, so the
    result matches the SVD null vector to ~cond(A)·ε_f32."""
    B = A.transpose(-1, -2)  # (..., 9, 8)
    rows = torch.arange(9, device=A.device)
    reflectors = []
    for k in range(8):
        col = torch.where(rows >= k, B[..., :, k], 0.0)
        nrm = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
        sign = torch.where(col[..., k:k + 1] >= 0.0, 1.0, -1.0)
        w = col + sign * nrm * (rows == k).to(B.dtype)
        beta = 2.0 / torch.clamp(torch.sum(w * w, dim=-1, keepdim=True), min=1e-30)
        wB = (w[..., None, :] @ B)[..., 0, :]  # (..., 8)
        B = B - beta[..., None] * (w[..., :, None] * wB[..., None, :])
        reflectors.append((w, beta))
    v = (rows == 8).to(B.dtype).expand(A.shape[:-2] + (9,))
    for w, beta in reversed(reflectors):
        v = v - beta * w * torch.sum(w * v, dim=-1, keepdim=True)
    return v / torch.clamp(torch.linalg.vector_norm(v, dim=-1, keepdim=True), min=1e-30)


def enforce_rank2(F):
    """Nearest rank-2 matrices (..., 3, 3): the smallest singular value set
    to 0 (mve/sfm/fundamental.cc enforce_fundamental_constraints)."""
    u, s, vt = torch.linalg.svd(F)
    s = torch.cat([s[..., :2], torch.zeros_like(s[..., 2:])], dim=-1)
    return (u * s[..., None, :]) @ vt


def sampson_distance(F, p1, p2):
    """Squared Sampson distance (mve/sfm/fundamental.cc:225); F (..., 3, 3),
    p1/p2 (..., M, 2) → (..., M)."""
    x1 = torch.cat([p1, torch.ones_like(p1[..., :1])], dim=-1)
    x2 = torch.cat([p2, torch.ones_like(p2[..., :1])], dim=-1)
    Fx1 = x1 @ F.transpose(-1, -2)  # (..., M, 3)
    Ftx2 = x2 @ F
    num = torch.sum(x2 * Fx1, dim=-1) ** 2
    den = Fx1[..., 0] ** 2 + Fx1[..., 1] ** 2 + Ftx2[..., 0] ** 2 + Ftx2[..., 1] ** 2
    return num / torch.clamp(den, min=1e-20)


def ransac_fundamental_batched(p1, p2, valid, samples, threshold: float = 0.0015
                               ) -> RansacFResult:
    """p1, p2: (P, M, 2) normalized correspondences; valid: (P, M);
    samples: (P, I, 8) long indices of each hypothesis's 8 correspondences.

    Rank-2 enforcement runs per hypothesis, as in the reference: scoring the
    un-enforced F measured ~30% fewer inliers on real matched pairs in the
    JAX package."""
    P, I, _ = samples.shape
    thresh2 = threshold * threshold
    pidx = torch.arange(P, device=p1.device)[:, None, None]
    F = _nullspace9(_epipolar_rows(p1[pidx, samples], p2[pidx, samples])).reshape(P, I, 3, 3)
    F = enforce_rank2(F)
    d = sampson_distance(F, p1[:, None], p2[:, None])  # (P, I, M)
    counts = torch.sum((d < thresh2) & valid[:, None], dim=-1)
    best = torch.argmax(counts, dim=-1)  # the first maximum, like jnp.argmax
    F = F[torch.arange(P, device=p1.device), best]
    inliers = (sampson_distance(F, p1, p2) < thresh2) & valid
    return RansacFResult(inliers=inliers, num_inliers=torch.sum(inliers, dim=-1), fundamental=F)


def draw_samples(counts, iterations: int, generator: torch.Generator, size: int = 8):
    """(P, iterations, size) uniform size-subsets of each pair's first
    counts[p] correspondences (counts (P,) long, every count ≥ size), by
    Floyd's algorithm: the j-th draw r ∈ [0, n−size+j] is kept unless
    already taken, in which case n−size+j is taken."""
    P = counts.shape[0]
    device = counts.device
    chosen = torch.empty((P, iterations, size), dtype=torch.long, device=device)
    for j in range(size):
        hi = (counts - size + j)[:, None]  # inclusive upper bound
        u = torch.rand((P, iterations), generator=generator, device=device)
        r = torch.minimum((u * (hi + 1)).long(), hi)
        dup = torch.any(chosen[..., :j] == r[..., None], dim=-1)
        chosen[..., j] = torch.where(dup, hi, r)
    return chosen
