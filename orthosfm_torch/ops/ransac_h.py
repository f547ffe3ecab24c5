"""Pair-batched RANSAC homography estimation with IRLS refinement: port of
orthosfm_tpu/ops/ransac_h.py.

The counterpart of the reference's CudaSift geometric verification
(src/cuda_sift/matching.cu FindHomography: 10000 random 4-point hypotheses,
each scored by its transfer error at 60 px; src/cuda_sift/geomFuncs.cpp:6-60
ImproveHomography: 50 iteratively reweighted 8×8 DLT solves over the
inliers at 30 px). Plain PyTorch on the device: the JAX package computes
this in XLA, with no Pallas kernel, and the batched 8×8 solves are
torch.linalg.solve_ex.

The samples are an input: (P, iterations, 4) indices into each pair's valid
prefix. The JAX package draws them by a Gumbel top-4 from JAX keys
(ransac_h.py:69-70), which a torch.Generator cannot reproduce, so the
pipeline draws them with draw_samples and the tests inject JAX's.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from orthosfm_torch.ops import ransac_f


class RansacHResult(NamedTuple):
    inliers: torch.Tensor  # (..., M) bool
    num_inliers: torch.Tensor  # (...,)
    homography: torch.Tensor  # (..., 3, 3)


def _dlt_rows(p1, p2):
    """DLT constraint rows for h (8-vector, h22 = 1), two rows per point:
    ((..., 2, 8), (..., 2))."""
    x, y = p1[..., 0], p1[..., 1]
    u, v = p2[..., 0], p2[..., 1]
    z = torch.zeros_like(x)
    o = torch.ones_like(x)
    r1 = torch.stack([x, y, o, z, z, z, -u * x, -u * y], dim=-1)
    r2 = torch.stack([z, z, z, x, y, o, -v * x, -v * y], dim=-1)
    return torch.stack([r1, r2], dim=-2), torch.stack([u, v], dim=-1)


def _to_h(h):
    """(..., 8) → (..., 3, 3) with h22 = 1."""
    return torch.cat([h, torch.ones_like(h[..., :1])], dim=-1).reshape(h.shape[:-1] + (3, 3))


def _solve8(A, b):
    """Batched 8×8 solves; a singular system gives NaN (as the JAX package's
    LU solve gives a non-finite h), whose hypothesis then has no inlier."""
    h, info = torch.linalg.solve_ex(A, b)
    return torch.where(info[..., None] == 0, h, torch.full_like(h, float("nan")))


def homography_from_4(p1, p2):
    """Exact homographies from 4 correspondences: p1, p2 (..., 4, 2) →
    (..., 3, 3)."""
    rows, rhs = _dlt_rows(p1, p2)  # (..., 4, 2, 8), (..., 4, 2)
    A = rows.reshape(rows.shape[:-3] + (8, 8))
    b = rhs.reshape(rhs.shape[:-2] + (8,))
    eye = torch.eye(8, dtype=A.dtype, device=A.device)
    return _to_h(_solve8(A + 1e-10 * eye, b))


def transfer_errors(H, p1, p2):
    """Squared one-way transfer error ‖H·p1 − p2‖² (CudaSift TestHomography):
    H (..., 3, 3), p1, p2 (..., M, 2) → (..., M). Formed row by row, so that
    scoring I hypotheses of P pairs (H (P, I, 3, 3), p1 (P, 1, M, 2)) holds no
    block larger than (P, I, M)."""
    x, y = p1[..., 0], p1[..., 1]
    h = H[..., None, :, :]  # against the M axis

    def row(r):
        return h[..., r, 0] * x + h[..., r, 1] * y + h[..., r, 2]

    w = row(2)
    w = torch.where(torch.abs(w) < 1e-12, torch.full_like(w, 1e-12), w)
    return (row(0) / w - p2[..., 0]) ** 2 + (row(1) / w - p2[..., 1]) ** 2


def find_homography_batched_keys(p1, p2, valid, samples, threshold_px: float = 30.0,
                                 find_threshold_px: float = 60.0,
                                 refine_loops: int = 50) -> RansacHResult:
    """RANSAC + IRLS homography of P pairs at once (reference parameters:
    hypotheses scored at 60 px, 50 refinement loops at 30 px,
    matching.cpp:183-187). p1, p2: (P, M, 2) pixel correspondences; valid:
    (P, M); samples: (P, I, 4) long indices of each hypothesis's 4
    correspondences, the counterpart of the JAX package's per-pair keys.
    The first hypothesis with the most inliers wins."""
    P = p1.shape[0]
    pidx = torch.arange(P, device=p1.device)[:, None, None]
    Hs = homography_from_4(p1[pidx, samples], p2[pidx, samples])  # (P, I, 3, 3)
    find_t2 = find_threshold_px * find_threshold_px
    counts = torch.sum((transfer_errors(Hs, p1[:, None], p2[:, None]) < find_t2)
                       & valid[:, None], dim=-1)  # (P, I)
    H = Hs[torch.arange(P, device=p1.device), torch.argmax(counts, dim=-1)]
    limit = threshold_px * threshold_px

    # IRLS refinement: weighted 8×8 DLT over the current inliers
    # (geomFuncs.cpp:15-58)
    rows, rhs = _dlt_rows(p1, p2)  # (P, M, 2, 8), (P, M, 2)
    rows, rhs = rows.reshape(P, -1, 8), rhs.reshape(P, -1)
    eye = torch.eye(8, dtype=p1.dtype, device=p1.device)
    for _ in range(refine_loops):
        w = ((transfer_errors(H, p1, p2) < limit) & valid).to(p1.dtype)  # (P, M)
        w2 = torch.repeat_interleave(w, 2, dim=1)  # (P, 2M)
        A = (rows * w2[..., None]).transpose(1, 2) @ rows
        b = ((rows * w2[..., None]) * rhs[..., None]).sum(dim=1)
        H_new = _to_h(_solve8(A + 1e-6 * eye, b))
        ok = torch.sum(w, dim=-1) >= 4
        H = torch.where(ok[:, None, None], H_new, H)
    inliers = (transfer_errors(H, p1, p2) < limit) & valid
    return RansacHResult(inliers=inliers, num_inliers=torch.sum(inliers, dim=-1), homography=H)


def find_homography(p1, p2, valid, samples, threshold_px: float = 30.0,
                    find_threshold_px: float = 60.0, refine_loops: int = 50) -> RansacHResult:
    """find_homography_batched_keys of one pair: p1, p2 (M, 2), valid (M,),
    samples (I, 4)."""
    res = find_homography_batched_keys(p1[None], p2[None], valid[None], samples[None],
                                       threshold_px, find_threshold_px, refine_loops)
    return RansacHResult(*(x[0] for x in res))


def draw_samples(counts, iterations: int, generator: torch.Generator):
    """(P, iterations, 4) uniform 4-subsets of each pair's first counts[p]
    correspondences (every count ≥ 4)."""
    return ransac_f.draw_samples(counts, iterations, generator, size=4)
