"""Rotation alignment between point correspondence sets (Kabsch/Umeyama).

Port of orthosfm_tpu/core/umeyama.py: replaces Eigen::umeyama(src, dst,
false) as the reference uses it for group→global alignment (reference:
OrthographicReconstructionAlgorithm.cpp:125-141). Only the rotation block is
consumed, so R is returned directly.
"""

from __future__ import annotations

import torch


def rotation_align(src, dst):
    """Best rotation R (3,3) minimizing Σ‖R·src_i − dst_i‖² after demeaning.

    src, dst: (N, 3) correspondence points. Handles reflections via the
    det-sign correction (Umeyama 1991)."""
    src_c = src - src.mean(dim=0, keepdim=True)
    dst_c = dst - dst.mean(dim=0, keepdim=True)
    cov = dst_c.T @ src_c  # (3, 3)
    u, _, vt = torch.linalg.svd(cov)
    d = torch.sign(torch.linalg.det(u) * torch.linalg.det(vt))
    diag = torch.diag(torch.stack([torch.ones_like(d), torch.ones_like(d), d]))
    return u @ diag @ vt
