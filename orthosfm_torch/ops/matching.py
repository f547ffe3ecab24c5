"""Pairwise descriptor matching: port of orthosfm_tpu/ops/matching.py.

Replacement for the reference's matchers (MVE exhaustive/cascade hashing:
src/mve/sfm/{matching,exhaustive_matching,cascade_hashing}.*; CudaSift:
src/cuda_sift/matching.cu): exact nearest neighbours by the descriptor
product, the Lowe ratio test on squared distances (MVE matching.h:126-142)
and the mutual cross-check (matching.cc:18-36).

The per-row top-2 of every pair, in both directions, runs through one call
of ops.matching_kernels.top2: the hand-written CUDA kernel for CUDA tensors
(one product per pair, never stored), its plain PyTorch version for CPU
tensors.
"""

from __future__ import annotations

import torch

from orthosfm_torch.ops.matching_kernels import BIG, top2

#: match_pairs_batched's mark on the rows of a pair out of range
BAD_PAIR = -2


def match_pairs_batched(stack, bi, bj, ci, cj, lowe_ratio: float = 0.8, impl: str = "auto"):
    """Two-way Lowe-ratio + mutual-consistency matching for a batch of view
    pairs of one descriptor stack, from one top2 call (both directions of
    one product per pair).

    stack: (V, N, D) descriptors; pair p matches view bi[p] (its first ci[p]
    rows valid) against view bj[p] (first cj[p] rows valid); bi, bj, ci, cj
    (P,) int32 on the stack's device. Returns (P, N) long: the index into
    view bj[p] of each row of view bi[p], −1 for unmatched, BAD_PAIR on
    every row of a pair whose views or counts lie out of range (checked
    where the result is pulled: see check_pulled). Semantics of the JAX
    package's match_pairs_batched on stack[bi], iota < ci, stack[bj],
    iota < cj."""
    N = stack.shape[1]
    rows = torch.arange(N, device=stack.device)
    r2 = lowe_ratio * lowe_ratio
    out = top2(stack, bi, bj, ci, cj, impl=impl)

    def oneway(d_best, d_second, idx, cA):
        ok = (d_best <= r2 * d_second) & (rows[None, :] < cA[:, None]) & (d_best < BIG)
        return torch.where(ok, idx.long(), -1)

    m12 = oneway(*out[:3], ci)  # (P, N)
    m21 = oneway(*out[3:], cj)  # (P, N)
    back = torch.gather(m21, 1, torch.clamp(m12, 0, max(N - 1, 0)))
    consistent = (m12 >= 0) & (back == rows[None, :])
    return torch.where(out[2][:, :1] < 0, BAD_PAIR, torch.where(consistent, m12, -1))


def check_pulled(m12):
    """m12 from match_pairs_batched, pulled to the host (numpy): raises if a
    pair was out of range, else returns it."""
    if (m12 == BAD_PAIR).any():
        raise ValueError("a pair's views lie outside the descriptor stack or its valid counts "
                         "outside [0, N]")
    return m12


def match_pair(desc1, valid1, desc2, valid2, lowe_ratio: float = 0.8, impl: str = "auto"):
    """Two-way matching of one pair: desc (N, D) unit descriptors whose
    valid rows form a prefix (valid1/valid2 (N,) masks). Returns (N1,) long
    indices into set 2, −1 for unmatched. The single-pair case of
    match_pairs_batched."""
    n1, n2 = desc1.shape[0], desc2.shape[0]
    N = max(n1, n2)
    counts = []
    for v in (valid1, valid2):
        c = int(v.sum())
        if not bool(v[:c].all()):
            raise ValueError("valid rows must form a prefix")
        counts.append(c)
    stack = torch.zeros((2, N, desc1.shape[1]), dtype=torch.float32, device=desc1.device)
    stack[0, :n1] = desc1
    stack[1, :n2] = desc2
    pair = torch.tensor([[0, 1, counts[0], counts[1]]], dtype=torch.int32, device=desc1.device)
    m = match_pairs_batched(stack, *pair.T.contiguous(), lowe_ratio=lowe_ratio, impl=impl)
    return m[0, :n1]


def count_matches(m12):
    return torch.sum(m12 >= 0)


def lowres_subset(scale, valid, n: int):
    """Indices of the n largest-scale (lowest-resolution) valid features:
    the low-res matchability gate subset (MVE matching_base.h:46-52), in
    lax.top_k's order (lower index first among equal scales)."""
    score = torch.where(valid, scale, -torch.inf)
    return torch.sort(score, descending=True, stable=True).indices[:n]
