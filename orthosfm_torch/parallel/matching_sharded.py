"""Pair-axis sharding for the matching stage: port of
orthosfm_tpu/parallel/matching_sharded.py over torch.distributed.

The reference's largest parallel surface is the omp-parallel per-pair loop
(src/mve/sfm/bundler_matching.cc:74-96). Here the batched pair programs
(the top2 matcher of ops.matching.match_pairs_batched, RANSAC-F and
RANSAC-H verification) run on each rank's share of the pair axis; pairs
are independent, so the only collective is the all_gather of the results.
The RANSAC sample indices are drawn for all pairs before the pair axis is
split (pipeline.matching), as the JAX package pre-splits per-pair keys, so
matches and tracks are those of a run on one device.
"""

from __future__ import annotations

import torch

from orthosfm_torch.parallel.mesh import Mesh


def pad_pair_axis(arrs, n: int):
    """Zero-pads each tensor's leading (pair) axis to a multiple of n.
    Returns (padded tensors, original length)."""
    p0 = arrs[0].shape[0]
    pad = (-p0) % n
    if pad == 0:
        return list(arrs), p0
    return [torch.cat([a, a.new_zeros((pad, *a.shape[1:]))]) for a in arrs], p0


def _gather(mesh: Mesh, out, p0: int):
    """Every rank's `out` (a tensor, or a NamedTuple of them, pair axis
    first), all-gathered and cut back to the p0 real pairs."""
    if isinstance(out, torch.Tensor):
        return mesh.all_gather(out)[:p0]
    return type(out)(*(mesh.all_gather(x)[:p0] for x in out))


def run_over_pairs(mesh: Mesh, fn, *arrs):
    """fn(*arrs) (batched over the leading pair axis of every operand) with
    that axis split over the mesh's ranks: each rank runs fn on its pairs,
    padded pairs (zeros) are computed and cut off, and every rank gets every
    pair's result."""
    if mesh is None or mesh.size == 1 and mesh.group is None:
        return fn(*arrs)
    padded, p0 = pad_pair_axis(arrs, mesh.size)
    sl = mesh.shard(padded[0].shape[0])
    return _gather(mesh, fn(*(a[sl] for a in padded)), p0)
