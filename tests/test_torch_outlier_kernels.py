"""The outlier filter's neighbour-search kernel (orthosfm_torch/csrc/
outlier_kernels.cu: outlier_nn_kernel; ops/outlier_kernels.py) on the CPU.

The CUDA source built for the host (outlier_kernels.host_library) runs the
kernel's arithmetic, every CTA one after another with the candidate axis
split as on the card (so the min-combine runs), against the plain version
(ops/outliers.nearest_neighbor_distances with impl="torch", which
tests/test_torch_core.py holds to the JAX package): the squared distances
within TOL_ULPS ulp of |p_i|² + max_j |p_j|² (the expansion's own
rounding: the kernel rounds as the plain version does on the card, where
torch.sum and the GEMM sum in other orders than on the CPU), exact zeros for
tracks without a point, an exact twin as the nearest at that rounding of 0,
1e6 for a pointed track with no pointed neighbour, the
same bits whatever the split, and the same tracks kept by
filter_outlier_tracks. Also: CPU tensors never reach the kernel, the launch
plan, and the wrapper's constants against the source. The card's tests are
in tests/test_torch_cuda.py.
"""

import re

import numpy as np
import pytest
import torch

from orthosfm_torch.config import FilterConfig
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.ops import outlier_kernels as okern
from orthosfm_torch.ops import outliers

torch.set_num_threads(2)

TOL_ULPS = 4


def _case(name):
    """(points (T, 4) f32 with w = 1, has_pt (T,) bool, twins: index pairs
    of exact duplicates, both pointed), from numpy, seeded."""
    rng = np.random.default_rng(sum(map(ord, name)))
    T = {"ragged_holes": 700, "duplicates": 300, "lone": 200, "all_unpointed": 150,
         "one_track": 1}[name]
    pts = np.ones((T, 4), np.float32)
    pts[:, :3] = rng.normal(scale=0.7, size=(T, 3))
    has = rng.random(T) > 0.2
    twins = []
    if name == "duplicates":
        for a, b in ((3, 250), (17, 18), (120, 299)):
            pts[b] = pts[a]
            has[a] = has[b] = True
            twins.append((a, b))
    if name == "lone":
        has[:] = False
        has[77] = True
    if name == "all_unpointed":
        has[:] = False
    if name == "one_track":
        has[:] = True
    return torch.from_numpy(pts), torch.from_numpy(has), twins


CASES = ("ragged_holes", "duplicates", "lone", "all_unpointed", "one_track")


def _d2_tolerance(pts, has):
    sq = (pts.double() ** 2).sum(1)
    top = float(sq[has].max()) if bool(has.any()) else 0.0
    return TOL_ULPS * torch.finfo(torch.float32).eps * (sq + top)


@pytest.mark.parametrize("name", CASES)
def test_kernel_arithmetic_matches_plain_version(name):
    pts, has, twins = _case(name)
    T = pts.shape[0]
    ref = outliers.nearest_neighbor_distances(pts, has, impl="torch")
    chunk = okern.launch_plan(T)
    splits = -(-T // chunk)
    if T > okern.TILE:
        assert splits > 1  # the min-combine of the partial minima runs
    got = okern.outlier_nn_host(pts, has, chunk)
    for other in (T, okern.TILE, 45):
        # the same bits in one share, in whole stages and in padded ones
        assert torch.equal(got, okern.outlier_nn_host(pts, has, other))

    assert torch.equal(got[~has], torch.zeros_like(got[~has]))
    gap = (got.double() ** 2 - ref.double() ** 2).abs()
    assert bool((gap[has] <= _d2_tolerance(pts, has)[has]).all()), float(gap.max())
    n_pointed = int(has.sum())
    if n_pointed == 1:
        assert float(got[has]) == float(ref[has]) == 1e6
    tol = _d2_tolerance(pts, has)
    for a, b in twins:
        # the twin is the nearest, at the expansion's rounding of 0
        assert float(got[a]) == float(got[b]) and float(got[a]) ** 2 <= float(tol[a])
    others = has.clone()
    for a, b in twins:
        others[a] = others[b] = False
    assert bool((got[others] > 0).all())  # a track is never its own neighbour


def test_filter_keeps_the_tracks_the_plain_version_keeps(monkeypatch):
    """filter_outlier_tracks with the kernel's arithmetic in place of the
    plain sweep: the same alive and has_point, on a blob of 2402 tracks with
    holes and far-off points."""
    rng = np.random.default_rng(5)
    T = 2402
    ts = tracks_mod.empty(T, 3, device="cpu")
    pts = np.ones((T, 4), np.float32)
    pts[:, :3] = rng.normal(scale=0.5, size=(T, 3))
    pts[::37, :3] += rng.normal(scale=3.0, size=pts[::37, :3].shape)
    ts = ts.replace(points=torch.from_numpy(pts), has_point=torch.from_numpy(rng.random(T) > 0.1),
                    alive=torch.from_numpy(rng.random(T) > 0.05))
    ref = outliers.filter_outlier_tracks(ts, FilterConfig())
    monkeypatch.setattr(outliers, "nearest_neighbor_distances",
                        lambda p, h: okern.outlier_nn_host(p, h, okern.launch_plan(T)))
    got = outliers.filter_outlier_tracks(ts, FilterConfig())
    assert torch.equal(got.alive, ref.alive) and torch.equal(got.has_point, ref.has_point)
    assert 0 < int(ref.alive.sum()) < T


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(okern, "library", refuse)
    pts, has, _ = _case("ragged_holes")
    before = okern.outlier_nn.launches
    auto = outliers.nearest_neighbor_distances(pts, has)
    assert torch.equal(auto, outliers.nearest_neighbor_distances(pts, has, impl="torch"))
    assert okern.outlier_nn.launches == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        outliers.nearest_neighbor_distances(pts, has, impl="kernel")


@pytest.mark.parametrize("T", [1, 700, 2402, 3800, 7800, 50000])
def test_launch_plan_fills_the_card_once(T):
    """The candidate shares cover T, each at least half a stage; shares x
    query blocks stays within one wave of resident CTAs, fills every SM at
    sweep16's track counts (2402-7800) and most of the wave at 50 000."""
    chunk = okern.launch_plan(T)
    splits, blocks = -(-T // chunk), -(-T // okern.QUERIES)
    slots = okern.H100_SMS * okern.MIN_BLOCKS
    assert chunk * (splits - 1) < T <= chunk * splits
    assert chunk >= min(T, okern.TILE // 2)
    assert splits * blocks <= max(slots, blocks)
    if T >= 2402:
        assert splits * blocks >= okern.H100_SMS
    if T == 50000:
        assert splits * blocks >= 0.9 * slots


def test_wrapper_constants_are_the_sources():
    src = okern.SOURCE.read_text()
    for name in ("THREADS", "ROWS", "TILE", "MIN_BLOCKS"):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src)[1]) == getattr(okern, name)
    assert "outlier_nn_kernel" in src
