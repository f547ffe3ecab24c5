"""The port's RANSAC-H (orthosfm_torch/ops/ransac_h.py) and the pipeline's
homography branch against the JAX package's (orthosfm_tpu/ops/ransac_h.py,
pipeline/matching.py:406-460).

The port takes the 4-point sample indices as an input; the tests inject the
indices the JAX package's Gumbel top-4 draws from its keys, so both score
the same hypotheses. Tolerances: inlier masks equal; homographies within
1e-3 of max |H| (f32 8×8 solves in another order: measured ~3e-4); the DLT
pieces within 1e-4 relative."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (caps torch's threads)
from tests.torch_port_helpers import n, t

from orthosfm_tpu.ops import ransac_h as jrh
from orthosfm_torch.config import MatchingConfig, ReconstructionConfig, SolverType
from orthosfm_torch.io import project as project_io
from orthosfm_torch.ops import ransac_h
from orthosfm_torch.pipeline import matching as pipeline_matching
from orthosfm_torch.pipeline.reconstruct import reconstruct
from orthosfm_torch.testbench import metrics, render

H_TRUE = np.array([[1.02, 0.05, 12.0], [-0.03, 0.98, -7.0], [1e-5, -2e-5, 1.0]])


def _pairs(P, M, seed=0):
    """P pairs of up to M pixel correspondences under a perturbed H_TRUE,
    a quarter of them outliers, 2 px noise on the rest; ragged valid
    prefixes."""
    rng = np.random.default_rng(seed)
    p1 = np.zeros((P, M, 2), np.float32)
    p2 = np.zeros((P, M, 2), np.float32)
    valid = np.zeros((P, M), bool)
    for p in range(P):
        count = M - 12 * p
        H = H_TRUE + rng.normal(0, 1e-3, (3, 3)) * [[1, 1, 100], [1, 1, 100], [1e-3, 1e-3, 0]]
        a = rng.uniform(0, 1000, (count, 2))
        q = np.concatenate([a, np.ones((count, 1))], -1) @ H.T
        b = q[:, :2] / q[:, 2:3] + rng.normal(0, 2.0, (count, 2))
        bad = rng.choice(count, count // 4, replace=False)
        b[bad] += rng.uniform(-200, 200, (len(bad), 2))
        p1[p, :count], p2[p, :count], valid[p, :count] = a, b, True
    return p1, p2, valid


def _jax_draws(key, valid, iterations):
    """The (iterations, 4) indices find_homography draws from `key`: a
    Gumbel top-4 over the valid entries of each split key."""
    keys = jax.random.split(key, iterations)
    v = jnp.asarray(valid)
    return np.asarray(jax.vmap(lambda k: jax.lax.top_k(
        jnp.where(v, jax.random.gumbel(k, v.shape), -jnp.inf), 4)[1])(keys))


def test_dlt_pieces_match():
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 500, (16, 4, 2)).astype(np.float32)
    b = (a + rng.uniform(-20, 20, a.shape)).astype(np.float32)
    H_j = np.stack([np.asarray(jrh.homography_from_4(jnp.asarray(x), jnp.asarray(y)))
                    for x, y in zip(a, b)])
    H_p = n(ransac_h.homography_from_4(t(a), t(b)))
    np.testing.assert_allclose(H_p, H_j, rtol=1e-4, atol=1e-4 * np.abs(H_j).max())
    pts1 = rng.uniform(0, 500, (100, 2)).astype(np.float32)
    pts2 = rng.uniform(0, 500, (100, 2)).astype(np.float32)
    e_j = np.asarray(jrh.transfer_errors(jnp.asarray(H_j[0]), jnp.asarray(pts1),
                                         jnp.asarray(pts2)))
    e_p = n(ransac_h.transfer_errors(t(H_j[0]), t(pts1), t(pts2)))
    np.testing.assert_allclose(e_p, e_j, rtol=1e-4)


def test_batched_keys_match_jax_with_its_draws_injected():
    """M = 64, 200 hypotheses, three pairs of 64, 52 and 40 correspondences."""
    P, M, iters = 3, 64, 200
    p1, p2, valid = _pairs(P, M)
    keys = jax.random.split(jax.random.PRNGKey(3), P)
    ref = jrh.find_homography_batched_keys(jnp.asarray(p1), jnp.asarray(p2),
                                           jnp.asarray(valid), keys, iterations=iters)
    samples = np.stack([_jax_draws(keys[p], valid[p], iters) for p in range(P)])
    got = ransac_h.find_homography_batched_keys(t(p1), t(p2), t(valid),
                                                torch.as_tensor(samples, dtype=torch.long))
    np.testing.assert_array_equal(n(got.inliers), np.asarray(ref.inliers))
    np.testing.assert_array_equal(n(got.num_inliers), np.asarray(ref.num_inliers))
    H_j = np.asarray(ref.homography)
    for p in range(P):
        assert np.abs(n(got.homography)[p] - H_j[p]).max() <= 1e-3 * np.abs(H_j[p]).max()
    # the single-pair entry point is the batched one's first pair
    one = ransac_h.find_homography(t(p1[0]), t(p2[0]), t(valid[0]),
                                   torch.as_tensor(samples[0], dtype=torch.long))
    np.testing.assert_array_equal(n(one.inliers), n(got.inliers)[0])


def test_recovers_a_homography_with_its_own_draws():
    """The JAX package's test_homography_recovery with the port's sampler:
    300 points, 30% outliers, 2000 hypotheses."""
    rng = np.random.default_rng(0)
    count = 300
    a = rng.uniform(0, 1000, (count, 2))
    q = np.concatenate([a, np.ones((count, 1))], -1) @ H_TRUE.T
    b = q[:, :2] / q[:, 2:3]
    bad = rng.choice(count, 90, replace=False)
    b[bad] += rng.uniform(-200, 200, (90, 2))
    gen = torch.Generator().manual_seed(1)
    samples = ransac_h.draw_samples(torch.tensor([count]), 2000, gen)[0]
    res = ransac_h.find_homography(t(a), t(b), torch.ones(count, dtype=torch.bool), samples)
    inl = n(res.inliers)
    good = ~np.isin(np.arange(count), bad)
    assert inl[good].mean() > 0.95 and inl[bad].mean() < 0.1
    H = n(res.homography)
    np.testing.assert_allclose(H / H[2, 2], H_TRUE, atol=0.5)


def test_draw_samples_are_distinct_valid_indices():
    counts = torch.tensor([4, 5, 60])
    s = ransac_h.draw_samples(counts, 500, torch.Generator().manual_seed(0))
    assert s.shape == (3, 500, 4)
    srt = torch.sort(s, dim=-1).values
    assert bool((srt[..., 1:] != srt[..., :-1]).all())
    assert bool((s < counts[:, None, None]).all()) and bool((s >= 0).all())
    # a pair of exactly 4 correspondences always samples all four
    assert bool((srt[0] == torch.arange(4)).all())


def test_a_singular_system_scores_no_inlier():
    """A singular 8×8 system gives NaN (torch.linalg.solve would raise; the
    JAX package's LU solve returns a non-finite h) and its homography
    scores no inlier."""
    A = torch.eye(8).repeat(2, 1, 1)
    A[1, 7] = A[1, 6]  # two equal rows
    h = ransac_h._solve8(A, torch.ones(2, 8))
    assert bool(torch.isfinite(h[0]).all()) and not bool(torch.isfinite(h[1]).any())
    pts = t(np.random.default_rng(0).uniform(0, 100, (10, 2)))
    e = ransac_h.transfer_errors(ransac_h._to_h(h[1]), pts, pts)
    assert not bool((e < 3600.0).any())


def test_unknown_matcher_raises():
    config = ReconstructionConfig(matching=MatchingConfig(matcher="flann"))
    with pytest.raises(ValueError, match="unknown matcher 'flann'"):
        pipeline_matching.match_all_pairs([], config, verbose=False)


def test_reconstruct_with_the_homography_engine(tmp_path):
    """The JAX package's test_reconstruct_homography_engine
    (tests/test_full_pipeline.py:107) on the port, on the CPU: 5 views of
    224², seed 3, a 100° ring, 2000 hypotheses (the reference's 10000 run on
    the card, chip_smoke.py phase 7); every view placed, max error < 3°."""
    images = str(tmp_path / "images")
    proj = str(tmp_path / "project")
    gt = render.make_image_dataset(images, num_views=5, width=224, height=224, seed=3,
                                   ring_degrees=100, device="cpu")
    project_io.create_project(proj)
    cfg = ReconstructionConfig(project_folder=proj, image_folder=images,
                               solver=SolverType.ORTHO_QUATERNION)
    cfg = dataclasses.replace(cfg, matching=dataclasses.replace(
        cfg.matching, pair_verification="homography", homography_iterations=2000))
    res, _ = reconstruct(cfg, verbose=False, device="cpu")
    assert bool(res.present.all())
    ang, _ = metrics.pose_errors(res.cameras, gt)
    assert ang.max() < 3.0, ang
    assert os.path.isfile(os.path.join(proj, "cameras.txt"))
