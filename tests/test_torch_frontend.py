"""The image front end: renderer, gray preparation, SIFT, SURF,
pair matching, RANSAC-F and track building, through the JAX package and
through the port, on the same inputs; and the port's CLI from images.

Inputs are numpy (the renderer's scene parameters are numpy draws). The JAX
reference's SIFT and SURF run once per module, on the padded gray stack the
pipeline itself builds, so the pipeline test reuses their compiled programs.

Tolerances, each with its reason:
- renderer: uint8 images equal except ≤ 0.1% of pixels off by 1 (float64
  trig and dot products of two libraries);
- gray preparation, halving and the integral image: bit-equal (the same
  operations in the same order, exact integer sums);
- SIFT / SURF: ≥ 97% of the JAX keypoints have the port's keypoint in the
  same slot within 0.01 px, 1e-4 relative scale, 1e-3 rad and 1e-3 max abs
  on the descriptor (blur sums and atan2 differ by ulps; thresholds may
  flip a marginal keypoint);
- matching: indices equal except on rows whose best and second d2 lie
  within 1e-5 (the two libraries' f32 products differ by a few 1e-7);
- RANSAC-F with JAX's draws injected: inlier masks equal except points
  within 1e-3 relative of the threshold, inlier counts within 1;
- track building: identical track lists for the same pair matches;
- the pipeline on 3 views (JAX's RANSAC draws injected): the same accepted
  pairs, inlier counts and track counts within 5%.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (caps torch's threads)

from orthosfm_tpu.config import MatchingConfig as JMatching
from orthosfm_tpu.config import ReconstructionConfig as JConfig
from orthosfm_tpu.core import cameras as jcam
from orthosfm_tpu.data.views import View as JView
from orthosfm_tpu.ops import matching as jmatch
from orthosfm_tpu.ops import ransac_f as jransac
from orthosfm_tpu.ops import sift as jsift
from orthosfm_tpu.ops import surf as jsurf
from orthosfm_tpu.pipeline import matching as jpipe
from orthosfm_tpu.pipeline import tracks_build as jtracks
from orthosfm_tpu.testbench import render as jrender

from orthosfm_torch import app
from orthosfm_torch.config import MatchingConfig, ReconstructionConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.data.views import View
from orthosfm_torch.io import cameras_io, timing
from orthosfm_torch.ops import matching as match_ops
from orthosfm_torch.ops import matching_kernels as mk
from orthosfm_torch.ops import ransac_f, sift, surf
from orthosfm_torch.pipeline import matching as pipe
from orthosfm_torch.pipeline import tracks_build
from orthosfm_torch.testbench import metrics, render

SIZE = 160
NEAR_TIE = 1e-5


@pytest.fixture(scope="module")
def scene():
    """3 sphere views at 160², 20° apart: (numpy RGB images, JAX views,
    port views)."""
    _, images, _ = render.make_scene_views(3, SIZE, SIZE, seed=3, ring_degrees=60.0,
                                          device="cpu")
    rgb = [im.numpy() for im in images]
    jviews = [JView(i, f"view_{i:02d}.png", SIZE, SIZE, pixels=p) for i, p in enumerate(rgb)]
    pviews = [View(i, f"view_{i:02d}.png", SIZE, SIZE, pixels=p) for i, p in enumerate(rgb)]
    return rgb, jviews, pviews


@pytest.fixture(scope="module")
def grays(scene):
    """The pipeline's padded gray stack (3, 256, 256), from the port."""
    _, _, pviews = scene
    prepared = pipe._prepare_grays(pviews, ReconstructionConfig(), "cpu")
    return torch.stack([p[0] for p in prepared])


@pytest.fixture(scope="module")
def jax_features(grays):
    """The JAX package's raw SIFT and SURF slot arrays of the gray stack."""
    g = jnp.asarray(grays.numpy())
    return jsift.extract_batch(g, min_octave=0), jsurf.extract_batch(g)


# ---------------------------------------------------------------------------
# Renderer and gray preparation


@pytest.mark.parametrize("name", ["sphere", "blob", "cube"])
def test_render_views_matches_jax(name):
    rng = np.random.default_rng(5)
    angles = jrender.trajectory_angles("circle", 3, 90.0, 10.0, 6.0, rng)
    ref = jrender.render_views(jcam.make_euler(np.arange(3), 96, 80, angles=angles), 96, 80,
                               jrender.SCENES[name](3), jrender.FourierTexture3D(seed=4))
    got = render.render_views(cam_mod.make_euler(np.arange(3), 96, 80, angles=angles), 96, 80,
                              render.SCENES[name](3), render.FourierTexture3D(seed=4))
    diff = np.abs(np.stack(ref).astype(int) - torch.stack(got).numpy().astype(int))
    assert diff.max() <= 1
    assert np.mean(diff > 0) <= 1e-3


@pytest.mark.parametrize("max_pixels", [6_000_000, 10_000])
def test_prepare_grays_bit_equal(scene, max_pixels):
    """Gray from the channel sum, `halvings` half-size reductions (0 and 1
    here) and the edge padding to a multiple of 128: bit-equal."""
    _, jviews, pviews = scene
    ref = jpipe._prepare_grays(jviews, JConfig(matching=JMatching(max_image_pixels=max_pixels)))
    got = pipe._prepare_grays(pviews, ReconstructionConfig(
        matching=MatchingConfig(max_image_pixels=max_pixels)), "cpu")
    for (gj, hj, yj, xj), (gp, hp, yp, xp) in zip(ref, got):
        assert (hj, yj, xj) == (hp, yp, xp)
        np.testing.assert_array_equal(np.asarray(gj), gp.numpy())


def test_integral_image_bit_equal(grays):
    np.testing.assert_array_equal(np.asarray(jsurf.integral_image(jnp.asarray(grays.numpy()))),
                                  surf.integral_image(grays).numpy())


# ---------------------------------------------------------------------------
# SIFT and SURF


def _wrapped(a, b):
    d = np.abs(a - b) % (2 * np.pi)
    return np.minimum(d, 2 * np.pi - d)


def _assert_features_agree(ref, got, min_count):
    """≥ 97% of the JAX keypoints have the port's keypoint in the same slot
    within the module's tolerances; the port has no extra keypoints beyond
    3% either."""
    for v in range(ref.valid.shape[0]):
        rv, gv = np.asarray(ref.valid[v]), got.valid[v]
        assert rv.sum() >= min_count
        desc_err = np.abs(np.asarray(ref.desc[v]) - got.desc[v].numpy()).max(axis=-1)
        close = (rv & gv
                 & np.all(np.abs(np.asarray(ref.xy[v]) - got.xy[v]) <= 0.01, axis=-1)
                 & (np.abs(got.scale[v] / np.where(rv, ref.scale[v], 1.0) - 1.0) <= 1e-4)
                 & (_wrapped(np.asarray(ref.orientation[v]), got.orientation[v]) <= 1e-3)
                 & (desc_err <= 1e-3))
        assert close.sum() >= 0.97 * rv.sum(), (v, int(close.sum()), int(rv.sum()))
        assert gv.sum() <= rv.sum() + 0.03 * rv.sum(), (v, int(gv.sum()), int(rv.sum()))


def test_sift_matches_jax(grays, jax_features):
    _assert_features_agree(jax_features[0], sift.extract_batch(grays, min_octave=0), 50)


def test_surf_matches_jax(grays, jax_features):
    _assert_features_agree(jax_features[1], surf.extract_batch(grays), 30)


def test_top_k_first_ranks_like_lax_top_k():
    score = np.array([[0.5, -1.0, 0.5, 2.0, 0.0, 2.0, 0.5, -1.0]], np.float32)
    vals, idx = sift.top_k_first(torch.as_tensor(score), 5)
    ref_vals, ref_idx = jax.lax.top_k(jnp.asarray(score), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref_idx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(ref_vals))


# ---------------------------------------------------------------------------
# Matching


def _descriptor_stack(D, seed=0, V=5, N=300):
    """Unit descriptors with exact duplicates: every database row of view 1
    appears twice, view 2's first rows equal view 1's duplicated rows (best
    and second d2 exactly equal), and view 4 repeats some rows of view 3."""
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(V, N, D)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[1, N // 2:] = d[1, :N - N // 2]
    d[2, :40] = d[1, :40]
    d[4, 100:150] = d[3, :50]
    return d


# (view i, view j, valid rows of i, valid rows of j): full sets, ragged
# prefixes, a repeated view, and databases of 0 and 1 valid rows
PAIRS = [(0, 1, 300, 300), (2, 1, 300, 300), (3, 4, 280, 257), (1, 1, 300, 300),
         (0, 3, 300, 0), (4, 2, 300, 1), (2, 0, 1, 300)]


@pytest.mark.parametrize("D", [128, 64])
def test_match_pairs_batched_matches_jax(D):
    d = _descriptor_stack(D)
    bi, bj, ci, cj = (np.array(c) for c in zip(*PAIRS))
    N = d.shape[1]
    iota = np.arange(N)
    ref = np.asarray(jmatch.match_pairs_batched(
        jnp.asarray(d[bi]), jnp.asarray(iota[None] < ci[:, None]),
        jnp.asarray(d[bj]), jnp.asarray(iota[None] < cj[:, None]), lowe_ratio=0.8))
    cols = [torch.as_tensor(c.astype(np.int32)) for c in (bi, bj, ci, cj)]
    got = match_ops.match_pairs_batched(torch.as_tensor(d), *cols, lowe_ratio=0.8).numpy()
    # rows where either direction has a near tie may differ
    best, second = mk.top2_ref(torch.as_tensor(d), *cols)[:2]
    near = ((second - best) <= NEAR_TIE).numpy() & (iota[None] < ci[:, None])
    assert np.array_equal(got[~near], ref[~near])
    # view 4's rows 100..149 repeat view 3's first 50: mutual matches
    np.testing.assert_array_equal(got[2, :50], np.arange(100, 150))
    assert np.all(got[4] == -1) and np.all(got[5] == -1)  # 0 and 1 valid database rows


def test_top2_plain_version_semantics():
    """Exact duplicates tie (best = second) at the lower column, an empty
    database gives (4, 4, 0), one valid row gives second = 4, rows past ci
    give (4, 4, 0); the backward outputs likewise, per database row."""
    d = _descriptor_stack(64)
    cols = [torch.as_tensor(np.array(c, np.int32)) for c in zip(*PAIRS)]
    out = [x.numpy() for x in mk.top2_ref(torch.as_tensor(d), *cols)]
    best, second, idx = out[:3]
    b_best, b_second, b_idx = out[3:]
    assert np.all(b_best[4] == 4.0) and np.all(b_idx[4] == 0)
    assert np.all(b_second[6] == 4.0) and np.all(b_idx[6] == 0) and np.all(b_best[6] < 4.0)
    assert np.all(b_best[5, 1:] == 4.0) and np.all(b_idx[5, 1:] == 0) and b_best[5, 0] < 4.0
    assert np.all(idx[1, :40] == np.arange(40)) and np.all(best[1, :40] == second[1, :40])
    assert np.all(best[1, :40] < 1e-6)
    assert np.all(best[4] == 4.0) and np.all(second[4] == 4.0) and np.all(idx[4] == 0)
    assert np.all(second[5] == 4.0) and np.all(idx[5] == 0) and np.all(best[5] < 4.0)
    assert np.all(best[6, 1:] == 4.0) and np.all(idx[6, 1:] == 0)
    sim = jnp.asarray(d[3]) @ jnp.asarray(d[4]).T
    ref = np.asarray(jax.lax.top_k(-jnp.maximum(2.0 - 2.0 * sim, 0.0).at[:, 257:].set(4.0),
                                   2)[1])[:280, 0]
    far = ((second[2] - best[2]) > NEAR_TIE)[:280]
    np.testing.assert_array_equal(idx[2][:280][far], ref[far])


def test_top2_routes_by_device_and_never_falls_back():
    """CPU tensors take the plain version; the kernel route on CPU tensors
    raises instead of quietly running the plain version."""
    d = torch.as_tensor(_descriptor_stack(64))
    cols = [torch.as_tensor(np.array(c, np.int32)) for c in zip(*PAIRS)]
    before = mk.top2.launches
    for got, ref in zip(mk.top2(d, *cols), mk.top2_ref(d, *cols)):
        assert torch.equal(got, ref)
    assert mk.top2.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        mk.top2(d, *cols, impl="kernel")
    with pytest.raises(ValueError, match="impl"):
        mk.top2(d, *cols, impl="fast")


def test_match_pair_matches_jax():
    d = _descriptor_stack(128)
    valid = np.arange(300) < 250
    ref = np.asarray(jmatch.match_pair(jnp.asarray(d[3]), jnp.asarray(valid),
                                       jnp.asarray(d[4]), jnp.ones(300, bool)))
    got = match_ops.match_pair(torch.as_tensor(d[3]), torch.as_tensor(valid),
                               torch.as_tensor(d[4]), torch.ones(300, dtype=torch.bool)).numpy()
    np.testing.assert_array_equal(got, ref)
    assert int(match_ops.count_matches(torch.as_tensor(got))) == int((ref >= 0).sum()) >= 50
    with pytest.raises(ValueError, match="prefix"):
        match_ops.match_pair(torch.as_tensor(d[3]), torch.as_tensor(~valid),
                             torch.as_tensor(d[4]), torch.ones(300, dtype=torch.bool))


def test_lowres_subset_matches_jax():
    scale = np.array([1.0, 3.0, 2.0, 3.0, 0.5, 2.0], np.float32)
    valid = np.array([True, True, False, True, True, True])
    ref = np.asarray(jmatch.lowres_subset(jnp.asarray(scale), jnp.asarray(valid), 4))
    got = match_ops.lowres_subset(torch.as_tensor(scale), torch.as_tensor(valid), 4).numpy()
    np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# RANSAC-F


def test_nullspace9_matches_jax():
    rng = np.random.default_rng(1)
    A = rng.normal(size=(64, 8, 9)).astype(np.float32)
    ref = np.asarray(jax.jit(jax.vmap(jransac._nullspace9))(jnp.asarray(A)))
    got = ransac_f._nullspace9(torch.as_tensor(A)).numpy()
    np.testing.assert_allclose(got, ref, atol=2e-5)
    np.testing.assert_allclose(np.abs(np.einsum("bij,bj->bi", A, got)).max(), 0.0, atol=2e-5)


def _jax_draws(keys, valid, iterations):
    """The sample indices JAX's ransac_fundamental draws from each pair's
    key: gumbel noise over the valid rows, top 8 (ransac_f.py:99-104)."""

    def one(key, v):
        def hyp(k):
            g = jax.random.gumbel(k, v.shape)
            return jax.lax.top_k(jnp.where(v, g, -jnp.inf), 8)[1]

        return jax.vmap(hyp)(jax.random.split(key, iterations))

    return np.array(jax.jit(jax.vmap(one))(keys, jnp.asarray(valid)))


def _epipolar_pairs(P=3, M=160, seed=2):
    """Correspondences of two affine cameras (noise-free), 25% outliers and a
    ragged valid prefix, in normalized coordinates."""
    rng = np.random.default_rng(seed)
    p1 = np.zeros((P, M, 2), np.float32)
    p2 = np.zeros((P, M, 2), np.float32)
    valid = np.zeros((P, M), bool)
    for p in range(P):
        X = rng.uniform(-1, 1, (M, 3))
        a = np.deg2rad(10 + 8 * p)
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])
        p1[p] = 0.3 * X[:, :2]
        p2[p] = 0.3 * (X @ R.T)[:, :2] + 0.01 * p
        bad = rng.choice(M, M // 4, replace=False)
        p2[p, bad] = rng.uniform(-0.3, 0.3, (len(bad), 2))
        valid[p, :M - 13 * p] = True
    return p1, p2, valid


def test_ransac_f_with_jax_draws_matches_jax():
    p1, p2, valid = _epipolar_pairs()
    keys = jax.random.split(jax.random.PRNGKey(11), p1.shape[0])
    iters, thr = 200, 0.0015
    ref = jransac.ransac_fundamental_batched_keys(jnp.asarray(p1), jnp.asarray(p2),
                                                  jnp.asarray(valid), keys, iterations=iters,
                                                  threshold=thr)
    samples = torch.as_tensor(_jax_draws(keys, valid, iters)).long()
    got = ransac_f.ransac_fundamental_batched(torch.as_tensor(p1), torch.as_tensor(p2),
                                              torch.as_tensor(valid), samples, threshold=thr)
    d = ransac_f.sampson_distance(got.fundamental, torch.as_tensor(p1),
                                  torch.as_tensor(p2)).numpy()
    marginal = np.abs(d / thr**2 - 1.0) <= 1e-3
    ref_inl = np.asarray(ref.inliers)
    assert np.array_equal(got.inliers.numpy()[~marginal], ref_inl[~marginal])
    assert np.all(np.abs(got.num_inliers.numpy() - np.asarray(ref.num_inliers)) <= 1)
    assert np.all(got.num_inliers.numpy() >= 0.7 * valid.sum(axis=1))


def test_draw_samples_are_distinct_valid_subsets():
    gen = torch.Generator().manual_seed(0)
    counts = torch.tensor([8, 9, 40])
    s = ransac_f.draw_samples(counts, 500, gen)
    assert s.shape == (3, 500, 8)
    srt = torch.sort(s, dim=-1).values
    assert bool(torch.all(srt[..., 1:] != srt[..., :-1]))
    assert bool(torch.all((s >= 0) & (s < counts[:, None, None])))
    assert bool(torch.all(srt[0] == torch.arange(8)))  # 8 of 8: every row once
    # uniform over the 40: each index drawn 500·8/40 = 100 times on average
    hist = torch.bincount(s[2].reshape(-1), minlength=40).float()
    assert float(hist.min()) > 60 and float(hist.max()) < 140


# ---------------------------------------------------------------------------
# Tracks and the pipeline


def test_tracks_build_identical_to_jax():
    rng = np.random.default_rng(0)
    counts = [300, 250, 280, 310, 200]
    pm = [(i, j, rng.choice(counts[i], 120, replace=False),
           rng.choice(counts[j], 120, replace=False))
          for i in range(5) for j in range(i + 1, 5)]
    ref = jtracks.build_tracks(pm, counts)
    assert len(ref) > 20
    assert tracks_build.build_tracks(pm, counts) == ref
    assert tracks_build.build_tracks([], counts) == []


def test_build_tracks_matches_jax(scene, jax_features, monkeypatch):
    """match_all_pairs + tracks_from_matches on the 3-view scene. RANSAC-F
    gets JAX's draws: the pipeline's keys (seed + 7919, one per candidate)
    over its padded match count (pipeline/matching.py:465-482)."""
    _, jviews, pviews = scene
    jcfg, cfg = JConfig(), ReconstructionConfig()
    jfeats = jpipe.extract_all_view_features(jviews, jcfg)
    ref = jpipe.match_all_pairs(jfeats, jcfg, verbose=False)

    def jax_draws(counts, iterations, generator):
        P = counts.shape[0]
        M = jpipe._bucket(int(counts.max()), 256)
        _, k = jax.random.split(jax.random.PRNGKey(cfg.seed + 7919))
        valid = np.arange(M)[None] < counts.numpy()[:, None]
        return torch.as_tensor(_jax_draws(jax.random.split(k, P), valid, iterations)).long()

    monkeypatch.setattr(pipe.ransac_f, "draw_samples", jax_draws)
    feats = pipe.extract_all_view_features(pviews, cfg, "cpu")
    got = pipe.match_all_pairs(feats, cfg, verbose=False)
    assert [f.count for f in feats] == [f.count for f in jfeats]
    assert [(i, j) for i, j, _, _ in got] == [(i, j) for i, j, _, _ in ref] != []
    for (_, _, a_ref, _), (_, _, a_got, _) in zip(ref, got):
        assert abs(len(a_got) - len(a_ref)) <= 0.05 * len(a_ref)
    t_ref = jpipe.tracks_from_matches(jviews, jfeats, ref)
    t_got = pipe.tracks_from_matches(pviews, feats, got, device="cpu")
    n_ref, n_got = int(np.asarray(t_ref.alive).sum()), int(t_got.alive.sum())
    assert abs(n_got - n_ref) <= 0.05 * n_ref
    # the same pair matches give the same TrackSet
    t_same = pipe.tracks_from_matches(pviews, jfeats, ref, device="cpu")
    for name in ("obs", "obs_mask", "local_ids", "global_ids", "alive"):
        np.testing.assert_array_equal(getattr(t_same, name).numpy(),
                                      np.asarray(getattr(t_ref, name)), err_msg=name)


def test_cli_reconstructs_from_images(tmp_path):
    """The JAX package's bar for the full pipeline
    (tests/test_full_pipeline.py:17-39), on the port alone, from PNGs."""
    images, proj = tmp_path / "images", tmp_path / "project"
    gt = render.make_image_dataset(str(images), num_views=5, width=224, height=224, seed=3,
                                   ring_degrees=100, device="cpu")
    assert app.main([str(proj), str(images), "--device", "cpu"]) == 0
    for name in ("cameras.txt", "sparse_cloud.ply", "tracks.txt", "time_measurements.txt"):
        assert (proj / name).is_file(), name
    entries = cameras_io.import_cameras(str(proj / "cameras.txt"))
    assert len(entries) == 5
    R = torch.as_tensor(np.stack([e.transform[:3, :3] for e in entries]), dtype=torch.float32)
    cams = cam_mod.make_quaternion(np.arange(5), 224.0, 224.0, q=quat.from_matrix(R))
    order = [int(e.image_name[5:7]) for e in entries]  # cameras.txt is in insertion order
    ang, pos = metrics.pose_errors(cams, cam_mod.take(gt, order))
    assert ang.max() < 3.0, ang
    assert pos.max() < 0.06, pos
    assert timing.load_runtimes(str(proj / "time_measurements.txt")).total_time > 0
    assert len((proj / "tracks.txt").read_text().splitlines()) >= 100


def test_cli_without_cuda_stops_unless_cpu_is_named(tmp_path, monkeypatch, capsys):
    """The device defaults to CUDA; with no CUDA device the CLI exits
    non-zero, names --device cpu and writes nothing, instead of carrying on
    on the CPU."""
    images, proj = tmp_path / "images", tmp_path / "project"
    images.mkdir()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert app.main([str(proj), str(images)]) != 0
    assert "--device cpu" in capsys.readouterr().out
    assert not proj.exists()
