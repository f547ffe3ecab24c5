"""The frozen input generators agree with the program's own at a small size
(the test may import the program; the harness's generators do not)."""

import numpy as np
import pytest

from sfm_bench.inputs import render as frozen_render
from sfm_bench.inputs import synthetic as frozen

from orthosfm_torch.data import synthetic
from orthosfm_torch.testbench import render


@pytest.mark.parametrize("name,spec", [("Cube", {"shape": "cube", "n_per_edge": 21}),
                                       ("Sphere", {"shape": "sphere", "points": 3800}),
                                       ("Blob", {"shape": "blob", "points": 7800})])
def test_clouds(name, spec):
    np.testing.assert_array_equal(frozen.cloud(spec, 0), synthetic.CLOUDS[name]())


@pytest.mark.parametrize("seed", [0, 11, 2**31 + 5])
def test_tracks_and_noise(seed):
    views, pts = 5, synthetic.blob_cloud(200, seed=3)
    ds = synthetic.generate_dataset(pts, num_views=views, seed=seed, device="cpu")
    angles = frozen.ring_angles(views, seed)
    obs, R = frozen.project_cloud(pts, angles, 2048.0, 2048.0)
    np.testing.assert_allclose(obs, ds.tracks.obs.numpy(), atol=2e-3)
    from orthosfm_torch.core import cameras as cam_mod

    np.testing.assert_allclose(R, cam_mod.basis(ds.gt_cameras).double().numpy(), atol=1e-6)
    noisy = synthetic.add_observation_noise(ds.tracks, 7.0, np.random.default_rng(seed), 0.6)
    mine = frozen.add_noise(ds.tracks.obs.numpy(), 7.0, np.random.default_rng(seed), 0.6)
    np.testing.assert_array_equal(mine, noisy.obs.numpy())


def test_sphere_render():
    rng = np.random.default_rng(4)
    angles = render.trajectory_angles("circle", 3, 200.0, 10.0, 6.0, rng)
    np.testing.assert_array_equal(
        angles, frozen_render.circle_angles(3, 200.0, 10.0, 6.0, np.random.default_rng(4)))
    from orthosfm_torch.core import cameras as cam_mod

    gt = cam_mod.make_euler(np.arange(3), 64, 64, angles=angles, device="cpu")
    want = render.render_views(gt, 64, 64, render.SphereScene(0.75),
                               texture=render.FourierTexture3D(seed=9))
    got, R = frozen_render.render_sphere(angles, 64, 64, frozen_render.FourierTexture3D(seed=9),
                                         device="cpu")
    for v in range(3):
        np.testing.assert_array_equal(got[v].numpy(), want[v][..., 0].numpy())
    np.testing.assert_allclose(R, cam_mod.basis(gt).double().numpy(), atol=1e-6)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_noise_levels_are_drawn_evenly(seed):
    """Each pair of cloud and solver takes one level in each sixth of 0-100
    px; a seed's 36 levels are spaced 101/36 apart, so at least three lie at
    10 px or under (where the mix states accuracy bars)."""
    from sfm_bench.inputs import generate

    mix = {"clouds": [{}] * 3, "solvers": ["a", "b"], "noise_px_range": [0, 100],
           "noise_px_slots": 6}
    levels = generate.noise_levels(mix, seed)
    assert levels.shape == (6, 6) and len(np.unique(levels)) == 36
    for m in range(6):
        assert np.all((levels[:, m] >= m * 101 / 6 - 1) & (levels[:, m] < (m + 1) * 101 / 6))
    assert np.sum(levels <= 10) >= 3
    spacing = np.diff(np.sort(levels.ravel()))
    assert spacing.min() >= 2 and spacing.max() <= 3


def test_noise_levels_cover_the_range_uniformly():
    from sfm_bench.inputs import generate

    mix = {"clouds": [{}] * 3, "solvers": ["a", "b"], "noise_px_range": [0, 100],
           "noise_px_slots": 6}
    counts = np.bincount(np.concatenate([generate.noise_levels(mix, s).ravel().astype(int)
                                         for s in range(1000)]), minlength=101)
    assert len(counts) == 101 and counts.min() > 0.85 * 1000 * 36 / 101
