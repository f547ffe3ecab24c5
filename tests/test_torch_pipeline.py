"""The slice as a whole: pose estimation from a track set, through the JAX
package and through the port, on the same tracks.

The two draw their RANSAC samples from different generators (JAX keys, a
torch.Generator), so the comparison is of outcomes: the same views placed in
the same order, both within 1e-2 degrees of ground truth on perfect tracks,
and each camera of the port within 0.05 degrees of the JAX camera. Angles
are compared after the reference testbench's global-mirror normalization
(testbench.metrics.pose_errors), since an orthographic reconstruction is
defined up to that mirror."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (caps torch's threads)

from orthosfm_tpu import app as japp
from orthosfm_tpu.config import ReconstructionConfig as JConfig, SolverType as JSolver
from orthosfm_tpu.core import cameras as jcam
from orthosfm_tpu.data import synthetic as jsyn
from orthosfm_tpu.io import tracks_io as jtracks_io
from orthosfm_tpu.pipeline import incremental as jinc
from orthosfm_tpu.testbench import metrics as jmetrics

from orthosfm_torch import app
from orthosfm_torch.config import ReconstructionConfig, SolverType
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.io import cameras_io, timing
from orthosfm_torch.pipeline import incremental
from orthosfm_torch.testbench import metrics

GT_LIMIT_DEG = 1e-2
PORT_VS_JAX_DEG = 0.05
# theta / roll ranges of the ground-truth ring that each solver can represent
# (EulerHorizontal has phi only, EulerHorizontalVertical phi and theta)
GT_RANGES = {0: (30.0, 30.0), 1: (0.0, 0.0), 2: (30.0, 0.0), 3: (30.0, 30.0)}


def _sphere_scene(solver, num_views=6, n_points=300):
    theta, roll = GT_RANGES[solver]
    gt = jsyn.generate_gt_cameras(num_views, theta_range=theta, roll_range=roll, seed=0)
    ds = jsyn.generate_dataset(jsyn.sphere_cloud(n_points), num_views=num_views, seed=0)
    pts = jnp.concatenate([jnp.asarray(jsyn.sphere_cloud(n_points) / 3.0, jnp.float32),
                           jnp.ones((n_points, 1), jnp.float32)], axis=-1)
    return ds.tracks.replace(obs=jnp.transpose(jcam.project(gt, pts), (1, 0, 2))), gt


@pytest.mark.parametrize("solver", [0, 1, 2, 3])
def test_pose_estimation_matches_jax(solver):
    tracks, gt = _sphere_scene(solver)
    wh = np.full(6, 2048.0)
    ref = jinc.run_pose_estimation(tracks, wh, wh, JConfig(solver=JSolver(solver)),
                                   verbose=False)
    got = incremental.run_pose_estimation(tracks_mod.from_numpy(tracks), wh, wh,
                                          ReconstructionConfig(solver=SolverType(solver)),
                                          verbose=False)
    np.testing.assert_array_equal(got.present, ref.present)
    assert got.insertion_order == ref.insertion_order
    assert got.cameras.rot.dtype == torch.float32
    ang_ref, _ = jmetrics.pose_errors(ref.cameras, gt)
    ang_got, _ = metrics.pose_errors(got.cameras, cam_mod.from_numpy(gt))
    assert float(np.mean(ang_ref)) < GT_LIMIT_DEG
    assert float(np.mean(ang_got)) < GT_LIMIT_DEG
    ang, _ = metrics.pose_errors(got.cameras, cam_mod.from_numpy(ref.cameras))
    assert float(np.max(ang)) < PORT_VS_JAX_DEG
    assert bool(torch.all(got.tracks.has_point[got.tracks.alive]))


def _cams_from_file(path):
    """cameras.txt → (names, CameraSet of the stored rotations)."""
    entries = cameras_io.import_cameras(path)
    R = torch.as_tensor(np.stack([e.transform[:3, :3] for e in entries]), dtype=torch.float32)
    cams = cam_mod.make_quaternion(np.arange(len(entries)), 2048.0, 2048.0,
                                   q=quat.from_matrix(R))
    return [e.image_name for e in entries], cams


def test_cli_matches_jax_cli_on_verify_drive(tmp_path, monkeypatch):
    """The verify drive (16 views, 1500-track blob, 2048² blank images)
    through `--calculated-tracks` of both CLIs."""
    from PIL import Image

    images = tmp_path / "images"
    images.mkdir()
    blank = Image.new("RGB", (2048, 2048))
    for i in range(16):
        blank.save(images / f"view_{i:02d}.png")
    ds = jsyn.generate_dataset(jsyn.blob_cloud(1500), num_views=16, seed=0)
    track_file = str(tmp_path / "tracks.txt")
    jtracks_io.save_tracks(ds.tracks, track_file)

    # The JAX CLI points jax's persistent compile cache at a fixed directory;
    # keep this test's compiles out of it.
    update = jax.config.update
    monkeypatch.setattr(jax.config, "update", lambda k, v: None if "cache" in k else update(k, v))
    assert japp.main([str(tmp_path / "jax"), str(images), "--calculated-tracks", track_file]) == 0
    assert app.main([str(tmp_path / "port"), str(images), "--calculated-tracks", track_file,
                     "--device", "cpu"]) == 0

    for name in ("cameras.txt", "sparse_cloud.ply", "time_measurements.txt", "project.txt"):
        assert (tmp_path / "port" / name).is_file(), name
    t = timing.load_runtimes(str(tmp_path / "port" / "time_measurements.txt"))
    assert t.total_time >= t.pose_estimation_time > 0.0
    vertices = []
    for side in ("jax", "port"):
        head = (tmp_path / side / "sparse_cloud.ply").read_text().splitlines()[2]
        assert head.startswith("element vertex ")
        vertices.append(int(head.split()[-1]))
    # the outlier filters keep the same points up to a few at their thresholds
    assert abs(vertices[1] - vertices[0]) <= 0.02 * vertices[0], vertices

    names_j, cams_j = _cams_from_file(str(tmp_path / "jax" / "cameras.txt"))
    names_p, cams_p = _cams_from_file(str(tmp_path / "port" / "cameras.txt"))
    assert names_p == names_j and len(names_p) == 16
    ang, _ = metrics.pose_errors(cams_p, cams_j)
    assert float(np.max(ang)) < PORT_VS_JAX_DEG
    # the verify drive's own bar: ground truth recovered (cameras.txt rows
    # are in insertion order; reorder them by view id)
    order = [int(name[5:7]) for name in names_p]
    gt = cam_mod.take(cam_mod.from_numpy(ds.gt_cameras), order)
    ang_gt, _ = metrics.pose_errors(cams_p, gt)
    assert float(np.mean(ang_gt)) < GT_LIMIT_DEG
