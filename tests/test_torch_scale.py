"""The many-view reconstruction (scripts/scale_demo.py in the JAX package,
testbench/scale_demo.py in the port) at a small size on the CPU: the same
noisy blob tracks through both packages' run_pose_estimation, and the port's
scale_demo entry point with the JAX script's JSON keys.

The two draw their RANSAC samples from different generators (JAX keys, a
torch.Generator), so the comparison is of outcomes, as in
tests/test_torch_pipeline.py: every view placed in both, the same insertion
order, and each camera of the port within 0.05 degrees of the JAX camera
(that file's PORT_VS_JAX_DEG) after the testbench's mirror normalization.
At 1 px both land on the global BA's optimum of the same tracks, so their
cameras agree far inside that bar."""

import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (caps torch's threads)
from tests.test_torch_pipeline import PORT_VS_JAX_DEG

from orthosfm_tpu.config import ReconstructionConfig as JConfig, SolverType as JSolver
from orthosfm_tpu.data import synthetic as jsyn
from orthosfm_tpu.pipeline import incremental as jinc
from orthosfm_tpu.testbench import metrics as jmetrics

from orthosfm_torch.config import ReconstructionConfig, SolverType
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.pipeline import incremental
from orthosfm_torch.testbench import metrics, scale_demo

VIEWS, TRACKS, NOISE_PX = 10, 600, 1.0
# the JAX script's bar at its size (docs/scale_demo.json: 0.007 / 0.013
# degrees at 64 x 50 000); 600 tracks carry ~9x the noise per camera
MEAN_LIMIT_DEG = 0.25


def _noisy_scene(seed=0):
    """The JAX dataset of the scale run (blob cloud, seed 0) with 1 px of
    numpy Gaussian noise on every observation: (JAX tracks, GT cameras)."""
    ds = jsyn.generate_dataset(jsyn.blob_cloud(TRACKS, seed=seed), num_views=VIEWS, seed=seed)
    rng = np.random.default_rng(seed)
    obs = np.asarray(ds.tracks.obs) + NOISE_PX * rng.standard_normal(ds.tracks.obs.shape)
    return ds.tracks.replace(obs=jnp.asarray(obs.astype(np.float32))), ds.gt_cameras


def test_many_view_path_matches_jax():
    tracks, gt = _noisy_scene()
    ref = jinc.run_pose_estimation(tracks, 2048.0, 2048.0,
                                   JConfig(solver=JSolver.ORTHO_QUATERNION, seed=0),
                                   verbose=False)
    got = incremental.run_pose_estimation(tracks_mod.from_numpy(tracks), 2048.0, 2048.0,
                                          ReconstructionConfig(
                                              solver=SolverType.ORTHO_QUATERNION, seed=0),
                                          verbose=False)
    assert ref.present.all() and got.present.all()
    assert got.insertion_order == ref.insertion_order
    ang_ref, _ = jmetrics.pose_errors(ref.cameras, gt)
    ang_got, _ = metrics.pose_errors(got.cameras, cam_mod.from_numpy(gt))
    assert float(np.mean(ang_ref)) < MEAN_LIMIT_DEG and float(np.mean(ang_got)) < MEAN_LIMIT_DEG
    ang, _ = metrics.pose_errors(got.cameras, cam_mod.from_numpy(ref.cameras))
    assert float(np.max(ang)) < PORT_VS_JAX_DEG


def test_scale_demo_prints_the_jax_keys_and_its_counts(tmp_path, capsys):
    """The port's entry point on the CPU at the small size: the JAX
    script's keys (docs/scale_demo.json), every view placed, the schedule's
    BA calls (a global BA every third group and a final one), no kernel
    launched on the CPU, and the pose estimation's stages."""
    out_file = tmp_path / "scale.json"
    assert scale_demo.main(["--views", str(VIEWS), "--tracks", str(TRACKS), "--runs", "1",
                            "--platform", "cpu", "--json", str(out_file)]) == 0
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    out = json.loads(out_file.read_text())
    assert printed == out
    with open("docs/scale_demo.json") as f:
        assert set(json.load(f)) <= set(out)
    assert out["platform"] == "cpu" and out["views_placed"] == VIEWS
    assert out["mean_angular_error_deg"] < MEAN_LIMIT_DEG
    groups = VIEWS - 2
    assert out["ba"]["global_ba_calls"] == groups // 3 + 1
    assert out["ba"]["ba_calls"] == groups + groups // 3 + 1
    assert out["ba"]["by_views"]["3"]["ba_calls"] == groups
    assert 0 < out["ba"]["iterations_worked"] <= out["ba"]["iterations_launched"]
    assert set(out["launches"].values()) == {0} and set(out["camera_solve_routes"].values()) == {0}
    assert set(out["lm_fused_routes"].values()) == {0}
    assert {"pose/tk", "pose/local_ba", "pose/global_ba"} <= set(out["stages_s"])
    assert out["tk"]["hypotheses"] == 241 and out["tk"]["tracks"] == TRACKS
    assert out["peak_bytes"] is None and out["tk"]["tk_peak_bytes"] is None


def test_scale_demo_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        scale_demo.run_scale_demo(VIEWS, TRACKS)
