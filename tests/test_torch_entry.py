"""The port's library entry point, orthosfm_torch.reconstruct: it runs on
CUDA unless the caller names another device, and without a CUDA device it
raises at once rather than fall back to the CPU (as the CLI does)."""

import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (caps torch's threads)

import orthosfm_torch
from orthosfm_torch.config import ReconstructionConfig
from orthosfm_torch.data import synthetic
from orthosfm_torch.io import cameras_io, tracks_io
from orthosfm_torch.pipeline import reconstruct as reconstruct_mod
from orthosfm_torch.testbench import metrics
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat

N_VIEWS = 6
WIDTH = 256


def _project(tmp_path):
    """Six blank 256² views and the perfect tracks of a 300-point blob."""
    from PIL import Image

    images = tmp_path / "images"
    images.mkdir()
    for i in range(N_VIEWS):
        Image.new("RGB", (WIDTH, WIDTH)).save(images / f"view_{i:02d}.png")
    ds = synthetic.generate_dataset(synthetic.blob_cloud(300), num_views=N_VIEWS,
                                    width=WIDTH, height=WIDTH, seed=0)
    track_file = str(tmp_path / "tracks.txt")
    tracks_io.save_tracks(ds.tracks, track_file)
    project = tmp_path / "project"
    project.mkdir()
    return ReconstructionConfig(project_folder=str(project), image_folder=str(images),
                                track_file=track_file), ds


@pytest.mark.parametrize("entry", [orthosfm_torch.reconstruct, reconstruct_mod.reconstruct])
def test_reconstruct_without_cuda_raises_and_names_cpu(entry, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    config, _ = _project(tmp_path)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        entry(config, verbose=False)
    # it raised before doing any work
    assert not any((tmp_path / "project").iterdir())


def test_reconstruct_on_the_cpu_when_asked(tmp_path):
    config, ds = _project(tmp_path)
    res, views = orthosfm_torch.reconstruct(config, verbose=False, device="cpu")
    assert len(views) == N_VIEWS and bool(np.all(res.present))
    assert res.cameras.rot.device.type == "cpu"
    entries = cameras_io.import_cameras(str(tmp_path / "project" / "cameras.txt"))
    assert len(entries) == N_VIEWS
    R = torch.as_tensor(np.stack([e.transform[:3, :3] for e in entries]), dtype=torch.float32)
    cams = cam_mod.make_quaternion(np.arange(N_VIEWS), WIDTH, WIDTH, q=quat.from_matrix(R))
    order = [int(e.image_name[5:7]) for e in entries]
    ang, _ = metrics.pose_errors(cams, cam_mod.take(ds.gt_cameras, order))
    assert float(np.mean(ang)) < 1e-2
