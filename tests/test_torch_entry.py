"""The port's entry points: orthosfm_torch.reconstruct and load_tracks run on
CUDA unless the caller names another device, and without a CUDA device they
raise at once rather than fall back to the CPU (as the CLI does); the native
tracks.txt reader against its plain version and the JAX package's reader;
the config and CLI against the JAX package's fields and flags; the BA
kernels' view ceiling; and no module of the port imports JAX."""

import dataclasses

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
                                    width=WIDTH, height=WIDTH, seed=0, device="cpu")
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


# ---------------------------------------------------------------------------
# load_tracks: the native reader, on CUDA unless the caller names the CPU


def test_load_tracks_defaults_to_cuda(tmp_path, monkeypatch):
    """Without a card load_tracks raises, naming device="cpu", unless the
    caller asks for the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ds = _project(tmp_path)
    path = str(tmp_path / "tracks.txt")
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tracks_io.load_tracks(path, np.arange(N_VIEWS))
    tracks = tracks_io.load_tracks(path, np.arange(N_VIEWS), device="cpu")
    assert tracks.obs.device.type == "cpu"
    # tracks.txt holds 6 significant digits
    torch.testing.assert_close(tracks.obs, ds.tracks.obs, rtol=5e-6, atol=1e-6)


def _tracks_file(path, seed=0):
    """A tracks.txt of ragged tracks over views 10..15 with colors, written by
    the JAX package."""
    from orthosfm_tpu.data import tracks as jtracks
    from orthosfm_tpu.io import tracks_io as jtracks_io

    rng = np.random.default_rng(seed)
    tracks = []
    for _ in range(200):
        views = rng.choice(np.arange(10, 16), size=rng.integers(2, 7), replace=False)
        tracks.append([(int(v), int(rng.integers(0, 5000)), int(v) * (1 << 20) + 7,
                        float(rng.uniform(0, 2048)), float(rng.uniform(0, 2048)),
                        *(int(c) for c in rng.integers(0, 256, 3))) for v in views])
    jtracks_io.save_tracks(jtracks.from_feature_lists(tracks, np.arange(10, 16)), path)


def _fields(tracks):
    """A TrackSet's fields (the port's or the JAX package's) as numpy arrays."""
    from orthosfm_torch.data.tracks import TrackSet

    return {f.name: np.asarray(x.cpu() if isinstance(x, torch.Tensor) else x)
            for f in dataclasses.fields(TrackSet) for x in [getattr(tracks, f.name)]}


@pytest.mark.parametrize("capacity", [None, 150, 260])
def test_native_reader_matches_the_plain_and_jax_readers(tmp_path, capacity):
    from orthosfm_tpu.io import tracks_io as jtracks_io

    path = str(tmp_path / "tracks.txt")
    _tracks_file(path)
    view_ids = np.array([12, 10, 11, 15, 13, 14])  # columns in another order
    got = tracks_io.load_tracks(path, view_ids, capacity=capacity, device="cpu")
    plain = tracks_io.load_tracks_plain(path, view_ids, capacity=capacity)
    ref = jtracks_io.load_tracks(path, view_ids, capacity=capacity)
    for name, a in _fields(got).items():
        np.testing.assert_array_equal(a, _fields(plain)[name], err_msg=name)
        np.testing.assert_array_equal(a, _fields(ref)[name], err_msg=name)
        assert a.dtype == _fields(ref)[name].dtype, name


@pytest.mark.parametrize("damage", ["trailing separator", "short track", "bad count",
                                    "text in a field", "missing file"])
def test_native_reader_raises_on_a_strict_parse_failure(tmp_path, damage):
    """The files the JAX package's native reader refuses (it then falls back
    to its Python loop, orthosfm_tpu/io/tracks_io.py:35-45): the port
    raises instead."""
    from orthosfm_tpu import native

    path = str(tmp_path / "tracks.txt")
    _tracks_file(path)
    lines = open(path).read().splitlines()
    if damage == "trailing separator":
        lines[3] += ";"
    elif damage == "short track":
        lines[5] = lines[5].rsplit(";", 8)[0]
    elif damage == "bad count":
        lines[0] = "-1" + lines[0][lines[0].index(";"):]
    elif damage == "text in a field":
        lines[7] = lines[7].replace(";", ";x", 1)
    if damage == "missing file":
        path = str(tmp_path / "absent.txt")
    else:
        open(path, "w").write("\n".join(lines) + "\n")
    assert native.parse_tracks_file(path) is None
    with pytest.raises(ValueError, match="not a readable tracks.txt"):
        tracks_io.parse_tracks_file(path)
    with pytest.raises(ValueError):
        tracks_io.load_tracks(path, np.arange(10, 16), device="cpu")


def test_native_reader_that_fails_to_build_raises(tmp_path, monkeypatch):
    from orthosfm_torch import kernel_build

    monkeypatch.setattr(kernel_build, "CXX", str(tmp_path / "no-such-compiler"))
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "build")
    tracks_io.library.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="cannot be built"):
            tracks_io.library()
    finally:
        tracks_io.library.cache_clear()


# ---------------------------------------------------------------------------
# The config and CLI take the JAX package's fields and flags


def test_config_takes_every_jax_field():
    """Every field of the JAX package's config dataclasses, with its JAX
    default, builds the port's, which then holds the same values (a field
    added to the JAX package later fails here)."""
    import orthosfm_tpu.config as jconfig

    import orthosfm_torch.config as pconfig

    for name in ("RansacConfig", "BundleAdjustConfig", "FilterConfig", "MatchingConfig"):
        jcls, pcls = getattr(jconfig, name), getattr(pconfig, name)
        jobj = jcls()
        kwargs = {f.name: getattr(jobj, f.name) for f in dataclasses.fields(jcls)}
        pobj = pcls(**kwargs)
        for key, value in kwargs.items():
            assert getattr(pobj, key) == value, (name, key)
    jrc = jconfig.ReconstructionConfig(project_folder="p", image_folder="i", seed=4)
    kwargs = {f.name: getattr(jrc, f.name) for f in dataclasses.fields(jrc)}
    for sub in ("ransac", "ba", "filters", "matching"):
        obj = kwargs[sub]
        kwargs[sub] = getattr(pconfig, type(obj).__name__)(
            **{f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)})
    kwargs["solver"] = pconfig.SolverType(int(kwargs["solver"]))
    prc = pconfig.ReconstructionConfig(**kwargs)
    assert prc.camera_distance == jrc.camera_distance and prc.seed == 4
    assert prc.matching.homography_iterations == 10000
    assert prc.matching.matcher == "cascade_hashing"


def test_cli_platform_flag(tmp_path, monkeypatch):
    """--platform cpu runs on the CPU as --device cpu does; --platform gpu
    names the card and without one the CLI exits non-zero."""
    from orthosfm_torch import app

    config, _ = _project(tmp_path)
    argv = [config.project_folder, config.image_folder, "--calculated-tracks",
            config.track_file, "--overwrite"]
    assert app.main(argv + ["--platform", "cpu"]) == 0
    assert len(cameras_io.import_cameras(str(tmp_path / "project" / "cameras.txt"))) == N_VIEWS
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert app.main(argv + ["--platform", "gpu"]) == 1
    assert app.main(argv + ["--device", "cpu", "--platform", "cuda"]) == 1
    with pytest.raises(SystemExit):
        app.build_parser().parse_args(argv + ["--platform", "tpu"])


def test_dataset_generators_run_on_cuda_unless_asked(monkeypatch):
    """synthetic.generate_dataset and problems.make_problem default to CUDA:
    without a card they raise, naming device="cpu", rather than run on the
    CPU unasked; asked for the CPU they run there."""
    from orthosfm_torch.testbench.problems import make_problem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        synthetic.generate_dataset(synthetic.sphere_cloud(20), num_views=3)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        make_problem("quat", num_views=3, n_points=20)
    ds = synthetic.generate_dataset(synthetic.sphere_cloud(20), num_views=3, device="cpu")
    cams, points, obs, mask = make_problem("quat", "cpu", num_views=3, n_points=20)
    assert ds.tracks.obs.device.type == "cpu" and obs.device.type == "cpu"


def test_port_imports_neither_jax_nor_the_jax_package():
    """No module of orthosfm_torch, no torch script and not chip_smoke.py
    imports jax or orthosfm_tpu."""
    import ast
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    files = [*sorted((root / "orthosfm_torch").rglob("*.py")), root / "chip_smoke.py",
             *sorted((root / "scripts").glob("torch_*.py"))]
    assert len(files) > 30
    assert {root / "orthosfm_torch" / name for name in ("bench.py", "entry.py")} <= set(files)
    for path in files:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib", "flax", "orthosfm_tpu"), \
                    f"{path.relative_to(root)} imports {name}"


def test_gt_cameras_run_on_cuda_unless_asked(monkeypatch):
    """synthetic.generate_gt_cameras defaults to CUDA, as generate_dataset
    does: without a card it raises, naming device="cpu"; asked for the CPU
    it gives the JAX package's cameras."""
    from orthosfm_tpu.data import synthetic as jsyn

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        synthetic.generate_gt_cameras(4)
    gt = synthetic.generate_gt_cameras(4, seed=3, device="cpu")
    ref = jsyn.generate_gt_cameras(4, seed=3)
    assert gt.rot.device.type == "cpu"
    np.testing.assert_allclose(gt.rot.numpy(), np.asarray(ref.rot), rtol=0, atol=1e-6)
