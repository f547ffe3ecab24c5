"""The slice as a whole: pose estimation from a track set, through the JAX
package and through the port, on the same tracks.

The two draw their RANSAC samples from different generators (JAX keys, a
torch.Generator), so the comparison is of outcomes: the same views placed in
the same order, both within 1e-2 degrees of ground truth on perfect tracks,
and each camera of the port within 0.05 degrees of the JAX camera. Angles
are compared after the reference testbench's global-mirror normalization
(testbench.metrics.pose_errors), since an orthographic reconstruction is
defined up to that mirror."""

import contextlib
import functools

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
from orthosfm_torch.config import RansacConfig, ReconstructionConfig, SolverType
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.io import cameras_io, timing
from orthosfm_torch.pipeline import incremental, tk_graphs
from orthosfm_torch.solvers import tomasi_kanade as tk
from orthosfm_torch.testbench import metrics
from orthosfm_torch.utils import profiling

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


# (solver, group size); the size-3 cases keep the ids they had before the
# group size was a parameter
POSE_CASES = {str(s): (s, 3) for s in range(4)}
POSE_CASES.update({f"{s}-size{k}": (s, k) for s in (0, 3) for k in (2, 4)})


@pytest.mark.parametrize("solver,group_size", list(POSE_CASES.values()), ids=list(POSE_CASES))
def test_pose_estimation_matches_jax(solver, group_size):
    tracks, gt = _sphere_scene(solver)
    wh = np.full(6, 2048.0)
    ref = jinc.run_pose_estimation(
        tracks, wh, wh, JConfig(solver=JSolver(solver), group_size=group_size), verbose=False)
    got = incremental.run_pose_estimation(
        tracks_mod.from_numpy(tracks), wh, wh,
        ReconstructionConfig(solver=SolverType(solver), group_size=group_size), verbose=False)
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


def test_the_group_loop_indexes_only_with_device_tensors(monkeypatch):
    """Once the schedule is made, every column index the pose driver hands
    to tracks.col_index and cameras.take is a tensor, never a host sequence
    to copy to the device."""
    seen = []

    def spy(fn):
        def wrapped(owner, idx):
            seen.append((fn.__name__, type(idx)))
            return fn(owner, idx)
        return wrapped

    real_stage = incremental.stage

    @contextlib.contextmanager
    def stage(name, **kwargs):
        with real_stage(name, **kwargs):
            yield
        if name == "pose/grouping":
            seen.clear()  # only what follows pose/grouping counts

    monkeypatch.setattr(tracks_mod, "col_index", spy(tracks_mod.col_index))
    monkeypatch.setattr(cam_mod, "take", spy(cam_mod.take))
    monkeypatch.setattr(incremental, "stage", stage)
    tracks, _ = _sphere_scene(0)
    wh = np.full(6, 2048.0)
    got = incremental.run_pose_estimation(tracks_mod.from_numpy(tracks), wh, wh,
                                          ReconstructionConfig(), verbose=False)
    assert got.present.all()
    assert {name for name, _ in seen} == {"col_index", "take"}
    assert all(issubclass(kind, torch.Tensor) for _, kind in seen), seen


def test_tk_runs_the_eager_code_off_the_card_under_a_mesh_or_with_another_generator(
        monkeypatch):
    """The route of a TK initialization: a CUDA graph only on a card, with
    no mesh of more than one rank and the draws from the card's TK
    generator; on the CPU a run records "eager" for every group and
    captures nothing, and robust_factorization with injected draws, called
    directly, keeps no graph either."""
    graphs = tk_graphs.TKGraphs()
    monkeypatch.setattr(tk_graphs, "GRAPHS", graphs)
    cpu, card = torch.device("cpu"), torch.device("cuda", 0)
    assert not graphs.graphed(cpu, False, graphs.generator(cpu))
    assert not graphs.graphed(card, False, torch.Generator())  # not the card's TK generator
    assert not graphs.graphed(card, True, torch.Generator())
    tracks, _ = _sphere_scene(3)
    wh = np.full(6, 2048.0)
    with profiling.collect_stages({}, "cpu"):
        got = incremental.run_pose_estimation(
            tracks_mod.from_numpy(tracks), wh, wh,
            ReconstructionConfig(solver=SolverType.ORTHO_EULER_ALL_DOF), verbose=False)
    calls = profiling.traces()[-1]["tk_calls"]
    assert got.present.all() and len(calls) == 4
    assert [c["route"] for c in calls] == ["eager"] * 4
    assert profiling.traces()[-1]["tk_captures"] == 0
    obs = torch.as_tensor(np.array(tracks.obs)[:, :3])
    valid = torch.ones(obs.shape[0], dtype=torch.bool)
    samp, q0, q0_fb = tk.draw_hypotheses(valid, RansacConfig(), torch.Generator().manual_seed(0))
    tk.robust_factorization(obs, valid, 2048.0, 2048.0, RansacConfig(), samp_idx=samp, q0=q0,
                            q0_fallback=q0_fb)
    assert graphs.captures == 0 and not graphs._graphs


class _FakeGraph:
    """Stands in for a captured CUDA graph: its replay runs the captured
    function on the captured inputs into the captured output."""

    def __init__(self, fn, inputs, output):
        self.fn, self.inputs, self.output = fn, inputs, output
        self.replays = 0

    def replay(self):
        self.output.copy_(self.fn(*self.inputs))
        self.replays += 1


def test_tk_graphs_replay_into_their_inputs_and_keep_the_most_recently_used(monkeypatch):
    """TKGraphs with room for two keys: a call's key is its function, its
    arguments and its inputs' device, shapes and dtypes; a key's first call
    answers from fn run eagerly and captures on copies of the inputs; each
    later call copies its inputs into the captured ones, replays and returns
    a copy of the output; another argument, shape or dtype is another key,
    and a third key drops the least recently used."""
    monkeypatch.setattr(tk_graphs, "GRAPHS_KEPT", 2)
    graphs = tk_graphs.TKGraphs()

    def capture(fn, inputs):
        graphs.captures += 1
        output = fn(*inputs).clone()
        return tk_graphs._Graph(_FakeGraph(fn, inputs, output), inputs, output)

    monkeypatch.setattr(graphs, "_capture", capture)
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())

    def affine(x, y, *, scale):
        return x * scale + y

    double, triple = functools.partial(affine, scale=2.0), functools.partial(affine, scale=3.0)
    a, b = torch.arange(3.0), torch.ones(3)
    got, route = graphs.run(double, (a, b))
    assert torch.equal(got, double(a, b)) and route == "capture" and graphs.captures == 1
    (first,) = graphs._graphs.values()
    assert first.inputs[0] is not a and torch.equal(first.inputs[0], a)  # the graph's own
    got, route = graphs.run(double, (a + 1, b))
    assert torch.equal(got, double(a + 1, b)) and route == "replay" and got is not first.output
    assert torch.equal(first.inputs[0], a + 1) and first.graph.replays == 1
    assert torch.equal(a, torch.arange(3.0))  # the caller's inputs are untouched
    assert graphs.run(triple, (a, b))[1] == "capture"  # another argument
    assert graphs.run(double, (a, b))[1] == "replay"  # double is now the most recently used
    assert graphs.run(double, (a.double(), b.double()))[1] == "capture"  # another dtype
    assert len(graphs._graphs) == 2 and graphs.captures == 3
    assert graphs.run(double, (a, b))[1] == "replay" and graphs.captures == 3
    assert graphs.run(double, (torch.arange(4.0), torch.ones(4)))[1] == "capture"  # a shape
    assert graphs.run(triple, (a, b))[1] == "capture" and graphs.captures == 5


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
