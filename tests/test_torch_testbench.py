"""The port's testbench (orthosfm_torch/testbench: render, metrics,
synthetic_tests, full_pipeline, run, bench_pipeline) and the image loader
against the JAX package's, on the CPU.

Tolerances: the analytic scenes render pixel for pixel (and mask for mask)
as the JAX renderer does; PointCloudScene's f32 intersect cancels ~100
against a squared sphere radius of ~1e-3, and XLA fuses its sums in its own
order (the port emulates its FMAs, render._fma), so there the masks are
equal and the grey levels within 1 on all but 0.1% of the pixels
(measured: 1 pixel of 12288). References and scores within 1e-6; CSV files
byte for byte; the noise sweep under the JAX package's own test's bars."""

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

import tests.torch_port_helpers  # noqa: F401  (caps torch's threads)

from orthosfm_tpu.config import SolverType as JSolverType
from orthosfm_tpu.core import cameras as jcam
from orthosfm_tpu.data import synthetic as jsyn
from orthosfm_tpu.testbench import full_pipeline as jfp
from orthosfm_tpu.testbench import metrics as jmetrics
from orthosfm_tpu.testbench import render as jrender
from orthosfm_tpu.testbench import run as jrun
from orthosfm_tpu.testbench import synthetic_tests as jsweep
from orthosfm_torch.config import SolverType
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.testbench import bench_pipeline, full_pipeline, metrics, render, run
from orthosfm_torch.testbench import synthetic_tests

W = 64


def _both_cams(trajectory, num_views, seed=5):
    rng = np.random.default_rng(seed)
    ang = jrender.trajectory_angles(trajectory, num_views, 100.0, 20.0, 15.0, rng)
    return (jcam.make_euler(np.arange(num_views), W, W, angles=ang),
            cam_mod.make_euler(np.arange(num_views), W, W, angles=ang))


def _render_both(scene_j, scene_p, trajectory="circle", num_views=4):
    jg, pg = _both_cams(trajectory, num_views)
    ji, jm = jrender.render_views(jg, W, W, scene_j, texture=jrender.FourierTexture3D(seed=9),
                                  return_masks=True)
    pi, pm = render.render_views(pg, W, W, scene_p, texture=render.FourierTexture3D(seed=9),
                                 return_masks=True)
    return (np.stack(ji), np.stack([x.numpy() for x in pi]), np.stack(jm),
            np.stack([x.numpy() for x in pm]))


@pytest.mark.parametrize("scene,trajectory", [("ornament_cube", "circle"), ("rings", "3lat"),
                                              ("suzanne", "3lat_rotated"), ("blob", "circle")])
def test_scenes_render_like_jax(scene, trajectory):
    ji, pi, jm, pm = _render_both(jrender.SCENES[scene](3), render.SCENES[scene](3), trajectory)
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pm, jm)
    assert (jm > 0).mean() > 0.1  # the scene fills part of the frame


def test_scene_table_matches():
    assert set(render.SCENES) == set(jrender.SCENES)


def test_composite_of_two_scenes_renders_like_jax():
    ji, pi, jm, pm = _render_both(
        jrender.CompositeScene(jrender.SphereScene(radius=0.4), jrender.RingsScene()),
        render.CompositeScene(render.SphereScene(radius=0.4), render.RingsScene()))
    np.testing.assert_array_equal(pi, ji)
    np.testing.assert_array_equal(pm, jm)


def test_point_cloud_scene_renders_like_jax():
    """A generated cloud of 2000 points (the blob, scaled into the frame)."""
    pts = jsyn.blob_cloud(2000) / 1.2
    js, ps = jrender.PointCloudScene(pts), render.PointCloudScene(pts)
    assert ps.radius == js.radius
    ji, pi, jm, pm = _render_both(js, ps, num_views=3)
    np.testing.assert_array_equal(pm, jm)
    assert (jm > 0).mean() > 0.2
    diff = np.abs(pi.astype(int) - ji.astype(int)).max(axis=-1)
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).sum())


def test_median_nn_spacing_matches():
    pts = jsyn.blob_cloud(3000)
    dup = np.concatenate([pts, pts[:500]])  # duplicated vertices, as in exported PLYs
    for x in (pts, dup):
        assert render._median_nn_spacing(x) == jrender._median_nn_spacing(x)


def test_render_sphere_views_matches():
    jg, pg = _both_cams("circle", 3)
    ji = jrender.render_sphere_views(jg, W, W, radius=0.6)
    pi = render.render_sphere_views(pg, W, W, radius=0.6)
    np.testing.assert_array_equal(np.stack([x.numpy() for x in pi]), np.stack(ji))


def test_dataset_matrix_matches():
    for width in (320, 512):
        assert run.dataset_matrix(width) == jrun.dataset_matrix(width)
    cells = sum(len(row[7]) for row in run.dataset_matrix(320))
    assert cells == 21


def test_mean_and_std_match():
    v = np.random.default_rng(0).exponential(size=37)
    assert metrics.mean_and_std(v) == jmetrics.mean_and_std(v)
    assert metrics.mean_and_std([2.5]) == jmetrics.mean_and_std([2.5])


def _hand_project(tmp_path, mirrored):
    """A hand-written references.txt of 4 views (written by the JAX package)
    and a project folder with a cameras.txt of those poses perturbed (and
    conjugated by the flip of metrics.FLIP_ROT / FLIP_POS), and a
    time_measurements.txt."""
    rng = np.random.default_rng(0)
    ang = rng.uniform(-0.6, 0.6, (4, 3)).astype(np.float32)
    gt = jcam.make_euler(np.arange(4), 256, 256, angles=ang)
    names = [f"v{i}.png" for i in range(4)]
    ref_path = str(tmp_path / "references.txt")
    jfp.write_references(ref_path, gt, names)
    proj = tmp_path / "project"
    proj.mkdir()
    R = np.asarray(jcam.basis(gt), np.float64)
    o = np.einsum("vij,j->vi", R, [0.0, 0.0, -10.0])
    lines = []
    for v in (2, 0, 1, 3):  # reconstruction order
        w = rng.normal(0, 0.01, 3)  # a rotation of ~1° (Rodrigues)
        K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
        th = np.linalg.norm(w)
        dR = np.eye(3) + np.sin(th) / th * K + (1 - np.cos(th)) / th**2 * K @ K
        Rv, ov = R[v] @ dR, o[v] * 1.01
        if mirrored:
            Rv, ov = jmetrics.FLIP_ROT @ Rv @ jmetrics.FLIP_ROT, jmetrics.FLIP_POS @ ov
        m = np.eye(4)
        m[:3, :3], m[:3, 3] = Rv, ov
        lines.append(f"{names[v]};" + ",".join(f"{x:.6f}" for x in m.reshape(-1)))
    (proj / "cameras.txt").write_text("\n".join(lines) + "\n")
    (proj / "time_measurements.txt").write_text(
        "Initialization Time [s] = 0.5\nTrack Building Time [s] = 1.25\n"
        "Pose Estimation Time [s] = 2.5\nTotal Time [s] = 4.5\n")
    return gt, names, ref_path, str(proj)


@pytest.mark.parametrize("mirrored", [False, True])
def test_references_and_evaluate_run_match(tmp_path, mirrored):
    gt, names, ref_path, proj = _hand_project(tmp_path, mirrored)
    port_path = str(tmp_path / "references_port.txt")
    full_pipeline.write_references(port_path, cam_mod.from_numpy(gt), names)

    def rows(path):
        lines = [ln.split(";") for ln in open(path).read().splitlines()]
        return [ln[0] for ln in lines], np.array([[float(x) for x in ln[1:]] for ln in lines])

    (names_p, vals_p), (names_j, vals_j) = rows(port_path), rows(ref_path)
    assert names_p == names_j == names
    # f32 bases formed in another order: the matrices agree to an ulp, the
    # camera centers (10 × the look axis) to ten
    np.testing.assert_allclose(vals_p, vals_j, rtol=0, atol=1e-6)
    refs, jrefs = full_pipeline.load_references(ref_path), jfp.load_references(ref_path)
    assert [r.name for r in refs] == [r.name for r in jrefs] == names
    for a, b in zip(refs, jrefs):
        np.testing.assert_allclose(a.rotation_matrix, b.rotation_matrix, rtol=0, atol=1e-6)
        np.testing.assert_allclose(a.position, b.position, rtol=0, atol=1e-6)
    got, ref = full_pipeline.evaluate_run(proj, refs), jfp.evaluate_run(proj, jrefs)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-6)  # angular errors
    np.testing.assert_allclose(got[1], ref[1], rtol=0, atol=1e-6)  # position errors
    assert got[2:] == ref[2:] == (4.5, 2.5)
    if not mirrored:
        assert 0.1 < max(got[0]) < 5.0  # the perturbation of ~1°


def test_results_csv_match(tmp_path):
    rows = [("DS", "Quaternion", 1.0, 0.5, 0.01, 0.005, 12.0, 8.0),
            ("DS", "EulerAllDoF", 0.25, 0.125, 0.02, 0.001, float("nan"), 3.0),
            ("Other", "Quaternion", 0.1234567, 0.0, 0.0, 0.0, 1.0, 0.5)]
    full_pipeline.save_results_csv([full_pipeline.FullPipelineResult(*r) for r in rows],
                                   str(tmp_path / "port.csv"))
    jfp.save_results_csv([jfp.FullPipelineResult(*r) for r in rows], str(tmp_path / "jax.csv"))
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "jax.csv").read_bytes()

    entries = [("Cube", "ORTHO_QUATERNION", 0.0, 0.1, 0.02, 0.001, False),
               ("Sphere", "ORTHO_EULER_ALL_DOF", 2.5, float("nan"), float("nan"),
                float("nan"), True)]
    synthetic_tests.save_results([synthetic_tests.SweepEntry(*e) for e in entries],
                                 str(tmp_path / "port_sweep.csv"))
    jsweep.save_results([jsweep.SweepEntry(*e) for e in entries], str(tmp_path / "jax_sweep.csv"))
    assert (tmp_path / "port_sweep.csv").read_bytes() == (tmp_path / "jax_sweep.csv").read_bytes()


def test_noise_sweep_small_like_jax(tmp_path):
    """The JAX package's test_noise_sweep_small (Sphere, quaternion solver,
    6 views, 300 tracks, σ ∈ {0, 2} px) in both packages: the same bars, the
    noise-free errors at the f32 floor in both, the noisy ones within a
    factor 2 of each other (the noise draws differ: JAX keys and numpy)."""
    kw = dict(datasets=("Sphere",), noise_levels=(0.0, 2.0), num_views=6, max_tracks=300,
              verbose=False)
    csv = str(tmp_path / "sweep.csv")
    got = synthetic_tests.run_noise_sweep(solvers=(SolverType.ORTHO_QUATERNION,),
                                          csv_path=csv, device="cpu", **kw)
    ref = jsweep.run_noise_sweep(solvers=(JSolverType.ORTHO_QUATERNION,), **kw)
    for res in (got, ref):
        assert len(res) == 2
        assert not any(r.failed for r in res)
        assert res[0].mean_angular_error_deg < 1e-4
        assert res[1].mean_angular_error_deg < 5.0
    a, b = got[1].mean_angular_error_deg, ref[1].mean_angular_error_deg
    assert 0.5 < a / b < 2.0, (a, b)
    assert open(csv).read().splitlines()[1].startswith("Sphere,ORTHO_QUATERNION,0.0,")


def test_a_failed_sweep_run_is_recorded(monkeypatch):
    def fail(*args, **kwargs):
        raise RuntimeError("no group could be initialized")

    monkeypatch.setattr(synthetic_tests.incremental, "run_pose_estimation", fail)
    res = synthetic_tests.run_noise_sweep(datasets=("Cube",), solvers=(SolverType(0),),
                                          noise_levels=(0.0,), num_views=4, max_tracks=50,
                                          verbose=False, device="cpu")
    assert len(res) == 1 and res[0].failed and np.isnan(res[0].mean_angular_error_deg)


def _tiny_dataset(root, name="Tiny"):
    ds = os.path.join(root, name)
    gt = render.make_image_dataset(os.path.join(ds, "images"), num_views=5, width=224,
                                   height=224, seed=3, ring_degrees=100, device="cpu")
    full_pipeline.write_references(os.path.join(ds, "references.txt"), gt,
                                   [f"view_{i:02d}.png" for i in range(5)])


def test_testbench_main_runs_a_dataset_folder_on_the_cpu(tmp_path):
    """run.main over a folder holding one rendered dataset (5 views of 224²),
    in process, --platform cpu: results.csv in the reference's schema with a
    mean angular error under the JAX package's 3° bar for this scene."""
    data = str(tmp_path / "data")
    _tiny_dataset(data)
    proj = str(tmp_path / "proj")
    assert run.main([proj, data, "--solvers", "0,3", "--repetitions", "1",
                     "--platform", "cpu"]) == 0
    lines = open(os.path.join(proj, "results.csv")).read().splitlines()
    assert lines[0] == "Metric;Dataset;EulerAllDoF;Quaternion"
    assert len(lines) == 7
    err = [float(x) for x in lines[1].split(";")[2:]]
    assert lines[1].startswith("Mean Angular Error [deg];Tiny;") and max(err) < 3.0, lines[1]


def test_testbench_entry_points_default_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        synthetic_tests.run_noise_sweep(datasets=("Cube",), noise_levels=(0.0,), verbose=False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        bench_pipeline.run_benchmark(num_views=3, width=64)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        run.main([str(tmp_path / "p"), str(tmp_path / "d")])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        render.make_scene_views(2, W, W)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        render.make_image_dataset(str(tmp_path / "i"), num_views=2, width=W, height=W)
    assert not os.path.exists(tmp_path / "i")


def test_bench_pipeline_prints_one_json_line(tmp_path, capsys):
    assert bench_pipeline.main(["--views", "8", "--width", "224", "--no-warmup",
                                "--device", "cpu"]) == 0
    out = capsys.readouterr().out.strip().splitlines()
    rec = json.loads(out[-1])
    for key in ("initialization_s", "track_building_s", "pose_estimation_s", "total_s",
                "frames_per_s", "mean_angular_error_deg", "device"):
        assert key in rec, key
    assert rec["views_placed"] == 8 and rec["device"] == "cpu"


def test_image_dataset_files_match_jax(tmp_path):
    """make_image_dataset writes what the JAX package's writes: the same
    pixels and masks, and the same cameras."""
    from PIL import Image

    kw = dict(num_views=3, width=W, height=W, seed=4, ring_degrees=100, scene="ornament_cube")
    jgt = jrender.make_image_dataset(str(tmp_path / "j"), mask_folder=str(tmp_path / "jm"), **kw)
    pgt = render.make_image_dataset(str(tmp_path / "p"), mask_folder=str(tmp_path / "pm"),
                                    device="cpu", **kw)
    np.testing.assert_array_equal(pgt.rot.numpy(), np.asarray(jgt.rot))
    for i in range(3):
        for a, b in ((f"j/view_{i:02d}.png", f"p/view_{i:02d}.png"),
                     (f"jm/view_{i:02d}_mask.png", f"pm/view_{i:02d}_mask.png")):
            np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / b)),
                                          np.asarray(Image.open(tmp_path / a)))


def test_load_views_match_jax(tmp_path):
    """load_views of a folder that Pillow wrote (its adaptive PNG filters),
    with masks and a downscale, gives the JAX package's pixels and masks."""
    from orthosfm_tpu.data import views as jviews
    from orthosfm_torch.data import views

    render.make_image_dataset(str(tmp_path / "i"), num_views=3, width=96, height=96, seed=2,
                              ring_degrees=100, scene="rings", mask_folder=str(tmp_path / "m"),
                              device="cpu")
    for factor in (1, 2):
        got = views.load_views(str(tmp_path / "i"), str(tmp_path / "m"), factor)
        want = jviews.load_views(str(tmp_path / "i"), str(tmp_path / "m"), factor)
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            assert (g.width, g.height) == (w.width, w.height) == (96 // factor, 96 // factor)
            np.testing.assert_array_equal(g.pixels, w.pixels)
            np.testing.assert_array_equal(g.mask, w.mask)


def test_sweep_entry_fields_match():
    assert ([f.name for f in dataclasses.fields(synthetic_tests.SweepEntry)]
            == [f.name for f in dataclasses.fields(jsweep.SweepEntry)])
    assert ([f.name for f in dataclasses.fields(full_pipeline.FullPipelineResult)]
            == [f.name for f in dataclasses.fields(jfp.FullPipelineResult)])
    np.testing.assert_array_equal(full_pipeline.COORD_TRANSFORM, jfp.COORD_TRANSFORM)
