"""Parity of the port's core, data, io, ops and grouping modules
(orthosfm_torch) with the JAX package (orthosfm_tpu): the same inputs, made
from numpy seeds or by the JAX generator, go through both, and the outputs
agree to 1e-5 unless stated (f32 on both sides; the only differences are the
order of f32 operations)."""

import os
import subprocess
import sys
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t

from orthosfm_tpu.config import FilterConfig as JFilterConfig, SolverType as JSolver
from orthosfm_tpu.core import cameras as jcam
from orthosfm_tpu.core import quaternions as jquat
from orthosfm_tpu.core import umeyama as jumeyama
from orthosfm_tpu.data import synthetic as jsyn
from orthosfm_tpu.io import cameras_io as jcameras_io, tracks_io as jtracks_io
from orthosfm_tpu.ops import outliers as joutliers, triangulate as jtri
from orthosfm_tpu.pipeline import grouping as jgrouping

from orthosfm_torch.config import FilterConfig, SolverType
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.core import quaternions as quat
from orthosfm_torch.core import umeyama
from orthosfm_torch.data import synthetic
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.io import cameras_io, tracks_io
from orthosfm_torch.ops import outliers, triangulate
from orthosfm_torch.pipeline import grouping
from orthosfm_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL = 1e-5


def _unit_quats(k, seed=0):
    q = np.random.default_rng(seed).normal(size=(k, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=1, keepdims=True)


def _cams(solver, num_views=6, seed=0):
    """(JAX cameras, port cameras) with random poses, offsets and scales."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(-1.0, 1.0, (num_views, 3)).astype(np.float32)
    off = rng.uniform(-0.1, 0.1, (num_views, 2)).astype(np.float32)
    sc = rng.uniform(0.8, 1.2, num_views).astype(np.float32)
    e = jcam.make_euler(np.arange(num_views), 2048.0, 1536.0, angles=ang, offset=off,
                        scale=sc, solver=JSolver(solver))
    if JSolver(solver).is_quaternion:
        e = jcam.make_quaternion(np.arange(num_views), 2048.0, 1536.0,
                                 q=jquat.from_matrix(jcam.basis(e)), offset=off, scale=sc)
    e = e.replace(fixed=jnp.zeros(num_views, bool).at[1].set(True))
    return e, cam_mod.from_numpy(e)


def test_port_imports_without_jax_or_flax():
    """Every module of orthosfm_torch imports with jax and flax blocked."""
    code = r"""
import importlib, pkgutil, sys

class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError("blocked: " + name)
        return None

sys.meta_path.insert(0, Block())
import orthosfm_torch
for m in pkgutil.walk_packages(orthosfm_torch.__path__, "orthosfm_torch."):
    importlib.import_module(m.name)
assert not any(k.split(".")[0] in ("jax", "flax") for k in sys.modules)
print("IMPORT_OK")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "IMPORT_OK" in proc.stdout


def test_precision_is_pinned_to_f32():
    import orthosfm_torch  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


@pytest.mark.parametrize("fn", ["multiply", "to_matrix", "from_matrix", "exp_map", "slerp",
                                "angular_distance", "from_to_rotation"])
def test_quaternions_match(fn):
    a, b = _unit_quats(64, 1), _unit_quats(64, 2)
    if fn == "multiply":
        got, ref = quat.multiply(t(a), t(b)), jquat.multiply(a, b)
    elif fn == "to_matrix":
        got, ref = quat.to_matrix(t(a)), jquat.to_matrix(a)
    elif fn == "from_matrix":
        m = np.asarray(jquat.to_matrix(a))
        got, ref = quat.from_matrix(t(m)), jquat.from_matrix(m)
    elif fn == "exp_map":
        d = np.random.default_rng(3).normal(size=(64, 3)).astype(np.float32)
        d[:8] *= 1e-7  # the small-angle branch
        got, ref = quat.exp_map(t(d)), jquat.exp_map(d)
    elif fn == "slerp":
        got, ref = quat.slerp(t(a), t(b), 0.3), jquat.slerp(a, b, 0.3)
    elif fn == "angular_distance":
        got, ref = quat.angular_distance(t(a), t(b)), jquat.angular_distance(a, b)
    else:
        got, ref = quat.from_to_rotation(t(a), t(b)), jquat.from_to_rotation(a, b)
    np.testing.assert_allclose(n(got), n(ref), atol=TOL)


def test_umeyama_matches():
    rng = np.random.default_rng(0)
    src = rng.normal(size=(12, 3)).astype(np.float32)
    R = np.asarray(jquat.to_matrix(_unit_quats(1, 5)[0]))
    dst = src @ R.T + 0.01 * rng.normal(size=(12, 3)).astype(np.float32)
    got = umeyama.rotation_align(t(src), t(dst))
    np.testing.assert_allclose(n(got), n(jumeyama.rotation_align(src, dst)), atol=TOL)


@pytest.mark.parametrize("solver", [0, 1, 2, 3])
def test_cameras_match(solver):
    je, te = _cams(solver)
    pts = np.concatenate([np.random.default_rng(1).normal(size=(40, 3)),
                          np.ones((40, 1))], axis=1).astype(np.float32)
    pix = np.random.default_rng(2).uniform(0, 2048, (6, 40, 2)).astype(np.float32)
    pairs = [
        (cam_mod.rotation_l2w(te), jcam.rotation_l2w(je)),
        (cam_mod.origins(te), jcam.origins(je)),
        (cam_mod.project(te, t(pts)) / 2048.0, jcam.project(je, pts) / 2048.0),
        (cam_mod.pixel_to_plane_point(te, t(pix)), jcam.pixel_to_plane_point(je, pix)),
        (cam_mod.basis_to_phi_theta_roll(cam_mod.basis(te)),
         jcam.basis_to_phi_theta_roll(jcam.basis(je))),
        (cam_mod.export_matrices(te), jcam.export_matrices(je)),
        (cam_mod.normalize_scene_to_camera(te, 2).rot,
         jcam.normalize_scene_to_camera(je, 2).rot),
    ]
    if je.kind == "euler":
        pairs.append((cam_mod.spherical_matrix_derivs(te.rot[:, :3]),
                      jcam.spherical_matrix_derivs(je.rot[:, :3])))
    for got, ref in pairs:
        np.testing.assert_allclose(n(got), n(ref), atol=TOL)
    np.testing.assert_array_equal(n(cam_mod.free_mask(te)), n(jcam.free_mask(je)))
    assert cam_mod.active_param_slots(te) == jcam.active_param_slots(je)
    delta = np.random.default_rng(3).normal(scale=0.05, size=(6, 6)).astype(np.float32)
    rt, rj = cam_mod.retract(te, t(delta)), jcam.retract(je, delta)
    for name in ("rot", "offset", "scale"):
        np.testing.assert_allclose(n(getattr(rt, name)), n(getattr(rj, name)), atol=TOL)
    basis = np.asarray(jcam.basis(je))
    fb_t = cam_mod.from_basis(t(basis), np.arange(6), 2048.0, 1536.0, SolverType(solver))
    fb_j = jcam.from_basis(basis, np.arange(6), 2048.0, 1536.0, JSolver(solver))
    np.testing.assert_allclose(n(fb_t.rot), n(fb_j.rot), atol=TOL)
    assert cam_mod.format_cameras(te) == jcam.format_cameras(je)


def test_synthetic_dataset_matches():
    for cloud in ("Cube", "Sphere", "Blob"):
        np.testing.assert_array_equal(synthetic.CLOUDS[cloud](), jsyn.CLOUDS[cloud]())
    ds_t = synthetic.generate_dataset("Blob", num_views=16, seed=3, device="cpu")
    ds_j = jsyn.generate_dataset("Blob", num_views=16, seed=3)
    # pixels on a 2048 image, f32 on both sides
    np.testing.assert_allclose(n(ds_t.tracks.obs), n(ds_j.tracks.obs), atol=2e-3)
    for name in ("obs_mask", "local_ids", "global_ids", "alive", "view_ids"):
        np.testing.assert_array_equal(n(getattr(ds_t.tracks, name)),
                                      n(getattr(ds_j.tracks, name)))
    np.testing.assert_allclose(n(ds_t.gt_cameras.rot), n(ds_j.gt_cameras.rot), atol=TOL)


def test_observation_noise_draws_from_numpy():
    ds = synthetic.generate_dataset(synthetic.sphere_cloud(200), num_views=4, seed=0, device="cpu")
    a = synthetic.add_observation_noise(ds.tracks, 1.0, np.random.default_rng(5))
    b = synthetic.add_observation_noise(ds.tracks, 1.0, np.random.default_rng(5))
    np.testing.assert_array_equal(n(a.obs), n(b.obs))
    d = n(a.obs - ds.tracks.obs)
    assert a.obs.dtype == torch.float32
    assert abs(float(d.std()) - 1.0) < 0.1
    half = synthetic.add_observation_noise(ds.tracks, 1.0, np.random.default_rng(5), 0.5)
    assert 0.3 < float(np.mean(n(half.obs - ds.tracks.obs)[..., 0] != 0)) < 0.7


def _triangulated(num_views=6, n_points=300):
    ds = jsyn.generate_dataset(jsyn.sphere_cloud(n_points), num_views=num_views, seed=0)
    cams = ds.gt_cameras
    ts = jtri.triangulate_tracks(cams, ds.tracks, np.arange(num_views))
    return cams, ts


def test_triangulate_matches():
    cams, tracks = _triangulated()
    mask = np.asarray(tracks.obs_mask).copy()
    mask[::7, 2:] = False  # some tracks with fewer rays, some with one
    mask[::11, 1:] = False
    tracks = tracks.replace(obs_mask=jnp.asarray(mask), has_point=jnp.zeros_like(tracks.alive))
    cols = np.array([0, 2, 3, 5])
    cams_sub = jcam.take(cams, cols)
    for reset in (True, False):
        ref = jtri.triangulate_tracks(cams_sub, tracks, cols, reset_existing=reset)
        got = triangulate.triangulate_tracks(cam_mod.from_numpy(cams_sub),
                                             tracks_mod.from_numpy(tracks), cols,
                                             reset_existing=reset)
        np.testing.assert_array_equal(n(got.has_point), n(ref.has_point))
        np.testing.assert_allclose(n(got.points), n(ref.points), atol=TOL)


def test_outlier_filters_match():
    cams, tracks = _triangulated()
    rng = np.random.default_rng(0)
    pts = np.asarray(tracks.points).copy()
    pts[::25, :3] += rng.normal(scale=0.5, size=pts[::25, :3].shape)  # far-off points
    obs = np.asarray(tracks.obs).copy()
    obs[::9, 1] += 4.0  # features off by 4 px
    tracks = tracks.replace(points=jnp.asarray(pts), obs=jnp.asarray(obs))
    tt = tracks_mod.from_numpy(tracks)
    got = outliers.filter_outlier_tracks(tt, FilterConfig())
    ref = joutliers.filter_outlier_tracks(tracks, JFilterConfig())
    np.testing.assert_array_equal(n(got.alive), n(ref.alive))
    np.testing.assert_allclose(
        n(outliers.nearest_neighbor_distances(tt.points, tt.has_point)),
        n(joutliers.nearest_neighbor_distances(tracks.points, tracks.has_point)), atol=TOL)
    cols = np.arange(4)
    got = outliers.filter_tracks_reprojection_error(
        tt, cam_mod.from_numpy(jcam.take(cams, cols)), cols, FilterConfig())
    ref = joutliers.filter_tracks_reprojection_error(tracks, jcam.take(cams, cols), cols,
                                                     JFilterConfig())
    for name in ("obs_mask", "alive", "has_point"):
        np.testing.assert_array_equal(n(getattr(got, name)), n(getattr(ref, name)))


def test_grouping_matches():
    rng = np.random.default_rng(0)
    inc = rng.uniform(size=(400, 9)) < 0.5
    ids = np.arange(10, 19)
    assert grouping.build_groups(ids, inc, 3) == jgrouping.build_groups(ids, inc, 3)
    assert grouping.build_groups(ids, inc, 4) == jgrouping.build_groups(ids, inc, 4)


def _windowed(rng, T, V):
    """Each track seen in a window of 5-11 views around a random centre on
    the ring."""
    centre, half = rng.integers(0, V, T), rng.integers(2, 6, T)
    return np.abs((np.arange(V)[None, :] - centre[:, None] + V // 2) % V - V // 2) \
        <= half[:, None]


def _repeated(rng, T, V, k):
    """k distinct random patterns, each repeated an unequal number of times."""
    base = rng.uniform(size=(k, V)) < 0.5
    return base[rng.choice(k, size=T, p=np.arange(1, k + 1) / (k * (k + 1) / 2))]


def _three_views(rng, T, V):
    """Each track seen in 3 random views: small, equal counts everywhere."""
    inc = np.zeros((T, V), bool)
    for row in inc:
        row[rng.choice(V, 3, replace=False)] = True
    return inc


# name: (view ids from a seed, incidence from a seed)
GROUPING_CASES = {
    "ties": (lambda r: np.arange(10), lambda r: _three_views(r, 25, 10)),
    "patterns": (lambda r: np.arange(20), lambda r: r.uniform(size=(3000, 20)) < 0.5),
    "repeated": (lambda r: np.arange(12), lambda r: _repeated(r, 2000, 12, 7)),
    "v13": (lambda r: np.arange(13), lambda r: r.uniform(size=(500, 13)) < 0.4),
    "v72": (lambda r: np.arange(72), lambda r: _windowed(r, 3000, 72)),
    "non_contiguous_ids": (lambda r: r.permutation(200)[:15],
                           lambda r: r.uniform(size=(400, 15)) < 0.3),
    "many64": (lambda r: np.arange(64), lambda r: np.ones((50000, 64), bool)),
    "ring192": (lambda r: np.arange(192), lambda r: np.ones((4096, 192), bool)),
    "sweep16": (lambda r: np.arange(16), lambda r: np.ones((7800, 16), bool)),
    "v201": (lambda r: np.arange(201), lambda r: _windowed(r, 2000, 201)),
    "v230": (lambda r: np.arange(230), lambda r: r.uniform(size=(600, 230)) < 0.2),
    "all_ties": (lambda r: r.permutation(40)[:11], lambda r: np.zeros((30, 11), bool)),
}


@pytest.mark.parametrize("case", list(GROUPING_CASES))
def test_grouping_schedule_matches_reference(case):
    """The port's group-size-3 schedule is the JAX package's, group for
    group in the same order, ties included (its dense tensor up to 200
    views, its lazy schedule above), with the same disconnected-view
    warnings."""
    rng = np.random.default_rng(sorted(GROUPING_CASES).index(case))
    ids_of, inc_of = GROUPING_CASES[case]
    ids, inc = [int(v) for v in ids_of(rng)], inc_of(rng)
    got, want = [], []
    for fn, warned in ((grouping.build_groups, got), (jgrouping.build_groups, want)):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            warned.append(fn(ids, inc, 3))
        warned.append(len(caught))
    assert got == want
    assert {v for g in got[0] for v in g} == set(ids)


def _replay_merges(groups, view_ids):
    """The pose driver's merge bookkeeping, replayed group by group with a
    view id -> column map: for each group its (overlapping positions, their
    columns, new positions, their columns, present mask, present columns),
    and the insertion order."""
    col_of = {int(v): c for c, v in enumerate(view_ids)}
    present = np.zeros(len(view_ids), bool)
    order, out = [], []
    for ids in groups:
        old = [j for j, vid in enumerate(ids) if present[col_of[vid]]]
        new = [j for j, vid in enumerate(ids) if not present[col_of[vid]]]
        for j in new:
            present[col_of[ids[j]]] = True
            order.append(ids[j])
        present_cols = [col_of[int(v)] for v in np.asarray(view_ids)[present]]
        out.append((old, [col_of[ids[j]] for j in old], new, [col_of[ids[j]] for j in new],
                    present.copy(), present_cols))
    return out, order


@pytest.mark.parametrize("group_size", [2, 3, 4])
def test_group_schedule_matches_a_replay_of_the_merges(group_size):
    """grouping.schedule gives each group's columns, sizes, new and
    overlapping cameras and the present columns after it, as a replay of
    the driver's merges gives them, in views whose ids are not their
    columns; its device fields are views of one table."""
    rng = np.random.default_rng(group_size)
    view_ids = [int(v) for v in rng.permutation(40)[:9]]
    inc = rng.uniform(size=(300, 9)) < 0.5
    widths = rng.uniform(500, 3000, 9).astype(np.float32)
    heights = rng.uniform(500, 3000, 9).astype(np.float32)
    groups = grouping.build_groups(view_ids, inc, group_size)
    sched = grouping.schedule(groups, view_ids, widths, heights, "cpu")
    col_of = {v: c for c, v in enumerate(view_ids)}
    want, order = _replay_merges(groups, view_ids)
    cols = [[col_of[v] for v in ids] for ids in groups]
    assert sched.groups == groups and sched.cols == cols and sched.insertion_order == order
    np.testing.assert_array_equal(n(sched.cols_t), cols)
    np.testing.assert_array_equal(n(sched.view_ids_t), groups)
    np.testing.assert_array_equal(n(sched.sizes_t), [widths, heights])
    np.testing.assert_array_equal(n(sched.wh_t), np.stack([widths[cols], heights[cols]], 1))
    assert sched.cols_t.dtype == torch.long and sched.wh_t.dtype == torch.float32
    assert n(grouping.schedule(groups, view_ids, 2048.0, 1536.0, "cpu").sizes_t).tolist() == [
        [2048.0] * 9, [1536.0] * 9]
    assert sched.view_ids_t.dtype == torch.int32
    for g, (old, old_cols, new, new_cols, present, present_cols) in enumerate(want):
        assert sched.new[g] == new
        assert n(sched.overlap_t[g]).tolist() == [old, old_cols]
        assert n(sched.new_t[g]).tolist() == [new, new_cols]
        assert n(sched.present_cols_t[g]).tolist() == present_cols
        np.testing.assert_array_equal(sched.present[g], present)
        np.testing.assert_array_equal(n(sched.present_t[g]), present)
    assert sched.present[-1].all()
    base = sched.cols_t.untyped_storage().data_ptr()
    assert all(t.untyped_storage().data_ptr() == base
               for t in (*sched.new_t, *sched.overlap_t, *sched.present_cols_t))


def test_support_patterns_are_the_unique_rows():
    """The packed-key dedupe gives np.unique(axis=0)'s patterns and counts,
    in another order, at widths on and off a byte and past 64 views."""
    rng = np.random.default_rng(5)
    for inc in (_repeated(rng, 900, 13, 6), rng.uniform(size=(700, 72)) < 0.5,
                _three_views(rng, 300, 8), np.ones((50, 3), bool)):
        patterns, counts = grouping._support_patterns(inc)
        rows, want = np.unique(inc, axis=0, return_counts=True)
        assert patterns.dtype == bool and patterns.shape == (len(rows), inc.shape[1])
        assert sorted(zip(map(tuple, patterns), counts)) == sorted(zip(map(tuple, rows), want))


def test_record_grouping_only_under_a_collector():
    """build_groups records tracks, views, distinct patterns and groups in
    a traced collector (patterns None for other group sizes) and nothing
    outside one."""
    inc = np.repeat(np.eye(5, dtype=bool) | np.eye(5, k=1, dtype=bool), [4, 1, 2, 3, 5], axis=0)
    inc[:, :2] = True
    grouping.build_groups(range(5), inc, 3)  # no collector: nowhere to record
    with profiling.collect_stages({}, "cpu"):
        pass
    assert profiling.traces()[-1]["grouping_calls"] == []
    with profiling.collect_stages({}, "cpu"):
        groups = grouping.build_groups(range(5), inc, 3)
        grouping.build_groups(range(5), inc, 4)
    assert profiling.traces()[-1]["grouping_calls"] == [
        {"tracks": 15, "views": 5, "patterns": 5, "groups": len(groups)},
        {"tracks": 15, "views": 5, "patterns": None, "groups": 2}]


def test_tracks_and_cameras_io_match(tmp_path):
    ds = jsyn.generate_dataset(jsyn.sphere_cloud(50), num_views=4, seed=0)
    tt = tracks_mod.from_numpy(ds.tracks)
    tracks_io.save_tracks(tt, str(tmp_path / "port.txt"))
    jtracks_io.save_tracks(ds.tracks, str(tmp_path / "jax.txt"))
    assert (tmp_path / "port.txt").read_text() == (tmp_path / "jax.txt").read_text()
    back = tracks_io.load_tracks(str(tmp_path / "port.txt"), np.arange(4), device="cpu")
    ref = jtracks_io.load_tracks(str(tmp_path / "jax.txt"), np.arange(4))
    np.testing.assert_array_equal(n(back.obs), n(ref.obs))
    np.testing.assert_array_equal(n(back.obs_mask), n(ref.obs_mask))
    assert back.obs.dtype == torch.float32

    names = [f"v{i}.png" for i in range(4)]
    cameras_io.export_cameras(cam_mod.from_numpy(ds.gt_cameras), names,
                              str(tmp_path / "c_port.txt"), order=[2, 0, 1, 3])
    jcameras_io.export_cameras(ds.gt_cameras, names, str(tmp_path / "c_jax.txt"),
                               order=[2, 0, 1, 3])
    got = cameras_io.import_cameras(str(tmp_path / "c_port.txt"))
    ref = jcameras_io.import_cameras(str(tmp_path / "c_jax.txt"))
    assert [c.image_name for c in got] == [c.image_name for c in ref]
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.transform, b.transform, atol=2e-6)


@pytest.mark.parametrize("solver", [0, 1, 2, 3])
def test_free_mask_matches_jax_for_every_solver(solver):
    """free_mask, built on the device from the count of free slots (a
    prefix of the six), is the JAX package's mask for every solver, with
    fixed cameras frozen."""
    basis = np.stack([np.eye(3, dtype=np.float32)] * 4)
    je = jcam.from_basis(basis, np.arange(4), 2048.0, 2048.0, JSolver(solver))
    je = je.replace(fixed=jnp.asarray([True, False, True, False]))
    te = cam_mod.from_numpy(je)
    np.testing.assert_array_equal(n(cam_mod.free_mask(te)), n(jcam.free_mask(je)))
    assert int(n(cam_mod.free_mask(te))[1].sum()) == {0: 5, 1: 1, 2: 2, 3: 5}[solver]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_camera_constants_are_made_once_with_the_values_of_each_calls_copy(dtype):
    """coord_transform, down and euler_free_angles are tensors made once a
    device and dtype (a copy from the host each call would synchronize with
    a card and cannot be captured in a CUDA graph), equal to what each call
    used to copy: on the given tensor's device and in its dtype."""
    like = torch.zeros(2, dtype=dtype)
    C = cam_mod.coord_transform(like)
    assert torch.equal(C, like.new_tensor([[1.0, 0.0, 0.0], [0.0, 0.0, -1.0], [0.0, 1.0, 0.0]]))
    assert (C.dtype, C.device) == (dtype, like.device)
    assert cam_mod.coord_transform(torch.ones(5, 3, 3, dtype=dtype)) is C
    d = cam_mod.down(like)
    assert torch.equal(d, like.new_tensor([0.0, 0.0, -cam_mod.CAMERA_DISTANCE]))
    assert (d.dtype, d.device) == (dtype, like.device) and cam_mod.down(like) is d
    assert cam_mod.coord_transform(torch.zeros(1, dtype=torch.float16)).dtype == torch.float16
    for solver in SolverType:
        dof = solver.degrees_of_freedom
        free = cam_mod.euler_free_angles(solver, like.device)
        assert torch.equal(free, torch.tensor([dof >= 1, dof >= 2, dof >= 3]))
        assert free.dtype == torch.bool and cam_mod.euler_free_angles(solver) is free
