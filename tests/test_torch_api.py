"""The JAX package's public functions that the port's pipeline does not call
itself, through both packages on the same inputs: the BA API
(run_even_odd, reprojection_errors, schur_solve, the track-major point
manifold and the autodiff Jacobians), cameras' project_from_params,
normalize_scene and concatenate, and tracks' restrict_to_columns.

Tolerances, each with its reason:
- elementwise geometry (projection, the manifold, masks): 1e-5 absolute in
  unit-scale quantities, f32 rounding of the same formulas;
- pixels: 1e-5 relative to the 2048-pixel image (f32 at ~2000);
- schur_solve: the JAX package's own for its kernels against its XLA step
  (tests/test_ba_pallas.py:98-133), 1e-4 of the largest step entry and 1e-4
  relative on the points' step (sums over the tracks in another order);
- the autodiff Jacobians against the analytic ones: tests/test_ba.py:85-110's
  bar (1e-3 relative, 1e-2 absolute in pixels per unit), and the robust
  weights 1/|r| that bar implies (5e-3 relative at |r| >= 2.5 px); the
  autodiff residuals and Jacobians against the JAX package's jacfwd: 1e-4
  relative (the same formulas, f32);
- run_even_odd: the cost within 1e-2 of its start, as the JAX test asks
  (with the first two cameras fixed too, the JAX package's cost to 1e-3
  relative), and each camera within 1e-3 degrees of the JAX package's (LM
  stops near the f32 floor in different iterations).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t
from tests.test_ba_pallas import _kernel_inputs, _problem as _make_problem
from tests.test_torch_core import _cams

from orthosfm_tpu.core import cameras as jcam
from orthosfm_tpu.core import quaternions as jquat
from orthosfm_tpu.data import synthetic as jsyn
from orthosfm_tpu.data import tracks as jtracks
from orthosfm_tpu.ops import triangulate as jtri
from orthosfm_tpu.solvers import ba as jba

from orthosfm_torch.config import BundleAdjustConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.data import tracks as tracks_mod
from orthosfm_torch.solvers import ba
from orthosfm_torch.testbench import metrics

TOL = 1e-5


@functools.lru_cache(maxsize=None)
def _problem(kind, num_views=6, n_points=256):
    return _make_problem(kind, num_views=num_views, n_points=n_points)


def _unit_points(seed=0, T=64):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(T, 4)).astype(np.float32)
    p[::7, 3] *= -1.0
    return p / np.linalg.norm(p, axis=-1, keepdims=True)


def test_point_manifold_track_major_matches_jax_and_the_T_forms():
    p = _unit_points()
    d = np.random.default_rng(1).normal(scale=0.1, size=(64, 3)).astype(np.float32)
    B = ba.point_tangent_basis(t(p))
    np.testing.assert_allclose(n(B), n(jba.point_tangent_basis(p)), atol=TOL)
    np.testing.assert_allclose(n(ba.retract_point(t(p), t(d))), n(jba.retract_point(p, d)),
                               atol=TOL)
    # the same manifold as the T-minor forms the solver runs
    np.testing.assert_allclose(n(B), n(ba.point_tangent_basis_T(t(p.T))).transpose(2, 0, 1),
                               atol=TOL)
    np.testing.assert_allclose(n(ba.retract_point(t(p), t(d))),
                               n(ba.retract_point_T(t(p.T), t(d.T))).T, atol=TOL)
    # an orthonormal basis orthogonal to the point
    np.testing.assert_allclose(n(B.transpose(-1, -2) @ B), np.broadcast_to(np.eye(3), (64, 3, 3)),
                               atol=TOL)
    np.testing.assert_allclose(n(torch.einsum("ti,tij->tj", t(p), B)), 0.0, atol=TOL)


@pytest.mark.parametrize("kind", ["quat", "euler"])
def test_autodiff_jacobians_match_jax_and_the_analytic_ones(kind):
    cams, points, obs, mask = _problem(kind)
    obs = obs + 2.5  # residuals and weights away from zero
    p_hat = points / jnp.maximum(jnp.linalg.norm(points, axis=-1, keepdims=True), 1e-20)
    p_hat = jnp.where(jnp.any(mask, axis=1)[:, None], p_hat, jnp.array([0.0, 0.0, 0.0, 1.0]))
    ref = jba._residuals_and_jacobians_autodiff(cams, p_hat, obs, mask, 1.0)
    tc = cam_mod.from_numpy(cams)
    got = ba._residuals_and_jacobians_autodiff(tc, t(p_hat), t(obs), t(mask), 1.0)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(n(a), n(b), rtol=1e-4, atol=1e-4 * max(np.abs(n(b)).max(), 1))
    R, dS = ba.rotation_tensors(kind, tc.rot)
    blocks = ba._residuals_and_jacobians(kind, R, dS, ba.pack_camp(tc), t(p_hat).T.contiguous(),
                                         t(obs).permute(1, 2, 0), t(mask).T, 1.0)
    r, Jc, Jp, w = got
    np.testing.assert_allclose(n(blocks.r.permute(2, 0, 1)), n(r), atol=1e-2)
    np.testing.assert_allclose(n(blocks.Jc.permute(3, 0, 1, 2)), n(Jc), rtol=1e-3, atol=1e-2)
    np.testing.assert_allclose(n(blocks.Jp.permute(3, 0, 1, 2)), n(Jp), rtol=1e-3, atol=1e-2)
    # weights 1/|r| past the Huber threshold: |r| >= ~2.5 px here, so the
    # residuals' 1e-2 px bar is 4e-3 of the weight
    np.testing.assert_allclose(n(blocks.weight.T), n(w), rtol=5e-3)


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("optimize_points", [True, False])
def test_schur_solve_matches_jax(kind, optimize_points):
    cams, points, obs, mask = _problem(kind)
    pT, obsT, maskT = _kernel_inputs(cams, points, obs, mask)
    free_c = jcam.free_mask(cams)
    blocks = jba._residuals_and_jacobians(cams, pT, obsT, maskT, 1.0)
    jblocks = jba.normal_equations(blocks, free_c)
    ref_c, ref_p = jax.jit(jba.schur_solve, static_argnums=(7,))(
        *jblocks, free_c, 1e-3, optimize_points)
    tc = cam_mod.from_numpy(cams)
    R, dS = ba.rotation_tensors(kind, tc.rot)
    tblocks = ba._residuals_and_jacobians(kind, R, dS, ba.pack_camp(tc), t(pT), t(obsT),
                                          t(maskT), 1.0)
    got_c, got_p = ba.schur_solve(*ba.normal_equations(tblocks, cam_mod.free_mask(tc)),
                                  cam_mod.free_mask(tc), 1e-3, optimize_points)
    np.testing.assert_allclose(n(got_c), n(ref_c), atol=1e-4 * np.abs(n(ref_c)).max())
    scale_p = max(np.abs(n(ref_p)).max(), 1e-12)
    np.testing.assert_allclose(n(got_p), n(ref_p), atol=1e-4 * scale_p)
    assert not optimize_points or scale_p > 1e-8
    # the solver's own plain step on the same blocks
    S, dU, rhs = bk_schur(kind, tc, pT, obsT, maskT, optimize_points)
    step = ba._solve_camera_system(S, dU, rhs, cam_mod.free_mask(tc), torch.tensor(1e-3))
    np.testing.assert_allclose(n(got_c), n(step), atol=1e-4 * np.abs(n(ref_c)).max())


def bk_schur(kind, tc, pT, obsT, maskT, optimize_points):
    """normal_eq_schur_ref (the plain K1) at lambda 1e-3 on the JAX inputs."""
    from orthosfm_torch.solvers import ba_kernels as bk

    p2, r2, c2 = bk.lm_buffers(t(pT), tc.rot, ba.pack_camp(tc))
    return bk.normal_eq_schur_ref(kind, p2, t(obsT), t(np.asarray(maskT, np.float32)), r2, c2,
                                  cam_mod.free_mask(tc).float(), bk.new_state(1e-3), 1.0,
                                  optimize_points)


def test_reprojection_errors_match_jax():
    cams, points, obs, mask = _problem("euler")
    noisy = obs + np.random.default_rng(2).normal(size=obs.shape).astype(np.float32)
    ref = jba.reprojection_errors(cams, points, noisy, mask)
    got = ba.reprojection_errors(cam_mod.from_numpy(cams), t(points), t(noisy), t(mask))
    np.testing.assert_allclose(n(got), n(ref), atol=2048 * TOL)
    assert np.all(n(got)[~np.asarray(mask)] == 0.0) and float(got.max()) > 1.0


def _even_odd_scene():
    """tests/test_homography.py:39-60's scene: 4 views of a 200-point
    sphere, cameras perturbed by up to 1 degree, camera 0 fixed."""
    ds = jsyn.generate_dataset(jsyn.sphere_cloud(200), num_views=4, seed=0)
    rng = np.random.default_rng(1)
    pert = np.asarray(ds.gt_cameras.rot[:, :3]) + np.deg2rad(
        rng.uniform(-1, 1, (4, 3))).astype(np.float32)
    e = jcam.make_euler(np.arange(4), 2048, 2048, angles=pert)
    cams = jcam.make_quaternion(np.arange(4), 2048, 2048, q=jquat.from_matrix(jcam.basis(e)))
    cams = cams.replace(fixed=jnp.zeros(4, bool).at[0].set(True))
    ts = jtri.triangulate_tracks(cams, ds.tracks, np.arange(4))
    return cams, ts.points, ts.obs, ts.obs_mask & ts.alive[:, None] & ts.has_point[:, None]


@pytest.mark.parametrize("fix_first_two", [False, True])
def test_run_even_odd_matches_jax(fix_first_two):
    cams, points, obs, mask = _even_odd_scene()
    ref = jba.run_even_odd(cams, points, obs, mask, fix_first_two=fix_first_two)
    got = ba.run_even_odd(cam_mod.from_numpy(cams), t(points), t(obs), t(mask),
                          fix_first_two=fix_first_two, config=BundleAdjustConfig())
    if not fix_first_two:
        assert float(got.cost) < float(got.initial_cost) * 1e-2
    # two perturbed cameras held fixed leave a cost the JAX package reaches too
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-3,
                               atol=1e-4 * float(ref.initial_cost))
    np.testing.assert_allclose(float(got.initial_cost), float(ref.initial_cost), rtol=1e-4)
    # the original fixed flags come back (plus the first two when asked)
    np.testing.assert_array_equal(n(got.cams.fixed), n(ref.cams.fixed))
    np.testing.assert_array_equal(n(got.cams.fixed), [True, fix_first_two, False, False])
    assert int(got.iterations) >= 3
    ang, _ = metrics.pose_errors(got.cams, cam_mod.from_numpy(ref.cams))
    assert float(np.max(ang)) < 1e-3


@pytest.mark.parametrize("solver", [0, 3])
def test_project_normalize_concatenate_match_jax(solver):
    je, te = _cams(solver)
    pts = np.concatenate([np.random.default_rng(1).normal(size=(40, 3)),
                          np.ones((40, 1))], axis=1).astype(np.float32)
    R = jcam.rotation_l2w(je)
    ref = jcam.project_from_params(R[:, None], je.offset[:, None], je.scale[:, None],
                                   je.width[:, None], je.height[:, None], pts[None])
    got = cam_mod.project_from_params(cam_mod.rotation_l2w(te)[:, None], te.offset[:, None],
                                      te.scale[:, None], te.width[:, None],
                                      te.height[:, None], t(pts)[None])
    np.testing.assert_allclose(n(got) / 2048.0, n(ref) / 2048.0, atol=TOL)
    np.testing.assert_allclose(n(got), n(cam_mod.project(te, t(pts))), atol=2048 * TOL)
    np.testing.assert_allclose(n(cam_mod.normalize_scene(te).rot),
                               n(jcam.normalize_scene(je).rot), atol=TOL)
    jc = jcam.concatenate(je, jcam.take(je, [2, 0]))
    tcat = cam_mod.concatenate(te, cam_mod.take(te, [2, 0]))
    assert len(tcat) == 8 and tcat.kind == jc.kind and tcat.solver == int(jc.solver)
    for name in ("rot", "offset", "scale", "width", "height", "view_ids", "fixed"):
        np.testing.assert_allclose(n(getattr(tcat, name)), n(getattr(jc, name)), atol=TOL)
    with pytest.raises(ValueError, match="concatenate"):
        cam_mod.concatenate(te, _cams(1 if solver == 0 else 0)[1])


@pytest.mark.parametrize("only_full_size", [True, False])
@pytest.mark.parametrize("keep_additional", [True, False])
def test_restrict_to_columns_matches_jax(only_full_size, keep_additional):
    ds = jsyn.generate_dataset(jsyn.sphere_cloud(60), num_views=5, seed=0)
    rng = np.random.default_rng(4)
    jts = ds.tracks.replace(obs_mask=jnp.asarray(rng.random((60, 5)) < 0.6))
    cols = [0, 2, 3]
    ref = jtracks.restrict_to_columns(jts, cols, only_full_size, keep_additional)
    got = tracks_mod.restrict_to_columns(tracks_mod.from_numpy(jts), cols, only_full_size,
                                         keep_additional)
    np.testing.assert_array_equal(n(got.alive), n(ref.alive))
    np.testing.assert_array_equal(n(got.obs_mask), n(ref.obs_mask))
    assert 0 < int(got.alive.sum()) < 60
