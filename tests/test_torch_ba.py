"""Parity of the port's bundle adjustment (orthosfm_torch/solvers/ba.py and
the plain versions of its CUDA kernels in ba_kernels.py) with the JAX
package's Pallas kernels run in interpret mode and its fused LM solver.

Tolerances are the JAX package's own for its kernels against its XLA path
(tests/test_ba_pallas.py:98-133, tests/test_ba_fused.py:58-109): both sides
are f32 and differ only in the order of their sums. The CUDA kernels
themselves are held against these plain versions in tests/test_torch_cuda.py,
on the card."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.torch_port_helpers import n, t
from tests.test_ba_pallas import _kernel_inputs, _problem as _make_problem
from tests.test_ba_fused import _fused_inputs

from orthosfm_tpu.config import BundleAdjustConfig as JBAConfig
from orthosfm_tpu.core import cameras as jcam
from orthosfm_tpu.solvers import ba as jba
from orthosfm_tpu.solvers import ba_pallas

from orthosfm_torch.config import BundleAdjustConfig
from orthosfm_torch.core import cameras as cam_mod
from orthosfm_torch.solvers import ba
from orthosfm_torch.solvers import ba_kernels as bk


@functools.lru_cache(maxsize=None)
def _problem(kind, num_views=8, n_points=1024):
    """The JAX package's test problem, built once per shape: JAX builds it
    op by op, in seconds."""
    return _make_problem(kind, num_views=num_views, n_points=n_points)


@jax.jit
def _jax_camera_step(cams, pT, obsT, maskT, lam, delta):
    """The JAX package's XLA camera step δc of one LM iteration."""
    free_c = jcam.free_mask(cams)
    blocks = jba._residuals_and_jacobians(cams, pT, obsT, maskT, delta)
    U, Wc, Vt, g_c, g_p = jba.normal_equations(blocks, free_c)
    return jba.schur_solve(U, Wc, Vt, g_c, g_p, free_c, lam, True)[0]


def _port_inputs(cams, pT, obsT, maskT):
    """The port's stage inputs from the JAX package's padded T-minor tensors."""
    tc = cam_mod.from_numpy(cams)
    return (tc, t(pT), t(obsT), t(np.asarray(maskT, np.float32)), tc.rot.contiguous(),
            ba.pack_camp(tc), cam_mod.free_mask(tc).float())


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("optimize_points", [True, False])
def test_normal_eq_schur_ref_matches_pallas_interpret(kind, optimize_points):
    cams, points, obs, mask = _problem(kind, n_points=512)
    pT, obsT, maskT = _kernel_inputs(cams, points, obs, mask)
    lam, delta = 1e-3, 1.0
    R, dSt, camp = jba._camera_tensors(cams)
    free = jcam.free_mask(cams).astype(obsT.dtype)
    S_k, dU_k, rhs_k = ba_pallas.normal_eq_schur(
        cams.kind, pT, obsT, maskT.astype(obsT.dtype), R, dSt, camp, free, lam, delta,
        optimize_points, interpret=True)
    _, pT_t, obsT_t, maskT_t, rot, camp_t, free_t = _port_inputs(cams, pT, obsT, maskT)
    p2, r2, c2 = bk.lm_buffers(pT_t, rot, camp_t)
    S, dU, rhs = bk.normal_eq_schur_ref(kind, p2, obsT_t, maskT_t, r2, c2, free_t,
                                        bk.new_state(lam), delta, optimize_points)
    scale = float(jnp.max(jnp.abs(S_k)))
    assert float(np.max(np.abs(n(S) - n(S_k)))) / scale < 2e-5
    np.testing.assert_allclose(n(dU), n(dU_k), rtol=2e-5, atol=1e-4)
    rscale = float(jnp.max(jnp.abs(rhs_k)))
    assert float(np.max(np.abs(n(rhs) - n(rhs_k)))) / rscale < 2e-5


@pytest.mark.parametrize("kind", ["quat", "euler"])
def test_point_update_cost_ref_matches_pallas_interpret(kind):
    cams, points, obs, mask = _problem(kind, n_points=512)
    pT, obsT, maskT = _kernel_inputs(cams, points, obs, mask)
    lam, delta = 1e-3, 1.0
    free_c = jcam.free_mask(cams)
    R, dSt, camp = jba._camera_tensors(cams)
    delta_c = _jax_camera_step(cams, pT, obsT, maskT, lam, delta)
    cams_new = jcam.retract(cams, delta_c.astype(obsT.dtype))
    R2, _, camp2 = jba._camera_tensors(cams_new)
    p_k, cost_k = ba_pallas.point_update_cost(
        cams.kind, pT, obsT, maskT.astype(obsT.dtype), R, dSt, camp,
        free_c.astype(obsT.dtype), lam, delta_c.astype(obsT.dtype), R2, camp2, delta, True,
        interpret=True)

    tc, pT_t, obsT_t, maskT_t, rot, camp_t, free_t = _port_inputs(cams, pT, obsT, maskT)
    tn = cam_mod.from_numpy(cams_new)
    p_new, parts = bk.point_update_cost_ref(kind, pT_t, obsT_t, maskT_t, rot, camp_t, free_t,
                                            bk.new_state(lam), t(delta_c), tn.rot,
                                            ba.pack_camp(tn), delta, True)
    np.testing.assert_allclose(n(p_new), n(p_k), rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(float(parts.sum()), float(cost_k), rtol=1e-4)


@pytest.mark.parametrize("kind", ["quat", "euler"])
def test_residuals_and_jacobians_match(kind):
    cams, points, obs, mask = _problem(kind, n_points=512)
    pT, obsT, maskT = _kernel_inputs(cams, points, obs, mask)
    ref = jax.jit(jba._residuals_and_jacobians)(cams, pT, obsT, maskT, 1.0)
    tc = cam_mod.from_numpy(cams)
    R, dS = ba.rotation_tensors(kind, tc.rot)
    got = ba._residuals_and_jacobians(kind, R, dS, ba.pack_camp(tc), t(pT), t(obsT),
                                      t(maskT), 1.0)
    for name in ("r", "Jc", "Jp", "weight"):
        a, b = n(getattr(got, name)), n(getattr(ref, name))
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4 * np.abs(b).max())


def test_camera_solve_ref_matches_xla():
    cams, points, obs, mask = _problem("quat", n_points=512)
    pT, obsT, maskT = _kernel_inputs(cams, points, obs, mask)
    free_c = jcam.free_mask(cams)
    R, dSt, camp = jba._camera_tensors(cams)
    S, dU, rhs = ba_pallas.normal_eq_schur(
        "quat", pT, obsT, maskT.astype(obsT.dtype), R, dSt, camp, free_c.astype(obsT.dtype),
        1e-3, 1.0, True, interpret=True)
    ref = jba._solve_camera_system(S, dU, rhs, free_c, 1e-3)
    ref_cams = jcam.retract(cams, ref)
    tc = cam_mod.from_numpy(cams)
    _, r2, c2 = bk.lm_buffers(t(pT), tc.rot, ba.pack_camp(tc))
    delta = bk.camera_solve_ref("quat", t(S), t(dU), t(rhs), cam_mod.free_mask(tc).float(),
                                bk.new_state(1e-3), r2, c2)
    scale = float(np.abs(n(ref)).max())
    np.testing.assert_allclose(n(delta), n(ref), atol=1e-4 * scale)
    # a fresh state names half 0: the candidate is in half 1
    np.testing.assert_allclose(n(r2[1]), n(ref_cams.rot), atol=1e-6)
    np.testing.assert_allclose(n(c2[1, :, 3:5]), n(ref_cams.offset), atol=1e-6)
    assert torch.equal(r2[0], tc.rot)


def _run_both(kind, optimize_points, max_iterations, fixed=None):
    """The port's ba.run (plain path) and the JAX fused LM kernel in
    interpret mode, on the same problem."""
    cams, points, obs, mask = _problem(kind, num_views=8, n_points=1024)
    if fixed is not None:
        cams = cams.replace(fixed=jnp.asarray(fixed))
    cfg = JBAConfig(max_iterations=max_iterations, function_tolerance=0.0,
                    min_lambda=1e-12, use_pallas=False)
    pT, obsT, maskT = _fused_inputs(cams, points, obs, mask)
    rf = jba._run_fused(cams, pT, obsT, maskT, jcam.free_mask(cams), optimize_points, cfg,
                        n_tracks=obs.shape[0], interpret=True)
    pcfg = BundleAdjustConfig(max_iterations=max_iterations, function_tolerance=0.0,
                              min_lambda=1e-12, impl="torch")
    rt = ba.run(cam_mod.from_numpy(cams), t(points), t(obs), t(mask),
                optimize_points=optimize_points, config=pcfg)
    return cams, rf, rt


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("optimize_points", [True, False])
def test_single_step_matches_fused_interpret(kind, optimize_points):
    _, rf, rt = _run_both(kind, optimize_points, max_iterations=1)
    np.testing.assert_allclose(float(rt.initial_cost), float(rf.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(rt.cost), float(rf.cost), rtol=1e-3)
    np.testing.assert_allclose(n(rt.cams.rot), n(rf.cams.rot), rtol=1e-4, atol=2e-6)
    np.testing.assert_allclose(n(rt.cams.offset), n(rf.cams.offset), atol=1e-5)
    if optimize_points:
        np.testing.assert_allclose(n(rt.points), n(rf.points), rtol=1e-3, atol=1e-5)
    assert int(rt.iterations) == int(rf.iterations) == 1


@pytest.mark.parametrize("kind", ["quat", "euler"])
def test_full_lm_converges_like_fused(kind):
    _, rf, rt = _run_both(kind, True, max_iterations=15)
    assert float(rt.cost) < float(rt.initial_cost) * 1e-2, kind
    assert float(rt.cost) < float(rf.cost) * 1.5 + 1e-6
    assert int(rt.iterations) >= 1


@functools.lru_cache(maxsize=None)
def _rejecting_problem(kind):
    """The test problem with every free camera's scale 2.5 times too large
    (scale is pinned, so no step can repair it): from λ₀ = 1e-2 the first two
    LM steps raise the cost and are rejected, the third is accepted."""
    cams, points, obs, mask = _problem(kind, num_views=8, n_points=1024)
    scale = np.asarray(cams.scale).copy()
    scale[1:] *= 2.5
    return cams.replace(scale=jnp.asarray(scale)), points, obs, mask


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("max_iterations", [2, 3, 6])
def test_lm_with_rejected_steps_matches_fused_interpret(kind, max_iterations):
    """ba.run's three stages on the CPU, the buffer flip of an accepted step
    included, against the JAX package's fused LM kernel in interpret mode,
    over runs whose first two steps are rejected: after two iterations both
    still hold the initial cameras and cost, after three and six they agree
    on the accepted steps."""
    cams, points, obs, mask = _rejecting_problem(kind)
    kw = dict(max_iterations=max_iterations, function_tolerance=0.0, min_lambda=1e-12,
              initial_lambda=1e-2)
    pT, obsT, maskT = _fused_inputs(cams, points, obs, mask)
    rf = jba._run_fused(cams, pT, obsT, maskT, jcam.free_mask(cams), True,
                        JBAConfig(use_pallas=False, **kw), n_tracks=obs.shape[0], interpret=True)
    rt = ba.run(cam_mod.from_numpy(cams), t(points), t(obs), t(mask), True,
                BundleAdjustConfig(impl="torch", **kw))
    assert int(rt.iterations) == int(rf.iterations) == max_iterations
    np.testing.assert_allclose(float(rt.initial_cost), float(rf.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(float(rt.cost), float(rf.cost), rtol=1e-5)
    np.testing.assert_allclose(n(rt.cams.rot), n(rf.cams.rot), atol=2e-6)
    np.testing.assert_allclose(n(rt.cams.offset), n(rf.cams.offset), atol=1e-5)
    np.testing.assert_allclose(n(rt.points), n(rf.points), atol=1e-5)
    if max_iterations == 2:
        assert float(rt.cost) == float(rt.initial_cost)
        np.testing.assert_array_equal(n(rt.cams.rot), n(cams.rot))
    else:
        assert float(rt.cost) < float(rt.initial_cost) * 0.9


def _accept_stage_inputs(kind):
    """One LM iteration's inputs to the fused point-update/accept stage: the
    LM buffers with the plain camera step's candidate in half 1, and the
    step."""
    cams, points, obs, mask = _problem(kind, n_points=512)
    tc = cam_mod.from_numpy(cams)
    pT, obsT, maskT = ba.prepare(t(points), t(obs), t(mask))
    rot, camp, free = tc.rot.contiguous(), ba.pack_camp(tc), cam_mod.free_mask(tc).float()
    s = bk.new_state(1e-3)
    p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
    S, dU, rhs = bk.normal_eq_schur_ref(kind, p2, obsT, maskT, r2, c2, free, s, 1.0, True)
    delta = bk.camera_solve_ref(kind, S, dU, rhs, free, s, r2, c2)
    return pT, obsT, maskT, rot, camp, free, delta, r2[1].clone(), c2[1].clone()


@pytest.mark.parametrize("kind", ["quat", "euler"])
@pytest.mark.parametrize("case", ["accept", "reject", "done", "points fixed", "from half 1"])
def test_point_update_accept_ref_is_update_then_accept(kind, case):
    """The plain fused stage equals point_update_cost_ref then lm_accept_ref
    (which copy the accepted step): the half that its state_out[CUR] names
    holds what lm_accept_ref leaves in place, and nothing is copied into the
    current half."""
    pT, obsT, maskT, rot, camp, free, delta, rot_c, camp_c = _accept_stage_inputs(kind)
    cfg = bk.LMConfig(1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)
    opt = case != "points fixed"
    p_new, parts = bk.point_update_cost_ref(kind, pT, obsT, maskT, rot, camp, free,
                                            bk.new_state(1e-3), delta, rot_c, camp_c, 1.0, opt)
    s_in = bk.new_state(1e-3)
    s_in[bk.COST] = float(parts.sum()) * (0.5 if case == "reject" else 2.0)
    s_in[bk.DONE] = float(case == "done")
    ref_out = torch.zeros(bk.STATE_SIZE)
    r_ref, c_ref, p_ref = rot.clone(), camp.clone(), pT.clone()
    bk.lm_accept_ref(parts, s_in, ref_out, r_ref, c_ref, p_ref, rot_c, camp_c,
                     p_new if opt else None, cfg)

    half = 1 if case == "from half 1" else 0
    s_in[bk.CUR] = float(half)
    p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
    r2[1 - half], c2[1 - half] = rot_c, camp_c
    s_out = torch.zeros(bk.STATE_SIZE)
    got = bk.point_update_accept_ref(kind, p2, obsT, maskT, r2, c2, free, s_in, s_out, delta,
                                     1.0, opt, cfg)
    assert torch.equal(got, parts)
    accepted = case not in ("reject", "done")
    assert float(s_out[bk.CUR]) == float(half ^ accepted)
    expected = ref_out.clone()
    expected[bk.CUR] = s_out[bk.CUR]
    assert torch.equal(s_out, expected)
    for buf, ref in ((r2, r_ref), (c2, c_ref), (p2, p_ref)):
        assert torch.equal(bk.current(buf, s_out), ref)
    for buf, orig in ((r2, rot), (c2, camp), (p2, pT)):
        assert torch.equal(buf[half], orig)  # the current half is never written


def test_point_update_accept_ref_initial_cost():
    """With no state in, the plain fused stage writes the first state: λ₀,
    the cost at the current cameras and points (also as the initial cost)
    and half 0 current; without a state out it only returns the partials."""
    pT, obsT, maskT, rot, camp, free, *_ = _accept_stage_inputs("quat")
    cfg = bk.LMConfig(1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)
    _, parts = bk.point_update_cost_ref("quat", pT, obsT, maskT, rot, camp, free, None, None,
                                        rot, camp, 1.0, False)
    p2, r2, c2 = bk.lm_buffers(pT, rot, camp)
    r2[1] += 1.0  # an unrelated other half, never read
    s_out = torch.full((bk.STATE_SIZE,), 7.0)
    stage = bk.PointUpdateCost("quat", p2, obsT, maskT, r2, c2, free, 1.0, True, cfg)
    assert torch.equal(stage(None, s_out), parts)
    c = float(parts.sum())
    assert s_out.tolist() == [pytest.approx(1e-4), c, 0.0, 0.0, c, 0.0, 0.0, 0.0]
    assert torch.equal(p2[1], pT)  # the initial cost moves no point
    assert torch.equal(stage(None, None), parts)
    assert bk.launch_counts()["point_update_cost"] == 0


def test_fixed_cameras_stay_fixed():
    fixed = np.zeros(8, bool)
    fixed[[0, 3]] = True
    cams, _, rt = _run_both("quat", True, max_iterations=3, fixed=fixed)
    for i in (0, 3):
        np.testing.assert_array_equal(n(rt.cams.rot[i]), n(cams.rot[i]))
        np.testing.assert_array_equal(n(rt.cams.offset[i]), n(cams.offset[i]))


def test_lm_accept_rule():
    """lm_accept_ref follows the JAX package's accept/λ/done rule
    (ba.py:501-513): accept a lower cost and shrink λ, reject otherwise and
    grow λ, stop at a small relative decrease or at λ_max, and pass a done
    state through unchanged."""
    cfg = bk.LMConfig(1e-4, 1e-6, 4.0, 0.5, 1e-12, 1e8)
    rot, camp, pT = torch.zeros(2, 4), torch.zeros(2, 8), torch.zeros(4, 3)
    rot_c, camp_c, p_c = torch.ones(2, 4), torch.ones(2, 8), torch.ones(4, 3)

    def step(cost, new_cost, lam=1e-3, done=0.0):
        s_in = torch.tensor([lam, cost, 5.0, done, 100.0, 0, 0, 0])
        s_out = torch.zeros(bk.STATE_SIZE)
        r, c, p = rot.clone(), camp.clone(), pT.clone()
        bk.lm_accept_ref(torch.tensor([new_cost]), s_in, s_out, r, c, p, rot_c, camp_c, p_c,
                         cfg)
        return s_out, r, p

    s, r, p = step(10.0, 5.0)
    assert float(s[bk.COST]) == 5.0 and float(r.sum()) == 8 and float(p.sum()) == 12
    np.testing.assert_allclose(float(s[bk.LAM]), 5e-4, rtol=1e-6)
    assert float(s[bk.ITERS]) == 6.0 and float(s[bk.DONE]) == 0.0
    s, r, p = step(10.0, 11.0)
    assert float(s[bk.COST]) == 10.0 and float(r.sum()) == 0 and float(p.sum()) == 0
    np.testing.assert_allclose(float(s[bk.LAM]), 4e-3, rtol=1e-6)
    s, _, _ = step(10.0, 10.0 - 1e-6)
    assert float(s[bk.DONE]) == 1.0
    s, _, _ = step(10.0, 11.0, lam=5e7)
    assert float(s[bk.DONE]) == 1.0 and float(s[bk.LAM]) == 1e8
    s, r, _ = step(10.0, 5.0, done=1.0)
    assert float(s[bk.COST]) == 10.0 and float(s[bk.ITERS]) == 5.0 and float(r.sum()) == 0


def test_wrappers_use_plain_versions_on_cpu():
    cams, points, obs, mask = _problem("euler")
    tc, tp, to, tm = cam_mod.from_numpy(cams), t(points), t(obs), t(mask)
    bk.reset_launch_counts()
    cfg = BundleAdjustConfig(max_iterations=4, function_tolerance=0.0, impl="kernel")
    r_k = ba.run(tc, tp, to, tm, True, cfg)
    r_t = ba.run(tc, tp, to, tm, True, dataclasses.replace(cfg, impl="torch"))
    assert bk.launch_counts() == {"schur_assemble": 0, "camera_solve": 0, "point_update_cost": 0,
                                  "lm_accept": 0}
    np.testing.assert_array_equal(n(r_k.points), n(r_t.points))
    assert float(r_k.cost) == float(r_t.cost)
    with pytest.raises(ValueError):
        ba.run(tc, tp, to, tm, True, dataclasses.replace(cfg, impl="xla"))


def test_wrapper_argument_checks():
    x = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="dtype"):
        bk._check("x", x.double(), (4, 3), x.device)
    with pytest.raises(ValueError, match="shape"):
        bk._check("x", x, (3, 4), x.device)
    with pytest.raises(ValueError, match="contiguous"):
        bk._check("x", x.T, (3, 4), x.device)
    with pytest.raises(ValueError, match="kind"):
        bk._check_kind("axis-angle")


def test_library_is_named_by_source_hash(monkeypatch, tmp_path):
    """The shared build names each library by a hash of its source and
    flags, and a failed build raises."""
    from orthosfm_torch import kernel_build

    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    monkeypatch.setattr(kernel_build, "BUILD_DIR", tmp_path / "_build")
    one = kernel_build.library_path(src)
    src.write_text("// two\n")
    assert kernel_build.library_path(src) != one
    assert kernel_build.library_path(src).parent == tmp_path / "_build"
    assert bk.SOURCE.parent == kernel_build.CSRC
    monkeypatch.setattr(kernel_build, "NVCC", str(tmp_path / "no-nvcc"))
    with pytest.raises(RuntimeError, match="nvcc"):
        kernel_build.build(src)
